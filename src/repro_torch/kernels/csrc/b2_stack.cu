// Pairwise-butterfly stack with stripe skip, hand-written for Hopper (sm_90a).
//
//   out[g, x, y] = C((A_g A_g^T)[x, y], 2) * [x != y]
//
// Replaces kernel 3 of the reference package,
// src/repro/kernels/butterfly_sparse.py:420 b2_stack_pallas_sparse (body
// _b2_stack_kernel): the fd_update_mode="b2" precompute of the FD
// level-peel loop.
//
// Design.  One 256-thread block computes a 64 x 64 tile of W = A_g A_g^T in
// registers (4 x 4 per thread) from 16-column K-stripes staged through
// shared memory, with f32 FMA (wedge_tile.cuh, shared with the other
// butterfly kernels), and writes C(W, 2) with the diagonal zeroed.
// The Pallas kernel skips K-stripe k of tile (i, j) when
// k >= min(kmax_a[g, i], kmax_b[g, j]); here each block reads the extents of
// the reference tiles (bi rows on the A side, bj rows on the B side, bk
// columns a stripe) that cover its 64 rows and 64 columns, and stops its K
// loop at min(max kmax_a, max kmax_b) * bk.  Columns past that bound are
// zero in every row of the block (the extents are upper bounds), so the
// skip is exact.
//
// Exactness.  As in butterfly_sparse.cu: 0/1 operands, integer wedge counts below
// 2^24, and C(W, 2) evaluated in the reference's operation order, so every
// entry is bit-identical to the reference while it is below 2^24.
//
// What bounds it on the H100.  2 G m m K_used operations against G m n_v
// f32 reads and G m m f32 writes; at FD's stack shapes (m = 1024) the
// product dominates, so it is bound by operations.  Its floor is the int8
// tensor-core rate; this first version runs on the f32 FMA units, and the
// stripe skip removes the product's all-zero tail.
//
// Shapes need not be multiples of any tile: loads and stores mask the
// ragged edge.  a is (G, m, n_v) f32, kmax_a (G, n_ta) and kmax_b (G, n_tb)
// int32, out (G, m, m) f32, all contiguous.  The launch goes on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include "wedge_tile.cuh"

namespace {

using namespace wedge;

__global__ void __launch_bounds__(THREADS)
b2_stack_kernel(const float* __restrict__ a, const int* __restrict__ kmax_a,
                const int* __restrict__ kmax_b, float* __restrict__ out,
                int m, int n_v, int n_ta, int n_tb, int bi, int bj, int bk) {
  const int64_t g = blockIdx.z;
  a += g * m * (int64_t)n_v;
  out += g * m * (int64_t)m;
  kmax_a += g * n_ta;
  kmax_b += g * n_tb;

  const int x0 = blockIdx.x * TI;
  const int y0 = blockIdx.y * TJ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // per-block K bound from the stripe extents
  const int ka = covering_extent(kmax_a, x0, min(x0 + TI, m), bi);
  const int kb = covering_extent(kmax_b, y0, min(y0 + TJ, m), bj);
  const int k_end = (int)min((int64_t)min(ka, kb) * bk, (int64_t)n_v);

  float acc[4][4];
  tile_product(a, a, m, m, n_v, x0, y0, k_end, acc);

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int x = x0 + ty + 16 * p;
    if (x >= m) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int y = y0 + tx + 16 * q;
      if (y >= m) continue;
      const float w = acc[p][q];
      out[(int64_t)x * m + y] = (x != y) ? w * (w - 1.0f) * 0.5f : 0.0f;
    }
  }
}

}  // namespace

extern "C" int b2_stack_f32(const float* a, const int* kmax_a,
                            const int* kmax_b, float* out, int groups, int m,
                            int n_v, int n_ta, int n_tb, int bi, int bj,
                            int bk, void* stream) {
  const dim3 grid((m + TI - 1) / TI, (m + TJ - 1) / TJ, groups);
  b2_stack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, kmax_a, kmax_b, out, m, n_v, n_ta, n_tb, bi, bj, bk);
  return (int)cudaGetLastError();
}

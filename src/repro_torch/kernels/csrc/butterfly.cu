// Fused butterfly update, hand-written for Hopper (sm_90a).
//
//   out[g, i] = sum_{j : ids_b[g, j] != ids_a[g, i]} s[g, j] * C((A_g B_g^T)[i, j], 2)
//
// Replaces two Pallas TPU kernels of the reference package:
//   * kernel 1, src/repro/kernels/butterfly.py:125 butterfly_support_pallas
//     (body butterfly_kernel_body): one graph, GLOBAL row ids.  Counting and
//     HUC recounts (A = B, s = alive) and every CD peel update (B = gathered
//     peel rows, s = their validity mask).
//   * kernel 2, src/repro/kernels/butterfly.py:225
//     butterfly_update_pallas_batched: the same op over a stack of G
//     independent FD subgraphs with LOCAL ids.  Here it is kernel 1 with the
//     group as gridDim.z.
//
// Design.  One 256-thread block computes a 64 x 64 wedge tile
// W = A[i0:i0+64] . B[j0:j0+64]^T in registers (4 x 4 per thread), from
// 16-column K-stripes staged through shared memory, with f32 FMA.  The
// epilogue applies C(W, 2) = W * (W - 1) * 0.5, the row mask s and the
// not-self mask, row-reduces the tile (half-warp shuffles) and adds the
// partial row sums into out with atomicAdd.  The Pallas grid carries out_i
// across j in order on one core; here the j-tiles run as parallel blocks
// and meet in the atomics.  The wrapper zeroes out before the launch.
//
// Exactness.  A and B are 0/1, so every wedge count W is an integer below
// n_v and is exact in f32 while n_v < 2^24.  The engine works in the regime
// where every butterfly support is below 2^24 (DESIGN.md section 8); then
// every C(W, 2), every partial row sum and every atomicAdd operand is a
// non-negative integer no larger than the final support, so each f32
// addition is exact in ANY order: the atomics give the same bits on every
// run and the same bits as the reference.  C(W, 2) is evaluated in the
// reference's operation order (W * (W - 1), then * 0.5).
//
// What bounds it on the H100.  The work is a matrix product, 2 n_a n_b n_v
// operations, against (n_a + n_b) n_v f32 reads: at the engine's shapes
// (n_a = 8192 rows, n_v = 8192 columns) it is bound by operations, not
// bytes.  Its floor is the int8 tensor-core rate (0/1 operands and counts
// below 2^24 are exact in int8 -> int32); this first version runs on the
// f32 FMA units instead (about 1/30 of that rate), which keeps the
// arithmetic plainly exact.  Moving the product to wgmma (s8 x s8 -> s32)
// with TMA-fed stages is the work of a later change.
//
// Shapes need not be multiples of any tile: loads and the epilogue mask the
// ragged edge.  All tensors are contiguous, f32 (a, b, s, out) and int32
// (ids).  The launch goes on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TI = 64;        // output rows per block
constexpr int TJ = 64;        // mask-side rows per block
constexpr int TK = 16;        // K-stripe depth staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each

__global__ void __launch_bounds__(THREADS)
wedge_update_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ s,
                    const int* __restrict__ ids_a,
                    const int* __restrict__ ids_b, float* __restrict__ out,
                    int n_a, int n_b, int n_v) {
  const int64_t g = blockIdx.z;
  a += g * n_a * (int64_t)n_v;
  b += g * n_b * (int64_t)n_v;
  s += g * n_b;
  ids_b += g * n_b;
  ids_a += g * n_a;
  out += g * n_a;

  const int i0 = blockIdx.x * TI;
  const int j0 = blockIdx.y * TJ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx + 16 q
  const int ty = tid / 16;  // rows ty + 16 p

  // stripes stored k-major so the inner loop reads rows of the tile
  __shared__ float As[TK][TI + 1];
  __shared__ float Bs[TK][TJ + 1];

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;

  for (int k0 = 0; k0 < n_v; k0 += TK) {
    // each of the 4 loads of a thread: element e = tid + 256 r of the
    // 64 x 16 stripe; 16 neighbouring lanes read 16 neighbouring columns
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + THREADS * r;
      const int row = e / TK;
      const int kk = e % TK;
      const int k = k0 + kk;
      const int ra = i0 + row;
      const int rb = j0 + row;
      As[kk][row] = (ra < n_a && k < n_v) ? a[(int64_t)ra * n_v + k] : 0.0f;
      Bs[kk][row] = (rb < n_b && k < n_v) ? b[(int64_t)rb * n_v + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) av[p] = As[kk][ty + 16 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bs[kk][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += av[p] * bv[q];
    }
    __syncthreads();
  }

  // epilogue: C(W, 2) * s * not-self, reduced over this block's columns
  float part[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    part[p] = 0.0f;
    const int i = i0 + ty + 16 * p;
    if (i >= n_a) continue;
    const int ida = ids_a[i];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (j >= n_b) continue;
      const float w = acc[p][q];
      const float b2 = w * (w - 1.0f) * 0.5f;
      const float not_self = (ida != ids_b[j]) ? 1.0f : 0.0f;
      part[p] += b2 * not_self * s[j];
    }
  }
  // lanes tx = 0..15 of one half-warp share ty: reduce across them
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      part[p] += __shfl_xor_sync(0xffffffffu, part[p], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = i0 + ty + 16 * p;
      if (i < n_a && part[p] != 0.0f) atomicAdd(out + i, part[p]);
    }
  }
}

int launch(const float* a, const float* b, const float* s, const int* ids_a,
           const int* ids_b, float* out, int groups, int n_a, int n_b,
           int n_v, void* stream) {
  const dim3 grid((n_a + TI - 1) / TI, (n_b + TJ - 1) / TJ, groups);
  wedge_update_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, s, ids_a, ids_b, out, n_a, n_b, n_v);
  return (int)cudaGetLastError();
}

}  // namespace

// kernel 1: one graph.  a (n_a, n_v), b (n_b, n_v), s (n_b,), ids_a (n_a,),
// ids_b (n_b,), out (n_a,) zeroed by the caller.
extern "C" int butterfly_update_f32(const float* a, const float* b,
                                    const float* s, const int* ids_a,
                                    const int* ids_b, float* out, int n_a,
                                    int n_b, int n_v, void* stream) {
  return launch(a, b, s, ids_a, ids_b, out, 1, n_a, n_b, n_v, stream);
}

// kernel 2: a stack of G graphs.  a (G, n_a, n_v), b (G, n_b, n_v),
// s (G, n_b), ids_a (G, n_a), ids_b (G, n_b), out (G, n_a) zeroed.
extern "C" int butterfly_update_batched_f32(const float* a, const float* b,
                                            const float* s, const int* ids_a,
                                            const int* ids_b, float* out,
                                            int groups, int n_a, int n_b,
                                            int n_v, void* stream) {
  return launch(a, b, s, ids_a, ids_b, out, groups, n_a, n_b, n_v, stream);
}

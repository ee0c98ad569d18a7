// The 64 x 64 wedge tile shared by the butterfly kernels (sm_90a):
// butterfly_sparse.cu (kernels 1, 2, 4 and 5), b2_stack.cu (kernel 3) and
// butterfly_tiled.cu (kernel 6, which sums the product over many tile
// pairs with tile_product_add).
//
// One 256-thread block computes a 64 x 64 tile of W = A B^T in registers
// (4 x 4 per thread) from 16-column K-stripes staged through shared memory,
// with f32 FMA.  Thread (tx, ty) = (tid % 16, tid / 16) holds rows
// ty + 16 p and columns tx + 16 q of the tile.  A caller that skips
// stripes passes a K bound below n_v; rows past n_a / n_b and columns past
// the bound read as zero, so ragged shapes need no padding.
//
// A and B are 0/1, so every W is an integer below 2^24 and exact in f32;
// the update epilogue of kernels 1-5 evaluates C(W, 2) in the reference's
// operation order (W * (W - 1), then * 0.5) in f64, and its partial row
// sums are integers no larger than the final support, so its f64
// atomicAdds are exact in any order below 2^53.  Kernel 6 adds f32
// partials (add_row_partials<float>): exact below 2^24 (DESIGN.md
// section 8).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wedge {

constexpr int TI = 64;        // A rows per block
constexpr int TJ = 64;        // B rows per block
constexpr int TK = 16;        // K-stripe depth staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each

// largest extent over the reference tiles of `block` rows covering
// [r0, r1) of one extent vector (the per-block K bound of a stripe skip)
__device__ __forceinline__ int covering_extent(const int* kmax, int r0, int r1,
                                               int block) {
  int k = 0;
  for (int t = r0 / block; t <= (r1 - 1) / block; ++t) k = max(k, kmax[t]);
  return k;
}

// acc[p][q] += sum_{k < k_end} A[i0 + ty + 16 p, k] * B[j0 + tx + 16 q, k].
// Called by every thread of the block.
__device__ __forceinline__ void tile_product_add(const float* __restrict__ a,
                                                 const float* __restrict__ b,
                                                 int n_a, int n_b, int n_v,
                                                 int i0, int j0, int k_end,
                                                 float (&acc)[4][4]) {
  // stripes stored k-major so the inner loop reads rows of the tile
  __shared__ float As[TK][TI + 1];
  __shared__ float Bs[TK][TJ + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int k0 = 0; k0 < k_end; k0 += TK) {
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
      As[kk][row] = (ra < n_a && k < k_end) ? a[(int64_t)ra * n_v + k] : 0.0f;
      Bs[kk][row] = (rb < n_b && k < k_end) ? b[(int64_t)rb * n_v + k] : 0.0f;
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
}

// acc[p][q] = sum_{k < k_end} A[i0 + ty + 16 p, k] * B[j0 + tx + 16 q, k].
__device__ __forceinline__ void tile_product(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             int n_a, int n_b, int n_v, int i0,
                                             int j0, int k_end,
                                             float (&acc)[4][4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
  tile_product_add(a, b, n_a, n_b, n_v, i0, j0, k_end, acc);
}

// Adds each row's partial sum part[p] (row i0 + ty + 16 p, summed over the
// tile's columns tx + 16 q by the caller) into out with atomicAdd, after a
// half-warp reduction over tx.  Rows past n_a and zero sums add nothing.
// T is float (kernel 6) or double (kernels 1-5).
template <typename T>
__device__ __forceinline__ void add_row_partials(T (&part)[4],
                                                 T* __restrict__ out,
                                                 int n_a, int i0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
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
      if (i < n_a && part[p] != T(0)) atomicAdd(out + i, part[p]);
    }
  }
}

// The butterfly-update epilogue of kernels 1-5, in f64: C(W, 2) * s *
// not-self, reduced over the tile's columns (half-warp shuffles) and
// added into out with atomicAdd.  The wrapper zeroes out before the
// launch.
__device__ __forceinline__ void update_epilogue(
    const float (&acc)[4][4], const float* __restrict__ s,
    const int* __restrict__ ids_a, const int* __restrict__ ids_b,
    double* __restrict__ out, int n_a, int n_b, int i0, int j0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  double part[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    part[p] = 0.0;
    const int i = i0 + ty + 16 * p;
    if (i >= n_a) continue;
    const int ida = ids_a[i];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (j >= n_b) continue;
      const double w = acc[p][q];
      const double b2 = w * (w - 1.0) * 0.5;
      if (ida != ids_b[j]) part[p] += b2 * (double)s[j];
    }
  }
  add_row_partials(part, out, n_a, i0);
}

}  // namespace wedge

// Pieces of the int8 tensor-core peel bodies (sm_90a): butterfly_sparse.cu
// (the gathered peel form of kernels 1 and 4, and the stack form of
// kernels 2 and 5) and butterfly_tiled.cu (the peel form of kernel 6).
//
// Both multiply 0/1 operands staged through shared memory in 32-column
// K-stripes: the f32 A stripe arrives by cp.async (16-byte copies, or
// 4-byte ones when rows are not 16-byte aligned), zero-filled past the
// ragged edge, and becomes s8 as it is read into the mma fragments; the
// B rows are packed to s8 by a pre-pass.  The product runs as
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (W = A B^T: both
// operands are K-contiguous rows, which is the row.col layout).
//
// Exactness.  The s8 conversion maps a value v to [v != 0], which is the
// value itself for the 0/1 operands these kernels take (their contract,
// as the reference's).  A product of 0/1 values summed over K < 2^31
// columns cannot overflow s32, and every W is an integer below 2^24
// (DESIGN.md section 8), so the s32 -> f32 conversion is exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wmma8 {

constexpr int KS = 32;   // K-stripe width: the k32 of one s8 mma

// ---- cp.async ------------------------------------------------------- //
// Copy `bytes` (0..16) of src into the 16 bytes at dst, zero-filling the
// rest; src must be 16-byte aligned (and is not read when bytes == 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// The same for 4 bytes (bytes 0 or 4), 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- s8 packing and the product ------------------------------------ //
// Four values as four s8 bytes [v != 0], the first in the low byte (the
// element order of a packed mma operand register).
__device__ __forceinline__ uint32_t pack_s8(float x, float y, float z,
                                            float w) {
  return (uint32_t)(x != 0.0f) | ((uint32_t)(y != 0.0f) << 8) |
         ((uint32_t)(z != 0.0f) << 16) | ((uint32_t)(w != 0.0f) << 24);
}

__device__ __forceinline__ uint32_t pack_s8(float4 v) {
  return pack_s8(v.x, v.y, v.z, v.w);
}

// c += A (16 x 32, row) . B (32 x 8, col), s8 x s8 -> s32.  Fragments
// (lane = 4 g + t): a0 row g, k 4t..4t+3; a1 row g + 8, the same k;
// a2 row g, k 16 + 4t..; a3 row g + 8, k 16 + 4t..; b0 column g,
// k 4t..4t+3; b1 column g, k 16 + 4t..; c0, c1 row g, columns 2t, 2t + 1;
// c2, c3 row g + 8.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- shared-memory stripes ------------------------------------------ //
// An f32 A stripe of R rows x 32 columns: row r at r * 32 floats, its eight
// 16-byte chunks swizzled by chunk ^ 4 (r & 1), so the eight lanes of one
// 128-bit access phase (rows g, g + 1; chunks t) hit distinct banks.
__device__ __forceinline__ int a_slot(int row, int chunk) {
  return row * KS + ((chunk ^ ((row & 1) << 2)) << 2);
}

// An s8 B stripe of rows x 32 bytes: row n at n * 32 bytes, its two
// 16-byte halves swizzled by half ^ ((n >> 2) & 1), so a fragment load
// (rows g = 0..7, word t) hits 32 distinct banks.
__device__ __forceinline__ int b_slot(int row, int half) {
  return row * KS + ((half ^ ((row >> 2) & 1)) << 4);
}

// Issue the copy of one f32 stripe: rows [r0, r0 + rows) of a row-major
// f32 matrix with `ld` floats per row, of which `n_rows` exist, columns
// [k0, k0 + 32) below `kcut`, into `dst` (rows x 32 floats, a_slot
// layout).  kVec: rows are 16-byte aligned and ld % 4 == 0.
template <bool kVec, int kRows, int kThreads>
__device__ __forceinline__ void load_a_stripe(float* dst,
                                              const float* __restrict__ src,
                                              int64_t ld, int r0, int n_rows,
                                              int k0, int kcut) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
#pragma unroll
    for (int e = tid; e < kRows * 8; e += kThreads) {
      const int row = e >> 3;
      const int chunk = e & 7;
      const int col = k0 + 4 * chunk;
      const int r = r0 + row;
      const int bytes = (r < n_rows) ? min(max(kcut - col, 0), 4) * 4 : 0;
      cp_async16(dst + a_slot(row, chunk),
                 bytes ? (const void*)(src + r * ld + col) : (const void*)src,
                 bytes);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kRows * KS; e += kThreads) {
      const int row = e >> 5;
      const int kk = e & 31;
      const int col = k0 + kk;
      const int r = r0 + row;
      const int bytes = (r < n_rows && col < kcut) ? 4 : 0;
      cp_async4(dst + a_slot(row, kk >> 2) + (kk & 3),
                bytes ? (const void*)(src + r * ld + col) : (const void*)src,
                bytes);
    }
  }
}

// Issue the copy of four neighbouring f32 stripes (128 columns, 512
// bytes a row) as load_a_stripe does one: rows [r0, r0 + rows), columns
// [k0, k0 + 128) below `kcut`, stripe t into dst + t * kRows * 32 (a_slot
// layout).  With kVec, the 32 lanes of a warp copy one row's 512
// contiguous bytes in one instruction; without it, 128 contiguous bytes.
template <bool kVec, int kRows, int kThreads>
__device__ __forceinline__ void load_a_wide(float* dst,
                                            const float* __restrict__ src,
                                            int64_t ld, int r0, int n_rows,
                                            int k0, int kcut) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
#pragma unroll
    for (int e = tid; e < kRows * 32; e += kThreads) {
      const int row = e >> 5;
      const int c16 = e & 31;             // 16-byte chunk of the row's 512
      const int col = k0 + 4 * c16;
      const int r = r0 + row;
      const int bytes = (r < n_rows) ? min(max(kcut - col, 0), 4) * 4 : 0;
      cp_async16(dst + (c16 >> 3) * kRows * KS + a_slot(row, c16 & 7),
                 bytes ? (const void*)(src + r * ld + col) : (const void*)src,
                 bytes);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kRows * 4 * KS; e += kThreads) {
      const int row = e >> 7;
      const int kk = e & 127;
      const int col = k0 + kk;
      const int r = r0 + row;
      const int bytes = (r < n_rows && col < kcut) ? 4 : 0;
      cp_async4(dst + (kk >> 5) * kRows * KS + a_slot(row, (kk & 31) >> 2) +
                    (kk & 3),
                bytes ? (const void*)(src + r * ld + col) : (const void*)src,
                bytes);
    }
  }
}

// The four A fragment registers of the 16 stripe rows [m0, m0 + 16).
__device__ __forceinline__ void a_fragment(const float* as, int m0,
                                           uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r = m0 + g;
  a[0] = pack_s8(*reinterpret_cast<const float4*>(as + a_slot(r, t)));
  a[1] = pack_s8(*reinterpret_cast<const float4*>(as + a_slot(r + 8, t)));
  a[2] = pack_s8(*reinterpret_cast<const float4*>(as + a_slot(r, 4 + t)));
  a[3] = pack_s8(*reinterpret_cast<const float4*>(as + a_slot(r + 8, 4 + t)));
}

// c += A fragment . (B stripe rows [n0, n0 + 8))^T.
__device__ __forceinline__ void mma_b_rows(int (&c)[4], const uint32_t (&a)[4],
                                           const uint8_t* bs, int n0) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (lane >> 2);
  const int t = lane & 3;
  const uint32_t b0 =
      *reinterpret_cast<const uint32_t*>(bs + b_slot(n, 0) + 4 * t);
  const uint32_t b1 =
      *reinterpret_cast<const uint32_t*>(bs + b_slot(n, 1) + 4 * t);
  mma_s8(c, a[0], a[1], a[2], a[3], b0, b1);
}

// ---- block-wide stable compaction ----------------------------------- //
// Every thread offers `value` when `pred`; the offered values are written
// to list[base + rank] in thread order, where rank < cap (later ones are
// dropped).  Returns the number offered.  Called by every thread of a
// block whose size is a multiple of 32; `warp_sums` holds one int per
// warp.  Ends with a barrier, so the list is visible on return.
__device__ __forceinline__ int block_compact(bool pred, int value, int* list,
                                             int base, int cap,
                                             int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) warp_sums[warp] = __popc(bal);
  __syncthreads();
  int off = 0, total = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = warp_sums[w];
    off += (w < warp) ? c : 0;
    total += c;
  }
  const int at = base + off + __popc(bal & ((1u << lane) - 1u));
  if (pred && at < cap) list[at] = value;
  __syncthreads();
  return total;
}

}  // namespace wmma8

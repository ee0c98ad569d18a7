// The int8 tensor-core product of 128-row tile pairs of a 0/1 matrix with
// itself (sm_90a), shared by butterfly_count.cu (the count body of kernels
// 1 and 4) and b2_stack.cu (kernel 3):
//
//   W[I, J] = A[I rows] . A[J rows]^T      (128 x 128, s32)
//
// for the tile pairs I <= J of W = A A^T, which is symmetric.
//
//   1. s8_pack_kernel packs A (one matrix, or a stack of G along
//      blockIdx.z) to an s8 copy [v != 0] in scratch from the wrapper,
//      zero-padded to 128-row tiles per matrix and a 128-byte column pitch
//      (the TMA box).  With row-tile extents, each 128-row tile keeps only
//      its columns below kcut = its covering extent * bk (the rest is
//      written as 0 and never read from A), so the product of tiles I and J
//      can run to min(kcut_I, kcut_J) whatever stage rounding the main loop
//      does.
//   2. The main loop (pair_produce + pair_consume): one producer warp feeds
//      a ring of 128-column K-stages of both tiles through TMA
//      (cp.async.bulk.tensor, 128-byte swizzle, mbarrier tx counts); a
//      diagonal pair loads its one tile once.  Two consumer warpgroups (rows
//      0-63 and 64-127 of tile I) multiply with wgmma.mma_async
//      m64n128k32 .s32.s8.s8, both operands K-major as s8 wgmma requires
//      (A A^T needs no transpose), 64 s32 accumulators per thread,
//      releasing each stage once its products are done.  The callers'
//      epilogues read the accumulators in wgmma's layout
//      (wgmma_s8_m64n128k32).
//
// Exactness.  A is 0/1, so every product is exact in s8 x s8 -> s32 and
// every W an integer no larger than the columns (below 2^24 in the
// engine's regime, DESIGN.md section 8), so the s32 -> f32 conversion is
// exact.
//
// The TMA descriptor comes from cuTensorMapEncodeTiled, fetched through the
// runtime's driver entry point, so a library links nothing beyond the
// runtime.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "wedge_mma.cuh"
#include "wedge_tile.cuh"

namespace s8pair {

constexpr int CT = 128;                  // rows of a tile, on both sides
constexpr int CK = 128;                  // s8 columns (bytes) of a K-stage
constexpr int TILE_BYTES = CT * CK;      // one tile's K-stage
constexpr int CONSUMERS = 256;           // two warpgroups, 64 rows each
constexpr int C_THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int PACK_THREADS = 256;
constexpr int PACK_VECS = 4;             // 4-column groups packed per thread

// bytes of a ring of `stages` K-stages of both tiles
constexpr int ring_bytes(int stages) { return 2 * stages * TILE_BYTES; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarrier ------------------------------------------------------- //
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred P1;\n"
      "LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n"
      " bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA ------------------------------------------------------------ //
// One box of 128 rows x 128 bytes at (column c0, row r0) into dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
      "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ---------------------------------------------------------- //
// Shared-memory descriptor of a K-major operand in the 128-byte swizzle
// layout TMA writes: rows of 128 bytes, 8-row atoms 1024 bytes apart
// (SBO); the leading offset is unused for this layout.  A K-step of 32
// bytes inside the atom advances the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, s32) += A (64 x 32, s8) . B (128 x 32, s8)^T; accumulator
// element d[4 v + 2 h + e] of thread t (warp w = t / 32 of the warpgroup,
// lane = 4 g + q) is row 16 w + 8 h + g, column 8 v + 2 q + e.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// ---- tiles ---------------------------------------------------------- //
// Column bound of the 128-row tile starting at row r0 of an n-row matrix:
// its rows' share of the extents of `block`-row tiles (n_v without them).
__device__ __forceinline__ int tile_kcut(const int* __restrict__ kmax, int r0,
                                         int n, int n_v, int block, int bk) {
  if (kmax == nullptr) return n_v;
  const int k = wedge::covering_extent(kmax, r0, min(r0 + CT, n), block);
  return (int)min((int64_t)k * bk, (int64_t)n_v);
}

// Tile pair p -> (I, J), I <= J, J-major (so the long pairs of a
// staircase, small J, start first).
__device__ __forceinline__ void tile_pair(int64_t p, int& I, int& J) {
  J = (int)((sqrt(8.0 * p + 1.0) - 1.0) * 0.5);
  while ((int64_t)J * (J + 1) / 2 > p) --J;
  while ((int64_t)(J + 1) * (J + 2) / 2 <= p) ++J;
  I = (int)(p - (int64_t)J * (J + 1) / 2);
}

// grid (n_pad / rows, ceil(k_pad / (4 PACK_VECS PACK_THREADS)), G): block
// (x, y, g) writes s8 columns [4 PACK_VECS PACK_THREADS y, + 4 PACK_VECS
// PACK_THREADS) of rows [rows x, rows x + rows) of matrix g of a8 (n_pad
// rows of k_pad bytes per matrix), four at a time with neighbouring
// threads on neighbouring columns: [v != 0] below the row tile's kcut, 0
// past it (and on padding rows).  `rows` divides 128, so a block's rows lie
// in one row tile; narrow matrices take several rows a block, so that a
// block moves some 16 KB of A.  The tile's kcut is the smaller of its
// covering extents in kmax_a (bi-row tiles, n_ta per matrix) and kmax_b
// (bj-row tiles, n_tb per matrix); either may be null.  vec: A's rows are
// 16-byte aligned (n_v % 4 == 0), so four columns are one load.
// (static: each library that includes this header has its own copy; 32
// registers, so that eight blocks share an SM and keep enough loads in
// flight to stream A at the card's rate)
static __global__ void __launch_bounds__(PACK_THREADS, 8)
s8_pack_kernel(const float* __restrict__ a, const int* __restrict__ kmax_a,
               const int* __restrict__ kmax_b, int n, int n_v, int n_pad,
               int k_pad, int rows, int n_ta, int n_tb, int bi, int bj,
               int bk, bool vec, uint8_t* __restrict__ a8) {
  const int64_t g = blockIdx.z;
  const int r_first = blockIdx.x * rows;
  if (kmax_a != nullptr) kmax_a += g * n_ta;
  if (kmax_b != nullptr) kmax_b += g * n_tb;
  int tile_cut = 0;
  if (r_first < n) {
    const int r0 = r_first - r_first % CT;
    tile_cut = min(tile_kcut(kmax_a, r0, n, n_v, bi, bk),
                   tile_kcut(kmax_b, r0, n, n_v, bj, bk));
  }
  const float* row = a + (g * n + r_first) * (int64_t)n_v;
  uint8_t* dst = a8 + (g * n_pad + r_first) * (int64_t)k_pad;
  for (int r = r_first; r < r_first + rows; ++r, row += n_v, dst += k_pad) {
    const int kcut = r < n ? tile_cut : 0;
#pragma unroll
    for (int v = 0; v < PACK_VECS; ++v) {
      const int col =
          4 * ((blockIdx.y * PACK_VECS + v) * PACK_THREADS + threadIdx.x);
      if (col >= k_pad) break;
      uint32_t w;
      if (vec && col + 4 <= kcut) {
        w = wmma8::pack_s8(*reinterpret_cast<const float4*>(row + col));
      } else {
        w = wmma8::pack_s8(col < kcut ? row[col] : 0.0f,
                           col + 1 < kcut ? row[col + 1] : 0.0f,
                           col + 2 < kcut ? row[col + 2] : 0.0f,
                           col + 3 < kcut ? row[col + 3] : 0.0f);
      }
      *reinterpret_cast<uint32_t*>(dst + col) = w;
    }
  }
}

// ---- the main loop -------------------------------------------------- //
// Barrier set-up, by thread 0; the caller syncs the block after it.
template <int STAGES>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  for (int st = 0; st < STAGES; ++st) {
    mbar_init(full + st, 1);
    mbar_init(empty + st, 2);   // one arrival per consumer warpgroup
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer (one thread): n_k K-stages of tile rows [row_i, + 128) and,
// off the diagonal, [row_j, + 128) of the map into the ring.
template <int STAGES>
__device__ __forceinline__ void pair_produce(const CUtensorMap* map,
                                             uint8_t* ring_a, uint8_t* ring_b,
                                             uint64_t* full, uint64_t* empty,
                                             int row_i, int row_j, int n_k,
                                             bool diag) {
  const int bytes = diag ? TILE_BYTES : 2 * TILE_BYTES;
  for (int it = 0; it < n_k; ++it) {
    const int slot = it % STAGES;
    if (it >= STAGES) mbar_wait(empty + slot, (it / STAGES - 1) & 1);
    mbar_expect_tx(full + slot, bytes);
    tma_load(ring_a + slot * TILE_BYTES, map, it * CK, row_i, full + slot);
    if (!diag)
      tma_load(ring_b + slot * TILE_BYTES, map, it * CK, row_j, full + slot);
  }
}

// Consumer warpgroup wg (threads 128 wg .. 128 wg + 127): acc = rows
// 64 wg .. 64 wg + 63 of tile I times tile J (tile I itself on the
// diagonal), over the n_k K-stages.
template <int STAGES>
__device__ __forceinline__ void pair_consume(const uint8_t* ring_a,
                                             const uint8_t* ring_b,
                                             uint64_t* full, uint64_t* empty,
                                             int n_k, bool diag, int wg,
                                             int (&acc)[64]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;
  const uint32_t a_base = smem_u32(ring_a) + wg * 64 * CK;
  const uint32_t b_base = smem_u32(diag ? ring_a : ring_b);
  for (int it = 0; it < n_k; ++it) {
    const int slot = it % STAGES;
    mbar_wait(full + slot, (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < CK / 32; ++k)
      wgmma_s8_m64n128k32(acc, sw128_desc(a_base + slot * TILE_BYTES + 32 * k),
                          sw128_desc(b_base + slot * TILE_BYTES + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done with it
    if (it > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(empty + (it - 1) % STAGES);
  }
  wgmma_wait<0>();
}

// ---- host side ------------------------------------------------------ //
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (null when
// the driver does not offer it)
static inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Pack `groups` matrices of n x n_v f32 (a, contiguous) into a8 and encode
// the TMA map of the copy: 128 x 128-byte boxes, 128-byte swizzle, over
// groups * n_pad rows of k_pad bytes.  Returns a cudaError_t, or 100000
// plus the CUresult of a failed encoding.
static inline int pack_and_map(const float* a, const int* kmax_a,
                               const int* kmax_b, int groups, int n, int n_v,
                               int n_ta, int n_tb, int bi, int bj, int bk,
                               uint8_t* a8, cudaStream_t stream,
                               CUtensorMap* map) {
  const int n_pad = (n + CT - 1) / CT * CT;
  const int k_pad = (n_v + CK - 1) / CK * CK;
  const int col_blocks = (k_pad / 4 + PACK_VECS * PACK_THREADS - 1) /
                         (PACK_VECS * PACK_THREADS);
  // rows a block: the power of two (up to a row tile) that makes a block's
  // columns some 4 PACK_VECS PACK_THREADS
  int rows = 1;
  while (rows < CT && 2 * rows * k_pad <= 4 * PACK_VECS * PACK_THREADS)
    rows *= 2;
  const bool vec = (n_v % 4 == 0) && (((uintptr_t)a & 15) == 0);
  s8_pack_kernel<<<dim3(n_pad / rows, col_blocks, groups), PACK_THREADS, 0,
                   stream>>>(a, kmax_a, kmax_b, n, n_v, n_pad, k_pad, rows,
                             n_ta, n_tb, bi, bj, bk, vec, a8);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad,
                              (cuuint64_t)groups * (cuuint64_t)n_pad};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad};
  const cuuint32_t box[2] = {CK, CT};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a8, dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? (int)cudaSuccess : 100000 + (int)res;
}

// Scratch bytes of the s8 copy of `groups` n x n_v matrices: each padded
// to ceil(n / 128) 128 rows of ceil(n_v / 128) 128 bytes
// (kernels/butterfly.py's count_scratch_bytes and kernels/
// butterfly_sparse.py's b2_scratch_bytes are the same formula).
static inline int64_t s8_copy_bytes(int groups, int n, int n_v) {
  return (int64_t)groups * ((n + CT - 1) / CT) * CT *
         ((n_v + CK - 1) / CK) * CK;
}

}  // namespace s8pair

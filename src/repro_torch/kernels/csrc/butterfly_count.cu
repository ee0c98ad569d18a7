// The count body of kernels 1 and 4 (counting and HUC recounts, B = A),
// hand-written for Hopper (sm_90a):
//
//   out[i] = sum_{j : ids[j] != ids[i]} s[j] * C((A A^T)[i, j], 2)
//
// With row-tile extents kmax (kernel 4), the product of rows i and j stops
// at the covering extents' column bound, as the count body of
// butterfly_sparse.cu does; without them (null kmax, kernel 1) it reads
// every column.
//
// Replaces, for the form A = B (ops.butterfly_support and the engine's
// support_all), two Pallas TPU kernels of the reference package:
//   * kernel 1, src/repro/kernels/butterfly.py:125 butterfly_support_pallas,
//     no extents;
//   * kernel 4, src/repro/kernels/butterfly_sparse.py:220
//     butterfly_update_pallas_sparse, with the shared row-tile extents.
//
// What bounds it: operations.  At the full-size count (8192 x 8192) the
// full square's product is 2 n^2 n_v = 1.1 TOP, about 0.56 ms at the int8
// tensor-core peak, against 0.08 ms to read A once in f32.  The Pallas
// grid computes that whole square of tile pairs; W = A A^T is symmetric,
// so half of it is enough.  The design:
//   1. count_pack_kernel packs A to an s8 copy [v != 0] in scratch from the
//      wrapper, zero-padded to 128-row tiles and a 128-byte column pitch
//      (the TMA box).  With extents, each 128-row tile keeps only its
//      columns below kcut = covering extent * bk (the rest is written as 0
//      and never read from A), so the product of tiles I and J runs to
//      min(kcut_I, kcut_J) whatever stage rounding the main loop does.
//   2. count_update_kernel: one block per 128 x 128 tile pair I <= J only
//      (a 1-D grid enumerating the upper triangle, J-major, so the long
//      pairs of a staircase, small J, start first).  One producer warp
//      feeds a 4-stage ring (six measured no faster, PERF.md) of
//      128-column K-stages of both tiles through TMA
//      (cp.async.bulk.tensor, 128-byte swizzle, mbarrier tx counts); a
//      diagonal pair loads its one tile once.  Two consumer warpgroups
//      (rows 0-63 and 64-127 of tile I) multiply with
//      wgmma.mma_async m64n128k32 .s32.s8.s8, both operands K-major as s8
//      wgmma requires (A A^T needs no transpose), 64 s32 accumulators per
//      thread, releasing each stage once its products are done.
//   3. The epilogue converts each W to f32 (exact: W <= n_v < 2^24),
//      applies C(W, 2) in the reference's order (W * (W - 1), then * 0.5)
//      and the not-self mask on the ids, then adds the rows' sums weighted
//      by s[j] into out[I rows] and, off the diagonal, the columns' sums
//      weighted by s[i] into out[J rows] (W is symmetric, so the pair
//      (J, I) is the transpose of (I, J)), with atomicAdd.
//
// Exactness.  A is 0/1 (the function's contract), so every product is
// exact in s8 x s8 -> s32 and every W an integer below 2^24.  The engine
// works where every butterfly support is below 2^24 (DESIGN.md section 8):
// every C(W, 2), every partial row or column sum and every atomicAdd
// operand is a non-negative integer no larger than a final support, so
// each f32 addition is exact in any order and the bits equal the plain
// version's.
//
// The TMA descriptor comes from cuTensorMapEncodeTiled, fetched through
// the runtime's driver entry point, so the library links nothing beyond
// the runtime.  The launches go on the caller's stream, allocate nothing
// (the s8 copy is the wrapper's scratch) and return cudaGetLastError().

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "wedge_mma.cuh"
#include "wedge_tile.cuh"

namespace {

constexpr int CT = 128;                  // rows of a tile, on both sides
constexpr int CK = 128;                  // s8 columns (bytes) of a K-stage
constexpr int STAGES = 4;                // TMA ring depth
constexpr int TILE_BYTES = CT * CK;      // one tile's K-stage
constexpr int CONSUMERS = 256;           // two warpgroups, 64 rows each
constexpr int C_THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int PACK_THREADS = 256;
constexpr int PACK_VECS = 4;             // 4-column groups packed per thread

// dynamic shared memory: the ring (A tiles, then B tiles), the barriers,
// s and ids of both tiles' rows, the column partials of the 8 consumer
// warps; plus 1 KB to align the ring to the 1024-byte swizzle atom
constexpr int RING_BYTES = 2 * STAGES * TILE_BYTES;
constexpr int BAR_BYTES = 2 * STAGES * 8;
constexpr int SMEM_BYTES =
    1024 + RING_BYTES + BAR_BYTES + 4 * CT * 4 + 8 * CT * 4;

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

// Column bound of the 128-row tile starting at row r0: its rows' share of
// the extents (every column with kmax, n_v without).
__device__ __forceinline__ int tile_kcut(const int* __restrict__ kmax, int r0,
                                         int n, int n_v, int bi, int bk) {
  if (kmax == nullptr) return n_v;
  const int k = wedge::covering_extent(kmax, r0, min(r0 + CT, n), bi);
  return (int)min((int64_t)k * bk, (int64_t)n_v);
}

// grid (n_pad, ceil(k_pad / (4 PACK_VECS PACK_THREADS))): block (r, y)
// writes s8 columns [4 PACK_VECS PACK_THREADS y, + 4 PACK_VECS
// PACK_THREADS) of row r of a8, four at a time with neighbouring threads
// on neighbouring columns: [v != 0] below the row tile's kcut, 0 past it
// (and on padding rows).  vec: A's rows are 16-byte aligned (n_v % 4 ==
// 0), so four columns are one load.
__global__ void __launch_bounds__(PACK_THREADS)
count_pack_kernel(const float* __restrict__ a, const int* __restrict__ kmax,
                  int n, int n_v, int k_pad, int bi, int bk, bool vec,
                  uint8_t* __restrict__ a8) {
  const int r = blockIdx.x;
  const int kcut = r < n ? tile_kcut(kmax, r - r % CT, n, n_v, bi, bk) : 0;
  const float* row = a + (int64_t)r * n_v;
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
    *reinterpret_cast<uint32_t*>(a8 + (int64_t)r * k_pad + col) = w;
  }
}

// grid (n_t (n_t + 1) / 2) for n_t = n_pad / 128 row tiles, C_THREADS
// threads, SMEM_BYTES of dynamic shared memory.
__global__ void __launch_bounds__(C_THREADS, 1)
count_update_kernel(const __grid_constant__ CUtensorMap a8_map,
                    const float* __restrict__ s, const int* __restrict__ ids,
                    const int* __restrict__ kmax, float* __restrict__ out,
                    int n, int n_v, int bi, int bk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* ring_a = ring;
  uint8_t* ring_b = ring + STAGES * TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING_BYTES);
  uint64_t* empty = full + STAGES;
  float* s_i = reinterpret_cast<float*>(empty + STAGES);
  int* id_i = reinterpret_cast<int*>(s_i + CT);
  float* s_j = reinterpret_cast<float*>(id_i + CT);
  int* id_j = reinterpret_cast<int*>(s_j + CT);
  float* col_part = reinterpret_cast<float*>(id_j + CT);   // [8][CT]

  // block p -> tile pair (I, J), I <= J, J-major
  const int p = blockIdx.x;
  int J = (int)((sqrt(8.0 * p + 1.0) - 1.0) * 0.5);
  while ((int64_t)J * (J + 1) / 2 > p) --J;
  while ((int64_t)(J + 1) * (J + 2) / 2 <= p) ++J;
  const int I = (int)(p - (int64_t)J * (J + 1) / 2);
  const int i0 = I * CT;
  const int j0 = J * CT;
  const bool diag = I == J;
  // the pair's products stop where one tile's rows are all zero
  const int k_end = min(tile_kcut(kmax, i0, n, n_v, bi, bk),
                        tile_kcut(kmax, j0, n, n_v, bi, bk));
  const int n_k = (k_end + CK - 1) / CK;
  if (n_k == 0) return;   // W = 0 on the pair: C(0, 2) adds nothing

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < CT) {
    const int ri = i0 + tid;
    const int rj = j0 + tid;
    s_i[tid] = ri < n ? s[ri] : 0.0f;
    id_i[tid] = ri < n ? ids[ri] : -1;
    s_j[tid] = rj < n ? s[rj] : 0.0f;
    id_j[tid] = rj < n ? ids[rj] : -1;
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warp: one thread keeps the ring full
    if (tid == CONSUMERS) {
      const int bytes = diag ? TILE_BYTES : 2 * TILE_BYTES;
      for (int it = 0; it < n_k; ++it) {
        const int slot = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + slot, (it / STAGES - 1) & 1);
        mbar_expect_tx(full + slot, bytes);
        tma_load(ring_a + slot * TILE_BYTES, &a8_map, it * CK, i0,
                 full + slot);
        if (!diag)
          tma_load(ring_b + slot * TILE_BYTES, &a8_map, it * CK, j0,
                   full + slot);
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of I
  const int wg = tid >> 7;
  int acc[64];
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
    if (it > 0 && (tid & 127) == 0)
      mbar_arrive(empty + (it - 1) % STAGES);
  }
  wgmma_wait<0>();

  // epilogue: C(W, 2) and the not-self mask; rows weighted by s[j] into
  // out[I rows], columns weighted by s[i] into out[J rows] off the diagonal
  const int warp = tid >> 5;          // 0..7
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + g;   // rows r0 and r0 + 8
  const float si[2] = {s_i[r0], s_i[r0 + 8]};
  const int idi[2] = {id_i[r0], id_i[r0 + 8]};
  float row_sum[2] = {0.0f, 0.0f};
  float col_sum[32];
#pragma unroll
  for (int v = 0; v < 16; ++v) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * v + 2 * q + e;
      const float sj = s_j[c];
      const int idj = id_j[c];
      float cs = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float w = (float)acc[4 * v + 2 * h + e];
        const float b2 = (idi[h] != idj) ? w * (w - 1.0f) * 0.5f : 0.0f;
        row_sum[h] += b2 * sj;
        cs += b2 * si[h];
      }
      col_sum[2 * v + e] = cs;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
    const int i = i0 + r0 + 8 * h;
    if (q == 0 && i < n && row_sum[h] != 0.0f) atomicAdd(out + i, row_sum[h]);
  }
  if (diag) return;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    col_sum[e] += __shfl_xor_sync(0xffffffffu, col_sum[e], 4);
    col_sum[e] += __shfl_xor_sync(0xffffffffu, col_sum[e], 8);
    col_sum[e] += __shfl_xor_sync(0xffffffffu, col_sum[e], 16);
  }
  if (g == 0) {
#pragma unroll
    for (int v = 0; v < 16; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        col_part[warp * CT + 8 * v + 2 * q + e] = col_sum[2 * v + e];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  if (tid < CT) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < CONSUMERS / 32; ++w) total += col_part[w * CT + tid];
    const int j = j0 + tid;
    if (j < n && total != 0.0f) atomicAdd(out + j, total);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (null when
// the driver does not offer it)
EncodeTiled encode_tiled() {
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

}  // namespace

// Scratch bytes of the count body: the s8 copy of A, n_pad x k_pad with
// n_pad = ceil(n / 128) 128 and k_pad = ceil(n_v / 128) 128.
// kernels/butterfly.py's count_scratch_bytes is the same formula.
static int64_t count_scratch_bytes(int n, int n_v) {
  return (int64_t)((n + CT - 1) / CT) * CT * ((n_v + CK - 1) / CK) * CK;
}

// The count body of kernels 1 and 4: a (n, n_v) f32 0/1, s (n,) f32,
// ids (n,) int32, out (n,) f32 zeroed by the caller; kmax
// (ceil(n / bi),) int32 row-tile extents of bi rows and bk columns, or
// null for no stripe skip (bi and bk then unused); scratch: at least
// count_scratch_bytes(n, n_v) bytes of device memory, 128-byte aligned,
// needing no initial value.  Returns a cudaError_t, or 100000 plus the
// CUresult of a failed tensor-map encoding.
extern "C" int butterfly_count_f32(const float* a, const float* s,
                                   const int* ids, const int* kmax,
                                   float* out, int n, int n_v, int bi, int bk,
                                   void* scratch, long long scratch_bytes,
                                   void* stream) {
  if (n <= 0 || n_v <= 0) return (int)cudaSuccess;
  if (scratch_bytes < count_scratch_bytes(n, n_v) ||
      ((uintptr_t)scratch & 127) != 0 ||
      (kmax != nullptr && (bi <= 0 || bk <= 0)))
    return (int)cudaErrorInvalidValue;
  const int n_pad = (n + CT - 1) / CT * CT;
  const int k_pad = (n_v + CK - 1) / CK * CK;
  const int64_t n_t = n_pad / CT;
  const int64_t n_pairs = n_t * (n_t + 1) / 2;
  if (n_pairs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  uint8_t* a8 = static_cast<uint8_t*>(scratch);

  const int col_blocks = (k_pad / 4 + PACK_VECS * PACK_THREADS - 1) /
                         (PACK_VECS * PACK_THREADS);
  const bool vec = (n_v % 4 == 0) && (((uintptr_t)a & 15) == 0);
  count_pack_kernel<<<dim3(n_pad, col_blocks), PACK_THREADS, 0, st>>>(
      a, kmax, n, n_v, k_pad, bi, bk, vec, a8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap a8_map;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)n_pad};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad};
  const cuuint32_t box[2] = {CK, CT};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      &a8_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a8, dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 100000 + (int)res;

  // one-time opt-in above 48 KB of dynamic shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      count_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  count_update_kernel<<<(unsigned)n_pairs, C_THREADS, SMEM_BYTES, st>>>(
      a8_map, s, ids, kmax, out, n, n_v, bi, bk);
  return (int)cudaGetLastError();
}

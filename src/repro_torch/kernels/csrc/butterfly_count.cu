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
// so half of it is enough.  The design (steps 1 and 2 are wgmma_s8.cuh,
// shared with kernel 3's body in b2_stack.cu):
//   1. s8_pack_kernel packs A to an s8 copy [v != 0] in scratch from the
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
//   3. The epilogue converts each s32 W to f64, applies C(W, 2) in the
//      reference's order (W * (W - 1), then * 0.5) and the not-self mask
//      on the ids, then adds the rows' sums weighted by s[j] into out[I
//      rows] and, off the diagonal, the columns' sums weighted by s[i]
//      into out[J rows] (W is symmetric, so the pair (J, I) is the
//      transpose of (I, J)), with f64 atomicAdd (native on sm_90).
//
// Exactness.  A is 0/1 (the function's contract), so every product is
// exact in s8 x s8 -> s32 and every W an integer no larger than n_v.  From
// W on the epilogue works in f64 (DESIGN.md section 8, the port's
// paragraph): W (W - 1) < 2^53 for W < 2^26, and every C(W, 2), every
// partial row or column sum and every atomicAdd operand is a non-negative
// integer no larger than a final support, so while the supports stay below
// 2^53 each f64 addition is exact in any order and the bits equal the
// plain version's.
//
// The launches go on the caller's stream, allocate nothing (the s8 copy is
// the wrapper's scratch) and return cudaGetLastError().

#include "wgmma_s8.cuh"

namespace {

using namespace s8pair;

constexpr int STAGES = 4;                // TMA ring depth
constexpr int RING_BYTES = ring_bytes(STAGES);

// dynamic shared memory: the ring (A tiles, then B tiles), the barriers,
// s and ids of both tiles' rows, the f64 column partials of the 8 consumer
// warps; plus 1 KB to align the ring to the 1024-byte swizzle atom
constexpr int BAR_BYTES = 2 * STAGES * 8;
constexpr int SMEM_BYTES =
    1024 + RING_BYTES + BAR_BYTES + 4 * CT * 4 + 8 * CT * 8;

// grid (n_t (n_t + 1) / 2) for n_t = n_pad / 128 row tiles, C_THREADS
// threads, SMEM_BYTES of dynamic shared memory.
__global__ void __launch_bounds__(C_THREADS, 1)
count_update_kernel(const __grid_constant__ CUtensorMap a8_map,
                    const float* __restrict__ s, const int* __restrict__ ids,
                    const int* __restrict__ kmax, double* __restrict__ out,
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
  double* col_part = reinterpret_cast<double*>(id_j + CT);   // [8][CT]

  // block p -> tile pair (I, J), I <= J, J-major
  int I, J;
  tile_pair(blockIdx.x, I, J);
  const int i0 = I * CT;
  const int j0 = J * CT;
  const bool diag = I == J;
  // the pair's products stop where one tile's rows are all zero
  const int k_end = min(tile_kcut(kmax, i0, n, n_v, bi, bk),
                        tile_kcut(kmax, j0, n, n_v, bi, bk));
  const int n_k = (k_end + CK - 1) / CK;
  if (n_k == 0) return;   // W = 0 on the pair: C(0, 2) adds nothing

  const int tid = threadIdx.x;
  if (tid == 0) ring_init<STAGES>(full, empty);
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
    if (tid == CONSUMERS)
      pair_produce<STAGES>(&a8_map, ring_a, ring_b, full, empty, i0, j0, n_k,
                           diag);
    return;
  }

  // the consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of I
  const int wg = tid >> 7;
  int acc[64];
  pair_consume<STAGES>(ring_a, ring_b, full, empty, n_k, diag, wg, acc);

  // epilogue, in f64: C(W, 2) and the not-self mask; rows weighted by
  // s[j] into out[I rows], columns weighted by s[i] into out[J rows] off
  // the diagonal.  Each column's sum over the warp's 16 rows is reduced
  // (shuffles over the row groups) as soon as it is made, so no array of
  // 32 f64 partials stays live.
  const int warp = tid >> 5;          // 0..7
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + g;   // rows r0 and r0 + 8
  const double si[2] = {(double)s_i[r0], (double)s_i[r0 + 8]};
  const int idi[2] = {id_i[r0], id_i[r0 + 8]};
  double row_sum[2] = {0.0, 0.0};
#pragma unroll
  for (int v = 0; v < 16; ++v) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * v + 2 * q + e;
      const double sj = (double)s_j[c];
      const int idj = id_j[c];
      double cs = 0.0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double w = (double)acc[4 * v + 2 * h + e];
        const double b2 = (idi[h] != idj) ? w * (w - 1.0) * 0.5 : 0.0;
        row_sum[h] += b2 * sj;
        cs += b2 * si[h];
      }
      if (!diag) {
        cs += __shfl_xor_sync(0xffffffffu, cs, 4);
        cs += __shfl_xor_sync(0xffffffffu, cs, 8);
        cs += __shfl_xor_sync(0xffffffffu, cs, 16);
        if (g == 0) col_part[warp * CT + c] = cs;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
    const int i = i0 + r0 + 8 * h;
    if (q == 0 && i < n && row_sum[h] != 0.0) atomicAdd(out + i, row_sum[h]);
  }
  if (diag) return;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  if (tid < CT) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < CONSUMERS / 32; ++w) total += col_part[w * CT + tid];
    const int j = j0 + tid;
    if (j < n && total != 0.0) atomicAdd(out + j, total);
  }
}

}  // namespace

// Scratch bytes of the count body: the s8 copy of A, n_pad x k_pad with
// n_pad = ceil(n / 128) 128 and k_pad = ceil(n_v / 128) 128.
// kernels/butterfly.py's count_scratch_bytes is the same formula.
static int64_t count_scratch_bytes(int n, int n_v) {
  return s8_copy_bytes(1, n, n_v);
}

// The count body of kernels 1 and 4: a (n, n_v) f32 0/1, s (n,) f32,
// ids (n,) int32, out (n,) f64 zeroed by the caller; kmax
// (ceil(n / bi),) int32 row-tile extents of bi rows and bk columns, or
// null for no stripe skip (bi and bk then unused); scratch: at least
// count_scratch_bytes(n, n_v) bytes of device memory, 128-byte aligned,
// needing no initial value.  Returns a cudaError_t, or 100000 plus the
// CUresult of a failed tensor-map encoding.
extern "C" int butterfly_count_f32(const float* a, const float* s,
                                   const int* ids, const int* kmax,
                                   double* out, int n, int n_v, int bi, int bk,
                                   void* scratch, long long scratch_bytes,
                                   void* stream) {
  if (n <= 0 || n_v <= 0) return (int)cudaSuccess;
  if (scratch_bytes < count_scratch_bytes(n, n_v) ||
      ((uintptr_t)scratch & 127) != 0 ||
      (kmax != nullptr && (bi <= 0 || bk <= 0)))
    return (int)cudaErrorInvalidValue;
  const int64_t n_t = (n + CT - 1) / CT;
  const int64_t n_pairs = n_t * (n_t + 1) / 2;
  if (n_pairs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  uint8_t* a8 = static_cast<uint8_t*>(scratch);

  CUtensorMap a8_map;
  const int packed = pack_and_map(a, kmax, nullptr, 1, n, n_v, 0, 0, bi, bi,
                                  bk, a8, st, &a8_map);
  if (packed != 0) return packed;

  // one-time opt-in above 48 KB of dynamic shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      count_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  count_update_kernel<<<(unsigned)n_pairs, C_THREADS, SMEM_BYTES, st>>>(
      a8_map, s, ids, kmax, out, n, n_v, bi, bk);
  return (int)cudaGetLastError();
}

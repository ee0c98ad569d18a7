// Pairwise-butterfly stack with stripe skip, hand-written for Hopper (sm_90a).
//
//   out[g, x, y] = C((A_g A_g^T)[x, y], 2) * [x != y]
//
// Replaces kernel 3 of the reference package,
// src/repro/kernels/butterfly_sparse.py:420 b2_stack_pallas_sparse (body
// _b2_stack_kernel): the fd_update_mode="b2" precompute of the FD
// level-peel loop.  The Pallas kernel skips K-stripe k of tile (i, j) when
// k >= min(kmax_a[g, i], kmax_b[g, j]) (bi rows on the A side, bj on the B
// side, bk columns a stripe); both bodies here stop a tile's product at its
// covering extents' column bound, which is exact for extents that
// upper-bound the true ones (every column past the bound is zero in all the
// tile's rows), the function's contract.
//
// Two bodies compute it, and the caller names one (kernels/
// butterfly_sparse.py, body=):
//
// THE PAIRS BODY (the default).  What bounds it on the H100 is bytes: the
// G m^2 f32 output (67 MB at FD's (16, 1024, 1024) stack, 0.02 ms at 3.35
// TB/s) and A's live stripes, read once; the product over the distinct
// nonzero row pairs is some 17 GOP, under 0.01 ms at the int8 tensor-core
// rate.  So the body moves each byte once and keeps the product off the
// f32 units:
//   1. s8_pack_kernel (wgmma_s8.cuh) packs each group's rows to an s8
//      copy [v != 0] in the wrapper's scratch, zero-padded to 128-row
//      tiles per group and a 128-byte pitch; each 128-row tile keeps only
//      its columns below kcut = the smaller of its covering extents in
//      kmax_a and kmax_b (both upper bounds, so their minimum is one too;
//      with bi != bj each is the maximum over the bi- or bj-row tiles the
//      128 rows span), times bk.
//   2. b2_pairs_kernel: one block per (128 x 128 tile pair I <= J, group):
//      W = A_g A_g^T is symmetric, so the pairs I > J are not multiplied.
//      The count body's TMA ring and int8 wgmma main loop (wgmma_s8.cuh),
//      three stages deep so that two blocks share an SM and one block's
//      stores overlap the other's loads, over min(kcut_I, kcut_J)
//      columns.
//   3. The epilogue converts each s32 W to f32 (exact: W <= n_v < 2^24),
//      evaluates C(W, 2) in the reference's order (W * (W - 1), then
//      * 0.5), zeroes the diagonal x = y and writes tile (I, J) and, off
//      the diagonal, its transpose into (J, I), straight from the
//      accumulators.  In wgmma's layout a quad of lanes holds 8
//      neighbouring columns of one row (32 bytes) and the eight row
//      groups of a warp 8 neighbouring rows, so each store instruction
//      fills whole 32-byte sectors in both orientations when m % 8 == 0:
//      8 rows x 32 bytes for (I, J) (float2 stores), 4 rows x 32 bytes for
//      (J, I).  Ragged shapes mask the edge (scalar stores when m is
//      odd).  The output is written once and never read back.
//
// THE TILE BODY (body="tile", b2_stack_kernel): the f32 FMA tile of
// wedge_tile.cuh (64 x 64 per block, 16-column K-stripes through shared
// memory) over every tile pair, the K loop stopped at the block's covering
// extents; the yardstick the pairs body is timed against.
//
// Exactness.  0/1 operands, integer wedge counts below 2^24 and C(W, 2) in
// the reference's operation order: every entry is bit-identical to the
// reference while it is below 2^24.
//
// Shapes need not be multiples of any tile.  a is (G, m, n_v) f32, kmax_a
// (G, n_ta) and kmax_b (G, n_tb) int32, out (G, m, m) f32, all contiguous.
// The launches go on the caller's stream, allocate nothing (the pairs
// body's s8 copy is the wrapper's scratch) and return cudaGetLastError().

#include "wgmma_s8.cuh"

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

// ---------------------------------------------------------------------- //
// the pairs body
// ---------------------------------------------------------------------- //
namespace {

using namespace s8pair;

constexpr int B2_STAGES = 3;             // two blocks to an SM
constexpr int B2_RING = ring_bytes(B2_STAGES);
// the ring, its barriers, and 1 KB to align it to the 1024-byte swizzle atom
constexpr int B2_SMEM = 1024 + B2_RING + 2 * B2_STAGES * 8;

// The s8 copy's column bound of the 128-row tile at row r0 (as
// s8_pack_kernel's).
__device__ __forceinline__ int pair_kcut(const int* kmax_a, const int* kmax_b,
                                         int r0, int m, int n_v, int bi,
                                         int bj, int bk) {
  return min(tile_kcut(kmax_a, r0, m, n_v, bi, bk),
             tile_kcut(kmax_b, r0, m, n_v, bj, bk));
}

// grid (n_t (n_t + 1) / 2, G) for n_t = ceil(m / 128) row tiles, C_THREADS
// threads, B2_SMEM dynamic bytes; a8_map spans G * m_pad rows.  kPair: m
// is even and out 8-byte aligned, so the (I, J) stores go two columns at
// a time.
template <bool kPair>
__global__ void __launch_bounds__(C_THREADS, 2)
b2_pairs_kernel(const __grid_constant__ CUtensorMap a8_map,
                const int* __restrict__ kmax_a, const int* __restrict__ kmax_b,
                float* __restrict__ out, int m, int n_v, int m_pad, int n_ta,
                int n_tb, int bi, int bj, int bk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* ring_a = ring;
  uint8_t* ring_b = ring + B2_STAGES * TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + B2_RING);
  uint64_t* empty = full + B2_STAGES;

  const int64_t g = blockIdx.y;
  kmax_a += g * n_ta;
  kmax_b += g * n_tb;
  out += g * m * (int64_t)m;
  int I, J;
  tile_pair(blockIdx.x, I, J);
  const int i0 = I * CT;
  const int j0 = J * CT;
  const bool diag = I == J;
  // the pair's products stop where one tile's rows are all zero; a pair
  // with no column left still writes its C(0, 2) = 0
  const int k_end = min(pair_kcut(kmax_a, kmax_b, i0, m, n_v, bi, bj, bk),
                        pair_kcut(kmax_a, kmax_b, j0, m, n_v, bi, bj, bk));
  const int n_k = (k_end + CK - 1) / CK;

  const int tid = threadIdx.x;
  if (tid == 0) ring_init<B2_STAGES>(full, empty);
  __syncthreads();
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS)
      pair_produce<B2_STAGES>(&a8_map, ring_a, ring_b, full, empty,
                              (int)(g * m_pad) + i0, (int)(g * m_pad) + j0,
                              n_k, diag);
    return;
  }
  const int wg = tid >> 7;
  int acc[64];
  pair_consume<B2_STAGES>(ring_a, ring_b, full, empty, n_k, diag, wg, acc);

  // epilogue: element 4 v + 2 h + e is row x = i0 + r0 + 8 h, column
  // y = j0 + 8 v + 2 q + e
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;
  const int q = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + gr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = i0 + r0 + 8 * h;
    if (x >= m) continue;
    float* row = out + (int64_t)x * m;
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      const int y = j0 + 8 * v + 2 * q;
      float b2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float w = (float)acc[4 * v + 2 * h + e];
        b2[e] = (x != y + e) ? w * (w - 1.0f) * 0.5f : 0.0f;
      }
      if (kPair) {
        if (y < m)
          *reinterpret_cast<float2*>(row + y) = make_float2(b2[0], b2[1]);
      } else {
        if (y < m) row[y] = b2[0];
        if (y + 1 < m) row[y + 1] = b2[1];
      }
    }
  }
  if (diag) return;
  // the transpose: out[y, x] = out[x, y]; the eight row groups of a warp
  // write 8 neighbouring columns x of each row y
#pragma unroll
  for (int v = 0; v < 16; ++v) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int y = j0 + 8 * v + 2 * q + e;
      if (y >= m) continue;
      float* row = out + (int64_t)y * m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = i0 + r0 + 8 * h;
        const float w = (float)acc[4 * v + 2 * h + e];
        if (x < m) row[x] = w * (w - 1.0f) * 0.5f;   // x < y: never diagonal
      }
    }
  }
}

template <bool kPair>
cudaError_t launch_pairs(unsigned n_pairs, int groups, cudaStream_t stream,
                         const CUtensorMap& map, const int* kmax_a,
                         const int* kmax_b, float* out, int m, int n_v,
                         int m_pad, int n_ta, int n_tb, int bi, int bj,
                         int bk) {
  // one-time opt-in above 48 KB of dynamic shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      b2_pairs_kernel<kPair>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      B2_SMEM);
  if (attr != cudaSuccess) return attr;
  b2_pairs_kernel<kPair><<<dim3(n_pairs, groups), C_THREADS, B2_SMEM,
                           stream>>>(map, kmax_a, kmax_b, out, m, n_v, m_pad,
                                     n_ta, n_tb, bi, bj, bk);
  return cudaGetLastError();
}

}  // namespace

// Scratch bytes of the pairs body: the s8 copy of the stack, each group
// padded to ceil(m / 128) 128 rows of ceil(n_v / 128) 128 bytes
// (kernels/butterfly_sparse.py's b2_scratch_bytes is the same formula).
static int64_t b2_scratch_bytes(int groups, int m, int n_v) {
  return s8_copy_bytes(groups, m, n_v);
}

// The pairs body of kernel 3: operands as b2_stack_f32, kmax_a and kmax_b
// required, n_v > 0 (with no column every entry is 0); scratch: at least
// b2_scratch_bytes(groups, m, n_v) bytes of device memory, 128-byte
// aligned, needing no initial value.  Returns a cudaError_t, or 100000
// plus the CUresult of a failed tensor-map encoding.
extern "C" int b2_stack_pairs_f32(const float* a, const int* kmax_a,
                                  const int* kmax_b, float* out, int groups,
                                  int m, int n_v, int n_ta, int n_tb, int bi,
                                  int bj, int bk, void* scratch,
                                  long long scratch_bytes, void* stream) {
  if (groups <= 0 || m <= 0) return (int)cudaSuccess;
  if (kmax_a == nullptr || kmax_b == nullptr || bi <= 0 || bj <= 0 ||
      bk <= 0 || n_v <= 0 || groups > 65535 ||
      scratch_bytes < b2_scratch_bytes(groups, m, n_v) ||
      ((uintptr_t)scratch & 127) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_t = (m + CT - 1) / CT;
  const int64_t n_pairs = n_t * (n_t + 1) / 2;
  const int64_t m_pad = n_t * CT;
  if (n_pairs > 0x7fffffff || groups * m_pad > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap map;
  const int packed =
      pack_and_map(a, kmax_a, kmax_b, groups, m, n_v, n_ta, n_tb, bi, bj, bk,
                   static_cast<uint8_t*>(scratch), st, &map);
  if (packed != 0) return packed;
  const bool pair = (m % 2 == 0) && (((uintptr_t)out & 7) == 0);
  const cudaError_t err =
      pair ? launch_pairs<true>((unsigned)n_pairs, groups, st, map, kmax_a,
                                kmax_b, out, m, n_v, (int)m_pad, n_ta, n_tb,
                                bi, bj, bk)
           : launch_pairs<false>((unsigned)n_pairs, groups, st, map, kmax_a,
                                 kmax_b, out, m, n_v, (int)m_pad, n_ta, n_tb,
                                 bi, bj, bk);
  return (int)err;
}

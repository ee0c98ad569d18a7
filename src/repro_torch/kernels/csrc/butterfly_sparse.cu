// Fused butterfly update, with or without the staircase stripe skip,
// hand-written for Hopper (sm_90a).
//
//   out[g, i] = sum_{j : ids_b[g, j] != ids_a[g, i]} s[g, j] * C((A_g B_g^T)[i, j], 2)
//
// With extents, stripe k (columns [k bk, (k + 1) bk)) of the wedge tile of
// A rows i and B rows j adds nothing once
// k >= min(kmax_a[g, i / bi], kmax_b[g, j / bj]).  Without them (null
// extent pointers) every stripe is read.
//
// Replaces four Pallas TPU kernels of the reference package:
//   * kernel 1, src/repro/kernels/butterfly.py:125 butterfly_support_pallas
//     (body butterfly_kernel_body): one graph, GLOBAL row ids, no extents.
//     Counting and HUC recounts (A = B, s = alive) and every CD peel update
//     (B = gathered peel rows, s = their validity mask).
//   * kernel 2, src/repro/kernels/butterfly.py:225
//     butterfly_update_pallas_batched: kernel 1 over a stack of G
//     independent FD subgraphs with LOCAL ids.
//   * kernel 4, src/repro/kernels/butterfly_sparse.py:220
//     butterfly_update_pallas_sparse (body _update_kernel): kernel 1 with
//     row-tile extents kmax_a (n_a / bi,) and kmax_b (n_b / bj,); a CD peel
//     update gathers its B extents from the per-row extents, padding rows
//     extent 0.
//   * kernel 5, src/repro/kernels/butterfly_sparse.py:318
//     butterfly_update_pallas_sparse_batched (body _batched_update_kernel):
//     kernel 2 with one staircase per group member, extents (G, n_a / bi)
//     and (G, n_b / bj).
//
// Two bodies here compute that function, and the caller names one
// (kernels/butterfly.py, body=); the count body of kernels 1 and 4 is
// butterfly_count.cu.
//
// THE PEEL BODY (peel_prep_kernel + peel_update_kernel; the default of
// every kernel here: the CD peel updates of the dense and staircase
// backends and every ParB sweep, one graph; and every FD stack update of
// kernels 2 and 5, a stack of G graphs, group g in gridDim.z).  B holds a
// few gathered rows, most with s = 0 in a ParB sweep (128 gathered rows,
// one valid), and a valid row of degree ~13 touches ~13 of the 256
// 32-column stripes, so the function needs only the columns where a row
// with s mass holds a nonzero.  What bounds it is bytes: A's f32 columns
// in those stripes, read once, and B's mass rows once (2 n_a n_valid L
// operations over L live columns are ~1/100 of the byte time at the int8
// rate).  The design moves only those bytes:
//   1. peel_prep_kernel (grid: stripes / 4 x chunks of 128 B rows x
//      groups) packs the chunk's rows with s != 0 ("mass rows", compacted
//      in row order) to s8 into scratch, and marks each 32-column stripe
//      where any of them holds a nonzero: flags[group][chunk][stripe], on
//      the device, so the wrapper reads nothing.  Stripes left unmarked
//      add exactly 0 to every W[i, j] that s does not zero.
//   2. peel_update_kernel (grid: chunk x 64-row band of A x group, chunk
//      fastest so the blocks sharing an A band run together and share it
//      in L2): a block whose chunk has no mass row returns at once;
//      otherwise it compacts the live K-stages (below k_end = min(ka, kb)
//      bk with extents) into a list and walks it through a cp.async ring:
//      A's f32 rows of the stage (read from HBM once per band) and the
//      mass rows' s8 stripes, so the loads of the next stages overlap the
//      products.  One graph: a stage is one marked stripe, 128 bytes of
//      each A row, four stages deep.  A stack: a stage is four
//      neighbouring stripes, live when one of them is marked, 512
//      contiguous bytes of each A row copied by the 32 lanes of a warp in
//      one instruction (at FD's stack shapes nearly every stripe is live,
//      so the read of A is the whole bound, and 128-byte pieces 4 KB apart
//      read at a quarter of the card's rate), two stages deep so that two
//      blocks share an SM.  Eight warps (4 x 16 A rows,
//      2 x 64 mass rows) multiply with mma.sync m16n8k32 s8 x s8 -> s32
//      (wedge_mma.cuh) over only the n-tiles that hold mass rows.  The
//      epilogue converts each s32 W to f32 (exact: below 2^24) and applies
//      C(W, 2) in the reference's order (W * (W - 1), then * 0.5), s[j],
//      the not-self mask on the rows' ids (a gathered row is its own A
//      row's id), the row reduction (quad shuffles) and an exact f32
//      atomicAdd.
// mma.sync is enough here: the 256-row CD shape needs 34.4 GOP, 0.017 ms
// at the int8 peak, under the byte bound even at a quarter of that rate.
//
// THE TILE BODY (sparse_update_kernel; body="tile").  One 256-thread block
// computes a 64 x 64 wedge tile W = A[i0:i0+64] . B[j0:j0+64]^T in
// registers (4 x 4 per thread), from 16-column K-stripes staged through
// shared memory, with f32 FMA (wedge_tile.cuh, shared with b2_stack.cu's
// tile body).  The epilogue applies C(W, 2) = W * (W - 1) * 0.5, the row
// mask s and the not-self mask, row-reduces the tile (half-warp shuffles)
// and adds the partial row sums into out with atomicAdd.  The Pallas grid
// carries out_i across j in order on one core; here the j-tiles run as
// parallel blocks and meet in the atomics.  Stripe skip: the block reads
// the extents of the reference tiles (bi rows on the A side, bj rows on
// the B side) that cover its 64 rows and 64 columns and stops its K loop
// at min(max kmax_a, max kmax_b) * bk: exact for extents that upper-bound
// the true ones (every column past the bound is zero in all the block's
// rows on one side).  It computed every form until the count and peel
// bodies replaced it, and stays as the yardstick they are timed against.
//
// Exactness.  A and B are 0/1 (the function's contract; the peel body's
// s8 conversion [v != 0] relies on it), so every wedge count W is an
// integer below n_v: exact in f32 while n_v < 2^24, and the s32 products
// cannot overflow (W <= n_v < 2^31).  The engine works in the regime where
// every butterfly support is below 2^24 (DESIGN.md section 8); then every
// C(W, 2), every partial row sum and every atomicAdd operand is a
// non-negative integer no larger than the final support, so each f32
// addition is exact in ANY order: every body gives the same bits on every
// run, and the same bits as the reference.
//
// Shapes need not be multiples of any tile: loads and the epilogue mask the
// ragged edge.  All tensors are contiguous, f32 (a, b, s, out) and int32
// (ids, extents).  The launches go on the caller's stream, allocate nothing
// (the peel body's scratch comes from the wrapper) and return
// cudaGetLastError().

#include "wedge_mma.cuh"
#include "wedge_tile.cuh"

namespace {

using namespace wedge;

// kSkip = false: kernels 1 and 2, every stripe, no extent code compiled in
// (the extents' registers would cost the dense form for nothing)
template <bool kSkip>
__global__ void __launch_bounds__(THREADS)
sparse_update_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ s,
                     const int* __restrict__ ids_a,
                     const int* __restrict__ ids_b,
                     const int* __restrict__ kmax_a,
                     const int* __restrict__ kmax_b, float* __restrict__ out,
                     int n_a, int n_b, int n_v, int n_ta, int n_tb, int bi,
                     int bj, int bk) {
  const int64_t g = blockIdx.z;
  a += g * n_a * (int64_t)n_v;
  b += g * n_b * (int64_t)n_v;
  s += g * n_b;
  ids_b += g * n_b;
  ids_a += g * n_a;
  out += g * n_a;

  const int i0 = blockIdx.x * TI;
  const int j0 = blockIdx.y * TJ;
  // per-block K bound from the stripe extents (all of n_v without them);
  // a block with no live stripe has W = 0 and adds nothing
  int k_end = n_v;
  if constexpr (kSkip) {
    const int ka = covering_extent(kmax_a + g * n_ta, i0, min(i0 + TI, n_a),
                                   bi);
    const int kb = covering_extent(kmax_b + g * n_tb, j0, min(j0 + TJ, n_b),
                                   bj);
    k_end = (int)min((int64_t)min(ka, kb) * bk, (int64_t)n_v);
  }

  float acc[4][4];
  tile_product(a, b, n_a, n_b, n_v, i0, j0, k_end, acc);
  update_epilogue(acc, s, ids_a, ids_b, out, n_a, n_b, i0, j0);
}

}  // namespace

// kernels 1 and 4 (groups = 1), 2 and 5.  a (G, n_a, n_v), b (G, n_b, n_v),
// s (G, n_b), ids_a (G, n_a), ids_b (G, n_b), out (G, n_a) zeroed by the
// caller.  kmax_a (G, n_ta) and kmax_b (G, n_tb) with n_ta >= ceil(n_a / bi)
// and n_tb >= ceil(n_b / bj), or both null for no stripe skip (kernels 1
// and 2; n_ta, n_tb, bi, bj and bk are then unused).
extern "C" int butterfly_update_sparse_f32(
    const float* a, const float* b, const float* s, const int* ids_a,
    const int* ids_b, const int* kmax_a, const int* kmax_b, float* out,
    int groups, int n_a, int n_b, int n_v, int n_ta, int n_tb, int bi, int bj,
    int bk, void* stream) {
  if ((kmax_a == nullptr) != (kmax_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_a + TI - 1) / TI, (n_b + TJ - 1) / TJ, groups);
  auto kernel = (kmax_a != nullptr) ? &sparse_update_kernel<true>
                                    : &sparse_update_kernel<false>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, s, ids_a, ids_b, kmax_a, kmax_b, out, n_a, n_b, n_v, n_ta, n_tb,
      bi, bj, bk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------- //
// the peel body
// ---------------------------------------------------------------------- //
namespace {

using namespace wmma8;

constexpr int PB = 128;          // gathered B rows per chunk
constexpr int PA = 64;           // A rows per block
constexpr int P_THREADS = 256;   // 8 warps: 4 (A rows) x 2 (mass rows)
constexpr int PREP_THREADS = 128;
constexpr int A_STAGE = PA * KS;   // floats of one stripe
constexpr int B_STAGE = PB * KS;   // bytes of one stripe
// a K-stage: one stripe (one graph) or four (a stack: 512 bytes of each
// A row); the cp.async ring's depth: four stages, or two of the stack's
// 48 KB stages, so that two blocks share an SM (measured faster than one
// block with three or four, PERF.md); the ring's dynamic shared memory
__host__ __device__ constexpr int stage_stripes(bool wide) {
  return wide ? 4 : 1;
}
__host__ __device__ constexpr int p_stages(bool wide) { return wide ? 2 : 4; }
constexpr int p_smem(bool wide) {
  return p_stages(wide) * stage_stripes(wide) * (A_STAGE * 4 + B_STAGE);
}

// Rows of chunk [j0, j0 + PB) with s != 0, in row order, into mrow
// (offsets from j0); every thread of the block calls it, the first PB
// threads offer one row each.
__device__ __forceinline__ int chunk_mass_rows(const float* __restrict__ s,
                                               int n_b, int j0, int* mrow,
                                               int* warp_sums) {
  const int r = threadIdx.x;
  const bool mass = r < PB && j0 + r < n_b && s[j0 + r] != 0.0f;
  return block_compact(mass, r, mrow, 0, PB, warp_sums);
}

// b8 holds, per chunk, PB rows of n_str * 32 s8 bytes: mass row m of
// chunk c at (c * PB + m) * n_str * KS.
__device__ __forceinline__ int64_t b8_row(int c, int m, int n_str) {
  return ((int64_t)c * PB + m) * n_str * KS;
}

// grid (ceil(n_str / 4), n_chunks, G), PREP_THREADS: warp w of block
// (x, c, g) packs stripe 4 x + w of chunk c's mass rows of group g to s8
// and marks the stripe in the group's flags[c * n_str + k] when any of them
// holds a nonzero there.  kVec: B's rows are 16-byte aligned (n_v % 4 ==
// 0), so four columns are one load.
template <bool kVec>
__global__ void __launch_bounds__(PREP_THREADS)
peel_prep_kernel(const float* __restrict__ b, const float* __restrict__ s,
                 int n_b, int n_v, int n_str, int* __restrict__ flags,
                 uint8_t* __restrict__ b8) {
  __shared__ int mrow[PB];
  __shared__ int warp_sums[PREP_THREADS / 32];
  const int64_t g = blockIdx.z;
  const int n_chunks = gridDim.y;
  b += g * n_b * (int64_t)n_v;
  s += g * n_b;
  flags += g * n_chunks * (int64_t)n_str;
  b8 += g * b8_row(n_chunks, 0, n_str);
  const int c = blockIdx.y;
  const int j0 = c * PB;
  const int n_mass = chunk_mass_rows(s, n_b, j0, mrow, warp_sums);
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * (PREP_THREADS / 32) + (threadIdx.x >> 5);
  if (k >= n_str) return;
  // lanes 8 r + q: row m = r (mod 4), columns 4 q .. 4 q + 3 of the stripe
  const int col = k * KS + 4 * (lane & 7);
  bool any = false;
#pragma unroll 4
  for (int m = lane >> 3; m < n_mass; m += 4) {
    const float* row = b + (int64_t)(j0 + mrow[m]) * n_v;
    uint32_t w;
    if constexpr (kVec) {
      w = col < n_v ? pack_s8(*reinterpret_cast<const float4*>(row + col))
                    : 0u;
    } else {
      w = pack_s8(col < n_v ? row[col] : 0.0f,
                  col + 1 < n_v ? row[col + 1] : 0.0f,
                  col + 2 < n_v ? row[col + 2] : 0.0f,
                  col + 3 < n_v ? row[col + 3] : 0.0f);
    }
    any |= w != 0u;
    *reinterpret_cast<uint32_t*>(b8 + b8_row(c, m, n_str) + k * KS +
                                 4 * (lane & 7)) = w;
  }
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) flags[(int64_t)c * n_str + k] = any ? 1 : 0;
}

// grid (n_chunks, ceil(n_a / PA), G), P_THREADS, p_smem(kWide) dynamic
// bytes.  kWide: a K-stage is four stripes (the stack form), else one.
template <bool kSkip, bool kVec, bool kWide>
__global__ void __launch_bounds__(P_THREADS)
peel_update_kernel(const float* __restrict__ a, const float* __restrict__ s,
                   const int* __restrict__ ids_a,
                   const int* __restrict__ ids_b,
                   const int* __restrict__ kmax_a,
                   const int* __restrict__ kmax_b,
                   const int* __restrict__ flags,
                   const uint8_t* __restrict__ b8, float* __restrict__ out,
                   int n_a, int n_b, int n_v, int n_str, int n_ta, int n_tb,
                   int bi, int bj, int bk) {
  constexpr int SUB = stage_stripes(kWide);
  constexpr int P_STAGES = p_stages(kWide);
  constexpr int AS = SUB * A_STAGE;    // floats of a K-stage of A
  constexpr int BS = SUB * B_STAGE;    // bytes of a K-stage of B
  extern __shared__ __align__(16) unsigned char ring[];
  float* as_ring = reinterpret_cast<float*>(ring);
  uint8_t* bs_ring = ring + P_STAGES * AS * 4;
  __shared__ int mrow[PB];
  __shared__ int live[P_THREADS];
  __shared__ int warp_sums[P_THREADS / 32];

  if constexpr (kWide) {
    // the group's operands (a one-graph launch is not wide: one group)
    const int64_t g = blockIdx.z;
    const int n_chunks = gridDim.x;
    a += g * n_a * (int64_t)n_v;
    s += g * n_b;
    ids_a += g * n_a;
    ids_b += g * n_b;
    out += g * n_a;
    flags += g * n_chunks * (int64_t)n_str;
    b8 += g * b8_row(n_chunks, 0, n_str);
    if constexpr (kSkip) {
      kmax_a += g * n_ta;
      kmax_b += g * n_tb;
    }
  }

  const int c = blockIdx.x;
  const int j0 = c * PB;
  const int i0 = blockIdx.y * PA;
  const int n_mass = chunk_mass_rows(s, n_b, j0, mrow, warp_sums);
  if (n_mass == 0) return;   // no s mass in the chunk: nothing to add

  // columns past kcut add nothing to this block's W
  int kcut = n_v;
  if constexpr (kSkip) {
    const int ka = wedge::covering_extent(kmax_a, i0, min(i0 + PA, n_a), bi);
    const int kb = wedge::covering_extent(kmax_b, j0, min(j0 + PB, n_b), bj);
    kcut = (int)min((int64_t)min(ka, kb) * bk, (int64_t)n_v);
  }
  const int n_str_cut = (kcut + KS - 1) / KS;
  const int n_stage = (n_str_cut + SUB - 1) / SUB;   // K-stages below kcut
  const int b_rows = (n_mass + 7) & ~7;   // rows the mma reads

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 3;          // A rows 16 wm .. 16 wm + 15
  const int wn = warp >> 2;         // mass rows 64 wn .. 64 wn + 63
  const int n_tiles = min(max((n_mass - 64 * wn + 7) >> 3, 0), 8);
  int acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0;

  // K-stage q: stripes SUB q .. SUB q + SUB - 1
  auto load_stage = [&](int slot, int q) {
    if constexpr (kWide)
      load_a_wide<kVec, PA, P_THREADS>(as_ring + slot * AS, a, n_v, i0, n_a,
                                       q * SUB * KS, kcut);
    else
      load_a_stripe<kVec, PA, P_THREADS>(as_ring + slot * AS, a, n_v, i0,
                                         n_a, q * KS, kcut);
    // one 16-byte half-row of the mass rows' s8 stripe per thread and
    // stripe (zero past the row's last stripe)
    const int row = tid >> 1;
    const int half = tid & 1;
    if (row < b_rows) {
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        const int k = q * SUB + t;
        const bool have = row < n_mass && (SUB == 1 || k < n_str);
        cp_async16(bs_ring + slot * BS + t * B_STAGE + b_slot(row, half),
                   have ? (const void*)(b8 + b8_row(c, row, n_str) + k * KS +
                                        16 * half)
                        : (const void*)b8,
                   have ? 16 : 0);
      }
    }
  };

  // a K-stage is live when one of its stripes below kcut is marked
  auto stage_live = [&](int q) {
    bool any = false;
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      const int k = q * SUB + t;
      any |= k < n_str_cut && flags[(int64_t)c * n_str + k] != 0;
    }
    return any;
  };

  for (int win = 0; win < n_stage; win += P_THREADS) {
    const int q = win + tid;
    const int n_live = block_compact(q < n_stage && stage_live(q), q, live, 0,
                                     P_THREADS, warp_sums);
#pragma unroll
    for (int st = 0; st < P_STAGES - 1; ++st) {
      if (st < n_live) load_stage(st, live[st]);
      cp_async_commit();
    }
    for (int it = 0; it < n_live; ++it) {
      cp_async_wait<P_STAGES - 2>();
      __syncthreads();
      const int nx = it + P_STAGES - 1;
      if (nx < n_live) load_stage(nx % P_STAGES, live[nx]);
      cp_async_commit();
      if (n_tiles > 0) {
        const int slot = it % P_STAGES;
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          uint32_t af[4];
          a_fragment(as_ring + slot * AS + t * A_STAGE, 16 * wm, af);
          const uint8_t* bs = bs_ring + slot * BS + t * B_STAGE;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            if (nt < n_tiles) mma_b_rows(acc[nt], af, bs, 64 * wn + 8 * nt);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring and the list are free for the next window
  }

  // epilogue: C(W, 2) * s[j] * [ids differ], reduced over the quad's columns
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 16 * wm + gq + 8 * h;
    float part = 0.0f;
    if (i < n_a) {
      const int ida = ids_a[i];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= n_tiles) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 64 * wn + 8 * nt + 2 * t + e;
          if (m >= n_mass) continue;
          const int j = j0 + mrow[m];
          const float w = (float)acc[nt][2 * h + e];
          const float b2 = w * (w - 1.0f) * 0.5f;
          if (ida != ids_b[j]) part += b2 * s[j];
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (t == 0 && i < n_a && part != 0.0f) atomicAdd(out + i, part);
  }
}

// the operands of one peel launch
struct PeelArgs {
  const float* a;
  const float* s;
  const int* ids_a;
  const int* ids_b;
  const int* kmax_a;
  const int* kmax_b;
  const int* flags;
  const uint8_t* b8;
  float* out;
  int n_a, n_b, n_v, n_str, n_ta, n_tb, bi, bj, bk;
};

// one-time opt-in above 48 KB of dynamic shared memory, per instantiation
template <bool kSkip, bool kVec, bool kWide>
cudaError_t launch_peel_update(dim3 grid, cudaStream_t stream,
                               const PeelArgs& p) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      peel_update_kernel<kSkip, kVec, kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p_smem(kWide));
  if (attr != cudaSuccess) return attr;
  peel_update_kernel<kSkip, kVec, kWide>
      <<<grid, P_THREADS, p_smem(kWide), stream>>>(
          p.a, p.s, p.ids_a, p.ids_b, p.kmax_a, p.kmax_b, p.flags, p.b8,
          p.out, p.n_a, p.n_b, p.n_v, p.n_str, p.n_ta, p.n_tb, p.bi, p.bj,
          p.bk);
  return cudaGetLastError();
}

template <bool kSkip, bool kVec>
cudaError_t launch_peel(dim3 grid, cudaStream_t stream, bool wide,
                               const PeelArgs& p) {
  return wide ? launch_peel_update<kSkip, kVec, true>(grid, stream, p)
              : launch_peel_update<kSkip, kVec, false>(grid, stream, p);
}

}  // namespace

// Scratch bytes of the peel body over `groups` graphs: flags (groups x
// n_chunks x n_str int32, rounded up to 16 bytes) then the s8 mass rows
// (groups x n_chunks x PB x n_str x 32), with n_str = ceil(n_v / 32) and
// n_chunks = ceil(n_b / PB).  kernels/butterfly.py's peel_scratch_bytes is
// the same formula.
static int64_t peel_scratch_bytes(int groups, int n_b, int n_v) {
  const int64_t n_str = (n_v + KS - 1) / KS;
  const int64_t n_chunks = (int64_t)groups * ((n_b + PB - 1) / PB);
  const int64_t flag_bytes = (4 * n_chunks * n_str + 15) / 16 * 16;
  return flag_bytes + n_chunks * PB * n_str * KS;
}

// The peel body of kernels 1 and 4 (one graph: groups = 1, stack = 0) and
// of kernels 2 and 5 (a stack of `groups` graphs, group g the g-th slice of
// every operand: stack = 1, four stripes a K-stage).  Operands as
// butterfly_update_sparse_f32; scratch: at least peel_scratch_bytes(groups,
// n_b, n_v) bytes of device memory, 16-byte aligned, needing no initial
// value.
extern "C" int butterfly_update_peel_f32(
    const float* a, const float* b, const float* s, const int* ids_a,
    const int* ids_b, const int* kmax_a, const int* kmax_b, float* out,
    int groups, int n_a, int n_b, int n_v, int n_ta, int n_tb, int bi, int bj,
    int bk, int stack, void* scratch, long long scratch_bytes, void* stream) {
  if ((kmax_a == nullptr) != (kmax_b == nullptr))
    return (int)cudaErrorInvalidValue;
  if (scratch_bytes < peel_scratch_bytes(groups, n_b, n_v) ||
      ((uintptr_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_str = (n_v + KS - 1) / KS;
  const int n_chunks = (n_b + PB - 1) / PB;
  const int n_bands = (n_a + PA - 1) / PA;
  if (n_chunks > 65535 || n_bands > 65535 || groups > 65535 ||
      (stack == 0 && groups != 1))
    return (int)cudaErrorInvalidValue;
  int* flags = static_cast<int*>(scratch);
  uint8_t* b8 = static_cast<uint8_t*>(scratch) +
                ((4 * (int64_t)groups * n_chunks * n_str + 15) / 16 * 16);
  cudaStream_t st = (cudaStream_t)stream;

  const dim3 prep_grid((n_str + PREP_THREADS / 32 - 1) / (PREP_THREADS / 32),
                       n_chunks, groups);
  const bool vec_b = (n_v % 4 == 0) && (((uintptr_t)b & 15) == 0);
  if (vec_b)
    peel_prep_kernel<true><<<prep_grid, PREP_THREADS, 0, st>>>(
        b, s, n_b, n_v, n_str, flags, b8);
  else
    peel_prep_kernel<false><<<prep_grid, PREP_THREADS, 0, st>>>(
        b, s, n_b, n_v, n_str, flags, b8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(n_chunks, n_bands, groups);
  const bool vec = (n_v % 4 == 0) && (((uintptr_t)a & 15) == 0);
  const bool wide = stack != 0;
  const PeelArgs p{a, s, ids_a, ids_b, kmax_a, kmax_b, flags, b8, out,
                   n_a, n_b, n_v, n_str, n_ta, n_tb, bi, bj, bk};
  if (kmax_a != nullptr)
    err = vec ? launch_peel<true, true>(grid, st, wide, p)
              : launch_peel<true, false>(grid, st, wide, p);
  else
    err = vec ? launch_peel<false, true>(grid, st, wide, p)
              : launch_peel<false, false>(grid, st, wide, p);
  return (int)err;
}

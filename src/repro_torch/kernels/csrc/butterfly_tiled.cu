// Mask-form butterfly update over a nonzero-tile list, hand-written for
// Hopper (sm_90a).
//
//   out[x] = sum_{y != x} s[y] * C((A A^T)[x, y], 2)
//
// A is given as the CSR-of-tiles slot list of core.graph.TiledGraph:
// tile_data (n_slots, bi, bk) f32 0/1 payloads, scol (n_slots) the column
// band of each slot, sptr (n_rt + 1) the slot range of each row band, pos
// (n_rt, n_ct) the slot holding tile (band, column band) or -1, and
// slot_live (n_slots) 0 for a tile with no nonzero left.  With s = the
// alive mask this is per-vertex butterfly counting; with s = a peel mask
// it is the support delta of one sweep of the tiled level peel.
//
// Replaces kernel 6 of the reference package,
// src/repro/kernels/butterfly_tiled.py:259 butterfly_update_pallas_tiled
// (body _tiled_update_kernel).  The Pallas grid is (n_rt, n_slots): B band
// j outer, slot t inner, six scalar-prefetched index arrays, the B tile
// gathered in the BlockSpec index map through pos[j, scol[t]], and a
// bi x bi wedge accumulator carried in VMEM from a band's first slot to its
// last.  Nothing carries between blocks here, so the slot walk moves inside
// the block.
//
// Two bodies compute it.  The peel body is the one every caller launches
// (kernels/butterfly_tiled.py): every sweep of the tiled level peel and
// the count launch (s = alive) too, since chip_smoke.py phase 3 found it
// faster than the count body at every width it times, all rows included
// (PERF.md).  The count body, the body of the earlier port, stays as the
// yardstick that phase times it against (body="count").
//
// THE COUNT BODY (tiled_update_kernel).  One 256-thread block per (A row
// band i, 64-row sub-tile of it, B row band j, 64-row sub-tile of it):
// blockIdx.x = i * n_sub + xs, blockIdx.y = j * n_sub + ys, n_sub =
// ceil(bi / 64).  The block first checks its 64 entries of s and returns at
// once when none is nonzero (the Pallas kernel's per-band `sband` test,
// here per 64 rows).  Then it walks band i's slots t = sptr[i] ..
// sptr[i + 1] - 1, loading the indices itself, and skips a slot unless it
// is live, its partner p = pos[j, scol[t]] exists and the partner is live.
// For each remaining pair it adds the product of the two tiles' sub-tiles
// over bk into one 64 x 64 accumulator in registers, from 16-column
// stripes staged through shared memory, with f32 FMA (tile_product_add of
// wedge_tile.cuh, the tile of kernels 1-5).  The sum over the pairs is the
// bi x bi wedge tile W[band i, band j] restricted to the block's rows.  The
// epilogue evaluates C(W, 2) * s[y] * (x != y), reduces each row over the
// block's columns and adds it into out[x] with atomicAdd; blocks of
// different j (and ys) meet in the atomics.  Bound: with s = alive every
// live tile pair is multiplied, 2 bi^2 bk operations per pair, bound by
// operations at the engine's count shape (its floor the int8 tensor-core
// rate; moving it to wgmma is ROADMAP queue 0).
//
// THE PEEL BODY (tiled_peel_rows_kernel, tiled_peel_prep_kernel,
// tiled_peel_kernel).  A sweep of the tiled level peel peels a few rows
// (one in the median sweep at full size), and the function needs only the
// wedge columns W[:, y] of those rows: row y meets another row only in the
// column bands c where y holds a nonzero, in its live tile
// pos[band(y), c], and there only in the 32-column stripes where y does.
// What bounds it is bytes: the f32 A stripes of the live slots of those
// column bands, read once (2 bi bk operations per peeled row and slot are
// ~1/100 of the byte time at the int8 rate).  The design reads only those:
//   1. tiled_peel_rows_kernel (one block) compacts the rows with s != 0
//      of the row window [row0, row_end), in row order, into a list in
//      scratch, on the device (no read by the wrapper; the list holds at
//      most the n_srows the caller stated).  One window is every row; the
//      wrapper launches several only when the scratch for every peeled row
//      (an s8 copy of their partner rows) would outgrow its cap, the
//      payload's own size by default, so that the count launch keeps the
//      representation's memory proportional to its occupied tiles.
//   2. tiled_peel_prep_kernel (grid: column band c x chunk of 16 peeled
//      rows; warp m per row) packs row y of the partner tile
//      p = pos[band(y), c] to s8 into scratch, zero when p is absent or
//      dead, and ORs a bit per 32-column stripe where any of the chunk's
//      rows holds a nonzero: smask[chunk][c].
//   3. tiled_peel_kernel (grid: chunk x (row band i, 64-row sub-tile),
//      chunk fastest, so the blocks reading one sub-tile run together and
//      share it in L2): a block walks band i's slots t, skips dead slots,
//      and for column band c = scol[t] takes only the stripes marked in
//      smask[chunk][c] (a slot whose partners are all absent, dead or
//      zero in the chunk's rows has none).  Each (slot, stripe) goes
//      through a 4-stage cp.async ring: tile t's 64 x 32 f32 sub-stripe
//      and the chunk's 16 s8 partner rows there, so later loads overlap
//      the products; four warps (16 rows each) multiply with mma.sync
//      m16n8k32 s8 x s8 -> s32 (wedge_mma.cuh) into a 64 x 16 s32
//      accumulator summed across the slots, skipping the second n-tile
//      when the chunk has at most 8 rows.  Only after the last slot comes
//      C(W, 2), since W sums over column bands: each s32 W converts to f32
//      exactly, then W * (W - 1) * 0.5, * s[y], the self-exclusion
//      (i == band(y) and x == y % bi), the row reduction (quad shuffles)
//      and an exact f32 atomicAdd; chunks meet in the atomics.
//
// Filler slots (TiledGraph.from_graph(pad_slots_to=...)) sit in band
// n_rt - 1's slot range, are absent from pos and are dead, so both bodies
// skip them.  Any bi, bk >= 1 work: rows past bi and columns past bk read
// as zero, so a band of 8 rows uses one block of which 8 rows are live,
// and 128-row bands use 2 sub-tiles per band.
//
// Exactness.  A is 0/1 (the function's contract; the peel body's s8
// conversion [v != 0] relies on it), so every W is an integer below
// bk * n_ct: exact in f32 and, in the peel body, an s32 sum that cannot
// overflow.  The engine works in the regime where every butterfly support
// is below 2^24 (DESIGN.md section 8); then every C(W, 2), every partial
// row sum and every atomicAdd operand is a non-negative integer no larger
// than the final support, so each f32 addition is exact in ANY order and
// both bodies are bit-identical to the reference.  C(W, 2) is evaluated in
// the reference's operation order (W * (W - 1), then * 0.5).
//
// All tensors are contiguous: tile_data and s f32, the index arrays int32,
// out (n_rt * bi) f32.  The launches go on the caller's stream, allocate
// nothing (the peel body's scratch comes from the wrapper) and return
// cudaGetLastError() (cudaErrorInvalidValue for a grid past the y-dimension
// limit, 65535 row sub-tiles, or a scratch too small).

#include "wedge_mma.cuh"
#include "wedge_tile.cuh"

namespace {

using namespace wedge;

__global__ void __launch_bounds__(THREADS)
tiled_update_kernel(const float* __restrict__ tile_data,
                    const int* __restrict__ scol, const int* __restrict__ sptr,
                    const int* __restrict__ pos,
                    const int* __restrict__ slot_live,
                    const float* __restrict__ s, float* __restrict__ out,
                    int n_ct, int bi, int bk, int n_sub) {
  const int i = blockIdx.x / n_sub;
  const int x0 = (blockIdx.x % n_sub) * TI;
  const int j = blockIdx.y / n_sub;
  const int y0 = (blockIdx.y % n_sub) * TJ;
  const float* s_j = s + (int64_t)j * bi;

  // no s mass on the block's 64 B rows: nothing to add
  const int yt = y0 + (int)threadIdx.x;
  const bool mass = threadIdx.x < TJ && yt < bi && s_j[yt] != 0.0f;
  if (!__syncthreads_or(mass)) return;

  const int64_t tile = (int64_t)bi * bk;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
  bool paired = false;
  const int t_end = sptr[i + 1];
  for (int t = sptr[i]; t < t_end; ++t) {
    if (slot_live[t] == 0) continue;
    const int partner = pos[(int64_t)j * n_ct + scol[t]];
    if (partner < 0 || slot_live[partner] == 0) continue;
    tile_product_add(tile_data + t * tile, tile_data + partner * tile, bi, bi,
                     bk, x0, y0, bk, acc);
    paired = true;
  }
  if (!paired) return;  // W = 0 on the block's rows

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float part[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    part[p] = 0.0f;
    const int x = x0 + ty + 16 * p;
    if (x >= bi) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int y = y0 + tx + 16 * q;
      if (y >= bi) continue;
      const float w = acc[p][q];
      const float b2 = w * (w - 1.0f) * 0.5f;
      const float not_self = (i == j && x == y) ? 0.0f : 1.0f;
      part[p] += b2 * not_self * s_j[y];
    }
  }
  add_row_partials(part, out + (int64_t)i * bi, bi, x0);
}

}  // namespace

// out (n_rt * bi) zeroed by the caller.  srow is not needed: sptr gives
// each band's slot range.
extern "C" int butterfly_update_tiled_f32(const float* tile_data,
                                          const int* scol, const int* sptr,
                                          const int* pos, const int* slot_live,
                                          const float* s, float* out,
                                          int n_rt, int n_ct, int bi, int bk,
                                          void* stream) {
  const int n_sub = (bi + TI - 1) / TI;
  const int64_t sub_tiles = (int64_t)n_rt * n_sub;
  if (sub_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)sub_tiles, (unsigned)sub_tiles, 1);
  tiled_update_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      tile_data, scol, sptr, pos, slot_live, s, out, n_ct, bi, bk, n_sub);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------- //
// the peel body
// ---------------------------------------------------------------------- //
namespace {

using namespace wmma8;

constexpr int CH = 16;             // peeled rows per chunk (two n8 tiles)
constexpr int T_STAGES = 4;        // cp.async ring depth
constexpr int T_THREADS = 128;     // 4 warps x 16 sub-tile rows
constexpr int ROWS_THREADS = 1024;
constexpr int PREP6_THREADS = 32 * CH;
constexpr int MAX_SW = 32;         // stripe-mask words: bk <= 32768
constexpr int A6_STAGE = TI * KS;  // floats
constexpr int B6_STAGE = CH * KS;  // bytes

// scratch layout (kernels/butterfly_tiled.py's peel_scratch_bytes is the
// same formula): [0, 16) the row count, then ylist (n_chunks * CH int32),
// smask (n_chunks * n_ct * n_sw uint32) and y8 (n_chunks * n_ct * CH rows
// of n_str * 32 s8 bytes), each from a 16-byte boundary
struct PeelScratch {
  int* count;
  int* ylist;
  uint32_t* smask;
  uint8_t* y8;
};

inline int64_t up16(int64_t x) { return (x + 15) / 16 * 16; }

// offsets of ylist, smask and y8, and the total
inline void peel_scratch_layout(int n_chunks, int n_ct, int bk,
                                int64_t (&at)[4]) {
  const int64_t n_str = (bk + KS - 1) / KS;
  const int64_t n_sw = (n_str + 31) / 32;
  at[0] = 16;
  at[1] = at[0] + up16(4 * (int64_t)n_chunks * CH);
  at[2] = at[1] + up16(4 * (int64_t)n_chunks * n_ct * n_sw);
  at[3] = at[2] + (int64_t)n_chunks * n_ct * CH * n_str * KS;
}

// One block: the rows of [row0, row_end) with s != 0, in row order, the
// first `cap` of them into ylist; count = min(their number, cap).
__global__ void __launch_bounds__(ROWS_THREADS)
tiled_peel_rows_kernel(const float* __restrict__ s, int row0, int row_end,
                       int cap, int* __restrict__ ylist,
                       int* __restrict__ count) {
  __shared__ int warp_sums[ROWS_THREADS / 32];
  int base = 0;
  for (int r0 = row0; r0 < row_end && base < cap; r0 += ROWS_THREADS) {
    const int r = r0 + (int)threadIdx.x;
    base += block_compact(r < row_end && s[r] != 0.0f, r, ylist, base, cap,
                          warp_sums);
  }
  if (threadIdx.x == 0) *count = min(base, cap);
}

// grid (n_ct, n_chunks), PREP6_THREADS: warp m packs the stripes of
// peeled row y = ylist[CH q + m] in its partner tile of column band c.
__global__ void __launch_bounds__(PREP6_THREADS)
tiled_peel_prep_kernel(const float* __restrict__ tile_data,
                       const int* __restrict__ pos,
                       const int* __restrict__ slot_live,
                       const int* __restrict__ ylist,
                       const int* __restrict__ count,
                       uint32_t* __restrict__ smask, uint8_t* __restrict__ y8,
                       int n_ct, int bi, int bk, int n_str, int n_sw) {
  __shared__ uint32_t bits[MAX_SW];
  const int c = blockIdx.x;
  const int q = blockIdx.y;
  const int n_q = min(CH, *count - q * CH);
  if (n_q <= 0) return;   // the update kernel's block returns too
  for (int w = threadIdx.x; w < n_sw; w += blockDim.x) bits[w] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int m = threadIdx.x >> 5;
  const float* row = nullptr;
  if (m < n_q) {
    const int y = ylist[q * CH + m];
    const int p = pos[(int64_t)(y / bi) * n_ct + c];
    if (p >= 0 && slot_live[p] != 0)
      row = tile_data + ((int64_t)p * bi + y % bi) * bk;
  }
  const int64_t qc = (int64_t)q * n_ct + c;
  uint8_t* out = y8 + (qc * CH + m) * n_str * KS;
  for (int kk = 0; kk < n_str; ++kk) {
    const int col = kk * KS + lane;
    const bool nz = row != nullptr && col < bk && row[col] != 0.0f;
    out[col] = nz ? 1 : 0;
    if (__any_sync(0xffffffffu, nz) && lane == 0)
      atomicOr(&bits[kk >> 5], 1u << (kk & 31));
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n_sw; w += blockDim.x)
    smask[qc * n_sw + w] = bits[w];
}

// grid (n_chunks, n_rt * n_sub), T_THREADS.
template <bool kVec>
__global__ void __launch_bounds__(T_THREADS)
tiled_peel_kernel(const float* __restrict__ tile_data,
                  const int* __restrict__ scol, const int* __restrict__ sptr,
                  const int* __restrict__ slot_live,
                  const float* __restrict__ s,
                  const int* __restrict__ ylist, const int* __restrict__ count,
                  const uint32_t* __restrict__ smask,
                  const uint8_t* __restrict__ y8, float* __restrict__ out,
                  int n_ct, int bi, int bk, int n_sub, int n_str, int n_sw) {
  __shared__ __align__(16) float as_ring[T_STAGES * A6_STAGE];
  __shared__ __align__(16) uint8_t bs_ring[T_STAGES * B6_STAGE];
  __shared__ int ys[CH];
  __shared__ float sy[CH];

  const int q = blockIdx.x;
  const int i = blockIdx.y / n_sub;
  const int x0 = (blockIdx.y % n_sub) * TI;
  const int n_q = min(CH, *count - q * CH);
  if (n_q <= 0) return;   // no peeled row in this chunk
  const int tid = threadIdx.x;
  if (tid < CH) {
    const int y = tid < n_q ? ylist[q * CH + tid] : -1;
    ys[tid] = y;
    sy[tid] = y >= 0 ? s[y] : 0.0f;
  }
  __syncthreads();

  // the (slot, stripe) items of the block, in slot order: every thread
  // walks the same sequence (the index loads are uniform)
  const int t_end = sptr[i + 1];
  int t = sptr[i] - 1;
  int kk = n_str;                  // past the stripes: take the next slot
  int64_t qc = 0;
  auto next = [&](int& it_t, int& it_k, int64_t& it_qc) -> bool {
    while (true) {
      if (kk >= n_str) {
        do {
          if (++t >= t_end) return false;
        } while (slot_live[t] == 0);
        qc = (int64_t)q * n_ct + scol[t];
        kk = 0;
      }
      const uint32_t word = smask[qc * n_sw + (kk >> 5)] >> (kk & 31);
      if (word != 0u) {
        kk += __ffs(word) - 1;
        it_t = t;
        it_k = kk++;
        it_qc = qc;
        return true;
      }
      kk = (kk | 31) + 1;
    }
  };
  auto load_stage = [&](int slot, int it_t, int it_k, int64_t it_qc) {
    load_a_stripe<kVec, TI, T_THREADS>(
        as_ring + slot * A6_STAGE, tile_data + (int64_t)it_t * bi * bk, bk,
        x0, bi, it_k * KS, bk);
    if (tid < 2 * CH) {
      const int row = tid >> 1;
      const int half = tid & 1;
      cp_async16(bs_ring + slot * B6_STAGE + b_slot(row, half),
                 y8 + (it_qc * CH + row) * n_str * KS + it_k * KS + 16 * half,
                 16);
    }
  };

  const int warp = tid >> 5;
  const int n_tiles = n_q > 8 ? 2 : 1;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  int issued = 0, done = 0;
  bool more = true;
  int it_t, it_k;
  int64_t it_qc;
#pragma unroll
  for (int st = 0; st < T_STAGES - 1; ++st) {
    if (more && (more = next(it_t, it_k, it_qc))) {
      load_stage(st, it_t, it_k, it_qc);
      ++issued;
    }
    cp_async_commit();
  }
  while (done < issued) {
    cp_async_wait<T_STAGES - 2>();
    __syncthreads();
    if (more && (more = next(it_t, it_k, it_qc))) {
      load_stage(issued % T_STAGES, it_t, it_k, it_qc);
      ++issued;
    }
    cp_async_commit();
    const int slot = done % T_STAGES;
    uint32_t af[4];
    a_fragment(as_ring + slot * A6_STAGE, 16 * warp, af);
    mma_b_rows(acc[0], af, bs_ring + slot * B6_STAGE, 0);
    if (n_tiles > 1) mma_b_rows(acc[1], af, bs_ring + slot * B6_STAGE, 8);
    ++done;
  }
  cp_async_wait<0>();
  if (issued == 0) return;   // no slot meets the chunk's rows: W = 0

  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = x0 + 16 * warp + g + 8 * h;
    float part = 0.0f;
    if (x < bi) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * nt + 2 * tq + e;
          if (m >= n_q) continue;
          const int y = ys[m];
          const float w = (float)acc[nt][2 * h + e];
          const float b2 = w * (w - 1.0f) * 0.5f;
          if (!(i == y / bi && x == y % bi)) part += b2 * sy[m];
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (tq == 0 && x < bi && part != 0.0f)
      atomicAdd(out + (int64_t)i * bi + x, part);
  }
}

}  // namespace

// The peel body over the rows [row0, row_end): it adds their terms y to
// out.  Operands as butterfly_update_tiled_f32; n_srows >= the number of
// nonzero entries of s in the window (rows past it are not seen);
// scratch: at least peel_scratch_layout(ceil(n_srows / 16), n_ct, bk)[3]
// bytes of device memory, 16-byte aligned, needing no initial value.
extern "C" int butterfly_update_tiled_peel_f32(
    const float* tile_data, const int* scol, const int* sptr, const int* pos,
    const int* slot_live, const float* s, float* out, int n_rt, int n_ct,
    int bi, int bk, int row0, int row_end, int n_srows, void* scratch,
    long long scratch_bytes, void* stream) {
  const int n_chunks = (n_srows + CH - 1) / CH;
  const int n_sub = (bi + TI - 1) / TI;
  const int n_str = (bk + KS - 1) / KS;
  const int n_sw = (n_str + 31) / 32;
  const int64_t sub_tiles = (int64_t)n_rt * n_sub;
  if (row0 < 0 || row_end < row0 || row_end > n_rt * bi)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0 || row_end == row0) return (int)cudaSuccess;
  if (sub_tiles > 65535 || n_chunks > 65535 || n_sw > MAX_SW)
    return (int)cudaErrorInvalidValue;
  int64_t at[4];
  peel_scratch_layout(n_chunks, n_ct, bk, at);
  if (scratch_bytes < at[3] || ((uintptr_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  uint8_t* base = static_cast<uint8_t*>(scratch);
  PeelScratch sc;
  sc.count = reinterpret_cast<int*>(base);
  sc.ylist = reinterpret_cast<int*>(base + at[0]);
  sc.smask = reinterpret_cast<uint32_t*>(base + at[1]);
  sc.y8 = base + at[2];
  cudaStream_t st = (cudaStream_t)stream;

  tiled_peel_rows_kernel<<<1, ROWS_THREADS, 0, st>>>(
      s, row0, row_end, n_chunks * CH, sc.ylist, sc.count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tiled_peel_prep_kernel<<<dim3(n_ct, n_chunks), PREP6_THREADS, 0, st>>>(
      tile_data, pos, slot_live, sc.ylist, sc.count, sc.smask, sc.y8, n_ct,
      bi, bk, n_str, n_sw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_chunks, (unsigned)sub_tiles);
  const bool vec = (bk % 4 == 0) && (((uintptr_t)tile_data & 15) == 0);
  if (vec)
    tiled_peel_kernel<true><<<grid, T_THREADS, 0, st>>>(
        tile_data, scol, sptr, slot_live, s, sc.ylist, sc.count, sc.smask,
        sc.y8, out, n_ct, bi, bk, n_sub, n_str, n_sw);
  else
    tiled_peel_kernel<false><<<grid, T_THREADS, 0, st>>>(
        tile_data, scol, sptr, slot_live, s, sc.ylist, sc.count, sc.smask,
        sc.y8, out, n_ct, bi, bk, n_sub, n_str, n_sw);
  return (int)cudaGetLastError();
}

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
// the block:
//
// Design.  One 256-thread block per (A row band i, 64-row sub-tile of it,
// B row band j, 64-row sub-tile of it): blockIdx.x = i * n_sub + xs,
// blockIdx.y = j * n_sub + ys, n_sub = ceil(bi / 64).  The block first
// checks its 64 entries of s and returns at once when none is nonzero (the
// Pallas kernel's per-band `sband` test, here per 64 rows, read by the
// block itself, so the wrapper computes nothing).  Then it walks band i's
// slots t = sptr[i] .. sptr[i + 1] - 1, loading the indices itself, and
// skips a slot unless it is live, its partner p = pos[j, scol[t]] exists
// and the partner is live.  For each remaining pair it adds the product of
// the two tiles' sub-tiles over bk into one 64 x 64 accumulator in
// registers, from 16-column stripes staged through shared memory, with f32
// FMA (tile_product_add of wedge_tile.cuh, the tile of kernels 1-5).  The
// sum over the pairs is the bi x bi wedge tile W[band i, band j] restricted
// to the block's rows.  The epilogue evaluates C(W, 2) * s[y] * (x != y),
// reduces each row over the block's columns and adds it into out[x] with
// atomicAdd; blocks of different j (and ys) meet in the atomics.  The
// wrapper zeroes out before the launch.
//
// Filler slots (TiledGraph.from_graph(pad_slots_to=...)) sit in band
// n_rt - 1's slot range, are absent from pos and are dead, so the slot
// test skips them.  Any bi, bk >= 1 work: rows past bi and columns past bk
// read as zero, so a band of 8 rows uses one block of which 8 rows are
// live, and 128-row bands use 2 x 2 blocks per band pair.
//
// Exactness.  A is 0/1, so every W is an integer below bk * n_ct and exact
// in f32.  The engine works in the regime where every butterfly support is
// below 2^24 (DESIGN.md section 8); then every C(W, 2), every partial row
// sum and every atomicAdd operand is a non-negative integer no larger than
// the final support, so each f32 addition is exact in ANY order and the
// result is bit-identical to the reference's.  C(W, 2) is evaluated in the
// reference's operation order (W * (W - 1), then * 0.5).
//
// What bounds it on the H100.  The work depends on the mask.  With s =
// alive every live tile pair is multiplied: 2 bi^2 bk operations per pair,
// bound by operations at the engine's count shape.  With a peel mask of a
// few rows the function needs only the peeled columns of W, 2 bi bk
// operations per peeled row and partner tile, against the tiles' f32 bytes:
// bound by bytes.  Its floor is the int8 tensor-core rate (0/1 operands and
// counts below 2^24 are exact in int8 -> int32).  This first version runs
// on the f32 FMA units and computes the block's whole 64 x 64 sub-tile even
// when one of its columns carries s mass; wgmma (s8 x s8 -> s32) and a peel
// form that multiplies only the peeled rows are later work.
//
// All tensors are contiguous: tile_data and s f32, the index arrays int32,
// out (n_rt * bi) f32.  The launch goes on the caller's stream, allocates
// nothing and returns cudaGetLastError() (cudaErrorInvalidValue for a grid
// past the y-dimension limit, 65535 row sub-tiles).

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

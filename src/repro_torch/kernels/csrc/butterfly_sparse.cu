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
// Replaces four Pallas TPU kernels of the reference package, all one body
// here with the group as gridDim.z:
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
// Design.  One 256-thread block computes a 64 x 64 wedge tile
// W = A[i0:i0+64] . B[j0:j0+64]^T in registers (4 x 4 per thread), from
// 16-column K-stripes staged through shared memory, with f32 FMA
// (wedge_tile.cuh, shared with b2_stack.cu).  The epilogue applies
// C(W, 2) = W * (W - 1) * 0.5, the row mask s and the not-self mask,
// row-reduces the tile (half-warp shuffles) and adds the partial row sums
// into out with atomicAdd.  The Pallas grid carries out_i across j in order
// on one core; here the j-tiles run as parallel blocks and meet in the
// atomics.  The wrapper zeroes out before the launch.
//
// Stripe skip.  As in b2_stack.cu, the block reads the extents of the
// reference tiles (bi rows on the A side, bj rows on the B side) that cover
// its 64 rows and 64 columns and stops its K loop at
// min(max kmax_a, max kmax_b) * bk.  The Pallas grid skips stripes tile pair
// by tile pair; a block that spans several reference tiles (bi or bj below
// 64) takes the largest extent among them.  Both are exact for extents that
// upper-bound the true ones: every column past the bound is zero in all the
// block's rows on one side.  With bi, bj >= 64 and multiples of 64 the block
// skips exactly the stripes the Pallas kernel skips.
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
// What bounds it on the H100.  The product over the live stripes,
// 2 * sum over tile pairs of bi bj min(ka, kb) bk operations (2 n_a n_b n_v
// without extents), against the live stripes' f32 reads: at the engine's
// count shape (8192 x 8192) it is bound by operations, at a 256-row peel
// update by bytes.  Its floor is the int8 tensor-core rate (0/1 operands and
// counts below 2^24 are exact in int8 -> int32); this first version runs on
// the f32 FMA units (about 1/30 of that rate), which keeps the arithmetic
// plainly exact, and the skip removes the staircase's all-zero tail.
// Moving the product to wgmma (s8 x s8 -> s32) is the work of a later change.
//
// Shapes need not be multiples of any tile: loads and the epilogue mask the
// ragged edge.  All tensors are contiguous, f32 (a, b, s, out) and int32
// (ids, extents).  The launch goes on the caller's stream, allocates nothing
// and returns cudaGetLastError().

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

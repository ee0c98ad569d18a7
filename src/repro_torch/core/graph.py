"""Bipartite graph substrate for RECEIPT (the port's copy of
``repro.core.graph``).

A bipartite graph G(W = (U, V), E).  Tip decomposition peels the U side;
V is never deleted.  The substrate provides:

  * an edge-list / dual-CSR container (host, numpy) with degree-descending
    relabeling (the Wang et al. cache trick -> tile density),
  * dense biadjacency views (0/1 matrices) padded to tile multiples for the
    blocked butterfly kernels, and the blocked-sparse ``TiledGraph`` (only
    the nonzero tiles, in CSR-of-tiles order) for the tiled kernel,
  * exact per-vertex wedge counts  w[u] = sum_{v in N_u} (d_v - 1)
    (the paper's workload proxy, used by adaptive range determination,
    HUC cost models and the benchmark wedge counters),
  * synthetic generators (Erdos-Renyi and Chung-Lu power-law, the shape of
    the KONECT datasets used in the paper) plus the paper's Fig.1 example.

Everything here is host-side preprocessing: numpy only, no torch.
(``repro_torch.api.errors`` is a stdlib-only leaf module.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..api.errors import GraphValidationError

__all__ = [
    "BipartiteGraph",
    "TiledGraph",
    "random_bipartite",
    "powerlaw_bipartite",
    "paper_fig1_graph",
    "pad_to_multiple",
]


def pad_to_multiple(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x`` (and >= m)."""
    return max(m, ((x + m - 1) // m) * m)


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """Immutable bipartite graph container.

    Attributes
    ----------
    n_u, n_v : int       sizes of the two vertex sets.
    edges_u, edges_v :   int32[m] endpoint arrays (parallel).  Deduplicated,
                         sorted by (u, v).
    """

    n_u: int
    n_v: int
    edges_u: np.ndarray
    edges_v: np.ndarray

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_edges(n_u: int, n_v: int, eu, ev) -> "BipartiteGraph":
        eu = np.asarray(eu, dtype=np.int32)
        ev = np.asarray(ev, dtype=np.int32)
        if eu.size:
            if eu.min() < 0 or eu.max() >= n_u:
                raise GraphValidationError("U endpoint out of range")
            if ev.min() < 0 or ev.max() >= n_v:
                raise GraphValidationError("V endpoint out of range")
        # dedup + canonical sort
        key = eu.astype(np.int64) * n_v + ev.astype(np.int64)
        key = np.unique(key)
        eu = (key // n_v).astype(np.int32)
        ev = (key % n_v).astype(np.int32)
        return BipartiteGraph(n_u=n_u, n_v=n_v, edges_u=eu, edges_v=ev)

    @staticmethod
    def from_dense(a, *, binarize: bool = False) -> "BipartiteGraph":
        """Graph from a dense 0/1 biadjacency matrix (rows = U, cols = V).

        Accepts bool or numeric arrays; any entry other than 0 or 1 is
        rejected (weighted matrices have no butterfly semantics here).
        NaN/inf entries and zero-size sides are always rejected.
        ``binarize=True`` is the escape hatch for score/weight matrices:
        every finite nonzero entry becomes an edge.
        """
        a = np.asarray(a)
        if a.ndim != 2:
            raise GraphValidationError(
                f"from_dense expects a 2-D biadjacency matrix, got shape "
                f"{a.shape}")
        if a.shape[0] == 0 or a.shape[1] == 0:
            raise GraphValidationError(
                f"from_dense got a zero-size side (shape {a.shape}); an "
                "empty vertex set has no dense biadjacency — construct an "
                "edgeless graph explicitly with from_edges(n_u, n_v, [], [])")
        if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            raise GraphValidationError(
                f"from_dense found {bad} NaN/inf entr"
                f"{'y' if bad == 1 else 'ies'}; a biadjacency matrix must "
                "be finite (binarize=True does not rescue non-finite input)")
        if not binarize and a.dtype != bool:
            nz = a[a != 0]
            if not np.isin(nz, [1]).all():
                n_neg = int((nz < 0).sum()) if np.issubdtype(
                    a.dtype, np.number) else 0
                detail = (f"including {n_neg} negative entr"
                          f"{'y' if n_neg == 1 else 'ies'}; "
                          if n_neg else "")
                raise GraphValidationError(
                    "from_dense expects a 0/1 (or bool) biadjacency matrix; "
                    f"found entries other than 0 and 1 ({detail}weighted "
                    "matrices have no butterfly semantics — pass "
                    "binarize=True to treat every nonzero as an edge)")
        eu, ev = np.nonzero(a)
        return BipartiteGraph.from_edges(a.shape[0], a.shape[1], eu, ev)

    # ------------------------------------------------------------------ #
    # structural integrity
    # ------------------------------------------------------------------ #
    def validate(self) -> "BipartiteGraph":
        """Structural integrity check; returns ``self`` or raises
        ``GraphValidationError``.

        ``from_edges``/``from_dense`` construct valid graphs, but the
        dataclass is directly constructible (fleet inputs may arrive
        deserialized), so the Executor re-checks before batching: sizes
        non-negative, edge arrays integer / parallel / in range.
        """
        if not (isinstance(self.n_u, (int, np.integer))
                and isinstance(self.n_v, (int, np.integer))):
            raise GraphValidationError(
                f"vertex-set sizes must be ints (got n_u="
                f"{type(self.n_u).__name__}, n_v={type(self.n_v).__name__})")
        if self.n_u < 0 or self.n_v < 0:
            raise GraphValidationError(
                f"vertex-set sizes must be >= 0 (got n_u={self.n_u}, "
                f"n_v={self.n_v})")
        eu, ev = np.asarray(self.edges_u), np.asarray(self.edges_v)
        if eu.ndim != 1 or ev.ndim != 1 or eu.shape != ev.shape:
            raise GraphValidationError(
                f"edge endpoint arrays must be parallel 1-D (got shapes "
                f"{eu.shape} and {ev.shape})")
        if eu.size and not (np.issubdtype(eu.dtype, np.integer)
                            and np.issubdtype(ev.dtype, np.integer)):
            raise GraphValidationError(
                f"edge endpoints must be integers (got dtypes {eu.dtype}, "
                f"{ev.dtype})")
        if eu.size:
            if eu.min() < 0 or eu.max() >= self.n_u:
                raise GraphValidationError(
                    f"U endpoint out of range [0, {self.n_u}) "
                    f"(min={eu.min()}, max={eu.max()})")
            if ev.min() < 0 or ev.max() >= self.n_v:
                raise GraphValidationError(
                    f"V endpoint out of range [0, {self.n_v}) "
                    f"(min={ev.min()}, max={ev.max()})")
        return self

    # ------------------------------------------------------------------ #
    # basic accessors
    # ------------------------------------------------------------------ #
    @property
    def m(self) -> int:
        return int(self.edges_u.size)

    def degrees_u(self) -> np.ndarray:
        return np.bincount(self.edges_u, minlength=self.n_u).astype(np.int64)

    def degrees_v(self) -> np.ndarray:
        return np.bincount(self.edges_v, minlength=self.n_v).astype(np.int64)

    def csr_u(self) -> Tuple[np.ndarray, np.ndarray]:
        """CSR over U: (indptr[n_u+1], indices -> v ids), rows sorted."""
        order = np.lexsort((self.edges_v, self.edges_u))
        indptr = np.zeros(self.n_u + 1, dtype=np.int64)
        np.add.at(indptr, self.edges_u + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, self.edges_v[order].astype(np.int32)

    def csr_v(self) -> Tuple[np.ndarray, np.ndarray]:
        """CSR over V: (indptr[n_v+1], indices -> u ids), rows sorted."""
        order = np.lexsort((self.edges_u, self.edges_v))
        indptr = np.zeros(self.n_v + 1, dtype=np.int64)
        np.add.at(indptr, self.edges_v + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, self.edges_u[order].astype(np.int32)

    # ------------------------------------------------------------------ #
    # paper metrics
    # ------------------------------------------------------------------ #
    def wedge_counts_u(self) -> np.ndarray:
        """w[u] = #wedges with endpoint u = sum_{v in N_u} (d_v - 1).

        This is the paper's per-vertex workload proxy (Alg. 3 input ``w``);
        summed over U it equals twice the number of (U,U) wedges and is the
        exact amount of wedge *traversal* BUP performs to peel all of U.
        """
        dv = self.degrees_v()
        w = np.zeros(self.n_u, dtype=np.int64)
        np.add.at(w, self.edges_u, dv[self.edges_v] - 1)
        return w

    def total_wedges_u(self) -> int:
        """Number of wedges with both endpoints in U: sum_v C(d_v, 2)."""
        dv = self.degrees_v()
        return int((dv * (dv - 1) // 2).sum())

    def counting_wedge_bound(self) -> int:
        """Chiba-Nishizeki counting bound: sum_{(u,v) in E} min(d_u, d_v).

        The paper's ``C_rcnt`` — the wedge-traversal cost of one full
        per-vertex butterfly recount (HUC's alternative path).
        """
        du = self.degrees_u()
        dv = self.degrees_v()
        return int(np.minimum(du[self.edges_u], dv[self.edges_v]).sum())

    # ------------------------------------------------------------------ #
    # reorder / views
    # ------------------------------------------------------------------ #
    def transposed(self) -> "BipartiteGraph":
        """Swap the vertex sets (U <-> V).  Tip-decomposing the transpose
        peels the other side — exact by symmetry (Table 3's *V rows)."""
        return BipartiteGraph.from_edges(
            self.n_v, self.n_u, self.edges_v, self.edges_u)

    def relabel_by_degree(self) -> "BipartiteGraph":
        """Relabel both sides in descending-degree order (Wang et al.).

        This concentrates nonzeros into leading tiles so the blocked
        kernels' stripe skip fires more often.
        """
        du, dv = self.degrees_u(), self.degrees_v()
        pu = np.argsort(-du, kind="stable")
        pv = np.argsort(-dv, kind="stable")
        inv_u = np.empty(self.n_u, dtype=np.int32)
        inv_v = np.empty(self.n_v, dtype=np.int32)
        inv_u[pu] = np.arange(self.n_u, dtype=np.int32)
        inv_v[pv] = np.arange(self.n_v, dtype=np.int32)
        return BipartiteGraph.from_edges(
            self.n_u, self.n_v, inv_u[self.edges_u], inv_v[self.edges_v]
        )

    def dense(self, dtype=np.float32, pad_u: int = 1, pad_v: int = 1) -> np.ndarray:
        """Dense 0/1 biadjacency, optionally padded to tile multiples."""
        nu = pad_to_multiple(self.n_u, pad_u)
        nv = pad_to_multiple(self.n_v, pad_v)
        a = np.zeros((nu, nv), dtype=dtype)
        a[self.edges_u, self.edges_v] = 1
        return a

    def induced_on_u(
        self, members: np.ndarray, *, min_degree_v: int = 1
    ) -> Tuple["BipartiteGraph", np.ndarray]:
        """Subgraph induced on ``members`` (subset of U) and all of V,
        with V compacted to columns that still have an edge (the paper's
        FD subgraph induction + our DGM column compaction in one step).

        ``min_degree_v`` additionally drops V columns whose *residual*
        degree falls below the bound — the CD engine passes 2, since a
        degree-<2 column cannot complete a wedge (DGM, DESIGN.md
        section 2).  One pass suffices: dropping a column never changes
        another column's degree.

        Returns (subgraph, v_map) where ``v_map[j]`` is the original V id of
        compacted column j.
        """
        members = np.asarray(members)
        keep = np.zeros(self.n_u, dtype=bool)
        keep[members] = True
        sel = keep[self.edges_u]
        eu, ev = self.edges_u[sel], self.edges_v[sel]
        if min_degree_v > 1 and len(ev):
            dv = np.bincount(ev, minlength=self.n_v)
            good = dv[ev] >= min_degree_v
            eu, ev = eu[good], ev[good]
        # compact U ids to 0..len(members)-1 in the order given
        u_map = np.full(self.n_u, -1, dtype=np.int64)
        u_map[members] = np.arange(len(members))
        v_used = np.unique(ev)
        v_map_inv = np.full(self.n_v, -1, dtype=np.int64)
        v_map_inv[v_used] = np.arange(len(v_used))
        sub = BipartiteGraph.from_edges(
            len(members), len(v_used), u_map[eu], v_map_inv[ev]
        )
        return sub, v_used.astype(np.int32)


# ---------------------------------------------------------------------- #
# blocked-sparse (tiled CSR) representation
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class TiledGraph:
    """Blocked-sparse biadjacency: only the NONZERO ``[block_rows x
    block_k]`` tiles of the padded dense matrix, in CSR-of-tiles order.

    The dense representation costs ``rows_pad * cols_pad`` cells no
    matter how sparse the graph is; real bipartite graphs (power-law
    KONECT regimes) have ``m << n_u * n_v``, so after degree-descending
    relabeling the nonzero tiles are a small fraction of the grid.  This
    container stores exactly those tiles plus the index structure the
    tiled kernel (kernel 6, ``kernels/butterfly_tiled``) walks:

    ``tile_data``  float32[n_slots, block_rows, block_k] tile payloads.
    ``srow``       int32[n_slots] row-tile id per slot (non-decreasing).
    ``scol``       int32[n_slots] column-tile id per slot (sorted within
                   a row-tile).
    ``sptr``       int32[n_row_tiles + 1] CSR pointers over slots.
    ``pos``        int32[n_row_tiles, n_col_tiles] reverse map: the slot
                   holding tile (i, k), or -1 when that tile is zero.

    Every row-tile owns at least one slot (an explicit zero tile at
    column-tile 0 when the row band is empty) so a kernel iterating the
    slot list initializes and flushes every output block.  Tile ids are
    over the PADDED shape — ``rows_pad = pad_to_multiple(n_u,
    block_rows)``, ``cols_pad = pad_to_multiple(n_v, block_k)`` — so a
    ``TiledGraph`` and ``BipartiteGraph.dense(pad_u=block_rows,
    pad_v=block_k)`` describe bit-identical matrices.
    """

    n_u: int
    n_v: int
    block_rows: int
    block_k: int
    tile_data: np.ndarray
    srow: np.ndarray
    scol: np.ndarray
    sptr: np.ndarray
    pos: np.ndarray

    # ------------------------------------------------------------------ #
    @staticmethod
    def from_graph(g: "BipartiteGraph", *, block_rows: int,
                   block_k: int, rows_pad: Optional[int] = None,
                   cols_pad: Optional[int] = None,
                   pad_slots_to: Optional[int] = None) -> "TiledGraph":
        """Build the tiled form of ``g`` from its edge list (CSR order).

        ``rows_pad`` / ``cols_pad`` override the minimal padded shape
        (must be block multiples covering the graph) and ``pad_slots_to``
        appends inert filler slots to the LAST row band — all three are
        the reference's executable-cache quantization hooks (its Planner
        buckets them), kept so both packages build the same slot lists
        from the same arguments.  Filler slots carry zero
        tiles, are absent from ``pos`` (never gathered as B tiles) and
        report dead in the slot liveness, so they change no result.
        """
        if block_rows < 1 or block_k < 1:
            raise GraphValidationError(
                f"tile blocks must be >= 1 (got block_rows={block_rows}, "
                f"block_k={block_k})")
        min_rows = pad_to_multiple(max(g.n_u, 1), block_rows)
        min_cols = pad_to_multiple(max(g.n_v, 1), block_k)
        rows_pad = min_rows if rows_pad is None else int(rows_pad)
        cols_pad = min_cols if cols_pad is None else int(cols_pad)
        if (rows_pad < min_rows or cols_pad < min_cols
                or rows_pad % block_rows or cols_pad % block_k):
            raise GraphValidationError(
                f"padded shape ({rows_pad}, {cols_pad}) must be block "
                f"multiples covering ({min_rows}, {min_cols})")
        n_rt = rows_pad // block_rows
        n_ct = cols_pad // block_k
        eu, ev = g.edges_u, g.edges_v
        rt = eu.astype(np.int64) // block_rows
        ct = ev.astype(np.int64) // block_k
        key = rt * n_ct + ct
        occupied = np.unique(key)
        # every row-tile gets >= 1 slot: empty bands carry an explicit
        # zero tile at column-tile 0 so the kernel's per-band output
        # lifecycle (zero at first slot, flush at last) always fires
        have = np.zeros(n_rt, dtype=bool)
        have[(occupied // n_ct).astype(np.int64)] = True
        filler = np.where(~have)[0].astype(np.int64) * n_ct
        keys = np.sort(np.concatenate([occupied, filler]))
        n_real = int(keys.size)
        n_slots = max(n_real, int(pad_slots_to or 0))
        slot_of = np.searchsorted(keys, key)
        tile_data = np.zeros((n_slots, block_rows, block_k), np.float32)
        tile_data[slot_of, eu % block_rows, ev % block_k] = 1.0
        srow = np.full(n_slots, n_rt - 1, dtype=np.int32)
        srow[:n_real] = (keys // n_ct).astype(np.int32)
        scol = np.zeros(n_slots, dtype=np.int32)
        scol[:n_real] = (keys % n_ct).astype(np.int32)
        sptr = np.zeros(n_rt + 1, dtype=np.int32)
        np.add.at(sptr, srow + 1, 1)
        np.cumsum(sptr, out=sptr)
        pos = np.full((n_rt, n_ct), -1, dtype=np.int32)
        pos[srow[:n_real], scol[:n_real]] = np.arange(n_real, dtype=np.int32)
        return TiledGraph(
            n_u=g.n_u, n_v=g.n_v, block_rows=block_rows, block_k=block_k,
            tile_data=tile_data, srow=srow, scol=scol, sptr=sptr, pos=pos)

    # ------------------------------------------------------------------ #
    @property
    def rows_pad(self) -> int:
        return self.pos.shape[0] * self.block_rows

    @property
    def cols_pad(self) -> int:
        return self.pos.shape[1] * self.block_k

    @property
    def n_row_tiles(self) -> int:
        return self.pos.shape[0]

    @property
    def n_col_tiles(self) -> int:
        return self.pos.shape[1]

    @property
    def n_slots(self) -> int:
        return int(self.srow.size)

    @property
    def m(self) -> int:
        return int(self.tile_data.sum())

    def fill_ratio(self) -> float:
        """Fraction of the tile grid that is materialized (the cost-model
        density input: dense work / tiled work ~ 1 / fill_ratio)."""
        return self.n_slots / float(self.n_row_tiles * self.n_col_tiles)

    def tiled_bytes(self) -> int:
        """Device bytes of the representation itself (payload + maps)."""
        return int(self.tile_data.nbytes + self.srow.nbytes
                   + self.scol.nbytes + self.sptr.nbytes + self.pos.nbytes)

    def dense_bytes(self) -> int:
        """Bytes the padded dense biadjacency would cost (float32)."""
        return 4 * self.rows_pad * self.cols_pad

    # ------------------------------------------------------------------ #
    def dense(self, dtype=np.float32) -> np.ndarray:
        """Reassemble the padded dense biadjacency (tests / oracle)."""
        a = np.zeros((self.rows_pad, self.cols_pad), dtype=dtype)
        bi, bk = self.block_rows, self.block_k
        for s in range(self.n_slots):
            i, k = int(self.srow[s]), int(self.scol[s])
            # accumulate: real slots are unique per (i, k); filler slots
            # alias (n_rt-1, 0) with zero payloads and must stay inert
            a[i * bi:(i + 1) * bi, k * bk:(k + 1) * bk] += self.tile_data[s]
        return a

    def to_csr_u(self) -> Tuple[np.ndarray, np.ndarray]:
        """Reconstruct ``BipartiteGraph.csr_u()`` from the tiles — the
        round-trip surface the property suite checks."""
        s, r, c = np.nonzero(self.tile_data)
        u = self.srow[s].astype(np.int64) * self.block_rows + r
        v = self.scol[s].astype(np.int64) * self.block_k + c
        order = np.lexsort((v, u))
        u, v = u[order], v[order]
        indptr = np.zeros(self.n_u + 1, dtype=np.int64)
        np.add.at(indptr, u + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, v.astype(np.int32)


# ---------------------------------------------------------------------- #
# generators
# ---------------------------------------------------------------------- #
def random_bipartite(
    n_u: int, n_v: int, p: float, seed: int = 0
) -> BipartiteGraph:
    """Erdos-Renyi bipartite G(n_u, n_v, p)."""
    rng = np.random.default_rng(seed)
    a = rng.random((n_u, n_v)) < p
    eu, ev = np.nonzero(a)
    return BipartiteGraph.from_edges(n_u, n_v, eu, ev)


def powerlaw_bipartite(
    n_u: int,
    n_v: int,
    m_target: int,
    alpha_u: float = 2.0,
    alpha_v: float = 2.0,
    seed: int = 0,
) -> BipartiteGraph:
    """Chung-Lu style bipartite graph with power-law expected degrees.

    Mirrors the heavy-tailed degree structure of the KONECT datasets the
    paper evaluates (few huge-degree hubs -> extreme max tip numbers).
    """
    rng = np.random.default_rng(seed)
    wu = (np.arange(1, n_u + 1, dtype=np.float64)) ** (-1.0 / (alpha_u - 1.0))
    wv = (np.arange(1, n_v + 1, dtype=np.float64)) ** (-1.0 / (alpha_v - 1.0))
    wu *= m_target / wu.sum()
    wv *= m_target / wv.sum()
    # sample edges proportional to wu[u] * wv[v]
    pu = wu / wu.sum()
    pv = wv / wv.sum()
    # oversample; dedup inside from_edges
    k = int(m_target * 1.3) + 16
    eu = rng.choice(n_u, size=k, p=pu)
    ev = rng.choice(n_v, size=k, p=pv)
    g = BipartiteGraph.from_edges(n_u, n_v, eu, ev)
    return g


def paper_fig1_graph() -> BipartiteGraph:
    """A 4x5 example matching the paper's Fig.1 caption.

    U = {u1..u4} (ids 0..3), V = {v1..v5} (ids 0..4).  Edges reconstructed
    so butterfly counts match the caption exactly: u4 participates in 1
    butterfly, u1 in 2; u3 participates in 5 butterflies in G of which 3
    are shared with u2, with which it forms a 3-tip.

    Butterfly counts: [2, 4, 5, 1].  Tip numbers: theta = [2, 3, 3, 1].
    """
    # u1: v1 v2 | u2: v1 v2 v3 | u3: v1 v2 v3 v4 v5 | u4: v4 v5
    eu = [0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3]
    ev = [0, 1, 0, 1, 2, 0, 1, 2, 3, 4, 3, 4]
    return BipartiteGraph.from_edges(4, 5, eu, ev)

"""The port's tiled slice against the reference: ``TiledGraph``, the
tile-list helpers, kernel 6's plain version and the tiled engine.

Each case is built once with numpy and handed to both packages.  The
reference runs its ``xla`` backend (and kernel 6 itself under the Pallas
interpreter, ``interpret=True``); the port runs ``torch`` with kernel
blocks (8, 8, 8), so both lay the graph out in 8 x 8 tiles.  Every
comparison is bit-equal: the f32 integer regime (DESIGN.md section 8)
makes the arithmetic exact in any order.  Kernel 6 itself is held against
its plain version on the card by tests/test_torch_gpu.py.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import GRAPH_CASES
from test_tiled import _masks
from repro.core.engine import ReceiptConfig as JConfig
from repro.core.engine import tip_decompose as j_tip_decompose
from repro.core.engine.tiled import build_tiled as j_build_tiled
from repro.core.graph import TiledGraph as JTiledGraph
from repro.core.peeling import bup_oracle
from repro.kernels import butterfly_tiled as jk
from repro_torch.api.errors import GraphValidationError
from repro_torch.convert import config_from_fields, graph_from_arrays
from repro_torch.core import receipt as treceipt
from repro_torch.core.engine import peel_loop as tpl
from repro_torch.core.engine import tiled as ttiled
from repro_torch.core.graph import TiledGraph as TTiledGraph
from repro_torch.kernels import butterfly_tiled as tk
from repro_torch.kernels import ops as tops

BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")
TILED_COUNTERS = ("rho_fd", "wedges_fd", "dgm_compactions",
                  "dgm_device_compactions", "num_subsets",
                  "sweeps_per_subset", "subset_sizes", "wedges_pvbcnt",
                  "rho_cd", "wedges_cd")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: its CPU tensors are small, and
    the test workers' thread pools would otherwise oversubscribe the
    cores (each pool spins while it waits)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_graph(g):
    return graph_from_arrays(g.n_u, g.n_v, g.edges_u, g.edges_v)


def _configs(**kw):
    """The reference's config (backend ``xla``) and the port's (``torch``),
    from the same fields."""
    jcfg = JConfig(backend="xla", kernel_blocks=BLOCKS, **kw)
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    return jcfg, config_from_fields(fields)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lists(g, blocks=(8, 8), pad_slots_to=None):
    """One slot list, built by both packages: (reference TiledGraph, its
    jnp arrays, the port's tensors)."""
    jt = JTiledGraph.from_graph(g, block_rows=blocks[0], block_k=blocks[1],
                                pad_slots_to=pad_slots_to)
    tt = TTiledGraph.from_graph(_port_graph(g), block_rows=blocks[0],
                                block_k=blocks[1], pad_slots_to=pad_slots_to)
    td = jnp.asarray(jt.tile_data)
    jargs = (td, jnp.asarray(jt.srow), jnp.asarray(jt.scol),
             jnp.asarray(jt.sptr), jnp.asarray(jt.pos), jk.slot_liveness(td))
    tdt = _t(tt.tile_data)
    targs = (tdt, _t(tt.srow), _t(tt.scol), _t(tt.sptr), _t(tt.pos),
             tk.slot_liveness(tdt))
    return jt, jargs, targs


# ---------------------------------------------------------------------- #
# TiledGraph
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("blocks", [(8, 8), (8, 16), (16, 8)])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_tiled_graph_matches_reference(case, blocks, pad):
    g = GRAPH_CASES[case]()
    br, bk = blocks
    jt = JTiledGraph.from_graph(g, block_rows=br, block_k=bk)
    slots = jt.n_slots + 13 if pad else None
    if pad:
        jt = JTiledGraph.from_graph(g, block_rows=br, block_k=bk,
                                    pad_slots_to=slots)
    tt = TTiledGraph.from_graph(_port_graph(g), block_rows=br, block_k=bk,
                                pad_slots_to=slots)
    for name in ("tile_data", "srow", "scol", "sptr", "pos"):
        want, got = getattr(jt, name), getattr(tt, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("rows_pad", "cols_pad", "n_row_tiles", "n_col_tiles",
                 "n_slots", "m"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt.fill_ratio() == jt.fill_ratio()
    assert tt.tiled_bytes() == jt.tiled_bytes()
    assert tt.dense_bytes() == jt.dense_bytes()
    np.testing.assert_array_equal(tt.dense(), jt.dense())
    for got, want in zip(tt.to_csr_u(), jt.to_csr_u()):
        np.testing.assert_array_equal(got, want)


def test_tiled_graph_rejects_bad_geometry():
    g = _port_graph(GRAPH_CASES["fig1"]())
    with pytest.raises(GraphValidationError, match="blocks must be >= 1"):
        TTiledGraph.from_graph(g, block_rows=0, block_k=8)
    with pytest.raises(GraphValidationError, match="block"):
        TTiledGraph.from_graph(g, block_rows=8, block_k=8, rows_pad=12)


@pytest.mark.parametrize("case", ["powerlaw", "vhub"])
def test_build_tiled_matches_reference_layout(case):
    """``tiled_blocks`` is ``(max(bi, bj), bk)`` for every port backend,
    the reference's rule for its kernel backends, so ``build_tiled`` lays
    the graph out as the reference's ``interpret`` backend does."""
    g = GRAPH_CASES[case]()
    for blocks in [(8, 8, 8), (8, 16, 32)]:
        jcfg = JConfig(backend="interpret", kernel_blocks=blocks)
        for backend in ("torch", "torch_sparse"):
            tcfg = tpl.ReceiptConfig(backend=backend, kernel_blocks=blocks)
            assert ttiled.tiled_blocks(tcfg) == (max(blocks[:2]), blocks[2])
            jt = j_build_tiled(g, jcfg)
            tt = ttiled.build_tiled(_port_graph(g), tcfg)
            for name in ("tile_data", "srow", "scol", "sptr", "pos"):
                np.testing.assert_array_equal(getattr(tt, name),
                                              getattr(jt, name))


# ---------------------------------------------------------------------- #
# the tile-list helpers
# ---------------------------------------------------------------------- #
HELPER_CASES = ["fig1", "er_small", "powerlaw", "empty_edges", "star"]


@pytest.mark.parametrize("case", HELPER_CASES)
def test_helpers_match_reference(case):
    """``slot_liveness``, ``colsum_tiled``, ``row_weights_tiled`` and
    ``masked_colsum_tiled`` on the reference's mask battery, which spans
    the 16/17-row boundary of the reference's gathered form (the port's
    full form equals both of the reference's)."""
    g = GRAPH_CASES[case]()
    jt, jargs, targs = _lists(g)
    td, srow, scol, _sptr, pos, sl = jargs
    ttd, tsrow, tscol, _tsptr, tpos, tsl = targs
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(sl))
    dv = jk.colsum_tiled(td, scol, jt.n_col_tiles)
    tdv = tk.colsum_tiled(ttd, tscol, jt.n_col_tiles)
    np.testing.assert_array_equal(tdv.numpy(), np.asarray(dv))
    np.testing.assert_array_equal(
        tk.row_weights_tiled(ttd, tsrow, tscol, tdv - 1.0,
                             jt.n_row_tiles).numpy(),
        np.asarray(jk.row_weights_tiled(td, srow, scol, dv - 1.0,
                                        jt.n_row_tiles)))
    for name, s in _masks(jt.rows_pad, seed=17).items():
        want = np.asarray(jk.masked_colsum_tiled(td, srow, scol, pos,
                                                 jnp.asarray(s)))
        got = tk.masked_colsum_tiled(ttd, tsrow, tscol, tpos, _t(s))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("case", HELPER_CASES)
def test_regather_matches_reference_in_place(case):
    g = GRAPH_CASES[case]()
    jt, jargs, targs = _lists(g)
    rng = np.random.default_rng(21)
    rows = (rng.random(jt.rows_pad) < 0.6).astype(np.float32)
    cols = (rng.random(jt.cols_pad) < 0.6).astype(np.float32)
    want_td, want_sl = jk.regather_tiles(jargs[0], jargs[1], jargs[2],
                                         jnp.asarray(rows), jnp.asarray(cols))
    ttd = targs[0]
    got_td, got_sl = tk.regather_tiles(ttd, targs[1], targs[2], _t(rows),
                                       _t(cols))
    assert got_td.data_ptr() == ttd.data_ptr()      # rewritten in place
    np.testing.assert_array_equal(got_td.numpy(), np.asarray(want_td))
    np.testing.assert_array_equal(got_sl.numpy(), np.asarray(want_sl))


# ---------------------------------------------------------------------- #
# kernel 6: the plain version
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["fig1", "er_small", "powerlaw", "vhub",
                                  "empty_edges", "star"])
def test_plain_matches_streaming_oracle(case):
    """Both paths of the plain version (chosen by the nonzero count, or by
    counting the mask) against ``butterfly_update_tiled_xla``, on live
    slot lists, after a regather left dead slots, and with filler slots;
    through ``ops`` on both CPU backend names too."""
    g = GRAPH_CASES[case]()
    jt, jargs, targs = _lists(g, pad_slots_to=None)
    rng = np.random.default_rng(5)
    rows = (rng.random(jt.rows_pad) < 0.7).astype(np.float32)
    cols = (rng.random(jt.cols_pad) < 0.7).astype(np.float32)
    jre = jk.regather_tiles(jargs[0], jargs[1], jargs[2], jnp.asarray(rows),
                            jnp.asarray(cols))
    tre = tk.regather_tiles(targs[0].clone(), targs[1], targs[2], _t(rows),
                            _t(cols))
    if case in ("er_small", "powerlaw", "vhub"):
        assert int(tre[1].sum()) < int(targs[5].sum())   # slots died
    _, jpad, tpad = _lists(g, pad_slots_to=jt.n_slots + 5)
    variants = {"live": (jargs, targs),
                "regathered": ((jre[0], *jargs[1:5], jre[1]),
                               (tre[0], *targs[1:5], tre[1])),
                "filler": (jpad, tpad)}
    for vname, (ja, ta) in variants.items():
        for name, s in _masks(jt.rows_pad, seed=11).items():
            want = np.asarray(jk.butterfly_update_tiled_xla(*ja,
                                                            jnp.asarray(s)))
            nz = int((s != 0).sum())
            for hint in (None, nz):
                got = tk.butterfly_update_tiled_plain(*ta, _t(s),
                                                      n_srows=hint)
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{vname} {name}")
            for backend in ("torch", "torch_sparse", None):
                got = tops.butterfly_update_tiled(*ta, _t(s), backend=backend)
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["fig1", "er_small", "powerlaw"])
def test_plain_matches_pallas_interpret(case):
    """Kernel 6's Pallas body under the interpreter, on the same battery
    (live slots and, after a regather, dead ones)."""
    g = GRAPH_CASES[case]()
    jt, jargs, targs = _lists(g)
    rng = np.random.default_rng(8)
    rows = (rng.random(jt.rows_pad) < 0.7).astype(np.float32)
    cols = (rng.random(jt.cols_pad) < 0.8).astype(np.float32)
    jre = jk.regather_tiles(jargs[0], jargs[1], jargs[2], jnp.asarray(rows),
                            jnp.asarray(cols))
    tre = tk.regather_tiles(targs[0].clone(), targs[1], targs[2], _t(rows),
                            _t(cols))
    for ja, ta in ((jargs, targs), ((jre[0], *jargs[1:5], jre[1]),
                                    (tre[0], *targs[1:5], tre[1]))):
        for name, s in _masks(jt.rows_pad, seed=13).items():
            want = np.asarray(jk.butterfly_update_pallas_tiled(
                *ja, jnp.asarray(s), interpret=True))
            got = tk.butterfly_update_tiled_plain(*ta, _t(s))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_cpu_tensors_take_the_plain_version_uncounted():
    g = GRAPH_CASES["powerlaw"]()
    _, _, targs = _lists(g)
    tops.reset_launch_counts()
    s = torch.ones(targs[4].shape[0] * 8)
    tops.butterfly_update_tiled(*targs, s)
    assert tops.launch_counts()["butterfly_update_tiled"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.butterfly_update_tiled(*targs, s, backend="cuda")


def test_wrapper_checks_reject_bad_inputs():
    g = GRAPH_CASES["powerlaw"]()
    _, _, (td, srow, scol, sptr, pos, sl) = _lists(g)
    s = torch.ones(pos.shape[0] * 8)
    tk._check(td, srow, scol, sptr, pos, sl, s)
    with pytest.raises(TypeError, match="int32"):
        tk._check(td, srow.long(), scol, sptr, pos, sl, s)
    with pytest.raises(ValueError, match="shape"):
        tk._check(td, srow, scol, sptr[:-1], pos, sl, s)
    with pytest.raises(ValueError, match="shape"):
        tk._check(td, srow, scol, sptr, pos, sl, s[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        tk._check(td.transpose(1, 2).contiguous().transpose(1, 2), srow,
                  scol, sptr, pos, sl, s)
    with pytest.raises(ValueError, match="tile_data must be"):
        tk._check(td[0], srow, scol, sptr, pos, sl, s)


# ---------------------------------------------------------------------- #
# the tiled engine end to end
# ---------------------------------------------------------------------- #
# the rebuild-after-every-sweep cadence (1, 0.9) is held against the
# reference in tests/test_torch_tiled_rebuild.py: its reference runs
# recompile at every rebuild, so it gets a file (and a test worker) of
# its own
CADENCES = {
    "every2_r0.5": dict(tiled_compact_every=2, tiled_compact_ratio=0.5),
    "every64_r0": dict(tiled_compact_every=64, tiled_compact_ratio=0.0),
    "max_sweeps3": dict(max_sweeps=3),
}


@functools.lru_cache(maxsize=None)
def _port_dense(case, side):
    _, tcfg = _configs()
    return treceipt.tip_decompose(_port_graph(GRAPH_CASES[case]()), tcfg,
                                  side=side, device=CPU)[0]


def assert_tiled_path_matches_reference(case, side, **cadence):
    """Theta and the tiled counters equal the reference's
    ``representation="tiled"`` run; theta also equals ``bup_oracle`` and
    the port's dense path."""
    g = GRAPH_CASES[case]()
    jcfg, tcfg = _configs(representation="tiled", **cadence)
    j_theta, j_stats = j_tip_decompose(g, jcfg, side=side)
    t_theta, t_stats = treceipt.tip_decompose(_port_graph(g), tcfg,
                                              side=side, device=CPU)
    np.testing.assert_array_equal(t_theta, j_theta)
    np.testing.assert_array_equal(
        t_theta, bup_oracle(g if side == "U" else g.transposed())[0])
    np.testing.assert_array_equal(t_theta, _port_dense(case, side))
    for key in TILED_COUNTERS:
        assert getattr(t_stats, key) == getattr(j_stats, key), key
    assert t_stats.overflow_fallbacks == 0


@pytest.mark.parametrize("cadence", sorted(CADENCES))
@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_tiled_path_matches_reference(case, side, cadence):
    """The cadences rebuild the slot list every second sweep once half the
    rows are gone, never (64-sweep segments, no recompaction), and cap
    every segment at 3 sweeps (the ``max_sweeps`` valve)."""
    assert_tiled_path_matches_reference(case, side, **CADENCES[cadence])


def test_cadences_rebuild_and_regather():
    """The counters compared above are not all trivial: on the power-law
    graph the tiled path rebuilds its slot list and regathers."""
    _, tcfg = _configs(representation="tiled", tiled_compact_every=2,
                       tiled_compact_ratio=0.5, tiled_regather_every=2)
    g = _port_graph(GRAPH_CASES["powerlaw"]())
    theta, stats = treceipt.tip_decompose(g, tcfg, device=CPU)
    assert stats.dgm_compactions > 1 and stats.dgm_device_compactions > 0
    assert stats.rho_fd > stats.device_loop_calls > 1
    np.testing.assert_array_equal(theta, _port_dense("powerlaw", "U"))


class _NoHostReads(torch.utils._python_dispatch.TorchDispatchMode):
    """Raise on every op that reads a tensor's value on the host or sizes
    a result by the data (``.item()``, ``bool()``, an index by a 0-dim
    tensor, an unsized ``nonzero``): on a CUDA tensor each would wait for
    the card."""

    READS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::item",
             "aten::is_nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.READS:
            raise AssertionError(f"uncounted host read in a sweep: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("regather_every", [1, 3])
def test_a_sweep_reads_only_through_fetch(regather_every, monkeypatch):
    """The reads of one tiled sweep are exactly the ones that
    ``host_round_trips`` counts: each sweep calls ``fetch`` once (the
    peel-set and alive sizes) and makes no other read; the only other
    ``fetch`` is the one at each segment's end."""
    sweep, fetch = ttiled._tiled_sweep, ttiled.fetch
    per_sweep, fetches = [], []

    def counted_fetch(*args, **kwargs):
        fetches.append(1)
        return fetch(*args, **kwargs)

    def watched(*args, **kwargs):
        before = len(fetches)
        with _NoHostReads():
            out = sweep(*args, **kwargs)
        per_sweep.append(len(fetches) - before)
        return out

    monkeypatch.setattr(ttiled, "fetch", counted_fetch)
    monkeypatch.setattr(ttiled, "_tiled_sweep", watched)
    _, tcfg = _configs(representation="tiled", tiled_compact_every=16,
                       tiled_regather_every=regather_every)
    g = _port_graph(GRAPH_CASES["powerlaw"]())
    theta, stats = treceipt.tip_decompose(g, tcfg, device=CPU)
    np.testing.assert_array_equal(theta, _port_dense("powerlaw", "U"))
    assert per_sweep and set(per_sweep) == {1}
    assert stats.host_round_trips == len(fetches)
    assert len(fetches) == len(per_sweep) + stats.device_loop_calls

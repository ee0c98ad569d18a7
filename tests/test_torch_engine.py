"""The port's main paths (count -> CD -> FD) against the reference engine.

Each case is built once with numpy and handed to both packages through
``repro_torch.convert``.  On the CPU the port runs its kernels' plain
versions (``torch``, and ``torch_sparse`` for the staircase kernels), the
reference runs its ``xla`` backend (the stripe skip is exact, so theta and
every counter are backend-independent), both with kernel blocks (8, 8, 8).
Theta must be bit-identical to the reference and to ``bup_oracle``; the
paper's counters must be equal, under both CD dispatches.
``host_round_trips``, ``device_loop_calls`` and ``overflow_fallbacks`` are
the port's own numbers and are not compared (the port sizes every CD
gather to its peel set, so it never overflows).
"""
import functools
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import GRAPH_CASES
from repro.core.engine import ReceiptConfig as JConfig
from repro.core.engine import tip_decompose as j_tip_decompose
from repro.core.engine.cd import find_hi_np as j_find_hi_np
from repro.core.engine.cd import receipt_cd as j_receipt_cd
from repro.core.engine.fd import build_fd_tasks as j_build_fd_tasks
from repro.core.engine.fd import pre_peel_tasks as j_pre_peel_tasks
from repro.core.engine.peel_loop import DeviceGraph as JDeviceGraph
from repro.core.engine.peel_loop import RunStats as JRunStats
from repro.core.engine.peel_loop import batched_level_loop as j_level_loop
from repro.core.engine.peel_loop import device_peel_loop as j_peel_loop
from repro.core.peeling import bup_oracle
from repro.kernels.butterfly_sparse import batched_row_extents as j_bre
from repro.kernels.ops import butterfly_support as j_butterfly_support
from repro_torch.api import faults as tfaults
from repro_torch.api.errors import KernelBackendError
from repro_torch.convert import (config_from_fields, graph_from_arrays,
                                 stats_fields)
from repro_torch.core import peeling as tpeeling
from repro_torch.core import receipt as treceipt
from repro_torch.core.engine import cd as tcd
from repro_torch.core.engine import fd as tfd
from repro_torch.core.engine import peel_loop as tpl

ROOT = Path(__file__).resolve().parents[1]
BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")
COUNTERS = ("rho_cd", "rho_fd", "wedges_cd", "wedges_fd", "wedges_pvbcnt",
            "huc_recounts", "elided_sweeps", "num_subsets", "bounds",
            "subset_sizes", "subset_wedges_fd", "dgm_compactions")
GRAPH_COUNTERS = ("rho_cd", "wedges_cd", "huc_recounts", "elided_sweeps",
                  "num_subsets", "sweeps_per_subset", "bounds",
                  "dgm_compactions", "dgm_device_compactions")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: its CPU tensors are small, and
    the test workers' thread pools would otherwise oversubscribe the
    cores (each pool spins while it waits)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(backend="torch", **kw):
    """The reference's config (backend ``xla``) and the port's, with the
    port's ``backend`` (``torch`` or ``torch_sparse``)."""
    jcfg = JConfig(backend="xla", kernel_blocks=BLOCKS, **kw)
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    fields["backend"] = {"torch": "xla", "torch_sparse": "interpret_sparse"}[
        backend]
    return jcfg, config_from_fields(fields)


def _port_graph(g):
    return graph_from_arrays(g.n_u, g.n_v, g.edges_u, g.edges_v)


@functools.lru_cache(maxsize=None)
def _reference(case, side, kw):
    """The reference's run of one case, once per (case, side, variant):
    both port backends are held against the same run."""
    jcfg, _ = _configs(**dict(kw))
    return j_tip_decompose(GRAPH_CASES[case](), jcfg, side=side)


def _run_both(case, side="U", backend="torch", **kw):
    g = GRAPH_CASES[case]()
    j_theta, j_stats = _reference(case, side, tuple(sorted(kw.items())))
    _, tcfg = _configs(backend, **kw)
    t_theta, t_stats = treceipt.tip_decompose(_port_graph(g), tcfg,
                                              side=side, device=CPU)
    return g, side, j_theta, j_stats, t_theta, t_stats


def _assert_same(g, side, j_theta, j_stats, t_theta, t_stats):
    oracle = bup_oracle(g if side == "U" else g.transposed())[0]
    np.testing.assert_array_equal(t_theta, j_theta)
    np.testing.assert_array_equal(t_theta, oracle)
    for key in COUNTERS:
        assert getattr(t_stats, key) == getattr(j_stats, key), key


# ---------------------------------------------------------------------- #
# the slice end to end
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_slice_matches_reference_and_oracle(case, side):
    _assert_same(*_run_both(case, side))


@pytest.mark.parametrize("variant", [
    dict(use_huc=False), dict(use_dgm=False),
    dict(fd_update_mode="kernel"), dict(fd_update_mode="b2"),
])
@pytest.mark.parametrize("case", ["powerlaw", "vhub"])
def test_slice_variants_match(case, variant):
    _assert_same(*_run_both(case, "U", **variant))


@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_sparse_backend_matches_reference_and_oracle(case, side):
    """``torch_sparse``: the plain staircase kernels, with the extents the
    engine derives at every stage, give the reference's theta and
    counters."""
    _assert_same(*_run_both(case, side, backend="torch_sparse"))


def test_sparse_backend_fd_kernel_mode_matches():
    """FD groups streaming through kernel 5 (``fd_update_mode="kernel"``),
    with the first-level delta and every sweep on per-group extents."""
    _assert_same(*_run_both("powerlaw", "U", backend="torch_sparse",
                            fd_update_mode="kernel"))


def test_huc_and_elision_fire_on_vhub():
    """The counters compared above are not all zero: HUC recounts and
    terminal-sweep elision both happen on the V-hub graph."""
    *_, t_stats = _run_both("vhub", "U", num_partitions=4)
    assert t_stats.huc_recounts > 0 and t_stats.elided_sweeps > 0
    assert t_stats.overflow_fallbacks == 0


def test_host_sweep_engine_matches():
    """device_loop=False: every sweep through host_sweep."""
    _assert_same(*_run_both("er_dense", "U", device_loop=False))


def test_host_sweep_engine_matches_on_sparse_backend():
    """host_sweep with the construction-time staircase extents."""
    _assert_same(*_run_both("er_dense", "U", backend="torch_sparse",
                            device_loop=False))


def test_cap_exits_reenter_exactly():
    """max_sweeps=1 caps every loop invocation; CD and FD re-enter."""
    run = _run_both("er_dense", "U", max_sweeps=1)
    _assert_same(*run)
    t_stats = run[-1]
    assert t_stats.device_loop_calls > t_stats.num_subsets


# ---------------------------------------------------------------------- #
# module by module
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("minmode", [False, True])
def test_device_peel_loop_matches(minmode):
    g = GRAPH_CASES["vhub"]()
    jcfg, tcfg = _configs()
    members = np.arange(g.n_u)
    jdg = JDeviceGraph(g, members, jcfg)
    tdg = tpl.DeviceGraph(_port_graph(g), members, tcfg, device=CPU)
    np.testing.assert_array_equal(tdg.a.numpy(), np.asarray(jdg.a))
    assert tdg.c_rcnt == jdg.c_rcnt and tdg.total_wedges == jdg.total_wedges
    rows = jdg.rows_pad
    alive = np.arange(rows) < jdg.n_rows
    sup = np.asarray(j_butterfly_support(
        jdg.a, jnp.asarray(alive, jdg.a.dtype), backend="xla"))
    sup = np.where(alive, sup, np.inf).astype(np.float32)
    hi, lo = float(np.sort(sup[alive])[len(sup[alive]) // 3]) + 1.0, 0.0
    want = j_peel_loop(
        jdg.a, jdg.ids, jdg.row_ext, jdg.kmax, jnp.asarray(sup),
        jnp.asarray(alive), jdg.dv0, jnp.zeros(rows, jnp.float32), hi, lo,
        jdg.c_rcnt, 0, backend="xla", blocks=BLOCKS, use_huc=True,
        peel_width=rows, max_sweeps=1000, minmode=minmode)
    stats = tpl.RunStats()
    got = tpl.device_peel_loop(
        tdg.a, tdg.ids, torch.from_numpy(sup), torch.from_numpy(alive),
        tdg.dv0, torch.zeros(rows), hi, lo, tdg.c_rcnt, 0, backend="torch",
        blocks=BLOCKS, use_huc=True, max_sweeps=1000, minmode=minmode,
        stats=stats)
    # (support, alive, dv, theta, peeled) tensors, then the counters
    for k in range(5):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
    for k in range(5, 11):
        assert float(got[k]) == float(want[k]), k
    assert stats.host_round_trips >= int(want[5])


@pytest.mark.parametrize("peel_width", [8, 16])
@pytest.mark.parametrize("update_mode", ["kernel", "b2"])
def test_batched_level_loop_matches(update_mode, peel_width):
    """Both update modes, with the gathered and the mask-form update."""
    rng = np.random.default_rng(9)
    g_n, mm, cc = 3, 16, 16
    a = (rng.random((g_n, mm, cc)) < 0.35).astype(np.float32)
    nmem = np.array([16, 11, 5])
    alive = np.arange(mm)[None, :] < nmem[:, None]
    a *= alive[:, :, None]
    w = np.einsum("gic,gjc->gij", a, a)
    b2 = w * (w - 1) / 2
    for k in range(g_n):
        np.fill_diagonal(b2[k], 0)
    sup = np.where(alive, b2.sum(axis=2), np.inf).astype(np.float32)
    dv = a.sum(axis=1)
    lo = np.array([0.0, 3.0, 1.0], np.float32)
    want = j_level_loop(
        jnp.asarray(a), jnp.zeros((g_n, mm), jnp.int32), jnp.asarray(sup),
        jnp.asarray(alive), jnp.asarray(dv), jnp.asarray(lo), backend="xla",
        blocks=BLOCKS, peel_width=peel_width, max_sweeps=1000,
        update_mode=update_mode)
    got = tpl.batched_level_loop(
        torch.from_numpy(a), torch.from_numpy(sup), torch.from_numpy(alive),
        torch.from_numpy(dv), torch.from_numpy(lo), backend="torch",
        blocks=BLOCKS, peel_width=peel_width, max_sweeps=1000,
        update_mode=update_mode)
    for k in range(7):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
    assert got[7] == int(want[7])


def test_receipt_cd_matches():
    """Subset ids, the FD init-support vector and the bounds."""
    g = GRAPH_CASES["powerlaw"]()
    jcfg, tcfg = _configs(num_partitions=6)
    j_out = j_receipt_cd(g, jcfg, JRunStats())
    t_out = tcd.receipt_cd(_port_graph(g), tcfg, tpl.RunStats(), device=CPU)
    for k in range(3):
        np.testing.assert_array_equal(t_out[k], j_out[k])


def test_cd_checkpoint_resume_is_exact():
    g = _port_graph(GRAPH_CASES["powerlaw"]())
    _, tcfg = _configs(num_partitions=6)
    states = []
    full = tcd.receipt_cd(g, tcfg, tpl.RunStats(), device=CPU,
                          checkpoint_cb=states.append)
    assert len(states) >= 3
    resumed = tcd.receipt_cd(g, tcfg, tpl.RunStats(), device=CPU,
                             resume_state=states[2])
    for k in range(3):
        np.testing.assert_array_equal(resumed[k], full[k])


def test_find_hi_and_pre_peel_match():
    rng = np.random.default_rng(2)
    sup = rng.integers(0, 50, 40).astype(np.float64)
    w = rng.integers(0, 9, 40).astype(np.float64)
    alive = rng.random(40) < 0.8
    for tgt in (1.0, 30.0, 1e9):
        assert tcd.find_hi_np(sup, w, alive, tgt) == j_find_hi_np(
            sup, w, alive, tgt)
    g = GRAPH_CASES["powerlaw"]()
    jcfg, tcfg = _configs()
    subset_id, init_sup, bounds, _ = j_receipt_cd(g, jcfg, JRunStats())
    for levels in (1, 4):
        js, ts = JRunStats(), tpl.RunStats()
        j_theta, t_theta = np.zeros(g.n_u), np.zeros(g.n_u)
        j_tasks = j_pre_peel_tasks(j_build_fd_tasks(g, subset_id, bounds, js),
                                   init_sup, j_theta, js, levels=levels)
        t_tasks = tfd.pre_peel_tasks(
            tfd.build_fd_tasks(_port_graph(g), subset_id, bounds, ts),
            init_sup, t_theta, ts, levels=levels)
        np.testing.assert_array_equal(t_theta, j_theta)
        assert (ts.rho_fd, ts.wedges_fd) == (js.rho_fd, js.wedges_fd)
        assert len(t_tasks) == len(j_tasks)
        for tt, jt in zip(t_tasks, j_tasks):
            for key in ("surv", "l1", "sup_surv"):
                np.testing.assert_array_equal(tt[key], jt[key])


# ---------------------------------------------------------------------- #
# whole-graph CD dispatch
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _reference_graph_cd(case, kw=()):
    """The reference's graph dispatch, once per (case, variant)."""
    g = GRAPH_CASES[case]()
    jcfg, _ = _configs(cd_dispatch="graph", **dict(kw))
    stats = JRunStats()
    out = j_receipt_cd(g, jcfg, stats)
    return out, stats


def _assert_graph_cd_same(case, backend, kw=()):
    g = GRAPH_CASES[case]()
    (j_sub, j_init, j_bounds, _), j_stats = _reference_graph_cd(case, kw)
    _, tcfg = _configs(backend, cd_dispatch="graph", **dict(kw))
    t_stats = tpl.RunStats()
    t_sub, t_init, t_bounds, _ = tcd.receipt_cd(_port_graph(g), tcfg, t_stats,
                                               device=CPU)
    np.testing.assert_array_equal(t_sub, j_sub)
    np.testing.assert_array_equal(t_init, j_init)
    np.testing.assert_array_equal(t_bounds, np.asarray(j_bounds))
    for key in GRAPH_COUNTERS:
        assert getattr(t_stats, key) == getattr(j_stats, key), key
    return t_stats


GRAPH_DISPATCH_CASES = ["fig1", "powerlaw", "vhub", "er_dense", "empty_edges",
                        "star"]


@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("case", GRAPH_DISPATCH_CASES)
def test_graph_dispatch_matches_reference(case, backend):
    """``receipt_cd``'s subset ids, FD init supports and bounds, and the
    CD counters, against the reference's graph dispatch; then the whole
    path's theta against ``bup_oracle`` on both sides."""
    t_stats = _assert_graph_cd_same(case, backend)
    assert t_stats.dgm_compactions == 0
    g = GRAPH_CASES[case]()
    _, tcfg = _configs(backend, cd_dispatch="graph")
    for side in "UV":
        theta, _ = treceipt.tip_decompose(_port_graph(g), tcfg, side=side,
                                          device=CPU)
        np.testing.assert_array_equal(
            theta, bup_oracle(g if side == "U" else g.transposed())[0])


def test_graph_dispatch_compacts_and_recounts_on_device():
    """The counters compared above are not all zero: on the V-hub graph the
    graph loop compacts at boundaries and HUC recounts fire."""
    t_stats = _assert_graph_cd_same("vhub", "torch_sparse",
                                    (("num_partitions", 4),))
    assert t_stats.dgm_device_compactions > 0
    assert t_stats.huc_recounts > 0 and t_stats.elided_sweeps > 0


@pytest.mark.parametrize("kw", [(("use_dgm", False),), (("max_sweeps", 1),),
                                (("use_huc", False),)])
def test_graph_dispatch_variants_match(kw):
    """DGM off (no compaction, the whole-graph HUC bound), and
    ``max_sweeps=1``: every invocation stops after one iteration and the
    CD dispatch re-enters with the returned state."""
    t_stats = _assert_graph_cd_same("powerlaw", "torch_sparse", kw)
    if dict(kw).get("use_dgm") is False:
        assert t_stats.dgm_device_compactions == 0
    if dict(kw).get("max_sweeps") == 1:
        assert t_stats.device_loop_calls > t_stats.rho_cd


class _NoHostReads(torch.utils._python_dispatch.TorchDispatchMode):
    """Raise on every op that reads a tensor's value on the host
    (``.item()``, ``bool()``, an index by a 0-dim tensor: all of them end
    in ``aten::_local_scalar_dense``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name == "aten::_local_scalar_dense":
            raise AssertionError(f"host read in a graph boundary: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
def test_graph_boundary_reads_nothing_on_the_host(backend, monkeypatch):
    """Every subset boundary of the graph loop (DGM, extents, ``w``,
    ``find_hi_device``) runs with no blocking read of its own: each read
    goes through ``fetch`` and counts in ``host_round_trips``."""
    boundary = tpl._graph_boundary
    calls = []

    def watched(*args, **kwargs):
        calls.append(1)
        with _NoHostReads():
            return boundary(*args, **kwargs)

    monkeypatch.setattr(tpl, "_graph_boundary", watched)
    t_stats = _assert_graph_cd_same("vhub", backend, (("num_partitions", 4),))
    assert len(calls) > 2 and t_stats.dgm_device_compactions > 0


def test_graph_dispatch_rejects_host_boundary_features():
    g = _port_graph(GRAPH_CASES["fig1"]())
    cfg = tpl.ReceiptConfig(cd_dispatch="graph", kernel_blocks=BLOCKS)
    with pytest.raises(ValueError, match="cd_dispatch='subset'"):
        tcd.receipt_cd(g, cfg, tpl.RunStats(), device=CPU,
                       checkpoint_cb=lambda st: None)
    with pytest.raises(ValueError, match="cd_dispatch='subset'"):
        tcd.receipt_cd(g, cfg, tpl.RunStats(), device=CPU, resume_state={})
    cfg.device_loop = False          # past the config's own check
    with pytest.raises(ValueError, match="device_loop=True"):
        tcd.receipt_cd(g, cfg, tpl.RunStats(), device=CPU)
    with pytest.raises(ValueError, match="square row tiles"):
        tpl.DeviceGraph(g, np.arange(g.n_u), tpl.ReceiptConfig(
            backend="torch_sparse", kernel_blocks=(8, 16, 8)), device=CPU)


@pytest.mark.parametrize("spec", ["kernel_launch:dispatch=graph@1",
                                  "kernel_launch:dispatch=graph@2",
                                  "dgm_boundary:dispatch=graph@1"])
def test_graph_fault_sites_fire(spec):
    """Counting, the loop invocation and (after a cap-exit with device
    compactions done) the DGM boundary, with the reference's context."""
    g = _port_graph(GRAPH_CASES["powerlaw"]())
    cfg = tpl.ReceiptConfig(cd_dispatch="graph", kernel_blocks=BLOCKS,
                            backend="torch_sparse", max_sweeps=4)
    with tfaults.inject(spec):
        with pytest.raises(KernelBackendError, match="graph"):
            treceipt.tip_decompose(g, cfg, device=CPU)


def test_graph_peel_buffer_site_is_exact():
    g = _port_graph(GRAPH_CASES["powerlaw"]())
    cfg = tpl.ReceiptConfig(cd_dispatch="graph", kernel_blocks=BLOCKS)
    with tfaults.inject("peel_buffer:dispatch=graph") as inj:
        theta, _ = treceipt.tip_decompose(g, cfg, device=CPU)
    assert inj.report()[0]["fired"] == 1
    np.testing.assert_array_equal(theta, tpeeling.bup_oracle(g)[0])


@pytest.mark.parametrize("peel_width", [8, 16])
def test_sparse_level_loop_matches_interpret(peel_width):
    """The sparse FD group: ``batched_level_loop(update_mode="kernel")``
    with per-row extents against the reference's loop on
    ``interpret_sparse`` (the Pallas staircase body under the
    interpreter), gathered and mask-form updates."""
    rng = np.random.default_rng(21)
    g_n, mm, cc = 2, 16, 24
    cut = rng.integers(0, cc + 1, size=(g_n, mm, 1))
    a = ((rng.random((g_n, mm, cc)) < 0.4)
         * (np.arange(cc)[None, None, :] < cut)).astype(np.float32)
    nmem = np.array([16, 9])
    alive = np.arange(mm)[None, :] < nmem[:, None]
    a *= alive[:, :, None]
    w = np.einsum("gic,gjc->gij", a, a)
    b2 = w * (w - 1) / 2
    for k in range(g_n):
        np.fill_diagonal(b2[k], 0)
    sup = np.where(alive, b2.sum(axis=2), np.inf).astype(np.float32)
    dv = a.sum(axis=1)
    lo = np.array([0.0, 2.0], np.float32)
    row_ext = j_bre(a, BLOCKS[2])
    want = j_level_loop(
        jnp.asarray(a), jnp.asarray(row_ext), jnp.asarray(sup),
        jnp.asarray(alive), jnp.asarray(dv), jnp.asarray(lo),
        backend="interpret_sparse", blocks=BLOCKS, peel_width=peel_width,
        max_sweeps=1000, update_mode="kernel")
    got = tpl.batched_level_loop(
        torch.from_numpy(a), torch.from_numpy(sup), torch.from_numpy(alive),
        torch.from_numpy(dv), torch.from_numpy(lo), backend="torch_sparse",
        blocks=BLOCKS, peel_width=peel_width, max_sweeps=1000,
        update_mode="kernel", row_ext=torch.from_numpy(row_ext))
    for k in range(7):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
    assert got[7] == int(want[7])


# ---------------------------------------------------------------------- #
# config, conversion, not-yet-ported paths
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("bad", [
    dict(num_partitions=0), dict(kernel_blocks=(8, 8)),
    dict(kernel_blocks=(8, 0, 8)), dict(fd_mode="nope"),
    dict(cd_dispatch="nope"), dict(cd_dispatch="graph", device_loop=False),
    dict(fd_update_mode="nope"), dict(max_sweeps=0), dict(peel_width=0),
    dict(dgm_row_threshold=0.0), dict(fd_b2_cells=0),
    dict(representation="nope"), dict(tiled_regather_every=0),
    dict(tiled_compact_every=0), dict(tiled_compact_ratio=2.0),
    dict(fd_prepeel_levels=0),
    dict(backend="sparse", kernel_blocks=(8, 16, 8)),
])
def test_config_validation_mirrors_reference(bad):
    """``backend="sparse"`` stands for each side's sparse backends: the
    reference's ``interpret_sparse``, the port's ``torch_sparse`` and
    ``cuda_sparse``."""
    sparse = bad.get("backend") == "sparse"
    with pytest.raises(ValueError):
        JConfig(**(dict(bad, backend="interpret_sparse") if sparse else bad))
    for backend in (("torch_sparse", "cuda_sparse") if sparse else (None,)):
        with pytest.raises(ValueError):
            tpl.ReceiptConfig(**(dict(bad, backend=backend) if sparse
                                 else bad))


def test_config_fields_and_backend_mapping():
    jnames = {f.name for f in dataclasses.fields(JConfig)}
    assert {f.name for f in dataclasses.fields(tpl.ReceiptConfig)} == jnames
    assert set(stats_fields(tpl.RunStats())) == {
        f.name for f in dataclasses.fields(JRunStats)}
    for jb, tb in [(None, None), ("xla", "torch"), ("interpret", "torch"),
                   ("pallas", "cuda")]:
        fields = dataclasses.asdict(JConfig(backend=jb))
        fields["dtype"] = np.dtype(fields["dtype"]).name
        tcfg = config_from_fields(fields)
        assert tcfg.backend == tb and tcfg.dtype == torch.float32
    for jb, tb in [("pallas_sparse", "cuda_sparse"),
                   ("interpret_sparse", "torch_sparse")]:
        fields = dataclasses.asdict(JConfig(backend=jb))
        fields["dtype"] = "float32"
        assert config_from_fields(fields).backend == tb
    with pytest.raises(ValueError, match="did you mean 'cuda'"):
        tpl.ReceiptConfig(backend="cudaa")


@pytest.mark.parametrize("kw", [dict(fd_mode="b2"), dict(fd_mode="matvec"),
                                dict(representation="tiled")])
def test_not_ported_paths_raise(kw):
    """The paths that raised NotImplementedError before the tiled slice was
    ported now run: theta equal to ``bup_oracle`` (tests/test_torch_tiled.py
    and tests/test_torch_baselines.py hold them against the reference)."""
    g = _port_graph(GRAPH_CASES["fig1"]())
    theta, _ = treceipt.tip_decompose(
        g, tpl.ReceiptConfig(kernel_blocks=BLOCKS, **kw), device=CPU)
    np.testing.assert_array_equal(theta, tpeeling.bup_oracle(g)[0])


def test_without_a_card_the_entry_point_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    g = _port_graph(GRAPH_CASES["fig1"]())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treceipt.tip_decompose(g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        treceipt.tip_decompose(g, tpl.ReceiptConfig(backend="cuda"),
                               device=CPU)


@pytest.mark.parametrize("spec,error", [
    ("kernel_launch@1", KernelBackendError),       # counting
    ("kernel_launch@2", KernelBackendError),       # first CD subset
    ("dgm_boundary@1", KernelBackendError),
])
def test_fault_sites_fire(spec, error):
    g = _port_graph(GRAPH_CASES["powerlaw"]())
    with tfaults.inject(spec):
        with pytest.raises(error, match="injected"):
            treceipt.tip_decompose(g, tpl.ReceiptConfig(kernel_blocks=BLOCKS),
                                   device=CPU)


def test_fault_sites_in_fd_and_peel_buffer():
    g = _port_graph(GRAPH_CASES["powerlaw"]())
    cfg = tpl.ReceiptConfig(kernel_blocks=BLOCKS)
    with tfaults.inject("kernel_launch:dispatch=fd_level@1"):
        with pytest.raises(KernelBackendError, match="fd_level"):
            treceipt.tip_decompose(g, cfg, device=CPU)
    with tfaults.inject("peel_buffer") as inj:
        theta, _ = treceipt.tip_decompose(g, cfg, device=CPU)
    assert inj.report()[0]["fired"] > 0
    np.testing.assert_array_equal(theta, tpeeling.bup_oracle(g)[0])


def test_port_oracle_matches_reference_oracle():
    for name in ("fig1", "powerlaw", "er_dense"):
        g = GRAPH_CASES[name]()
        tg = _port_graph(g)
        np.testing.assert_array_equal(tpeeling.bup_oracle(tg)[0],
                                      bup_oracle(g)[0])
        np.testing.assert_array_equal(
            tpeeling.parb_metrics(tg)[0], bup_oracle(g)[0])


# ---------------------------------------------------------------------- #
# import guards
# ---------------------------------------------------------------------- #
def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_no_source_line_imports_the_reference():
    pattern = re.compile(r"^\s*(import\s+(repro|jax)\b|from\s+(repro|jax)[\s.])")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits

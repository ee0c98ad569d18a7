"""The port's main path (count -> CD -> FD) against the reference engine.

Each case is built once with numpy and handed to both packages through
``repro_torch.convert``.  On the CPU the port runs its kernels' plain
versions, the reference runs its ``xla`` backend, both with kernel blocks
(8, 8, 8).  Theta must be bit-identical to the reference and to
``bup_oracle``; the paper's counters must be equal.  ``host_round_trips``,
``device_loop_calls`` and ``overflow_fallbacks`` are the port's own
numbers and are not compared (the port sizes every CD gather to its peel
set, so it never overflows).
"""
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


def _configs(**kw):
    jcfg = JConfig(backend="xla", kernel_blocks=BLOCKS, **kw)
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    return jcfg, config_from_fields(fields)


def _port_graph(g):
    return graph_from_arrays(g.n_u, g.n_v, g.edges_u, g.edges_v)


def _run_both(g, side="U", **kw):
    jcfg, tcfg = _configs(**kw)
    j_theta, j_stats = j_tip_decompose(g, jcfg, side=side)
    t_theta, t_stats = treceipt.tip_decompose(_port_graph(g), tcfg,
                                              side=side, device=CPU)
    return j_theta, j_stats, t_theta, t_stats


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
    g = GRAPH_CASES[case]()
    _assert_same(g, side, *_run_both(g, side))


@pytest.mark.parametrize("variant", [
    dict(use_huc=False), dict(use_dgm=False),
    dict(fd_update_mode="kernel"), dict(fd_update_mode="b2"),
])
@pytest.mark.parametrize("case", ["powerlaw", "vhub"])
def test_slice_variants_match(case, variant):
    g = GRAPH_CASES[case]()
    _assert_same(g, "U", *_run_both(g, "U", **variant))


def test_huc_and_elision_fire_on_vhub():
    """The counters compared above are not all zero: HUC recounts and
    terminal-sweep elision both happen on the V-hub graph."""
    g = GRAPH_CASES["vhub"]()
    *_, t_stats = _run_both(g, "U", num_partitions=4)
    assert t_stats.huc_recounts > 0 and t_stats.elided_sweeps > 0
    assert t_stats.overflow_fallbacks == 0


def test_host_sweep_engine_matches():
    """device_loop=False: every sweep through host_sweep."""
    g = GRAPH_CASES["er_dense"]()
    _assert_same(g, "U", *_run_both(g, "U", device_loop=False))


def test_cap_exits_reenter_exactly():
    """max_sweeps=1 caps every loop invocation; CD and FD re-enter."""
    g = GRAPH_CASES["er_dense"]()
    j_theta, j_stats, t_theta, t_stats = _run_both(g, "U", max_sweeps=1)
    _assert_same(g, "U", j_theta, j_stats, t_theta, t_stats)
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
])
def test_config_validation_mirrors_reference(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        tpl.ReceiptConfig(**bad)


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
    fields = dataclasses.asdict(JConfig(backend="interpret_sparse"))
    fields["dtype"] = "float32"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config_from_fields(fields)
    with pytest.raises(ValueError, match="did you mean 'cuda'"):
        tpl.ReceiptConfig(backend="cudaa")


@pytest.mark.parametrize("kw", [dict(cd_dispatch="graph"),
                                dict(fd_mode="b2"), dict(fd_mode="matvec"),
                                dict(representation="tiled")])
def test_not_ported_paths_raise(kw):
    g = _port_graph(GRAPH_CASES["fig1"]())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        treceipt.tip_decompose(g, tpl.ReceiptConfig(**kw), device=CPU)


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

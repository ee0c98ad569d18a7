"""The port's API layer (``repro_torch.api``) against the reference's
(``repro.api``): EngineConfig, Planner/ExecutionPlan, Executor.decompose
with its cache, Executor.map and the TipDecomposition queries.

Each case is built once with numpy and handed to both packages.  The
reference runs its ``interpret`` / ``interpret_sparse`` backends (the
Pallas kernels in interpret mode, padded to the kernel blocks as the
port's kernels are), the port the plain versions of its kernels on the
CPU (``torch`` / ``torch_sparse``), both with kernel blocks (8, 8, 8).
Theta must be bit-identical (``np.array_equal``) to the reference and to
``bup_oracle``.  By-design differences: the backend names (mapped through
``convert.BACKEND_MAP``), ``cd_host_syncs_bound`` (``None`` here: the
port's CD loops read once per sweep), and the counters that are the
port's own (``host_round_trips``, ``device_loop_calls``,
``overflow_fallbacks``).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import GRAPH_CASES
from repro.api import EngineConfig as JEngineConfig
from repro.api import Executor as JExecutor
from repro.api import Planner as JPlanner
from repro.core.graph import BipartiteGraph, powerlaw_bipartite
from repro.core.peeling import bup_oracle
from repro_torch.api import (EngineConfig, Executor, Planner,
                             PlanInfeasibleError, TipDecomposition,
                             decompose)
from repro_torch.api.errors import KernelBackendError
from repro_torch.convert import BACKEND_MAP, engine_config_from_fields
from repro_torch.convert import graph_from_arrays
from repro_torch.core import receipt as treceipt
from repro_torch.core.engine import ReceiptConfig
from repro_torch.core.engine import tip_decompose as t_engine_tip_decompose
from repro_torch.core.engine.peel_loop import bucket
from repro_torch.core.engine.tiled import build_tiled
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops

BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")
REF_BACKEND = {"torch": "interpret", "torch_sparse": "interpret_sparse"}
COUNTERS = ("rho_cd", "rho_fd", "wedges_cd", "wedges_fd", "wedges_pvbcnt",
            "huc_recounts", "elided_sweeps", "num_subsets", "bounds",
            "sweeps_per_subset", "subset_sizes", "subset_wedges_fd",
            "dgm_compactions", "dgm_device_compactions", "fd_groups")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors; the test
    workers' pools would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(backend="torch", **kw):
    """The reference's EngineConfig and the port's, carried across by
    ``engine_config_from_fields``."""
    jcfg = JEngineConfig(backend=REF_BACKEND[backend], kernel_blocks=BLOCKS,
                         **kw)
    return jcfg, engine_config_from_fields(jcfg.to_dict())


def _tg(g):
    return graph_from_arrays(g.n_u, g.n_v, g.edges_u, g.edges_v)


def _permuted_copy(g, seed):
    """An isomorphic copy: the same bucketed shape and signature."""
    rng = np.random.default_rng(seed)
    pu, pv = rng.permutation(g.n_u), rng.permutation(g.n_v)
    return BipartiteGraph.from_edges(g.n_u, g.n_v, pu[g.edges_u],
                                     pv[g.edges_v])


def _map_ref_strings(x):
    """The reference's backend names in a plan's strings, as the port
    names them."""
    if isinstance(x, str):
        if x in BACKEND_MAP:
            return BACKEND_MAP[x]
        for ref in ("interpret_sparse", "interpret"):
            x = x.replace(f"'{ref}'", f"'{BACKEND_MAP[ref]}'")
        return x
    if isinstance(x, list):
        return [_map_ref_strings(v) for v in x]
    return x


def _plan_dicts(jplan, tplan):
    """Both plans' ``to_dict()``, the reference's backend names mapped;
    ``cd_host_syncs_bound`` is the by-design difference, checked and
    dropped."""
    jd, td = jplan.to_dict(), tplan.to_dict()
    assert td.pop("cd_host_syncs_bound") is None
    jd.pop("cd_host_syncs_bound")
    jd["backend"] = BACKEND_MAP[jd["backend"]]
    jd["kernel_route"] = kops.route_label(jd["backend"])
    jd["signature"] = _map_ref_strings(jd["signature"])
    return jd, td


def _assert_same_run(jtd, ttd, g, side="U"):
    oracle = bup_oracle(g if side == "U" else g.transposed())[0]
    np.testing.assert_array_equal(ttd.theta, jtd.theta)
    np.testing.assert_array_equal(ttd.theta, oracle)
    for key in COUNTERS:
        assert getattr(ttd.stats, key) == getattr(jtd.stats, key), key


# --------------------------------------------------------------------- #
# EngineConfig
# --------------------------------------------------------------------- #
def test_engine_config_roundtrip_and_carry_across():
    jcfg, tcfg = _configs(num_partitions=12, side="V", cd_dispatch="graph",
                          fd_update_mode="kernel", peel_width=32,
                          memory_budget_bytes=1 << 30)
    assert EngineConfig.from_dict(tcfg.to_dict()) == tcfg
    assert json.loads(json.dumps(tcfg.to_dict())) == tcfg.to_dict()
    want = dict(jcfg.to_dict(), backend="torch")
    assert tcfg.to_dict() == want
    rcfg = tcfg.to_receipt_config()
    assert rcfg.dtype is torch.float32 and rcfg.backend == "torch"
    assert EngineConfig.from_receipt(rcfg, side="V") == dataclasses.replace(
        tcfg, memory_budget_bytes=None)
    assert "[non-default]" in tcfg.describe()


def test_engine_config_unknown_keys_hint_as_reference():
    for extra, hint in (({"num_partition": 4}, "'num_partitions'?"),
                        ({"definitely_not_a_knob": 1}, "known keys")):
        msgs = []
        for cls in (JEngineConfig, EngineConfig):
            with pytest.raises(ValueError, match="unknown key") as ei:
                cls.from_dict(dict(cls().to_dict(), **extra))
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1] and hint in msgs[1]


@pytest.mark.parametrize("bad", [
    dict(side="W"), dict(dtype="float64"), dict(fd_mode="Level"),
    dict(cd_dispatch="Graph"), dict(num_partitions=0), dict(max_sweeps=0),
    dict(peel_width=0), dict(dgm_row_threshold=0.0),
    dict(fd_update_mode="fast"), dict(kernel_blocks=(8, 8)),
    dict(representation="sparse"), dict(memory_budget_bytes=0),
    dict(fault_spec="kernel_lunch@1"), dict(workload="edge"),
    # conflicting knobs: the service layer's stricter rules
    dict(cd_dispatch="graph", use_dgm=False),
    dict(cd_dispatch="graph", device_loop=False),
    dict(fd_mode="b2", device_loop=False),
    dict(workload="wing", representation="tiled"),
])
def test_engine_config_rejects_as_reference(bad):
    """Bad values and conflicting knobs raise ValueError with the
    reference's message, word for word."""
    msgs = []
    for cls in (JEngineConfig, EngineConfig):
        with pytest.raises(ValueError) as ei:
            cls(**dict(dict(kernel_blocks=BLOCKS), **bad))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_engine_config_backends_are_the_ports():
    for b in (None, "cuda", "cuda_sparse", "torch", "torch_sparse"):
        assert EngineConfig(backend=b).backend == b
    with pytest.raises(ValueError, match="known backends: cuda"):
        EngineConfig(backend="pallas")
    # the raw engine config keeps the A/B combination the layer rejects
    ReceiptConfig(cd_dispatch="graph", use_dgm=False)


# --------------------------------------------------------------------- #
# Planner / ExecutionPlan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_plan_matches_reference(case, side, backend, dispatch):
    """``to_dict()`` field for field, the backend mapped and
    ``cd_host_syncs_bound`` the one by-design difference."""
    g = GRAPH_CASES[case]()
    jcfg, tcfg = _configs(backend, side=side, cd_dispatch=dispatch,
                          num_partitions=6)
    jd, td = _plan_dicts(JPlanner(jcfg).plan(g),
                         Planner(tcfg, device=CPU).plan(_tg(g)))
    assert td == jd
    assert "O(sweeps)" in Planner(tcfg, device=CPU).plan(_tg(g)).describe()


def test_plan_signature_keys_on_bucketed_shape_and_config():
    p = Planner(_configs()[1], device=CPU)
    g1 = _tg(powerlaw_bipartite(100, 60, 700, seed=0))
    g2 = _tg(powerlaw_bipartite(101, 60, 700, seed=3))     # same buckets
    g3 = _tg(powerlaw_bipartite(400, 60, 700, seed=0))     # other bucket
    assert p.plan(g1).signature == p.plan(g2).signature
    assert p.plan(g1).signature != p.plan(g3).signature
    assert p.plan(g1).signature != Planner(
        _configs(num_partitions=12)[1], device=CPU).plan(g1).signature
    with pytest.raises(ValueError, match="from_edges"):
        p.plan(np.zeros((4, 4)))


def test_plan_resolves_backend_from_device():
    g = _tg(GRAPH_CASES["fig1"]())
    assert Planner(EngineConfig(), device=CPU).plan(g).backend == "torch"
    assert Planner(EngineConfig()).plan(g).backend == "cuda"


_BUDGET_GRAPHS = dict(
    GRAPH_CASES,
    # tile occupancy 0.16 at 8 x 8 tiles: its tile list fits below the
    # dense matrix's bytes
    sparse=lambda: powerlaw_bipartite(300, 200, 500, seed=3))


def _budget_cases():
    """(name, graph, config kwargs, budget as a function of the
    unbudgeted plan's cost model): a downshift, the auto route to tiled,
    an infeasible budget."""
    return [
        (f"downshift-{case}", case, dict(num_partitions=8),
         lambda cm: cm["dense_bytes"] - 1) for case in ("powerlaw", "vhub")
    ] + [
        ("auto_tiled-sparse", "sparse", dict(num_partitions=8),
         lambda cm: (cm["tiled_bytes"] + cm["dense_fixed_bytes"]) // 2),
    ] + [
        (f"infeasible-{case}", case, dict(num_partitions=8),
         lambda cm: 1024) for case in ("powerlaw", "sparse")
    ]


@pytest.mark.parametrize("name,case,kw,budget_of", _budget_cases(),
                         ids=[c[0] for c in _budget_cases()])
def test_admission_matches_reference(name, case, kw, budget_of):
    """Admission control: the same downshift, tiled route or
    ``PlanInfeasibleError`` (a ValueError) on both sides."""
    g = _BUDGET_GRAPHS[case]()
    cm = Planner(_configs(**kw)[1], device=CPU).plan(_tg(g)).cost_model
    jcfg, tcfg = _configs(memory_budget_bytes=int(budget_of(cm)), **kw)
    if name.startswith("infeasible"):
        for planner, gg in ((JPlanner(jcfg), g),
                            (Planner(tcfg, device=CPU), _tg(g))):
            with pytest.raises(ValueError, match="budget"):
                planner.plan(gg)
        with pytest.raises(PlanInfeasibleError):
            Planner(tcfg, device=CPU).plan(_tg(g))
        return
    tplan = Planner(tcfg, device=CPU).plan(_tg(g))
    jd, td = _plan_dicts(JPlanner(jcfg).plan(g), tplan)
    assert td == jd
    assert tplan.padded_bytes <= tcfg.memory_budget_bytes
    if name.startswith("downshift"):
        assert tplan.representation == "dense"
        assert tplan.degraded_from_partitions == 8
    else:
        assert tplan.representation == "tiled"
        assert cm["dense_fixed_bytes"] > tcfg.memory_budget_bytes
    # the admitted plan still decomposes exactly
    td_ = Executor(tcfg, device=CPU).decompose(_tg(g), plan=tplan)
    np.testing.assert_array_equal(td_.theta, bup_oracle(g)[0])


def test_wing_and_mesh_are_named_as_not_ported():
    g = _tg(GRAPH_CASES["fig1"]())
    with pytest.raises(PlanInfeasibleError, match="wing slice"):
        Planner(EngineConfig(workload="wing"), device=CPU).plan(g)
    with pytest.raises(PlanInfeasibleError, match="wing"):
        Executor(EngineConfig(workload="wing"), device=CPU).map([g])
    with pytest.raises(NotImplementedError, match="item 6"):
        Executor(EngineConfig(), device=CPU, mesh=object())
    with pytest.raises(NotImplementedError, match="item 4"):
        Executor(EngineConfig(), device=CPU).repeel(g)


# --------------------------------------------------------------------- #
# Executor.decompose and its cache
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("case", ["fig1", "powerlaw", "vhub"])
def test_decompose_matches_reference_cold_and_cached(case, backend,
                                                     dispatch):
    """A cold run, then a cache hit on a permuted copy (the measured
    sizing reused on both sides): theta and counters equal to the
    reference Executor's run for run, theta to ``bup_oracle``."""
    g = GRAPH_CASES[case]()
    jcfg, tcfg = _configs(backend, cd_dispatch=dispatch, num_partitions=6)
    jex, tex = JExecutor(jcfg), Executor(tcfg, device=CPU)
    for gg in (g, _permuted_copy(g, 7)):
        _assert_same_run(jex.decompose(gg), tex.decompose(_tg(gg)), gg)
    assert tex.cache_stats == dict(entries=1, hits=1, misses=1,
                                   quarantined=0, fallback_runs=0)
    assert tex.cache_stats == jex.cache_stats


@pytest.mark.parametrize("case", ["powerlaw", "er_dense"])
def test_decompose_side_v_matches_reference(case):
    g = GRAPH_CASES[case]()
    jcfg, tcfg = _configs(side="V", num_partitions=4)
    _assert_same_run(JExecutor(jcfg).decompose(g),
                     Executor(tcfg, device=CPU).decompose(_tg(g)), g, "V")


def test_cache_reuses_measured_sizing():
    """What a cache hit reuses: the plan arrives seeded with the earlier
    run's measured CD width and FD gather widths; the shape hooks record
    the sizes each run built and change none (the hit builds what a cold
    run of its graph builds); the result stays bit-identical to a cold
    run of the same graph."""
    base = powerlaw_bipartite(90, 50, 600, seed=2)
    tcfg = _configs(num_partitions=4, use_dgm=False)[1]
    ex = Executor(tcfg, device=CPU)
    first = ex.decompose(_tg(base))
    entry = ex._entries[first.plan.signature]
    assert entry.cd_peel_width is not None
    assert entry.fd_level_widths
    assert {"dgm_rows", "dgm_cols", "fd_rows", "fd_cols", "fd_l1",
            "fd_groups"} <= set(first.plan.measured.observed_dims)
    copy = _permuted_copy(base, 11)
    second = ex.decompose(_tg(copy))
    m = second.plan.measured
    assert m.runs == 2
    assert m.cd_peel_width == entry.cd_peel_width
    assert second.plan.signature == first.plan.signature
    cold = Executor(tcfg, device=CPU).decompose(_tg(copy))
    np.testing.assert_array_equal(second.theta, cold.theta)
    assert m.observed_dims == cold.plan.measured.observed_dims
    assert ex.cache_stats["hits"] == 1


def test_cache_misses_on_a_different_signature():
    ex = Executor(_configs(num_partitions=4)[1], device=CPU)
    ex.decompose(_tg(powerlaw_bipartite(100, 60, 700, seed=0)))
    ex.decompose(_tg(powerlaw_bipartite(100, 60, 700, seed=5)))
    assert ex.cache_stats["hits"] == 1
    td = ex.decompose(_tg(powerlaw_bipartite(420, 60, 700, seed=0)))
    assert ex.cache_stats["entries"] == 2 and ex.cache_stats["misses"] == 2
    assert td.plan.measured.runs == 1           # nothing carried over


def test_tiled_hooks_record_the_graphs_own_slot_list():
    """A plan records the tiled slot list's sizes and pads nothing: the
    slot count is the graph's own, where the reference pads it to
    ``bucket(n_slots, 8)`` (211 -> 256 here) for its jit cache."""
    g = _tg(powerlaw_bipartite(300, 200, 500, seed=3))
    ex = Executor(_configs(representation="tiled")[1], device=CPU)
    plan = ex.plan(g)
    tg = build_tiled(g, ex.config, plan=plan)
    plain = build_tiled(g, ex.config)
    assert tg.n_slots == plain.n_slots != bucket(plain.n_slots, 8)
    assert (tg.rows_pad, tg.cols_pad) == (plain.rows_pad, plain.cols_pad)
    assert plan.measured.observed_dims == {
        "tiled_rows": {plain.rows_pad}, "tiled_cols": {plain.cols_pad},
        "tiled_slots": {plain.n_slots}}


def test_facade_bit_identical_to_engine():
    """``core.receipt.tip_decompose`` routes through ``api.decompose``:
    theta and every counter equal to a direct engine call."""
    for case in ("powerlaw", "vhub", "fig1"):
        g = _tg(GRAPH_CASES[case]())
        for cfg in (ReceiptConfig(num_partitions=6, kernel_blocks=BLOCKS,
                                  backend="torch"),
                    ReceiptConfig(num_partitions=6, kernel_blocks=BLOCKS,
                                  backend="torch_sparse",
                                  cd_dispatch="graph")):
            t_wrap, s_wrap = treceipt.tip_decompose(g, cfg, device=CPU)
            t_eng, s_eng = t_engine_tip_decompose(g, cfg, device=CPU)
            np.testing.assert_array_equal(t_wrap, t_eng)
            wrap = dataclasses.asdict(s_wrap)
            eng = dataclasses.asdict(s_eng)
            for k in ("time_count", "time_cd", "time_fd", "backend_used"):
                wrap.pop(k), eng.pop(k)
            assert wrap == eng
        tv, _ = treceipt.tip_decompose(g, ReceiptConfig(kernel_blocks=BLOCKS),
                                       side="V", device=CPU)
        np.testing.assert_array_equal(
            tv, bup_oracle(GRAPH_CASES[case]().transposed())[0])
    with pytest.raises(ValueError, match="side"):
        treceipt.tip_decompose(g, side="W", device=CPU)


def test_no_device_means_the_card():
    """``device=None`` is the card: without one the Executor raises and
    nothing carries on silently on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decompose(_tg(GRAPH_CASES["fig1"]()))


def test_refused_launch_is_a_kernel_backend_error():
    assert kops.fallback_chain("cuda") == ("cuda",)
    assert kops.fallback_chain("torch_sparse") == ("torch_sparse",)
    with pytest.raises(KernelBackendError, match="launch failed"):
        _build.check_launch(9, "butterfly_update[peel]")
    assert issubclass(KernelBackendError, RuntimeError)
    _build.check_launch(0, "butterfly_update[peel]")


# --------------------------------------------------------------------- #
# Executor.map
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["auto", "kernel", "b2"])
@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
def test_map_matches_per_graph_and_reference(backend, mode):
    """Mixed shapes (two buckets): bit-identical to per-graph
    ``decompose`` and to ``bup_oracle``, in fewer level-loop calls than
    the per-graph runs; with ``fd_update_mode="auto"`` (b2 at these
    shapes) also to the reference's ``map``, counters included (its
    mask-form kernel loop in interpret mode takes minutes)."""
    gs = [powerlaw_bipartite(40, 30, 200, seed=s) for s in range(3)]
    gs += [powerlaw_bipartite(150, 80, 900, seed=s) for s in range(2)]
    jcfg, tcfg = _configs(backend, num_partitions=4, fd_update_mode=mode)
    ex = Executor(tcfg, device=CPU)
    tds = ex.map([_tg(g) for g in gs])
    jtds = JExecutor(jcfg).map(gs) if mode == "auto" else [None] * len(gs)
    rep = ex.last_map_report
    assert rep["groups"] == 2 and rep["counting_dispatches"] == rep["chunks"]
    per_graph_calls = 0
    for g, td, jtd in zip(gs, tds, jtds):
        assert isinstance(td, TipDecomposition)
        one = Executor(tcfg, device=CPU).decompose(_tg(g))
        np.testing.assert_array_equal(td.theta, one.theta)
        np.testing.assert_array_equal(td.theta, bup_oracle(g)[0])
        if jtd is not None:
            np.testing.assert_array_equal(td.theta, jtd.theta)
            assert (td.stats.rho_fd, td.stats.wedges_fd,
                    td.stats.wedges_pvbcnt, td.stats.bounds) == (
                jtd.stats.rho_fd, jtd.stats.wedges_fd,
                jtd.stats.wedges_pvbcnt, jtd.stats.bounds)
        per_graph_calls += one.stats.device_loop_calls
    assert rep["device_loop_calls"] < per_graph_calls


def test_map_side_v_and_edge_cases():
    gs = [powerlaw_bipartite(40, 30, 200, seed=s) for s in range(2)]
    tds = Executor(_configs(side="V")[1], device=CPU).map(
        [_tg(g) for g in gs])
    for g, td in zip(gs, tds):
        np.testing.assert_array_equal(td.theta, bup_oracle(g.transposed())[0])
    assert Executor(_configs()[1], device=CPU).map([]) == []
    g0 = BipartiteGraph.from_edges(5, 4, [], [])
    g1 = GRAPH_CASES["fig1"]()
    tds = Executor(_configs(num_partitions=2)[1], device=CPU).map(
        [_tg(g0), _tg(g1)])
    np.testing.assert_array_equal(tds[0].theta, np.zeros(5, np.int64))
    np.testing.assert_array_equal(tds[1].theta, bup_oracle(g1)[0])


def test_map_respects_stack_cell_budget():
    """Oversized fleets split into LPT-balanced chunks, each padded
    stack inside the budget."""
    graphs = [powerlaw_bipartite(60, 40, 350, seed=s) for s in range(9)]
    budget = 64 * 64 * 2
    ex = Executor(_configs()[1], device=CPU, map_stack_cells=budget)
    tds = ex.map([_tg(g) for g in graphs])
    rep = ex.last_map_report
    assert rep["chunks"] >= 4
    for sig in ex._map_sigs:
        _, g_pad, mm, cc = sig[:4]
        assert g_pad * mm * cc <= budget
    for g, td in zip(graphs, tds):
        np.testing.assert_array_equal(td.theta, bup_oracle(g)[0])
    # a second fleet of the same shapes: every chunk signature is a hit
    ex.map([_tg(powerlaw_bipartite(60, 40, 350, seed=s))
            for s in range(20, 29)])
    assert ex.last_map_report["cache_misses"] == 0
    assert ex.last_map_report["cache_hits"] == rep["chunks"]


def test_map_rejects_legacy_fd_modes():
    with pytest.raises(ValueError, match="fd_mode"):
        Executor(_configs(fd_mode="b2")[1], device=CPU).map(
            [_tg(GRAPH_CASES["fig1"]())])


# --------------------------------------------------------------------- #
# TipDecomposition
# --------------------------------------------------------------------- #
def test_tip_decomposition_queries():
    g = GRAPH_CASES["fig1"]()
    td = decompose(_tg(g), _configs(num_partitions=2)[1], device=CPU)
    np.testing.assert_array_equal(td.theta, bup_oracle(g)[0])   # [2,3,3,1]
    assert td.n == 4 and td.vertex_tip(1) == 3 and td.max_theta() == 3
    assert td.max_level() == 3 and td.numbers is td.theta
    with pytest.raises(IndexError):
        td.vertex_tip(99)
    sub, members, v_ids = td.subgraph_at(3)
    np.testing.assert_array_equal(members, [1, 2])   # the 3-tip: u2, u3
    assert sub.n_u == 2 and sub.m > 0 and len(v_ids) == sub.n_v
    assert td.subgraph_at(0)[1].size == g.n_u
    d = td.to_dict()
    assert (d["workload"], d["axis"], d["side"]) == ("tip", "vertex", "U")
    assert d["numbers"] == [int(x) for x in td.theta] and d["max_level"] == 3
    json.dumps(d)
    with pytest.raises(ValueError, match="EngineConfig or ReceiptConfig"):
        decompose(_tg(g), {"num_partitions": 2}, device=CPU)

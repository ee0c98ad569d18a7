"""The port's edge axis (wing decomposition) against the reference's:
the edge ops (``kernels.ops``), the wing engine (``core.engine.wing``),
the numpy oracles (``core.wing``) and the Executor's wing workload.

Each case is built once with numpy and handed to both packages; the
reference runs its ``xla`` backend (its edge ops are plain jnp on every
backend), the port the plain versions of its kernels on the CPU, both at
kernel blocks (8, 8, 8).  Equality is ``np.array_equal``: bit-identical,
tolerance 0.  By design the port's ``edge_support_delta`` is
before-minus-after of the closed form, so it is compared on every slot
the engine or the service reads (not on the removed slots themselves),
and the counters that are the port's own (``host_round_trips``,
``device_loop_calls``) are not compared.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import GRAPH_CASES
from repro.api import EngineConfig as JEngineConfig
from repro.api import Executor as JExecutor
from repro.core import wing as jwing
from repro.core.engine.peel_loop import DELTA_RULES as J_DELTA_RULES
from repro.core.engine import ReceiptConfig as JReceiptConfig
from repro.core.engine import wing_decompose_engine as j_wing_engine
from repro.core.graph import powerlaw_bipartite
from repro.kernels import ops as jops
from repro_torch.api import (EngineConfig, Executor, PlanInfeasibleError,
                             WingDecomposition)
from repro_torch.convert import engine_config_from_fields, graph_from_arrays
from repro_torch.core import wing as twing
from repro_torch.core.engine import DELTA_RULES, ReceiptConfig
from repro_torch.core.engine import wing_decompose_engine
from repro_torch.kernels import ops as tops

BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")
COUNTERS = ("rho_cd", "rho_fd", "wedges_cd", "wedges_fd", "huc_recounts",
            "elided_sweeps", "num_subsets", "bounds", "sweeps_per_subset",
            "subset_sizes", "fd_groups", "fd_max_levels", "fd_peel_widths")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors; the test
    workers' pools would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ORACLE = {}


def _oracle(case):
    if case not in _ORACLE:
        _ORACLE[case] = jwing.wing_bup_oracle(GRAPH_CASES[case]())[0]
    return _ORACLE[case]


def _tg(g):
    return graph_from_arrays(g.n_u, g.n_v, g.edges_u, g.edges_v)


def _edge_inputs(seed, n_u=24, n_v=20, density=0.35, stack=0):
    """A seeded 0/1 matrix (or a stack of them) with edge slots: every
    edge of member 0, some absent cells (edges removed from the later
    members, and cells never set), and padding slots aliasing (0, 0)."""
    rng = np.random.default_rng(seed)
    a = (rng.random((max(stack, 1), n_u, n_v)) < density).astype(np.float32)
    a[:, 0, 0] = 1.0
    eu, ev = np.nonzero(a[0])
    absent = rng.integers(0, n_u, 5), rng.integers(0, n_v, 5)
    eu = np.concatenate([eu, absent[0], np.zeros(6, np.int64)])
    ev = np.concatenate([ev, absent[1], np.zeros(6, np.int64)])
    for k in range(1, a.shape[0]):                  # thinner members
        a[k] *= (rng.random((n_u, n_v)) < 0.8)
    return (a if stack else a[0]), eu.astype(np.int32), ev.astype(np.int32)


# --------------------------------------------------------------------- #
# the edge ops
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("stack", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_support_all_matches_reference(seed, stack):
    """2-D and stacked (the FD stack: one slot map broadcast over the
    members, and a per-member map), absent cells and padding slots."""
    a, eu, ev = _edge_inputs(seed, stack=stack)
    want = np.asarray(jops.edge_support_all(jnp.asarray(a), jnp.asarray(eu),
                                            jnp.asarray(ev), backend="xla"))
    got = tops.edge_support_all(torch.from_numpy(a), torch.from_numpy(eu),
                                torch.from_numpy(ev), backend="torch")
    np.testing.assert_array_equal(got.numpy(), want)
    if stack:
        eu2 = np.stack([np.roll(eu, k) for k in range(stack)])
        ev2 = np.stack([np.roll(ev, k) for k in range(stack)])
        want = np.asarray(jops.edge_support_all(
            jnp.asarray(a), jnp.asarray(eu2), jnp.asarray(ev2),
            backend="xla"))
        got = tops.edge_support_all(torch.from_numpy(a),
                                    torch.from_numpy(eu2),
                                    torch.from_numpy(ev2))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_rem", [1, 5, 17])
@pytest.mark.parametrize("seed", [0, 3])
def test_edge_support_delta_matches_reference_on_read_slots(seed, n_rem):
    """A set of distinct present edges (as the engine's peel sets and the
    service's deleted slots are), with padding entries of ``valid``
    False: equal on every slot outside the removed set — surviving edges,
    absent cells, padding slots aliasing a surviving (0, 0)."""
    a, eu, ev = _edge_inputs(seed)
    present = np.where(a[eu, ev] > 0)[0]
    present = present[(eu[present] != 0) | (ev[present] != 0)]
    rng = np.random.default_rng(seed + 10)
    rows = rng.choice(np.unique(eu[present] * 1000 + ev[present]).size,
                      n_rem, replace=False)
    keys = np.unique(eu[present] * 1000 + ev[present])[rows]
    slots = np.array([np.where(eu * 1000 + ev == k)[0][0] for k in keys])
    rows = np.concatenate([slots, [0, 3]]).astype(np.int32)   # + padding
    valid = np.arange(rows.size) < slots.size
    want = np.asarray(jops.edge_support_delta(
        jnp.asarray(a), jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(rows),
        jnp.asarray(valid), backend="xla"))
    got = tops.edge_support_delta(
        torch.from_numpy(a), torch.from_numpy(eu), torch.from_numpy(ev),
        torch.from_numpy(rows), torch.from_numpy(valid)).numpy()
    removed = np.isin(eu * 1000 + ev, keys)
    read = ~removed
    assert read.sum() > 0 and (want[read] != 0).any()
    np.testing.assert_array_equal(got[read], want[read])


@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("seed", [0, 4])
def test_vertex_support_edge_delta_matches_reference(seed, backend):
    """Every row: a present edge, one named twice, absent cells and
    padding entries all behave as the reference's gated composition."""
    a, eu, ev = _edge_inputs(seed, n_u=32, n_v=24)
    rng = np.random.default_rng(seed)
    present = np.where(a[eu, ev] > 0)[0][:9]
    mu = np.concatenate([eu[present], eu[present[:2]], [5, 7], [0, 0]])
    mv = np.concatenate([ev[present], ev[present[:2]], [23, 22], [0, 0]])
    a[5, 23] = a[7, 22] = 0.0                       # absent cells
    valid = np.ones(mu.size, bool)
    valid[-2:] = False                              # padding
    order = rng.permutation(mu.size)
    mu, mv, valid = mu[order], mv[order], valid[order]
    want = np.asarray(jops.vertex_support_edge_delta(
        jnp.asarray(a), jnp.asarray(mu, jnp.int32), jnp.asarray(mv, jnp.int32),
        jnp.asarray(valid), backend="xla"))
    got = tops.vertex_support_edge_delta(
        torch.from_numpy(a), torch.from_numpy(mu), torch.from_numpy(mv),
        torch.from_numpy(valid), backend=backend, blocks=BLOCKS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0


def test_delta_rules_registry_matches_reference():
    assert set(DELTA_RULES) == set(J_DELTA_RULES) == {"vertex", "edge"}
    for axis in DELTA_RULES:
        assert DELTA_RULES[axis].axis == J_DELTA_RULES[axis].axis == axis
        assert (DELTA_RULES[axis].mutable_geom
                == J_DELTA_RULES[axis].mutable_geom)


# --------------------------------------------------------------------- #
# the numpy oracles (core.wing)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_oracles_match_reference(case):
    g = GRAPH_CASES[case]()
    psi, rounds = twing.wing_bup_oracle(_tg(g))
    np.testing.assert_array_equal(psi, _oracle(case))
    assert rounds == g.m
    if g.m:
        a = g.dense()[: g.n_u, : g.n_v].astype(np.float64)
        np.testing.assert_array_equal(twing.edge_butterfly_counts(a),
                                      jwing.edge_butterfly_counts(a))
    tpsi, tst = twing.wing_decompose(_tg(g), num_partitions=3)
    jpsi, jst = jwing.wing_decompose(g, num_partitions=3)
    np.testing.assert_array_equal(tpsi, jpsi)
    assert (tst.rho_cd, tst.num_subsets, tst.bounds) == (
        jst.rho_cd, jst.num_subsets, [float(b) for b in jst.bounds])


# --------------------------------------------------------------------- #
# the wing engine
# --------------------------------------------------------------------- #
def _both_engines(g, side="U", **kw):
    base = dict(num_partitions=4, kernel_blocks=BLOCKS)
    base.update(kw)
    jpsi, jst = j_wing_engine(g, JReceiptConfig(backend="xla", **base),
                              side=side)
    tpsi, tst = wing_decompose_engine(
        _tg(g), ReceiptConfig(backend="torch", **base), side=side,
        device=CPU)
    return jpsi, jst, tpsi, tst


def _assert_same(jpsi, jst, tpsi, tst, case):
    np.testing.assert_array_equal(tpsi, jpsi)
    np.testing.assert_array_equal(tpsi, _oracle(case))
    for key in COUNTERS:
        assert getattr(tst, key) == getattr(jst, key), key


@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_wing_engine_matches_reference(case, dispatch, side):
    g = GRAPH_CASES[case]()
    _assert_same(*_both_engines(g, side=side, cd_dispatch=dispatch), case)


@pytest.mark.parametrize("dispatch", ["subset", "graph"])
@pytest.mark.parametrize("case", ["powerlaw", "vhub", "er_dense"])
def test_wing_engine_variants_match_reference(case, dispatch):
    """HUC off (every sweep recounts), a one-sweep valve (cap-exit
    re-entry), a narrow peel width (the HUC rule's width test) and
    P = 2; the sparse backend of the port too."""
    g = GRAPH_CASES[case]()
    for kw in (dict(use_huc=False), dict(max_sweeps=1),
               dict(peel_width=8), dict(num_partitions=2)):
        _assert_same(*_both_engines(g, cd_dispatch=dispatch, **kw), case)
    jpsi, jst = j_wing_engine(g, JReceiptConfig(
        backend="xla", num_partitions=4, kernel_blocks=BLOCKS,
        cd_dispatch=dispatch))
    tpsi, tst = wing_decompose_engine(_tg(g), ReceiptConfig(
        backend="torch_sparse", num_partitions=4, kernel_blocks=BLOCKS,
        cd_dispatch=dispatch), device=CPU)
    _assert_same(jpsi, jst, tpsi, tst, case)


def test_wing_engine_huc_fires_on_both_sides():
    """A graph whose peel sets pass ``c_rcnt`` makes the HUC recount
    decision on both sides, the same number of times."""
    g = powerlaw_bipartite(60, 12, 500, seed=2)
    jpsi, jst, tpsi, tst = _both_engines(g, num_partitions=3)
    np.testing.assert_array_equal(tpsi, jpsi)
    assert tst.huc_recounts == jst.huc_recounts > 0
    assert tst.wedges_cd == jst.wedges_cd


# --------------------------------------------------------------------- #
# the Executor's wing workload
# --------------------------------------------------------------------- #
def _api(**kw):
    base = dict(workload="wing", kernel_blocks=BLOCKS, num_partitions=4)
    base.update(kw)
    jcfg = JEngineConfig(backend="xla", **base)
    return jcfg, engine_config_from_fields(jcfg.to_dict())


def test_engine_config_carries_wing_across():
    jcfg, tcfg = _api(side="V")
    assert tcfg.workload == "wing" and tcfg.backend == "torch"
    assert tcfg.to_dict() == dict(jcfg.to_dict(), backend="torch")


@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("case", ["er_small", "er_dense", "vhub"])
def test_executor_wing_decompose_verify_matches_reference(case, side):
    g = GRAPH_CASES[case]()
    jcfg, tcfg = _api(side=side)
    jwd = JExecutor(jcfg).decompose(g, verify=True)
    ex = Executor(tcfg, device=CPU)
    twd = ex.decompose(_tg(g), verify=True)
    assert isinstance(twd, WingDecomposition)
    np.testing.assert_array_equal(twd.edge_wing, jwd.edge_wing)
    np.testing.assert_array_equal(twd.numbers, _oracle(case))
    assert twd.stats.verified
    assert twd.stats.verify_checks == jwd.stats.verify_checks
    for key in COUNTERS:
        assert getattr(twd.stats, key) == getattr(jwd.stats, key), key
    k = max(twd.max_psi(), 1)
    sub, keep = twd.subgraph_at(k)
    jsub, jkeep = jwd.subgraph_at(k)
    np.testing.assert_array_equal(keep, jkeep)
    assert sub.m == jsub.m == len(keep)
    if g.m:
        assert twd.edge_psi(0) == jwd.edge_psi(0)
    assert twd.to_dict() == jwd.to_dict()


def test_executor_wing_cache_matches_reference():
    g = GRAPH_CASES["powerlaw"]()
    jcfg, tcfg = _api()
    jex, tex = JExecutor(jcfg), Executor(tcfg, device=CPU)
    for _ in range(2):
        np.testing.assert_array_equal(tex.decompose(_tg(g)).edge_wing,
                                      jex.decompose(g).edge_wing)
    assert tex.cache_stats == jex.cache_stats
    plan = tex.plan(_tg(g))
    assert plan.signature[-1] == "wing"
    assert plan.signature != Executor(EngineConfig(
        kernel_blocks=BLOCKS, num_partitions=4), device=CPU).plan(
            _tg(g)).signature


def test_executor_map_rejects_wing_and_config_rejects_wing_tiled():
    g = _tg(GRAPH_CASES["fig1"]())
    with pytest.raises(PlanInfeasibleError, match="tip"):
        Executor(_api()[1], device=CPU).map([g])
    for cls in (JEngineConfig, EngineConfig):
        with pytest.raises(ValueError, match="tiled"):
            cls(workload="wing", representation="tiled")


def test_wing_plan_matches_reference_but_its_bytes():
    """Every plan field but the by-design memory count (``padded_bytes``
    and the cost model's byte entries) and the host-sync bound; an
    admission budget downshifts P by the port's own per-member cost."""
    g = GRAPH_CASES["powerlaw"]()
    for dispatch in ("subset", "graph"):
        jcfg, tcfg = _api(cd_dispatch=dispatch)
        jd = JExecutor(jcfg).plan(g).to_dict()
        tplan = Executor(tcfg, device=CPU).plan(_tg(g))
        td = tplan.to_dict()
        for d in (jd, td):
            for key in ("padded_bytes", "cd_host_syncs_bound", "backend",
                        "kernel_route", "signature"):
                d.pop(key)
            for key in ("dense_bytes", "dense_fixed_bytes"):
                d["cost_model"].pop(key)
        assert td == jd
        fixed = tplan.cost_model["dense_fixed_bytes"]
        member = (tplan.padded_bytes - fixed) // (tplan.num_partitions - 1)
        assert tplan.padded_bytes == fixed + 3 * member
    budget = fixed + member
    small = Executor(_api(memory_budget_bytes=budget)[1], device=CPU).plan(
        _tg(g))
    assert small.degraded_from_partitions == 4
    assert small.padded_bytes == budget and small.num_partitions == 2
    with pytest.raises(PlanInfeasibleError, match="budget"):
        Executor(_api(memory_budget_bytes=fixed - 1)[1],
                 device=CPU).plan(_tg(g))

"""The port's exact incremental re-peel (``core.engine.refresh`` and
``Executor.repeel``) against the reference's.

Mutation batches are made from a seed with the reference benchmark's
rule (inserts absent from the graph and deletes of present edges, both
at low-degree endpoints); the maintained supports, the stop ladder and
the watch set are built as the reference's service builds them (the
ladder is a copy of its ``_ladder``), once with numpy, and handed to both
packages.  The reference runs its ``xla`` backend, the port the plain
versions of its kernels on the CPU, both at kernel blocks (8, 8, 8).
Numbers, the stop used and the refresh counters must be bit-identical,
and the numbers equal to a from-scratch decomposition of the mutated
graph.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import GRAPH_CASES
from repro.api import EngineConfig as JEngineConfig
from repro.api import Executor as JExecutor
from repro.core.engine import ReceiptConfig as JReceiptConfig
from repro.core.engine import refresh as jrefresh
from repro.core.graph import BipartiteGraph, powerlaw_bipartite
from repro.core.peeling import bup_oracle
from repro.core.wing import wing_bup_oracle
from repro.kernels import ops as jops
from repro_torch.api import EngineConfig, Executor, PlanInfeasibleError
from repro_torch.convert import (BACKEND_MAP, engine_config_from_fields,
                                 graph_from_arrays)
from repro_torch.core.engine import ReceiptConfig, RunStats
from repro_torch.core.engine import refresh as trefresh

BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")
REFRESH = ("rho_fd", "wedges_fd", "refresh_stop", "refresh_mode")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors; the test
    workers' pools would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tg(g):
    return graph_from_arrays(g.n_u, g.n_v, g.edges_u, g.edges_v)


def _mutations(g, count, rng):
    """``count`` inserts absent from ``g`` + ``count`` present deletes at
    low-degree endpoints (the reference benchmark's rule)."""
    du = np.bincount(g.edges_u, minlength=g.n_u)
    dv = np.bincount(g.edges_v, minlength=g.n_v)
    u_pool = np.argsort(du)[: max(8, g.n_u // 4)]
    v_pool = np.argsort(dv)[: max(8, g.n_v // 4)]
    have = set((g.edges_u.astype(np.int64) * g.n_v + g.edges_v).tolist())
    ins = []
    while len(ins) < count:
        u, v = int(rng.choice(u_pool)), int(rng.choice(v_pool))
        if u * g.n_v + v not in have:
            have.add(u * g.n_v + v)
            ins.append((u, v))
    drop = np.argsort(du[g.edges_u] + dv[g.edges_v])[:count]
    return np.array(ins, np.int64).reshape(-1, 2), drop


def _ladder(bounds, floor):
    """The reference service's stop ladder: rungs strictly above
    ``floor``, then ``inf``."""
    rungs = sorted({float(b) for b in (bounds or [])
                    if float(b) > floor + 0.5})
    rungs.append(float("inf"))
    return rungs


def _mutate(g, frac, seed):
    rng = np.random.default_rng(seed)
    k = max(1, int(round(frac * g.m / 2)))
    ins, drop = _mutations(g, k, rng)
    keep = np.ones(g.m, bool)
    keep[drop] = False
    g1 = BipartiteGraph.from_edges(
        g.n_u, g.n_v, np.concatenate([g.edges_u[keep], ins[:, 0]]),
        np.concatenate([g.edges_v[keep], ins[:, 1]]))
    return g1, ins, np.stack([g.edges_u[drop], g.edges_v[drop]], 1)


def _tip_inputs(g0, ins, dels, theta_old, bounds):
    """Maintained supports (host supports of the base graph + the gains
    of the inserts - the losses of the deletes, both from the union
    matrix), the ladder and the watch set, as the reference service
    builds them."""
    a = np.zeros((g0.n_u, g0.n_v), np.float32)
    a[g0.edges_u, g0.edges_v] = 1.0
    w = a.astype(np.float64) @ a.T.astype(np.float64)
    per = w * (w - 1.0) / 2.0
    np.fill_diagonal(per, 0.0)
    sup = per.sum(axis=1)
    a[ins[:, 0], ins[:, 1]] = 1.0
    for rows, sign in ((ins, 1.0), (dels, -1.0)):
        d = jops.vertex_support_edge_delta(
            jnp.asarray(a), jnp.asarray(rows[:, 0], jnp.int32),
            jnp.asarray(rows[:, 1], jnp.int32), jnp.ones(len(rows), bool))
        sup = sup + sign * np.asarray(d, np.float64)
    t_known = float(theta_old[dels[:, 0]].max())
    seed = max(t_known, float(theta_old[ins[:, 0]].max()))
    return sup, _ladder(bounds, seed), np.unique(ins[:, 0])


def _wing_inputs(g0, g1, ins, dels, psi_base, bounds):
    """The reference service's wing arm: union supports in closed form,
    deletions through the delta, kept slots; inserted edges watched."""
    n_v = g0.n_v
    k0 = g0.edges_u.astype(np.int64) * n_v + g0.edges_v
    k1 = g1.edges_u.astype(np.int64) * n_v + g1.edges_v
    ki = ins[:, 0] * n_v + ins[:, 1]
    kd = dels[:, 0] * n_v + dels[:, 1]
    ku = np.sort(np.concatenate([k0, ki]))
    eu, ev = (ku // n_v).astype(np.int32), (ku % n_v).astype(np.int32)
    a = np.zeros((g0.n_u, n_v), np.float32)
    a[eu, ev] = 1.0
    b = np.asarray(jops.edge_support_all(jnp.asarray(a), jnp.asarray(eu),
                                         jnp.asarray(ev)), np.float64)
    d = np.asarray(jops.edge_support_delta(
        jnp.asarray(a), jnp.asarray(eu), jnp.asarray(ev),
        jnp.asarray(np.searchsorted(ku, kd).astype(np.int32)),
        jnp.ones(kd.size, bool)), np.float64)
    sup = (b - d)[np.isin(ku, k1)]
    psi_old = np.zeros(g1.m, np.int64)
    in_base = np.isin(k1, k0)
    psi_old[in_base] = psi_base[np.searchsorted(k0, k1[in_base])]
    t_known = float(psi_base[np.searchsorted(k0, kd)].max())
    return sup, _ladder(bounds, t_known), np.nonzero(np.isin(k1, ki))[0]


def _graphs():
    return {"powerlaw": GRAPH_CASES["powerlaw"](),
            "vhub": GRAPH_CASES["vhub"](),
            "er_dense": GRAPH_CASES["er_dense"]()}


# --------------------------------------------------------------------- #
# the engine entry points
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("frac", [0.02, 0.1])
@pytest.mark.parametrize("case", ["powerlaw", "vhub", "er_dense"])
def test_repeel_tip_prefix_matches_reference(case, frac, backend):
    g0 = _graphs()[case]
    g1, ins, dels = _mutate(g0, frac, seed=len(case))
    jcfg = JReceiptConfig(backend="xla", kernel_blocks=BLOCKS,
                          num_partitions=4)
    base = JExecutor(JEngineConfig(backend="xla", kernel_blocks=BLOCKS,
                                   num_partitions=4)).decompose(g0)
    sup, stops, watch = _tip_inputs(g0, ins, dels, base.theta,
                                    base.stats.bounds)
    jst = jrefresh.RunStats()
    jtheta, jstop = jrefresh.repeel_tip_prefix(g1, sup, base.theta, stops,
                                               watch, jcfg, jst)
    tst = RunStats()
    ttheta, tstop = trefresh.repeel_tip_prefix(
        _tg(g1), sup, base.theta, stops, watch, ReceiptConfig(
            backend=backend, kernel_blocks=BLOCKS, num_partitions=4),
        tst, device=CPU)
    np.testing.assert_array_equal(ttheta, jtheta)
    np.testing.assert_array_equal(ttheta, bup_oracle(g1)[0])
    assert tstop == jstop
    for key in REFRESH:
        assert getattr(tst, key) == getattr(jst, key), key


def test_repeel_escalates_and_caps_as_the_reference():
    """An edge inserted at the densest vertex: the first rung (above the
    deletion ceiling) is below its new tip number, so the watched row
    survives it and the stop escalates; a one-sweep valve re-enters at
    every stop."""
    g0 = powerlaw_bipartite(150, 90, 1100, seed=8)
    base = JExecutor(JEngineConfig(backend="xla", kernel_blocks=BLOCKS,
                                   num_partitions=6)).decompose(g0)
    top = int(np.argmax(base.theta))
    v_new = int(np.setdiff1d(np.arange(g0.n_v),
                             g0.edges_v[g0.edges_u == top])[0])
    ins = np.array([[top, v_new]])
    _g, _i, dels = _mutate(g0, 0.002, seed=3)
    keep = ~((g0.edges_u == dels[0, 0]) & (g0.edges_v == dels[0, 1]))
    g1 = BipartiteGraph.from_edges(
        g0.n_u, g0.n_v, np.append(g0.edges_u[keep], top),
        np.append(g0.edges_v[keep], v_new))
    sup, _stops, watch = _tip_inputs(g0, ins, dels[:1], base.theta,
                                     base.stats.bounds)
    stops = _ladder(base.stats.bounds, float(base.theta[dels[0, 0]]))
    for max_sweeps in (100_000, 1):
        jst, tst = jrefresh.RunStats(), RunStats()
        jtheta, jstop = jrefresh.repeel_tip_prefix(
            g1, sup, base.theta, stops, watch, JReceiptConfig(
                backend="xla", kernel_blocks=BLOCKS,
                max_sweeps=max_sweeps), jst)
        ttheta, tstop = trefresh.repeel_tip_prefix(
            _tg(g1), sup, base.theta, stops, watch, ReceiptConfig(
                backend="torch", kernel_blocks=BLOCKS,
                max_sweeps=max_sweeps), tst, device=CPU)
        np.testing.assert_array_equal(ttheta, jtheta)
        np.testing.assert_array_equal(ttheta, bup_oracle(g1)[0])
        assert tstop == jstop and tst.rho_fd == jst.rho_fd
        assert tst.device_loop_calls == jst.device_loop_calls
    assert jstop > stops[0]                  # it escalated


@pytest.mark.parametrize("case", ["er_small", "er_dense", "vhub"])
def test_repeel_wing_prefix_matches_reference(case):
    g0 = GRAPH_CASES[case]()
    g1, ins, dels = _mutate(g0, 0.05, seed=11)
    jcfg = JReceiptConfig(backend="xla", kernel_blocks=BLOCKS,
                          num_partitions=4)
    base = JExecutor(JEngineConfig(
        workload="wing", backend="xla", kernel_blocks=BLOCKS,
        num_partitions=4)).decompose(g0)
    sup, stops, watch = _wing_inputs(g0, g1, ins, dels, base.edge_wing,
                                     base.stats.bounds)
    psi_old = np.zeros(g1.m, np.int64)
    jst = jrefresh.RunStats()
    jpsi, jstop = jrefresh.repeel_wing_prefix(g1, sup, psi_old, stops,
                                              watch, jcfg, jst)
    sup_t, stops_t, watch_t = _wing_inputs(g0, g1, ins, dels,
                                           base.edge_wing, base.stats.bounds)
    tst = RunStats()
    tpsi, tstop = trefresh.repeel_wing_prefix(
        _tg(g1), sup_t, psi_old, stops_t, watch_t, ReceiptConfig(
            backend="torch", kernel_blocks=BLOCKS, num_partitions=4),
        tst, device=CPU)
    np.testing.assert_array_equal(tpsi, jpsi)
    assert tstop == jstop
    for key in REFRESH:
        assert getattr(tst, key) == getattr(jst, key), key


# --------------------------------------------------------------------- #
# Executor.repeel
# --------------------------------------------------------------------- #
def _cfgs(**kw):
    jcfg = JEngineConfig(backend="xla", kernel_blocks=BLOCKS,
                         num_partitions=4, **kw)
    return jcfg, engine_config_from_fields(jcfg.to_dict())


@pytest.mark.parametrize("side", ["U", "V"])
def test_executor_repeel_tip_matches_reference(side):
    g0 = GRAPH_CASES["powerlaw"]()
    g1, ins, dels = _mutate(g0, 0.05, seed=2)
    jcfg, tcfg = _cfgs(side=side)
    jex, tex = JExecutor(jcfg), Executor(tcfg, device=CPU)
    base = jex.decompose(g0)
    if side == "V":
        g0t = g0.transposed()
        ins_t, dels_t = ins[:, ::-1].copy(), dels[:, ::-1].copy()
        sup, stops, watch = _tip_inputs(g0t, ins_t, dels_t, base.theta,
                                        base.stats.bounds)
    else:
        sup, stops, watch = _tip_inputs(g0, ins, dels, base.theta,
                                        base.stats.bounds)
    kw = dict(sup0=sup, numbers_old=base.theta, stops=stops, watch=watch)
    jnum, jst = jex.repeel(g1, **kw)
    tnum, tst = tex.repeel(_tg(g1), **kw)
    np.testing.assert_array_equal(tnum, jnum)
    np.testing.assert_array_equal(tnum, tex.decompose(_tg(g1)).numbers)
    for key in REFRESH:
        assert getattr(tst, key) == getattr(jst, key), key
    assert tst.backend_used == BACKEND_MAP[jst.backend_used] == "torch"
    assert tst.refresh_mode == "delta"
    assert tex.cache_stats["hits"] >= 1


def test_executor_repeel_wing_matches_reference():
    g0 = GRAPH_CASES["er_dense"]()
    g1, ins, dels = _mutate(g0, 0.05, seed=5)
    jcfg, tcfg = _cfgs(workload="wing")
    jex, tex = JExecutor(jcfg), Executor(tcfg, device=CPU)
    base = jex.decompose(g0)
    sup, stops, watch = _wing_inputs(g0, g1, ins, dels, base.edge_wing,
                                     base.stats.bounds)
    kw = dict(sup0=sup, numbers_old=np.zeros(g1.m, np.int64), stops=stops,
              watch=watch)
    jnum, jst = jex.repeel(g1, **kw)
    tnum, tst = tex.repeel(_tg(g1), **kw)
    np.testing.assert_array_equal(tnum, jnum)
    np.testing.assert_array_equal(tnum, wing_bup_oracle(g1)[0])
    for key in REFRESH:
        assert getattr(tst, key) == getattr(jst, key), key


def test_executor_repeel_rejects_tiled_plans():
    g0 = GRAPH_CASES["powerlaw"]()
    _jcfg, tcfg = _cfgs(representation="tiled")
    with pytest.raises(PlanInfeasibleError, match="tiled"):
        Executor(tcfg, device=CPU).repeel(
            _tg(g0), sup0=np.zeros(g0.n_u), numbers_old=np.zeros(g0.n_u),
            stops=[float("inf")], watch=np.zeros(0, np.int64))


def test_executor_repeel_runs_on_the_card_by_default():
    """No device: the card, and an error where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only failure cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trefresh.repeel_tip_prefix(
            _tg(GRAPH_CASES["fig1"]()), np.zeros(4), np.zeros(4),
            [float("inf")], np.zeros(0, np.int64))

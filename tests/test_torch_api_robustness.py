"""The port's hardened runtime (``repro_torch.api``): fault specs through
EngineConfig, injected kernel failures (one-backend chain: they raise,
never reroute), ``guardrails=False``, fleet isolation in
``Executor.map``, verify mode and straggler flagging — the counterparts
of the reference's ``tests/test_robustness.py`` on the port, on the CPU
(the plain versions of the kernels, kernel blocks (8, 8, 8))."""
import numpy as np
import pytest
import torch

from repro_torch.api import (EngineConfig, Executor, PlanInfeasibleError,
                             verify_tip_decomposition)
from repro_torch.api.errors import (FleetPartialFailure,
                                    GraphValidationError,
                                    KernelBackendError, ReceiptError,
                                    VerificationError)
from repro_torch.api.faults import FaultSpec
from repro_torch.core.graph import (BipartiteGraph, paper_fig1_graph,
                                    powerlaw_bipartite, random_bipartite)
from repro_torch.core.peeling import bup_oracle

BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(num_partitions=3, kernel_blocks=BLOCKS, backend="torch")
    base.update(kw)
    return EngineConfig(**base)


def _er(nu, nv, ne, seed):
    rng = np.random.default_rng(seed)
    return BipartiteGraph.from_edges(
        nu, nv, rng.integers(0, nu, ne), rng.integers(0, nv, ne))


def _bad_graph():
    """A graph whose edge points past its U side (fails validate())."""
    return BipartiteGraph(4, 4, np.array([9]), np.array([0]))


# --------------------------------------------------------------------- #
# fault specs through EngineConfig
# --------------------------------------------------------------------- #
def test_engine_config_parses_fault_spec():
    cfg = _cfg(fault_spec="kernel_launch:backend=torch@2x3, map_chunk")
    rules = FaultSpec.parse(cfg.fault_spec).rules
    assert [(r.site, r.nth, r.count) for r in rules] == [
        ("kernel_launch", 2, 3), ("map_chunk", 0, 1)]
    with pytest.raises(ValueError, match="kernel_launch"):
        _cfg(fault_spec="kernel_lunch@1")
    with pytest.raises(ValueError, match="unknown fault-injection site"):
        _cfg(fault_spec="bogus")


# --------------------------------------------------------------------- #
# kernel failures: one backend, no reroute
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
def test_injected_kernel_fault_raises_naming_one_backend(backend, dispatch):
    g = _er(40, 30, 200, 1)
    ex = Executor(_cfg(backend=backend, cd_dispatch=dispatch,
                       fault_spec=f"kernel_launch:backend={backend}@1x*"),
                  device=CPU)
    for _ in range(3):
        with pytest.raises(KernelBackendError) as ei:
            ex.decompose(g)
        msg = str(ei.value)
        assert f"fallback chain failed: {backend} (last" in msg
        assert ei.value.plan_signature is not None
    # no backend to quarantine onto: the signature stays on its own
    assert ex.cache_stats["quarantined"] == 0
    assert ex.cache_stats["fallback_runs"] == 0
    assert ex.fault_report[0]["fired"] == 3


def test_one_shot_kernel_fault_then_clean_run():
    g = _er(40, 30, 200, 1)
    base = Executor(_cfg(), device=CPU).decompose(g).theta
    ex = Executor(_cfg(fault_spec="kernel_launch@1"), device=CPU)
    with pytest.raises(KernelBackendError):
        ex.decompose(g)
    td = ex.decompose(g)                        # the rule fired once
    np.testing.assert_array_equal(td.theta, base)
    assert td.stats.backend_used == "torch"
    assert td.stats.backend_fallbacks == []


def test_a_bare_runtime_error_is_not_a_kernel_failure(monkeypatch):
    """Only KernelBackendError takes the chain's path: a programming
    error propagates as itself."""
    ex = Executor(_cfg(), device=CPU)

    def boom(*a, **k):
        raise RuntimeError("not a kernel")

    monkeypatch.setattr(ex, "_engine_run", boom)
    with pytest.raises(RuntimeError, match="not a kernel") as ei:
        ex.decompose(_er(30, 20, 100, 2))
    assert type(ei.value) is RuntimeError and ei.value.__cause__ is None
    assert not isinstance(ei.value, KernelBackendError)


def test_guardrails_off_propagates_and_suppresses(monkeypatch):
    g = _er(30, 20, 100, 2)
    base = Executor(_cfg(), device=CPU).decompose(g).theta
    # guardrails=False suppresses this executor's own injector: the bare
    # path is byte-identical to an uninjected run
    ex = Executor(_cfg(fault_spec="kernel_launch@1x*"), guardrails=False,
                  device=CPU)
    np.testing.assert_array_equal(ex.decompose(g).theta, base)
    # ... and a kernel failure propagates unwrapped

    def fail(*a, **k):
        raise KernelBackendError("raw launch failure")

    monkeypatch.setattr(ex, "_engine_run", fail)
    with pytest.raises(KernelBackendError) as ei:
        ex.decompose(g)
    assert str(ei.value) == "raw launch failure"
    assert ei.value.__cause__ is None


# --------------------------------------------------------------------- #
# admission control
# --------------------------------------------------------------------- #
def test_infeasible_budget_raises():
    with pytest.raises(PlanInfeasibleError) as ei:
        Executor(_cfg(memory_budget_bytes=1024), device=CPU).decompose(
            _er(40, 30, 200, 1))
    assert "budget" in str(ei.value) and isinstance(ei.value, ValueError)


def test_no_budget_means_no_admission_control():
    plan = Executor(_cfg(num_partitions=4), device=CPU).plan(
        random_bipartite(50, 30, 0.15, seed=3))
    assert plan.memory_budget_bytes is None
    assert plan.degraded_from_partitions is None


# --------------------------------------------------------------------- #
# fleet isolation
# --------------------------------------------------------------------- #
class TestFleetIsolation:
    def _fleet(self):
        return [_er(16, 12, 60, s) for s in range(5)]

    @pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
    def test_bad_member_isolated_healthy_bit_identical(self, backend):
        fleet = self._fleet()
        clean = Executor(_cfg(backend=backend), device=CPU).map(fleet)
        fleet_bad = fleet[:2] + [_bad_graph()] + fleet[2:]
        ex = Executor(_cfg(backend=backend, fault_spec="map_chunk@1"),
                      device=CPU)
        res = ex.map(fleet_bad)
        assert len(res) == 6
        assert isinstance(res[2], GraphValidationError)
        assert res[2].context["graph_index"] == 2
        healthy = res[:2] + res[3:]
        for got, want in zip(healthy, clean):
            np.testing.assert_array_equal(got.theta, want.theta)
            # re-run one at a time on the SAME backend, never rerouted
            assert got.stats.backend_used == backend
        rep = ex.last_map_report
        assert rep["chunk_failures"] == 1          # the injected fault
        assert rep["isolated_graphs"] == 5 and rep["chunk_retries"] == 0
        assert list(rep["errors"]) == [2]

    def test_member_kernel_fault_pinned_to_that_member(self):
        """A launch fault that hits one member's lone re-run stays on
        that member; the rest of the chunk keeps its results."""
        fleet = self._fleet()
        clean = Executor(_cfg(), device=CPU).map(fleet)
        # launch 1: the chunk's count; launch 2: member 0's re-run count
        ex = Executor(_cfg(fault_spec="kernel_launch:dispatch=map@1x2"),
                      device=CPU)
        res = ex.map(fleet)
        bad = [i for i, r in enumerate(res) if isinstance(r, ReceiptError)]
        assert len(bad) == 1 and isinstance(res[bad[0]], KernelBackendError)
        assert res[bad[0]].injected
        for i, (got, want) in enumerate(zip(res, clean)):
            if i not in bad:
                np.testing.assert_array_equal(got.theta, want.theta)

    def test_strict_mode_aggregates(self):
        fleet = self._fleet()
        fleet[1] = _bad_graph()
        ex = Executor(_cfg(), device=CPU)
        with pytest.raises(FleetPartialFailure) as ei:
            ex.map(fleet, strict=True)
        assert list(ei.value.errors) == [1]
        assert ei.value.n_ok == 4
        assert isinstance(ei.value.errors[1], GraphValidationError)

    def test_non_graph_member_reported_not_raised(self):
        fleet = self._fleet()
        res = Executor(_cfg(), device=CPU).map(fleet[:2] + ["nope"])
        assert isinstance(res[2], GraphValidationError)
        assert all(not isinstance(r, ReceiptError) for r in res[:2])

    def test_single_member_chunk_failure_takes_its_slot(self):
        fleet = self._fleet()[:2]
        ex = Executor(_cfg(fault_spec="map_chunk@1"), device=CPU,
                      map_stack_cells=16 * 16)          # one graph a chunk
        res = ex.map(fleet)
        assert sum(isinstance(r, KernelBackendError) for r in res) == 1
        with pytest.raises(FleetPartialFailure):
            Executor(_cfg(fault_spec="map_chunk@1"), device=CPU,
                     map_stack_cells=16 * 16).map(fleet, strict=True)


# --------------------------------------------------------------------- #
# verify mode
# --------------------------------------------------------------------- #
class TestVerifyMode:
    @pytest.mark.parametrize("name", ["fig1", "er_dense", "powerlaw"])
    def test_verify_passes_on_real_results(self, name):
        g = {"fig1": paper_fig1_graph,
             "er_dense": lambda: random_bipartite(40, 25, 0.45, seed=4),
             "powerlaw": lambda: powerlaw_bipartite(200, 120, 1500,
                                                    seed=5)}[name]()
        td = Executor(_cfg(num_partitions=4), device=CPU).decompose(
            g, verify=True)
        assert td.stats.verified and td.stats.verify_checks >= 3
        np.testing.assert_array_equal(td.theta, bup_oracle(g)[0])

    def test_verify_rejects_upward_corruption(self):
        g = random_bipartite(40, 25, 0.45, seed=4)
        td = Executor(_cfg(num_partitions=4), device=CPU).decompose(g)
        bad = td.theta.copy()
        bad[0] = bad.max() + 3
        with pytest.raises(VerificationError):
            verify_tip_decomposition(g, "U", bad, bounds=td.stats.bounds)

    def test_verify_rejects_support_bound_violation(self):
        g = BipartiteGraph.from_edges(2, 2, [0, 0, 1, 1], [0, 1, 0, 1])
        with pytest.raises(VerificationError, match="support"):
            verify_tip_decomposition(g, "U", np.array([5, 1]))

    def test_verify_rejects_shape_mismatch(self):
        with pytest.raises(VerificationError, match="shape"):
            verify_tip_decomposition(paper_fig1_graph(), "U",
                                     np.zeros(3, np.int64))

    def test_verify_map_results(self):
        fleet = [_er(16, 12, 60, s) for s in range(3)]
        res = Executor(_cfg(), device=CPU).map(fleet)
        for g, r in zip(fleet, res):
            assert verify_tip_decomposition(g, "U", r.theta) >= 1
            assert verify_tip_decomposition(
                g, "U", r.theta, bounds=r.stats.bounds) >= 3


# --------------------------------------------------------------------- #
# straggler flagging
# --------------------------------------------------------------------- #
def test_map_straggler_flagging_monkeypatched():
    """Chunk walls feed the StragglerMonitor; a chunk forced slow is
    flagged in the report and on its members' stats."""
    fleet = [_er(16, 12, 60, s) for s in range(4)]
    ex = Executor(_cfg(), device=CPU, map_stack_cells=16 * 16)
    ex.map(fleet)                               # one chunk per graph
    timings = ex._stragglers.timings
    assert len(timings) >= 3
    # the recorded walls are the host's own, which a loaded machine can
    # skew: set them equal, so that only the forced chunk stands out
    for t in timings.values():
        t.ewma = 1.0
    assert ex._stragglers.stragglers() == []
    slow = next(iter(timings))
    for _ in range(5):
        ex._stragglers.record(slow, 1e3)
    assert ex._stragglers.stragglers() == [slow]
    res = ex.map(fleet[:1])                     # its chunk id is `slow`
    assert slow in ex.last_map_report["stragglers"]
    assert res[0].stats.straggler
    assert ex._stragglers.speculative_plan(list(ex._stragglers.timings), 2)

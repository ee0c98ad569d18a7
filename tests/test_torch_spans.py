"""The port's spans and counters (``repro_torch.utils.spans``): profiler
ranges at the work sites, the per-run span table and upload counters on
``RunStats.trace``, and the ring of recent runs.  Port only, on the CPU
with the kernels' plain versions."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import EngineConfig, Executor
from repro_torch.core.engine import ReceiptConfig, RunStats, tip_decompose
from repro_torch.core.engine.cd import receipt_cd
from repro_torch.core.engine.peel_loop import DeviceGraph, fetch, upload
from repro_torch.core.graph import powerlaw_bipartite
from repro_torch.service import DecompositionService, ServiceConfig
from repro_torch.utils import spans

BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seed=3):
    return powerlaw_bipartite(60, 80, 500, seed=seed)


def _cfg(**kw):
    return ReceiptConfig(num_partitions=6, kernel_blocks=BLOCKS,
                         backend="torch", **kw)


def _executor():
    return Executor(EngineConfig(backend="torch", num_partitions=6,
                                 kernel_blocks=BLOCKS), device=CPU)


def _profiled(fn):
    """``fn()`` inside the range ``caller`` under a CPU profiler: its
    result and the profiler's host ranges as ``{name: [(start, end)]}``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("caller"):
            out = fn()
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start,
                                              e.time_range.end))
    return out, ranges


def test_a_decompose_emits_its_ranges_inside_the_callers():
    g = _graph()
    td, ranges = _profiled(lambda: _executor().decompose(g))
    (c0, c1), = ranges["caller"]
    for name in ("cd", "cd.dgm", "cd.find_hi", "read", "fd", "fd.tasks",
                 "engine.prepare", "plan"):
        got = ranges[spans.PREFIX + name]
        assert got and all(c0 <= s <= e <= c1 for s, e in got), name
    (d0, d1), = ranges[spans.PREFIX + "cd"]
    assert all(d0 <= s <= e <= d1 for s, e in ranges[spans.PREFIX
                                                     + "cd.dgm"])
    assert len(ranges[spans.PREFIX + "read"]) == td.stats.host_round_trips


def test_a_delta_flush_emits_its_ranges():
    g = _graph()
    svc = DecompositionService(
        EngineConfig(backend="torch", num_partitions=6,
                     kernel_blocks=BLOCKS), ServiceConfig(), device=CPU)
    svc.ingest("g", edges=(g.edges_u, g.edges_v), n_u=g.n_u, n_v=g.n_v)
    svc.flush("g")
    svc.delete_edges("g", g.edges_u[:3], g.edges_v[:3])
    report, ranges = _profiled(lambda: svc.flush("g"))
    svc.close()
    assert report["refreshed"] == 1
    for name in ("flush", "flush.prepare", "flush.run", "flush.commit",
                 "flush.route", "refresh.delta", "refresh.repeel", "read",
                 "plan"):
        assert spans.PREFIX + name in ranges, name


def test_no_profiler_never_enters_record_function(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    g = _graph()
    td = _executor().decompose(g)
    assert td.stats.trace.calls["read"] == td.stats.host_round_trips
    svc = DecompositionService(
        EngineConfig(backend="torch", num_partitions=6,
                     kernel_blocks=BLOCKS), ServiceConfig(), device=CPU)
    svc.ingest("g", edges=(g.edges_u, g.edges_v), n_u=g.n_u, n_v=g.n_v)
    svc.flush("g")
    svc.delete_edges("g", g.edges_u[:3], g.edges_v[:3])
    assert svc.flush("g")["refreshed"] == 1
    svc.close()


@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
def test_tip_numbers_are_bit_identical_under_a_profiler(dispatch, backend):
    g = _graph(seed=5)
    cfg = ReceiptConfig(num_partitions=6, kernel_blocks=BLOCKS,
                        backend=backend, cd_dispatch=dispatch)
    theta, stats = tip_decompose(g, cfg, device=CPU)
    (theta_p, stats_p), ranges = _profiled(
        lambda: tip_decompose(g, cfg, device=CPU))
    np.testing.assert_array_equal(theta, theta_p)
    assert stats.host_round_trips == stats_p.host_round_trips
    assert spans.PREFIX + "cd" in ranges


def test_upload_bytes_count_the_first_device_graph_exactly():
    g = _graph()
    cfg = _cfg()
    stats = RunStats()
    dg = DeviceGraph(g, np.arange(g.n_u), cfg, device=CPU, stats=stats)
    # the matrix is built on the card from its edges' int64 linear ids:
    # those and dv0 are the two uploads
    sub, _ = g.induced_on_u(np.arange(g.n_u), min_degree_v=2)
    first = len(sub.edges_u) * 8 + dg.cols_pad * 4
    assert stats.trace.upload_bytes == first
    assert stats.trace.uploads == 2
    built = dg.rows_pad * dg.cols_pad * 4
    assert stats.trace.built_bytes == built
    _, run = tip_decompose(g, _cfg(degree_sort=False), device=CPU)
    # the run's first DeviceGraph is this one; DGM and FD upload more
    assert run.trace.upload_bytes > first
    assert run.trace.uploads > 2
    assert run.dgm_compactions > 0
    # every DGM builds a matrix no larger than the first, and at least one
    # row tile by one column tile
    floor = BLOCKS[0] * BLOCKS[2] * 4
    assert run.trace.built_bytes >= built + run.dgm_compactions * floor
    assert run.trace.built_bytes <= (1 + run.dgm_compactions) * built


def test_upload_makes_the_same_tensor_and_counts_it():
    stats = RunStats()
    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    t = upload(stats, x, CPU, torch.float32)
    assert t.dtype == torch.float32 and torch.equal(
        t, torch.as_tensor(x).to(dtype=torch.float32))
    assert upload(None, x, CPU).dtype == torch.float64
    assert (stats.trace.upload_bytes, stats.trace.uploads) == (48, 1)


@pytest.mark.parametrize("dispatch", ["subset", "graph"])
def test_cd_spans_lie_inside_the_cd_phase_times(dispatch):
    """``cd.dgm`` plus ``read`` inside CD take no more than
    ``time_count + time_cd``: both lie inside those windows and do not
    overlap."""
    g = _graph()
    stats = RunStats()
    receipt_cd(g, _cfg(cd_dispatch=dispatch), stats, device=CPU)
    sec = stats.trace.seconds
    assert sec["cd.dgm"] > 0 and sec["read"] > 0
    assert sec["cd.dgm"] + sec["read"] <= stats.time_count + stats.time_cd
    assert stats.time_count + stats.time_cd <= sec["cd"]
    assert stats.trace.calls["read"] == stats.host_round_trips


def test_fetch_times_its_read_and_counts_it():
    stats = RunStats()
    a, b = fetch(stats, torch.ones(3), torch.zeros(2, dtype=torch.bool))
    assert a.tolist() == [1.0, 1.0, 1.0] and b.tolist() == [0.0, 0.0]
    assert stats.host_round_trips == 1 and stats.trace.calls["read"] == 1
    fetch(None, torch.ones(1))                  # no run: nothing counted


def test_recent_runs_hold_the_decompose_run_itself():
    ex = _executor()
    td = ex.decompose(_graph())
    assert spans.recent_runs()[-1] is td.stats
    spans.clear_recent_runs()
    assert spans.recent_runs() == []


def test_recent_runs_hold_the_served_result_after_a_delta_flush():
    g = _graph()
    svc = DecompositionService(
        EngineConfig(backend="torch", num_partitions=6,
                     kernel_blocks=BLOCKS), ServiceConfig(), device=CPU)
    svc.ingest("g", edges=(g.edges_u, g.edges_v), n_u=g.n_u, n_v=g.n_v)
    svc.flush("g")
    svc.delete_edges("g", g.edges_u[:3], g.edges_v[:3])
    svc.insert_edges("g", [0], [g.n_v - 1])
    svc.flush("g")
    served = svc.query("g").stats
    svc.close()
    assert served.refresh_mode == "delta"
    assert spans.recent_runs()[-1] is served
    sec = served.trace.seconds
    for name in ("flush.route", "refresh.delta", "refresh.repeel", "read"):
        assert sec[name] > 0, name
    # the delta's one read and the re-peel's, all on the cycle's run
    assert served.trace.calls["read"] == served.host_round_trips
    assert served.trace.uploads > 0


def test_the_ring_keeps_the_last_runs_in_order():
    spans.clear_recent_runs()
    runs = [RunStats() for _ in range(spans.RECENT_RUNS + 5)]
    for s in runs:
        spans.note_run(s)
    kept = spans.recent_runs()
    assert len(kept) == spans.RECENT_RUNS
    assert all(a is b for a, b in zip(kept, runs[5:]))
    spans.clear_recent_runs()


def test_a_span_counts_its_time_when_the_block_raises():
    stats = RunStats()
    with pytest.raises(ValueError):
        with spans.span("x", stats):
            raise ValueError("boom")
    assert stats.trace.calls == {"x": 1} and stats.trace.seconds["x"] >= 0


def test_the_trace_is_no_field_of_run_stats():
    """``asdict``, ``fields`` and ``==`` leave the trace out, so two runs
    with the same counters compare equal whatever their spans took."""
    a, b = RunStats(), RunStats()
    with spans.span("read", a):
        pass
    assert "trace" not in dataclasses.asdict(a)
    assert "trace" not in {f.name for f in dataclasses.fields(RunStats)}
    assert a == b and a.trace != b.trace
    assert dataclasses.replace(a).trace == spans.RunTrace()

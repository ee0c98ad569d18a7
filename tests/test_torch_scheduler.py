"""The port's serving scheduler (``repro_torch.service.scheduler``)
against the reference's: the background flush worker (async refresh
exactness, stale reads without refresh wall, ``wait=True`` blocking,
cooperative shutdown), crash isolation through the ``refresh_worker``
fault site and ``RestartManager``-bounded restarts, the
``CacheGovernor`` (LRU-with-pin eviction, recompute on demand), the map
fleet's synthesized bound ladder, queue restore and route
classification.

Inline cases send the same traffic through the reference service
(``backend="xla"``) and the port's (``device="cpu"``) and hold numbers,
refresh stats, flush reports and cache reports bit-equal.  Background
cases run the port's worker and hold every answer to the reference's
inline drain of the same traffic or to its ``Executor``; they wait only
through ``wait_until_idle(timeout=...)`` or ``query(wait=True,
timeout=...)``.
"""
import threading
import time

import numpy as np
import pytest

from repro.api import Executor as JExecutor
from repro.api import ServiceWorkerError as JServiceWorkerError
from repro.core.engine.refresh import synthesize_bounds as j_synthesize
from repro.data.synthetic import interaction_graph
from repro.service import CacheGovernor as JCacheGovernor
from repro.service import RequestQueue as JRequestQueue
from repro.service import ServiceConfig as JServiceConfig
from repro.service import WorkItem as JWorkItem
from repro.service import classify_refresh as j_classify
from repro.service.state import DatasetState as JDatasetState
from repro_torch.api import ServiceWorkerError
from repro_torch.core.engine.refresh import synthesize_bounds
from repro_torch.service import (CacheGovernor, DecompositionService,
                                 RequestQueue, ServiceConfig, WorkItem,
                                 classify_refresh)
from repro_torch.service.state import DatasetState
from repro_torch.train.fault_tolerance import RestartManager
from test_torch_service import (Twin, _jcfg, _keys, _tcfg,  # noqa: F401
                                _tg, assert_same_result, one_torch_thread)


def _bg(service_kw=None, **kw):
    skw = dict(background=True, worker_poll_s=0.01)
    skw.update(service_kw or {})
    return DecompositionService(_tcfg(**kw), ServiceConfig(**skw),
                                device="cpu")


def _fresh_edges(g, count, rng):
    have = set(_keys(g).tolist())
    out = []
    while len(out) < count:
        u = int(rng.integers(g.n_u))
        v = int(rng.integers(g.n_v))
        if u * g.n_v + v not in have:
            have.add(u * g.n_v + v)
            out.append((u, v))
    return np.array(out, np.int64).reshape(-1, 2)


def _mutations(g, rng, n=3):
    """(inserts, deletes) of one mutation round (the reference tests'
    rule), as edge arrays both services take."""
    ins = _fresh_edges(g, n, rng)
    drop = rng.choice(g.m, n, replace=False)
    return ins, np.stack([g.edges_u[drop], g.edges_v[drop]], axis=1)


def _mutate(svc, name, rng, n=3):
    ins, dels = _mutations(svc._datasets[name].graph, rng, n)
    svc.insert_edges(name, ins[:, 0], ins[:, 1])
    svc.delete_edges(name, dels[:, 0], dels[:, 1])
    return ins, dels


def _reference(svc, name, workload="tip"):
    """The reference's from-scratch decomposition of the port's
    dataset's current graph."""
    from repro.core.graph import BipartiteGraph as JBipartiteGraph

    g = svc._datasets[name].graph
    return JExecutor(_jcfg(workload=workload)).decompose(
        JBipartiteGraph.from_edges(g.n_u, g.n_v, g.edges_u, g.edges_v))


# --------------------------------------------------------------------- #
# background worker: async refresh, staleness contract
# --------------------------------------------------------------------- #
def test_background_refresh_matches_synchronous_drain():
    """The port's worker drains the traffic the reference drains inline:
    the same numbers and refresh stats.  The worker is stopped while the
    round's inserts and deletes are queued, so that it drains them in one
    cycle, as the reference's inline flush does (a worker running
    between the two calls refreshes twice, 3 dirty edges each)."""
    g = interaction_graph(60, 40, 400, seed=3)
    rng = np.random.default_rng(3)
    tw = Twin()
    svc = _bg()
    try:
        tw.ingest("d", g)
        svc.ingest("d", _tg(g))
        assert_same_result(tw.j.query("d"),
                           svc.query("d", wait=True, timeout=60))
        assert svc.stop_worker(drain=True)
        ins, dels = _mutate(svc, "d", rng)
        svc.start_worker()
        tw.j.insert_edges("d", ins[:, 0], ins[:, 1])
        tw.j.delete_edges("d", dels[:, 0], dels[:, 1])
        assert svc.wait_until_idle(timeout=60)
        assert svc._datasets["d"].fresh
        assert_same_result(tw.j.query("d"), svc.query("d"))
    finally:
        svc.close()


def test_background_refresh_under_racing_mutations():
    """The inserts and deletes land while the worker runs (it may refresh
    between them): once idle, the dataset is fresh and its numbers equal
    the reference's inline drain of the same round and its from-scratch
    decomposition (the refresh stats depend on the race, so only the
    numbers are compared, as in the reference's own test)."""
    g = interaction_graph(60, 40, 400, seed=3)
    rng = np.random.default_rng(3)
    tw = Twin()
    svc = _bg()
    try:
        tw.ingest("d", g)
        svc.ingest("d", _tg(g))
        assert svc.query("d", wait=True, timeout=60) is not None
        ins, dels = _mutate(svc, "d", rng)
        tw.j.insert_edges("d", ins[:, 0], ins[:, 1])
        tw.j.delete_edges("d", dels[:, 0], dels[:, 1])
        assert svc.wait_until_idle(timeout=60)
        assert svc._datasets["d"].fresh
        got = np.asarray(svc.query("d").numbers)
        np.testing.assert_array_equal(
            got, np.asarray(tw.j.query("d").numbers))
        np.testing.assert_array_equal(got, _reference(svc, "d").numbers)
    finally:
        svc.close()


def test_stale_read_serves_last_version_without_refresh_wall(monkeypatch):
    """While the worker is inside a refresh (held there), a read returns
    the last consistent version at once, with staleness metadata; once
    the worker finishes, the read is fresh and exact."""
    g = interaction_graph(60, 40, 400, seed=4)
    rng = np.random.default_rng(4)
    svc = _bg()
    try:
        svc.ingest("d", _tg(g))
        first = svc.query("d", wait=True, timeout=60)
        v1 = svc._datasets["d"].result_version
        ex = svc._executor("tip")
        entered, release = threading.Event(), threading.Event()
        real = ex.repeel

        def held_repeel(*args, **kwargs):
            entered.set()
            assert release.wait(60)
            return real(*args, **kwargs)

        monkeypatch.setattr(ex, "repeel", held_repeel)
        _mutate(svc, "d", rng)
        assert entered.wait(60)
        t0 = time.perf_counter()
        dec, info = svc.query("d", with_info=True)
        stale_s = time.perf_counter() - t0
        release.set()
        assert not info["fresh"] and info["result_version"] == v1
        assert info["stale_by"] >= 1 and info["worker_alive"]
        assert dec is first
        assert svc._datasets["d"].stale_reads >= 1
        assert stale_s < 5.0                 # did not wait on the worker
        assert svc.wait_until_idle(timeout=60)
        dec2, info2 = svc.query("d", with_info=True)
        assert info2["fresh"] and info2["stale_by"] == 0
        np.testing.assert_array_equal(dec2.numbers,
                                      _reference(svc, "d").numbers)
    finally:
        release.set()
        svc.close()


def test_stale_read_never_waits_on_the_cycle_classification(monkeypatch):
    """A drain cycle classifies its routes off the service lock (at full
    size the key sort takes milliseconds): with the worker held inside
    the classification, a read and a mutation still go through."""
    from repro_torch.service import scheduler as tscheduler

    g = interaction_graph(60, 40, 400, seed=16)
    rng = np.random.default_rng(16)
    svc = _bg()
    release = threading.Event()
    try:
        svc.ingest("d", _tg(g))
        first = svc.query("d", wait=True, timeout=60)
        entered, real = threading.Event(), tscheduler.classify_refresh

        def held_classify(*args, **kwargs):
            entered.set()
            assert release.wait(60)
            return real(*args, **kwargs)

        monkeypatch.setattr(tscheduler, "classify_refresh", held_classify)
        _mutate(svc, "d", rng)
        assert entered.wait(60)
        served = []
        reader = threading.Thread(target=lambda: served.append(
            svc.query("d", with_info=True)))
        reader.start()
        reader.join(30)
        alive = reader.is_alive()
        ins = _fresh_edges(svc._datasets["d"].graph, 1, rng)
        mutator = threading.Thread(
            target=svc.insert_edges, args=("d", ins[:, 0], ins[:, 1]))
        mutator.start()
        mutator.join(30)
        mutating = mutator.is_alive()
        release.set()
        reader.join(60)
        mutator.join(60)
        assert not alive and not mutating
        (dec, info), = served
        assert dec is first and not info["fresh"]
        assert svc.wait_until_idle(timeout=60)
        np.testing.assert_array_equal(svc.query("d").numbers,
                                      _reference(svc, "d").numbers)
    finally:
        release.set()
        svc.close()


def test_wait_true_blocks_until_fresh():
    g = interaction_graph(50, 36, 320, seed=5)
    rng = np.random.default_rng(5)
    svc = _bg()
    try:
        svc.ingest("d", _tg(g))
        svc.query("d", wait=True, timeout=60)
        _mutate(svc, "d", rng)
        dec, info = svc.query("d", wait=True, timeout=60,
                              with_info=True)
        assert info["fresh"]
        np.testing.assert_array_equal(
            dec.numbers, _reference(svc, "d").numbers)
    finally:
        svc.close()


def test_no_torn_reads_under_concurrent_mutations():
    """Readers racing the worker always see a CONSISTENT (result,
    version, base graph) triple: the served numbers must be the
    reference's exact decomposition of SOME graph version the dataset
    passed through."""
    g = interaction_graph(40, 30, 240, seed=6)
    rng = np.random.default_rng(6)
    svc = _bg()
    try:
        svc.ingest("d", _tg(g))
        svc.query("d", wait=True, timeout=60)
        graphs = {1: svc._datasets["d"].graph}
        stop = threading.Event()
        errors = []
        served = []

        def reader():
            while not stop.is_set():
                try:
                    dec, info = svc.query("d", with_info=True)
                    served.append((info["result_version"],
                                   np.asarray(dec.numbers).copy()))
                except Exception as exc:   # noqa: BLE001 — test witness
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for _ in range(4):
            # record the graph at EVERY version: the worker may commit
            # at the intermediate (post-insert) version too
            g_cur = svc._datasets["d"].graph
            ins = _fresh_edges(g_cur, 2, rng)
            v = svc.insert_edges("d", ins[:, 0], ins[:, 1])
            graphs[v] = svc._datasets["d"].graph
            drop = rng.choice(g_cur.m, 2, replace=False)
            v = svc.delete_edges("d", g_cur.edges_u[drop],
                                 g_cur.edges_v[drop])
            graphs[v] = svc._datasets["d"].graph
            svc.query("d", wait=True, timeout=60)
        assert svc.wait_until_idle(timeout=120)
        stop.set()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        from repro.core.graph import BipartiteGraph as JBipartiteGraph

        ex = JExecutor(_jcfg())
        valid = {v: np.asarray(ex.decompose(JBipartiteGraph.from_edges(
            g_v.n_u, g_v.n_v, g_v.edges_u, g_v.edges_v)).numbers)
            for v, g_v in graphs.items()}
        assert served
        for rv, numbers in served:
            assert rv in valid, f"served unknown version {rv}"
            np.testing.assert_array_equal(numbers, valid[rv])
    finally:
        svc.close()


def test_shutdown_drain_finishes_pending_work():
    g = interaction_graph(50, 36, 320, seed=7)
    rng = np.random.default_rng(7)
    svc = _bg()
    svc.ingest("d", _tg(g))
    svc.query("d", wait=True, timeout=60)
    _mutate(svc, "d", rng)
    assert svc.stop_worker(drain=True, timeout=120)
    assert not svc._worker_alive()
    assert not svc._worker._thread.is_alive()
    assert svc._datasets["d"].fresh
    np.testing.assert_array_equal(
        svc.query("d").numbers, _reference(svc, "d").numbers)


def test_shutdown_abandon_leaves_work_queued_for_inline():
    g = interaction_graph(50, 36, 320, seed=8)
    rng = np.random.default_rng(8)
    # a slow heartbeat so the abandoned items stay queued
    svc = _bg(service_kw=dict(worker_poll_s=5.0))
    svc.ingest("d", _tg(g))
    svc.flush()                          # delegates to + waits on worker
    _mutate(svc, "d", rng)
    assert svc.stop_worker(drain=False, timeout=120)
    # the refresh may have been abandoned; inline serving picks it up
    dec = svc.query("d")
    np.testing.assert_array_equal(
        dec.numbers, _reference(svc, "d").numbers)


# --------------------------------------------------------------------- #
# crash isolation: refresh_worker fault site
# --------------------------------------------------------------------- #
def test_worker_crash_restarts_and_stays_exact():
    g = interaction_graph(50, 36, 320, seed=9)
    rng = np.random.default_rng(9)
    svc = DecompositionService(
        _tcfg(fault_spec="refresh_worker@2"),
        ServiceConfig(background=True, worker_poll_s=0.01,
                      worker_backoff_s=0.0), device="cpu")
    try:
        svc.ingest("d", _tg(g))
        svc.query("d", wait=True, timeout=60)
        _mutate(svc, "d", rng)
        dec = svc.query("d", wait=True, timeout=60)
        w = svc.report()["worker"]
        assert w["crashes"] >= 1
        assert w["restarts"] >= 1
        assert not w["dead"]
        assert w["failure_log"]          # RestartManager evidence
        assert w["failure_log"][0]["type"] == "ServiceWorkerError"
        np.testing.assert_array_equal(
            dec.numbers, _reference(svc, "d").numbers)
    finally:
        svc.close()


def test_worker_death_past_budget_degrades_to_inline():
    g = interaction_graph(50, 36, 320, seed=10)
    svc = DecompositionService(
        _tcfg(fault_spec="refresh_worker@1x100"),
        ServiceConfig(background=True, worker_poll_s=0.01,
                      worker_backoff_s=0.0, worker_max_restarts=2),
        device="cpu")
    try:
        svc.ingest("d", _tg(g))
        dec = svc.query("d", wait=True, timeout=120)
        np.testing.assert_array_equal(
            dec.numbers, _reference(svc, "d").numbers)
        w = svc.report()["worker"]
        assert w["dead"] and not w["alive"]
        assert w["crashes"] == 3         # initial + 2 restarts
        assert isinstance(svc._worker.last_error, ServiceWorkerError)
        assert len(w["failure_log"]) == 3
    finally:
        svc.close()


def test_worker_counts_an_untyped_fault_as_a_crash(monkeypatch):
    """An error outside the taxonomy (as PyTorch raises for a CUDA
    fault) escapes the drain cycle: it is counted as a worker crash,
    wrapped in ``ServiceWorkerError``, the drained work is restored and
    the restarted worker finishes it exactly."""
    g = interaction_graph(50, 36, 320, seed=15)
    rng = np.random.default_rng(15)
    svc = _bg(service_kw=dict(worker_backoff_s=0.0))
    try:
        svc.ingest("d", _tg(g))
        svc.query("d", wait=True, timeout=60)
        ex = svc._executor("tip")
        real, calls = ex.repeel, []

        def faulty_repeel(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")
            return real(*args, **kwargs)

        monkeypatch.setattr(ex, "repeel", faulty_repeel)
        _mutate(svc, "d", rng)
        dec = svc.query("d", wait=True, timeout=60)
        w = svc.report()["worker"]
        assert w["crashes"] == 1 and w["restarts"] == 1 and not w["dead"]
        assert isinstance(svc._worker.last_error, ServiceWorkerError)
        assert "illegal memory access" in w["last_error"]
        np.testing.assert_array_equal(
            dec.numbers, _reference(svc, "d").numbers)
    finally:
        svc.close()


def test_service_worker_error_context():
    kw = dict(site="refresh_worker", cycle=4, restarts=1)
    err = ServiceWorkerError("boom", **kw)
    s = str(err)
    assert s == str(JServiceWorkerError("boom", **kw))
    assert "site='refresh_worker'" in s
    assert "cycle=4" in s and "restarts=1" in s
    assert isinstance(err, RuntimeError)
    rm = RestartManager(max_failures=1, max_failure_log=2)
    assert rm.record_failure(err) and not rm.record_failure(err)
    rm.record_failure(err)
    assert [e["type"] for e in rm.failure_report()] == [
        "ServiceWorkerError"] * 2


# --------------------------------------------------------------------- #
# CacheGovernor: LRU-with-pin eviction
# --------------------------------------------------------------------- #
def _fake_ds(state_cls, name, nbytes):
    g = interaction_graph(6, 5, 12, seed=1)
    if state_cls is DatasetState:
        g = _tg(g)
    ds = state_cls(name=name, workload="tip", graph=g)
    ds.result = type("R", (), {"numbers": np.zeros(nbytes // 8,
                                                   np.int64)})()
    ds.result_version = ds.version
    ds.base_graph = ds.graph
    return ds


@pytest.fixture(params=["port", "reference"])
def gov_side(request):
    """The governor tests run on both packages' classes."""
    if request.param == "port":
        return CacheGovernor, DatasetState
    return JCacheGovernor, JDatasetState


def test_governor_evicts_lru_first(gov_side):
    gov_cls, state_cls = gov_side
    gov = gov_cls(budget_bytes=100)
    a, b = _fake_ds(state_cls, "a", 80), _fake_ds(state_cls, "b", 80)
    gov.touch(a)
    gov.touch(b)
    gov.touch(a)                         # b is now least-recently-used
    evicted = gov.enforce({"a": a, "b": b})
    assert evicted == ["b"]
    assert b.result is None and b.evictions == 1
    assert a.result is not None
    assert gov.report({"a": a, "b": b})["evicted_total"] == 1


def test_governor_never_evicts_pinned_state(gov_side):
    gov_cls, state_cls = gov_side
    gov = gov_cls(budget_bytes=10)
    a = _fake_ds(state_cls, "a", 80)
    a.pins = 1
    assert gov.enforce({"a": a}) == []   # over budget, but safe
    rep = gov.report({"a": a})
    assert rep["over_budget"] and rep["datasets"]["a"]["pinned"]
    a.pins = 0
    assert gov.enforce({"a": a}) == ["a"]


def test_governor_unbounded_budget_never_evicts(gov_side):
    gov_cls, state_cls = gov_side
    gov = gov_cls(budget_bytes=None)
    a = _fake_ds(state_cls, "a", 1 << 20)
    assert gov.enforce({"a": a}) == []
    assert gov.report({"a": a})["over_budget"] is False


def test_evicted_dataset_recomputes_exactly():
    g1 = interaction_graph(50, 36, 320, seed=11)
    g2 = interaction_graph(44, 32, 280, seed=12)
    tw = Twin(JServiceConfig(cache_budget_bytes=64))
    tw.ingest("a", g1)
    tw.ingest("b", g2)
    tw.query("a")
    tw.query("b")                        # evicts a (budget < any result)
    tw.check()
    assert tw.t.cache_report()["evicted_total"] >= 1
    assert tw.t._datasets["a"].result is None
    dec = tw.query("a")                  # recompute on demand
    np.testing.assert_array_equal(
        dec.numbers, _reference(tw.t, "a").numbers)
    assert tw.t._datasets["a"].evictions >= 1
    assert tw.t._datasets["a"].full_recomputes >= 2
    tw.check()


def test_eviction_with_background_worker_stays_correct():
    g = interaction_graph(50, 36, 320, seed=13)
    rng = np.random.default_rng(13)
    svc = _bg(service_kw=dict(cache_budget_bytes=64))
    try:
        svc.ingest("d", _tg(g))
        dec = svc.query("d", wait=True, timeout=60)
        np.testing.assert_array_equal(
            dec.numbers, _reference(svc, "d").numbers)
        _mutate(svc, "d", rng)
        dec2 = svc.query("d", wait=True, timeout=60)
        np.testing.assert_array_equal(
            dec2.numbers, _reference(svc, "d").numbers)
    finally:
        svc.close()


def test_pinned_state_never_evicted_mid_cycle():
    """A dataset pinned by an in-flight drain keeps its cached inputs:
    enforce() runs inside every commit, so with a 1-byte budget ANY
    unpinned cached state would be dropped — the refresh still lands,
    as the reference's does."""
    g = interaction_graph(50, 36, 320, seed=14)
    rng = np.random.default_rng(14)
    tw = Twin(JServiceConfig(cache_budget_bytes=1))
    tw.ingest("d", g)
    tw.query("d")
    ins, dels = _mutations(tw.graph("d"), rng)
    tw.insert_edges("d", ins[:, 0], ins[:, 1])
    tw.delete_edges("d", dels[:, 0], dels[:, 1])
    dec = tw.query("d")
    np.testing.assert_array_equal(
        dec.numbers, _reference(tw.t, "d").numbers)
    tw.check()


# --------------------------------------------------------------------- #
# map-fleet results carry a synthesized bound ladder
# --------------------------------------------------------------------- #
def test_mapped_results_carry_synthesized_bounds():
    tw = Twin(JServiceConfig(map_min_fleet=2))
    for i in range(3):
        tw.ingest(f"m{i}", interaction_graph(40, 30, 240, seed=20 + i))
    rep = tw.flush()
    assert rep["fleets"] == 1 and rep["mapped"] == 3
    for i in range(3):
        bounds = tw.t._datasets[f"m{i}"].bounds
        assert bounds is not None and len(bounds) >= 2
        assert bounds == sorted(bounds)
        assert bounds == tw.j._datasets[f"m{i}"].bounds
    tw.check()


def test_mapped_result_refresh_stops_below_inf():
    """The synthesized ladder removes the [inf]-rung penalty: a small
    mutation on a mapped result re-peels a strict subset of the ladder
    instead of the whole graph, with the reference's stop."""
    tw = Twin(JServiceConfig(map_min_fleet=2, refresh_dirty_threshold=0.5))
    for i in range(2):
        tw.ingest(f"m{i}", interaction_graph(60, 40, 420, seed=30 + i))
    tw.flush()
    g = tw.graph("m0")
    # delete one low-theta edge: the ceiling stays near the bottom rungs
    theta = np.asarray(tw.t._datasets["m0"].result.numbers)
    u_low = int(np.argmin(theta))
    e = int(np.nonzero(g.edges_u == u_low)[0][0])
    tw.delete_edges("m0", [g.edges_u[e]], [g.edges_v[e]])
    tw.flush()
    st = tw.t._datasets["m0"].result.stats
    assert st.refresh_mode == "delta"
    assert np.isfinite(st.refresh_stop)
    assert st.refresh_subsets_repeeled < st.refresh_subsets_total
    dec = tw.query("m0")
    np.testing.assert_array_equal(dec.numbers,
                                  _reference(tw.t, "m0").numbers)
    tw.check()


@pytest.mark.parametrize("case", [("rand", 6), ("empty", 4), ("flat", 1)])
def test_synthesize_bounds_properties(case):
    kind, parts = case
    th = {"rand": np.random.default_rng(22).integers(0, 40, 300),
          "empty": [], "flat": [5, 5, 5]}[kind]
    bounds = synthesize_bounds(th, parts)
    assert bounds == j_synthesize(th, parts)
    assert bounds == sorted(set(bounds)) and bounds[0] == 0.0
    assert bounds[-1] == (float(np.max(th)) + 1.0 if len(th) else 1.0)


# --------------------------------------------------------------------- #
# queue restore + route classification + config validation
# --------------------------------------------------------------------- #
def test_queue_restore_preserves_order_and_coalesces():
    out = []
    for queue_cls, item_cls in ((RequestQueue, WorkItem),
                                (JRequestQueue, JWorkItem)):
        q = queue_cls(8)
        q.submit(item_cls("a", "refresh", 2))
        q.submit(item_cls("b", "full", 1))
        drained = q.drain()
        q.submit(item_cls("b", "refresh", 3))    # raced submission
        q.restore(drained)
        out.append([(it.dataset, it.kind, it.version) for it in q.drain()])
    assert out[0] == out[1] == [("a", "refresh", 2), ("b", "full", 3)]


def test_classify_refresh_routes():
    g = interaction_graph(40, 30, 240, seed=40)
    scfg = JServiceConfig(refresh_dirty_threshold=0.05)
    tscfg = ServiceConfig(refresh_dirty_threshold=0.05)
    tw = Twin()
    tw.ingest("d", g)

    def routes(**kw):
        got = classify_refresh(tw.t._datasets["d"], tscfg, **kw)
        assert got == j_classify(tw.j._datasets["d"], scfg, **kw)
        return got

    assert routes() == "full"                          # no result yet
    tw.query("d")
    assert routes() == "noop"                          # fresh
    assert routes(force_full=True) == "full"
    rng = np.random.default_rng(40)
    ins, dels = _mutations(tw.graph("d"), rng, n=2)
    tw.insert_edges("d", ins[:, 0], ins[:, 1])
    tw.delete_edges("d", dels[:, 0], dels[:, 1])
    assert routes() == "delta"
    big = _fresh_edges(tw.graph("d"), tw.graph("d").m // 2, rng)
    tw.insert_edges("d", big[:, 0], big[:, 1])
    assert routes() == "full"                          # past threshold


@pytest.mark.parametrize("field, value", [
    ("cache_budget_bytes", 0), ("worker_poll_s", 0.0),
    ("worker_max_restarts", -1), ("repeel_fleet_cells", 0),
    ("wait_timeout_s", 0.0)])
def test_service_config_scheduler_validation(field, value):
    with pytest.raises(ValueError, match=field) as got:
        ServiceConfig(**{field: value})
    with pytest.raises(ValueError) as want:
        JServiceConfig(**{field: value})
    assert str(got.value) == str(want.value)


def test_delta_refreshes_pack_into_repeel_fleets():
    rng = np.random.default_rng(41)
    tw = Twin(JServiceConfig(refresh_dirty_threshold=0.5))
    for i in range(3):
        tw.ingest(f"d{i}", interaction_graph(40, 30, 240, seed=50 + i))
    tw.flush()
    for i in range(3):
        ins, dels = _mutations(tw.graph(f"d{i}"), rng, n=2)
        tw.insert_edges(f"d{i}", ins[:, 0], ins[:, 1])
        tw.delete_edges(f"d{i}", dels[:, 0], dels[:, 1])
    rep = tw.flush()
    assert rep["refreshed"] == 3
    assert rep["repeel_fleets"] >= 1
    for i in range(3):
        np.testing.assert_array_equal(
            tw.query(f"d{i}").numbers,
            _reference(tw.t, f"d{i}").numbers)
    tw.check()


def test_flush_keeps_per_member_error_slots(monkeypatch):
    """A fleet member whose map chunk fails keeps its own error slot
    (``strict=False``): the cycle counts one error, the other members
    commit, and the failed dataset recomputes on its next read."""
    from repro_torch.api import KernelBackendError

    svc = DecompositionService(_tcfg(), device="cpu")
    graphs = [interaction_graph(40, 30, 240, seed=60 + i) for i in range(3)]
    for i, g in enumerate(graphs):
        svc.ingest(f"m{i}", _tg(g))
    ex = svc._executor("tip")
    real_map = ex.map

    def map_with_a_bad_member(gs, strict=False):
        out = real_map(gs, strict=strict)
        out[1] = KernelBackendError("injected member failure")
        return out

    monkeypatch.setattr(ex, "map", map_with_a_bad_member)
    rep = svc.flush()
    assert rep["fleets"] == 1 and rep["mapped"] == 2 and rep["errors"] == 1
    assert isinstance(svc._datasets["m1"].last_error, KernelBackendError)
    monkeypatch.setattr(ex, "map", real_map)
    for i in range(3):
        np.testing.assert_array_equal(svc.query(f"m{i}").numbers,
                                      _reference(svc, f"m{i}").numbers)

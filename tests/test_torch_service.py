"""The port's serving layer (``repro_torch.service``) against the
reference's (``repro.service``): ingestion, queries and versioning,
admission batching through ``Executor.map``, the incremental refresh on
random mutation sequences, the staleness policies, the error taxonomy,
concurrent serving, and the ``launch/serve.py`` CLI.

Every case sends the same traffic, built from seeds with numpy, through
the reference service (``backend="xla"``, as its own tests run it) and
through the port's (``device="cpu"``: the plain versions of the kernels),
the configs carried across by ``engine_config_from_fields`` /
``service_config_from_fields``.  Bit-equal on both sides: the numbers,
the refresh stats, ``last_flush_report``, the per-dataset summaries and
``cache_report()`` (bytes, evictions, LRU clock), and the primed
supports against the reference's host product.  Threaded cases run on
the port and hold every answer to the reference's ``Executor``.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.api import EngineConfig as JEngineConfig
from repro.api import Executor as JExecutor
from repro.core.graph import random_bipartite
from repro.data.synthetic import interaction_graph
from repro.service import DecompositionService as JDecompositionService
from repro.service import RequestQueue as JRequestQueue
from repro.service import ServiceConfig as JServiceConfig
from repro.service import WorkItem as JWorkItem
from repro.service import refresh as jrefresh
from repro_torch.api import (DatasetNotFoundError, Decomposition, Executor,
                             GraphValidationError, PlanInfeasibleError,
                             ServiceUnavailableError, StaleReadError)
from repro_torch.api import faults
from repro_torch.convert import (engine_config_from_fields,
                                 graph_from_arrays,
                                 service_config_from_fields)
from repro_torch.launch import serve
from repro_torch.service import (DecompositionService, RequestQueue,
                                 ServiceConfig, WorkItem)
from repro_torch.service import refresh as trefresh

SMALL_BLOCKS = (8, 8, 8)
REFRESH_STATS = ("refresh_mode", "refresh_stop", "refresh_subsets_repeeled",
                 "refresh_subsets_total", "refresh_dirty_edges",
                 "refresh_t_hi")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors; the test
    workers' pools would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    base = dict(num_partitions=6, kernel_blocks=SMALL_BLOCKS,
                backend="xla", degree_sort=False)
    base.update(kw)
    return JEngineConfig(**base)


def _tcfg(**kw):
    return engine_config_from_fields(_jcfg(**kw).to_dict())


def _tg(g):
    return graph_from_arrays(g.n_u, g.n_v, g.edges_u, g.edges_v)


def _keys(g):
    return g.edges_u.astype(np.int64) * g.n_v + g.edges_v.astype(np.int64)


def _fresh_edges(g, count, rng, u_pool=None, v_pool=None):
    have = set(_keys(g).tolist())
    out = []
    pool = np.arange(g.n_u) if u_pool is None else np.asarray(u_pool)
    vpool = np.arange(g.n_v) if v_pool is None else np.asarray(v_pool)
    while len(out) < count:
        u = int(rng.choice(pool))
        v = int(rng.choice(vpool))
        if u * g.n_v + v not in have:
            have.add(u * g.n_v + v)
            out.append((u, v))
    return np.array(out, np.int64).reshape(-1, 2)


def assert_same_result(j, t):
    """Bit-equal numbers and refresh stats of one served result."""
    np.testing.assert_array_equal(np.asarray(t.numbers),
                                  np.asarray(j.numbers))
    assert t.workload == j.workload
    for f in REFRESH_STATS:
        assert getattr(t.stats, f) == getattr(j.stats, f), f


class Twin:
    """The reference service and the port's, fed the same traffic; each
    call is made on both sides and its outcome compared."""

    def __init__(self, service=None, **kw):
        jcfg = _jcfg(**kw)
        self.j = JDecompositionService(jcfg, service)
        self.t = DecompositionService(
            engine_config_from_fields(jcfg.to_dict()),
            None if service is None else service_config_from_fields(
                dataclasses.asdict(service)),
            device="cpu")

    def graph(self, name):
        return self.j._datasets[name].graph

    def ingest(self, name, g, **kw):
        vj = self.j.ingest(name, g, **kw)
        vt = self.t.ingest(name, _tg(g), **kw)
        assert vt == vj
        return vt

    def insert_edges(self, name, eu, ev):
        vj = self.j.insert_edges(name, eu, ev)
        assert self.t.insert_edges(name, eu, ev) == vj
        return vj

    def delete_edges(self, name, eu, ev):
        vj = self.j.delete_edges(name, eu, ev)
        assert self.t.delete_edges(name, eu, ev) == vj
        return vj

    def query(self, name, **kw):
        dj, dt = self.j.query(name, **kw), self.t.query(name, **kw)
        assert_same_result(dj, dt)
        return dt

    def flush(self, *args):
        rj, rt = self.j.flush(*args), self.t.flush(*args)
        assert rt == rj
        return rt

    def check(self):
        """Per-dataset summaries, queue counters and the cache report."""
        rj, rt = self.j.report(), self.t.report()
        assert rt["datasets"] == rj["datasets"]
        assert rt["queue"] == rj["queue"]
        assert self.t.cache_report() == self.j.cache_report()


# --------------------------------------------------------------------- #
# ingestion / query / versioning
# --------------------------------------------------------------------- #
def test_ingest_query_matches_direct_decompose():
    g = interaction_graph(60, 40, 400, seed=1)
    tw = Twin()
    assert tw.ingest("d", g) == 1
    dec = tw.query("d")
    assert isinstance(dec, Decomposition)
    ref = Executor(_tcfg(), device="cpu").decompose(_tg(g))
    np.testing.assert_array_equal(dec.numbers, ref.numbers)
    assert tw.t.max_level("d") == tw.j.max_level("d") == ref.max_level()
    assert tw.t.tip_number("d", 3) == tw.j.tip_number("d", 3)
    sub, members, v_ids = tw.t.subgraph_at("d", 2)
    rsub, rmem, rv = tw.j.subgraph_at("d", 2)
    np.testing.assert_array_equal(members, rmem)
    np.testing.assert_array_equal(v_ids, rv)
    np.testing.assert_array_equal(_keys(sub), _keys(rsub))
    tw.check()


def test_ingest_forms_and_validation():
    tw = Twin()
    for svc in (tw.j, tw.t):
        svc.ingest("from-edges", edges=([0, 0, 1, 1], [0, 1, 0, 1]),
                   n_u=3, n_v=3)
    assert tw.t.max_level("from-edges") == tw.j.max_level("from-edges") == 1
    a = np.zeros((3, 3))
    a[[0, 0, 1, 1], [0, 1, 0, 1]] = 1
    for svc in (tw.j, tw.t):
        svc.ingest("from-dense", a)
    np.testing.assert_array_equal(tw.query("from-dense").numbers,
                                  tw.query("from-edges").numbers)
    with pytest.raises(GraphValidationError):
        tw.t.ingest("bad", edges=([0], [99]), n_u=3, n_v=3)
    with pytest.raises(GraphValidationError):
        tw.t.ingest("from-dense", a)            # exists, replace not set
    assert tw.j.ingest("from-dense", a, replace=True) == 2
    assert tw.t.ingest("from-dense", a, replace=True) == 2
    tw.check()


def test_version_monotonicity_and_mutation_validation():
    g = random_bipartite(30, 20, 0.2, seed=2)
    tw = Twin()
    seen = [tw.ingest("d", g)]
    rng = np.random.default_rng(0)
    ins = _fresh_edges(g, 3, rng)
    seen.append(tw.insert_edges("d", ins[:, 0], ins[:, 1]))
    seen.append(tw.delete_edges("d", [g.edges_u[0]], [g.edges_v[0]]))
    assert seen == sorted(seen) and len(set(seen)) == len(seen)
    # inserting a present edge / deleting a missing edge fail validated
    with pytest.raises(GraphValidationError):
        tw.t.insert_edges("d", ins[:1, 0], ins[:1, 1])
    with pytest.raises(GraphValidationError):
        tw.t.delete_edges("d", [g.edges_u[0]], [g.edges_v[0]])
    # failed mutations must not bump the version
    assert tw.t.report()["datasets"]["d"]["version"] == seen[-1]
    tw.check()


def test_wing_dataset_served_through_same_interface():
    g = random_bipartite(25, 20, 0.25, seed=3)
    tw = Twin()
    tw.ingest("w", g, workload="wing")
    dec = tw.query("w")
    ref = JExecutor(_jcfg(workload="wing")).decompose(g)
    np.testing.assert_array_equal(dec.numbers, ref.numbers)
    assert tw.t.psi("w", 0) == tw.j.psi("w", 0) == int(ref.numbers[0])
    with pytest.raises(ServiceUnavailableError):
        tw.t.tip_number("w", 0)                 # wrong-workload query
    from repro.api import ServiceUnavailableError as JUnavailable

    with pytest.raises(JUnavailable):
        tw.j.tip_number("w", 0)
    tw.check()


# --------------------------------------------------------------------- #
# admission batching
# --------------------------------------------------------------------- #
def test_flush_batches_compatible_fulls_through_map():
    tw = Twin()
    graphs = [interaction_graph(48, 32, 300, seed=s) for s in range(3)]
    for i, g in enumerate(graphs):
        tw.ingest(f"d{i}", g)
    rep = tw.flush()
    assert rep["fleets"] == 1 and rep["mapped"] == 3
    ex = Executor(_tcfg(), device="cpu")
    for i, g in enumerate(graphs):
        np.testing.assert_array_equal(tw.query(f"d{i}").numbers,
                                      ex.decompose(_tg(g)).numbers)
    # fleet below map_min_fleet runs per-graph (no map fleet)
    tw.ingest("solo", interaction_graph(48, 32, 300, seed=9))
    rep = tw.flush()
    assert rep["fleets"] == 0 and rep["full"] == 1
    tw.check()


def test_warm_repeat_queries_hit_cache_without_new_dispatches():
    tw = Twin()
    g = interaction_graph(48, 32, 300, seed=4)
    tw.ingest("d", g)
    tw.query("d")                               # computes
    before = tw.t.report()
    for _ in range(5):
        tw.query("d")
    after = tw.t.report()
    ds_b, ds_a = before["datasets"]["d"], after["datasets"]["d"]
    assert ds_a["query_hits"] - ds_b["query_hits"] == 5
    # no further engine work ran: executor cache state unchanged
    assert after["executors"]["tip"] == before["executors"]["tip"]
    tw.check()


def test_queue_coalesces_and_admission_controls():
    def run(queue_cls, item_cls, unavailable):
        q = queue_cls(max_pending=2)
        q.submit(item_cls("a", "refresh", 1))
        q.submit(item_cls("a", "full", 2))          # upgrades in place
        q.submit(item_cls("a", "refresh", 3))       # full never degrades
        assert len(q) == 1
        item = q.drain("a")[0]
        q.submit(item_cls("a", "refresh", 1))
        q.submit(item_cls("b", "refresh", 1))
        with pytest.raises(unavailable):
            q.submit(item_cls("c", "refresh", 1))
        with pytest.raises(ValueError):
            item_cls("a", "florp", 1)
        return ((item.kind, item.version), len(q), q.submitted,
                q.coalesced, q.rejected)

    from repro.api import ServiceUnavailableError as JUnavailable

    got = run(RequestQueue, WorkItem, ServiceUnavailableError)
    assert got == run(JRequestQueue, JWorkItem, JUnavailable)
    assert got[0] == ("full", 3) and got[-1] == 1


# --------------------------------------------------------------------- #
# incremental refresh: differential suite
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("workload", ["tip", "wing"])
def test_refresh_differential_random_sequences(workload):
    """Random insert/delete sequences (deletes on every step): the
    refreshed numbers and refresh stats are bit-identical to the
    reference's on EVERY step and to from-scratch decomposition, and at
    least one step re-peels only a strict subset of the stored CD
    subsets."""
    rng = np.random.default_rng(11)
    if workload == "tip":
        g = interaction_graph(72, 48, 560, seed=7)
    else:
        # needs enough psi spread for a multi-subset CD ladder — a flat
        # ER graph collapses to one range and nothing can be partial
        g = interaction_graph(48, 40, 360, seed=7)
    parts = 8 if workload == "tip" else 6
    tw = Twin(JServiceConfig(refresh_dirty_threshold=0.2),
              num_partitions=parts)
    ref_ex = Executor(_tcfg(workload=workload, num_partitions=parts),
                      device="cpu")
    tw.ingest("d", g, workload=workload)
    tw.query("d")
    partial_steps = 0
    delta_steps = 0
    for step in range(6):
        cur = tw.graph("d")
        # bias mutations onto low-degree endpoints (both sides) so the
        # mutation ceiling stays below the top CD bounds on some steps
        du, dv = cur.degrees_u(), cur.degrees_v()
        pool = np.argsort(du)[: max(8, cur.n_u // 3)]
        vpool = np.argsort(dv)[: max(8, cur.n_v // 3)]
        ins = _fresh_edges(cur, 3, rng, u_pool=pool, v_pool=vpool)
        tw.insert_edges("d", ins[:, 0], ins[:, 1])
        low = np.argsort(du[cur.edges_u] + dv[cur.edges_v],
                         kind="stable")[:3]
        tw.delete_edges("d", cur.edges_u[low], cur.edges_v[low])
        dec = tw.query("d")
        ref = ref_ex.decompose(tw.t._datasets["d"].graph)
        np.testing.assert_array_equal(
            dec.numbers, ref.numbers,
            err_msg=f"step {step} refresh diverged from from-scratch")
        s = dec.stats
        if s.refresh_mode == "delta":
            delta_steps += 1
            assert s.refresh_stop > s.refresh_t_hi
            if s.refresh_subsets_repeeled < s.refresh_subsets_total:
                partial_steps += 1
        tw.check()                   # the maintained supports' bytes too
    if workload == "tip":
        np.testing.assert_array_equal(tw.t._datasets["d"].supports,
                                      tw.j._datasets["d"].supports)
    assert delta_steps >= 4, "dirty threshold unexpectedly forced fulls"
    assert partial_steps >= 1, (
        "no step re-peeled a strict subset — dirty-subset containment "
        "never exercised")


def test_refresh_falls_back_to_full_past_dirty_threshold():
    g = interaction_graph(60, 40, 420, seed=8)
    tw = Twin(JServiceConfig(refresh_dirty_threshold=0.01))
    tw.ingest("d", g)
    tw.query("d")
    rng = np.random.default_rng(2)
    ins = _fresh_edges(g, 30, rng)               # ~7% dirty > 1%
    tw.insert_edges("d", ins[:, 0], ins[:, 1])
    dec = tw.query("d")
    assert dec.stats.refresh_mode == "full"
    assert tw.t.report()["datasets"]["d"]["full_recomputes"] >= 1
    ref = Executor(_tcfg(), device="cpu").decompose(
        tw.t._datasets["d"].graph)
    np.testing.assert_array_equal(dec.numbers, ref.numbers)
    tw.check()


def test_refresh_net_noop_serves_without_recompute():
    g = random_bipartite(30, 20, 0.2, seed=9)
    tw = Twin()
    tw.ingest("d", g)
    first = tw.query("d")
    rng = np.random.default_rng(3)
    ins = _fresh_edges(g, 2, rng)
    tw.insert_edges("d", ins[:, 0], ins[:, 1])
    tw.delete_edges("d", ins[:, 0], ins[:, 1])   # net no-op
    assert tw.query("d") is first                # same object: no rerun
    rep = tw.t.report()["datasets"]["d"]
    assert rep["refreshes"] == 0 and rep["fresh"]
    tw.check()


# --------------------------------------------------------------------- #
# staleness policies
# --------------------------------------------------------------------- #
def test_staleness_strict_raises_and_flush_clears():
    g = random_bipartite(30, 20, 0.2, seed=10)
    tw = Twin(JServiceConfig(staleness="strict"))
    tw.ingest("d", g)
    with pytest.raises(StaleReadError):           # never computed yet
        tw.t.query("d")
    tw.flush()
    tw.query("d")
    tw.delete_edges("d", [g.edges_u[0]], [g.edges_v[0]])
    with pytest.raises(StaleReadError) as ei:
        tw.t.query("d")
    assert ei.value.context["version"] > ei.value.context["result_version"]
    tw.flush()
    assert tw.query("d") is not None


def test_staleness_stale_ok_serves_old_result():
    g = random_bipartite(30, 20, 0.2, seed=12)
    tw = Twin(JServiceConfig(staleness="stale_ok"))
    tw.ingest("d", g)
    tw.flush()
    first = tw.query("d")
    tw.delete_edges("d", [g.edges_u[0]], [g.edges_v[0]])
    assert tw.query("d") is first                 # stale but served
    assert tw.t.report()["datasets"]["d"]["stale_reads"] == 1
    tw.flush()
    assert tw.query("d") is not first
    tw.check()


# --------------------------------------------------------------------- #
# error taxonomy
# --------------------------------------------------------------------- #
def test_unknown_dataset_raises_structured_keyerror():
    svc = DecompositionService(_tcfg(), device="cpu")
    with pytest.raises(DatasetNotFoundError) as ei:
        svc.query("nope")
    assert isinstance(ei.value, KeyError)
    assert ei.value.context["dataset"] == "nope"
    with pytest.raises(DatasetNotFoundError):
        svc.drop("nope")


def test_map_wing_rejection_is_plan_infeasible():
    ex = Executor(_tcfg(workload="wing"), device="cpu")
    g = _tg(random_bipartite(10, 8, 0.3, seed=1))
    with pytest.raises(PlanInfeasibleError):
        ex.map([g])
    with pytest.raises(ValueError):               # taxonomy compat
        ex.map([g])


@pytest.mark.parametrize("bad", [dict(refresh_dirty_threshold=1.5),
                                 dict(staleness="eventual"),
                                 dict(map_min_fleet=1)])
def test_service_config_validation(bad):
    with pytest.raises(ValueError) as want:
        JServiceConfig(**bad)
    with pytest.raises(ValueError) as got:
        ServiceConfig(**bad)
    assert str(got.value) == str(want.value)
    fields = dataclasses.asdict(JServiceConfig(background=True,
                                               cache_budget_bytes=64))
    assert dataclasses.asdict(service_config_from_fields(fields)) == fields


def test_service_on_the_card_by_default(monkeypatch):
    """``device=None`` means the card: without one the service and the
    CLI raise; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecompositionService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--selftest"])


# --------------------------------------------------------------------- #
# protocol + describe
# --------------------------------------------------------------------- #
def test_decomposition_protocol_and_aliases():
    g = random_bipartite(25, 20, 0.25, seed=13)
    tip = Executor(_tcfg(), device="cpu").decompose(_tg(g))
    wing = Executor(_tcfg(workload="wing"), device="cpu").decompose(_tg(g))
    for dec, ref in ((tip, JExecutor(_jcfg()).decompose(g)),
                     (wing, JExecutor(_jcfg(workload="wing")).decompose(g))):
        assert isinstance(dec, Decomposition)
        assert dec.max_level() == (int(dec.numbers.max())
                                   if dec.numbers.size else 0)
        d = dec.to_dict()
        assert d == ref.to_dict()
        assert d["numbers"] == [int(x) for x in dec.numbers]
        assert d["max_level"] == dec.max_level()
    # deprecated aliases stay bit-compatible
    assert tip.max_theta() == tip.max_level()
    assert wing.max_psi() == wing.max_level()
    assert tip.vertex_tip(0) == int(tip.numbers[0])
    assert wing.edge_psi(0) == int(wing.numbers[0])
    assert tip.to_dict()["workload"] == "tip"
    assert wing.to_dict()["axis"] == "edge"


def test_engine_config_describe_renders_resolved_knobs():
    text = _tcfg(num_partitions=4).describe()
    assert "backend:" in text and "'torch'" in text
    assert "num_partitions" in text and "[non-default]" in text
    desc = Twin().t.describe()
    assert "ServiceConfig" in desc and "staleness" in desc
    # the service block is the reference's, line for line
    tail = desc[desc.index("ServiceConfig"):]
    jdesc = Twin().j.describe()
    assert tail == jdesc[jdesc.index("ServiceConfig"):]


# --------------------------------------------------------------------- #
# the support prime and the refresh's host reads
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("seed", [1, 2])
def test_support_prime_equals_reference_host_product(backend, seed):
    g = interaction_graph(70, 50, 600, seed=seed)
    want = jrefresh._tip_supports_host(g)
    a = trefresh._matrix(g.n_u, g.n_v, g.edges_u, g.edges_v, "cpu")
    got = trefresh.tip_supports(a, backend=backend, blocks=SMALL_BLOCKS)
    np.testing.assert_array_equal(got.double().numpy(), want)


def test_support_prime_past_the_f32_regime_recomputes(monkeypatch):
    """A prime at 2^24 cannot be exact in f32: the refresh raises
    ``PlanInfeasibleError`` inside and the dataset is recomputed in
    full, the error set in ``last_error`` when the fallback starts."""
    g = interaction_graph(60, 40, 400, seed=5)
    svc = DecompositionService(_tcfg(), device="cpu")
    svc.ingest("d", _tg(g))
    svc.query("d")
    monkeypatch.setattr(trefresh, "EXACT_LIMIT", 1.0)
    seen = []
    real_full = trefresh._full

    def spied_full(ds, executor, *, fallback):
        seen.append((fallback, ds.last_error))
        return real_full(ds, executor, fallback=fallback)

    monkeypatch.setattr(trefresh, "_full", spied_full)
    rng = np.random.default_rng(5)
    ins = _fresh_edges(g, 2, rng)
    svc.insert_edges("d", ins[:, 0], ins[:, 1])
    dec = svc.query("d")
    assert dec.stats.refresh_mode == "full"
    (fallback, err), = seen
    assert fallback and isinstance(err, PlanInfeasibleError)
    assert "2^24" in str(err)
    ref = Executor(_tcfg(), device="cpu").decompose(
        svc._datasets["d"].graph)
    np.testing.assert_array_equal(dec.numbers, ref.numbers)


@pytest.mark.parametrize("workload", ["tip", "wing"])
def test_refresh_counts_its_one_host_read(workload, monkeypatch):
    """A delta refresh reads the device once (supports, gains, losses;
    closed form and delta on the edge axis), and that read is added to
    the run's ``host_round_trips`` beside ``Executor.repeel``'s own."""
    g = interaction_graph(60, 40, 400, seed=6)
    svc = DecompositionService(_tcfg(), ServiceConfig(
        refresh_dirty_threshold=0.5), device="cpu")
    svc.ingest("d", _tg(g), workload=workload)
    svc.query("d")
    ex = svc._executor(workload)
    seen = {"fetch": 0}
    real_fetch, real_repeel = trefresh.fetch, ex.repeel

    def counted_fetch(*args):
        seen["fetch"] += 1
        return real_fetch(*args)

    def spied_repeel(*args, **kwargs):
        numbers, stats = real_repeel(*args, **kwargs)
        seen["repeel"] = stats.host_round_trips
        return numbers, stats

    monkeypatch.setattr(trefresh, "fetch", counted_fetch)
    monkeypatch.setattr(ex, "repeel", spied_repeel)
    rng = np.random.default_rng(6)
    ins = _fresh_edges(g, 2, rng)
    svc.insert_edges("d", ins[:, 0], ins[:, 1])
    svc.delete_edges("d", g.edges_u[:2], g.edges_v[:2])
    dec = svc.query("d")
    assert dec.stats.refresh_mode == "delta"
    assert seen["fetch"] == 1
    assert dec.stats.host_round_trips == seen["repeel"] + 1


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("argv", [
    ["--selftest", "--workload", "tip"],
    ["--selftest", "--workload", "wing"],
    ["--soak", "--background", "--datasets", "2", "--mutations", "2"],
])
def test_serve_cli_runs_on_cpu(argv, capsys):
    assert serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "exact=True" in out


def test_serve_soak_under_injected_worker_death(monkeypatch, capsys):
    monkeypatch.setenv("RECEIPT_FAULT", "refresh_worker@2")
    faults.reset()
    try:
        assert serve.main(["--soak", "--background", "--datasets", "2",
                           "--mutations", "2", "--device", "cpu"]) == 0
    finally:
        faults.reset()
    out = capsys.readouterr().out
    assert "crashes: 1" in out and "exact=True" in out


def test_serve_selftest_matches_reference(capsys):
    """The CLI's selftest line (levels, refresh route, stop, subsets)
    is the reference's."""
    from repro.launch import serve as jserve

    for workload in ("tip", "wing"):
        assert jserve.selftest(workload) == 0
        want = capsys.readouterr().out
        assert serve.selftest(workload, device="cpu") == 0
        assert capsys.readouterr().out == want


# --------------------------------------------------------------------- #
# concurrent serving
# --------------------------------------------------------------------- #
def test_concurrent_interleaved_ingest_query_refresh():
    """Two datasets, four threads interleaving mutations and queries on
    the port's service: every answer must match the reference's
    from-scratch decomposition of the graph version it was served at,
    versions stay monotone, and the warm query path keeps hitting the
    cache."""
    svc = DecompositionService(_tcfg(), ServiceConfig(
        refresh_dirty_threshold=0.5), device="cpu")
    gs = {"x": interaction_graph(56, 36, 380, seed=31),
          "y": interaction_graph(56, 36, 380, seed=32)}
    for name, g in gs.items():
        svc.ingest(name, _tg(g))
    svc.flush()                                   # one map fleet warm-up
    errors = []
    versions = {"x": [], "y": []}
    answers = []                                  # (name, keys, numbers)

    def mutator(name, seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(3):
                with svc._lock:                   # mutations atomic in pairs
                    cur = svc._datasets[name].graph
                    ins = _fresh_edges(cur, 2, r)
                    v1 = svc.insert_edges(name, ins[:, 0], ins[:, 1])
                    cur = svc._datasets[name].graph
                    drop = r.choice(cur.m, 2, replace=False)
                    v2 = svc.delete_edges(name, cur.edges_u[drop],
                                          cur.edges_v[drop])
                versions[name] += [v1, v2]
                svc.query(name)
        except Exception as exc:                  # surfaced after join
            errors.append(exc)

    def reader(name):
        try:
            for _ in range(6):
                with svc._lock:                   # snapshot version+answer
                    dec = svc.query(name)
                    gsnap = svc._datasets[name].base_graph
                answers.append((name, _keys(gsnap),
                                np.asarray(dec.numbers).copy()))
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=mutator, args=("x", 1)),
               threading.Thread(target=mutator, args=("y", 2)),
               threading.Thread(target=reader, args=("x",)),
               threading.Thread(target=reader, args=("y",))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for name in ("x", "y"):
        assert versions[name] == sorted(versions[name])
        assert len(set(versions[name])) == len(versions[name])
    # every served answer is bit-identical to the reference's
    # from-scratch decomposition of the graph it was served against
    from repro.core.graph import BipartiteGraph as JBipartiteGraph

    ex = JExecutor(_jcfg())
    checked = set()
    for name, keys, numbers in answers:
        sig = (name, keys.tobytes())
        if sig in checked:
            continue
        checked.add(sig)
        g = gs[name]
        gg = JBipartiteGraph.from_edges(g.n_u, g.n_v,
                                        keys // g.n_v, keys % g.n_v)
        np.testing.assert_array_equal(numbers, ex.decompose(gg).numbers)
    rep = svc.report()
    # warm expectation: most queries after the initial computes are hits
    total_q = sum(d["queries"] for d in rep["datasets"].values())
    hits = sum(d["query_hits"] for d in rep["datasets"].values())
    assert hits >= total_q // 3
    assert rep["queue"]["pending"] == 0

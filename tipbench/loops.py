"""The traffic loops a mix names, and what each one produces for the
check.

A mix is a JSON file of parameters under ``tipbench/traffic/``; its
``loop`` names one of ``LOOPS``.  A graph is a Chung-Lu graph of exactly
the configuration's counts, by its ``generator`` exponents
(``generator.powerlaw_edges_exact``).

* ``decompose``: a closed loop of one client.  Each request is a fresh
  graph of the configuration, drawn in set-up from ``(seed, i)`` for a
  pool of ``pool`` of them (cycled if a window outruns it).  The timed
  request is ``BipartiteGraph.from_edges``, then ``Executor.plan``, then
  ``Executor.decompose``, theta back on the host.
* ``refresh``: an inline ``DecompositionService`` holding the
  configuration's graph (drawn from the configuration's
  ``generator.seed``, the same on every run), ingested and flushed in
  set-up.  Each cycle deletes and inserts one mutation batch
  (``generator.mutation_batches``, drawn in set-up from ``(seed, 1)``),
  calls ``flush`` and reads the numbers back by ``query``.

Set-up ends with ``warm`` requests or cycles of the same shapes, which are
checked like the window's.  Every loop keeps, per request, the host times
of its spans and the program's ``RunStats`` counters, and its answers;
``expected(k)`` is the plain reference's answer to request ``k``, worked
out from the seed's data alone.

A configuration may state ``exact_limit``: every butterfly support below
it is computed exactly by the program under that configuration (its
``precision`` text names the DESIGN.md section that says so).  Without
the key the limit is ``EXACT_LIMIT``, the float32 integer regime
(DESIGN.md section 8).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import generator, reference

__all__ = ["LOOPS", "DecomposeLoop", "RefreshLoop", "exact_limit", "span"]

EXACT_LIMIT = 2 ** 24


def exact_limit(cfg: Dict):
    """The configuration's exact limit: its ``exact_limit``, else
    ``EXACT_LIMIT``."""
    return cfg.get("exact_limit", EXACT_LIMIT)


def span(name: str):
    """A profiler range named ``name`` (recorded only under a profiler)."""
    return torch.profiler.record_function(name)


def _engine_config(cfg: Dict):
    from repro_torch.api import EngineConfig

    return EngineConfig(**cfg["engine"])


def _stats(st) -> Dict:
    return {"time_count": float(st.time_count), "time_cd": float(st.time_cd),
            "time_fd": float(st.time_fd),
            "round_trips": int(st.host_round_trips)}


class _Loop:
    """What both loops share: the configuration, the mix, the seed, the
    device, the answers and the per-request records."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.side = cfg["engine"].get("side", "U")
        self.answers: List[np.ndarray] = []     # warm ones first
        self.records: List[Dict] = []           # window requests only
        self.n_warm = 0

    def graph_shape(self) -> Tuple[int, int, int]:
        c = self.cfg
        return int(c["n_u"]), int(c["n_v"]), int(c["m"])

    def draw(self, seed) -> Tuple[np.ndarray, np.ndarray]:
        """A graph of the configuration drawn from ``seed``, as (eu, ev)."""
        n_u, n_v, m = self.graph_shape()
        gen = self.cfg["generator"]
        return generator.powerlaw_edges_exact(n_u, n_v, m, gen["alpha_u"],
                                              gen["alpha_v"], seed=seed)

    def peeled(self, n_u, n_v, eu, ev):
        """The graph with the peeled side as U."""
        return (n_u, n_v, eu, ev) if self.side == "U" else (n_v, n_u, ev, eu)

    def expected(self, k: int, dtype=torch.float64):
        """The reference's (tip numbers, largest support) for request
        ``k``, at ``dtype``."""
        theta, _, top = reference.tip_numbers(
            *self.peeled(*self.answer_graph(k)), device=self.device,
            dtype=dtype)
        return theta, top

    def warm(self) -> None:
        for _ in range(int(self.traffic.get("warm", 1))):
            self.answers.append(self.step(len(self.answers))[0])
            self.n_warm += 1

    def replay(self) -> None:
        """One more request after the window, for a traced run's readings:
        its answer is kept, and checked like the others; it has no
        record."""
        self.answers.append(self.step(len(self.answers))[0])

    def timed(self) -> None:
        """The next request, as a window request (warm ones count first)."""
        theta, rec = self.step(len(self.answers))
        self.answers.append(theta)
        self.records.append(rec)


class DecomposeLoop(_Loop):
    """Fresh graphs of the configuration through ``Executor.decompose``
    (see module doc)."""

    def prepare(self) -> None:
        # answer k is pool graph k % pool; warm ones take the first
        self.pool = [self.draw((self.seed, i))
                     for i in range(int(self.traffic["pool"]))]

    def setup(self) -> None:
        from repro_torch.api import Executor

        self.executor = Executor(_engine_config(self.cfg),
                                 device=self.device)

    def answer_graph(self, k: int):
        n_u, n_v, _ = self.graph_shape()
        eu, ev = self.pool[k % len(self.pool)]
        return n_u, n_v, eu, ev

    def step(self, k: int):
        from repro_torch.core.graph import BipartiteGraph

        n_u, n_v, eu, ev = self.answer_graph(k)
        t0 = time.perf_counter()
        with span("tipbench.from_edges"):
            g = BipartiteGraph.from_edges(n_u, n_v, eu, ev)
        t1 = time.perf_counter()
        with span("tipbench.plan"):
            plan = self.executor.plan(g)
        t2 = time.perf_counter()
        with span("tipbench.decompose"):
            td = self.executor.decompose(g, plan=plan)
            theta = np.asarray(td.theta, np.int64).copy()
        t3 = time.perf_counter()
        rec = {"plan_s": t2 - t1, "request_s": t3 - t0, **_stats(td.stats)}
        return theta, rec

    def release(self) -> None:
        self.executor = None


class RefreshLoop(_Loop):
    """Mutation batches through an inline ``DecompositionService``."""

    NAME = "graph"

    def prepare(self) -> None:
        n_u, n_v, m = self.graph_shape()
        gen = self.cfg["generator"]
        self.edges = self.draw(gen["seed"])
        self.base = generator.edge_keys(*self.edges, n_v)
        t = self.traffic
        self.batches = generator.mutation_batches(
            self.base, n_u, n_v, m, gen["alpha_u"], gen["alpha_v"],
            float(t["batch_fraction"]), float(t["delete_share"]),
            int(t["cycles"]), seed=(self.seed, 1))

    def setup(self) -> None:
        from repro_torch.service import DecompositionService, ServiceConfig

        n_u, n_v, _ = self.graph_shape()
        eu, ev = self.edges
        self.service = DecompositionService(
            _engine_config(self.cfg), ServiceConfig(), device=self.device)
        self.service.ingest(self.NAME, edges=(eu, ev), n_u=n_u, n_v=n_v)
        self.service.flush(self.NAME)

    def answer_graph(self, k: int):
        """The graph after cycles 0..k."""
        n_u, n_v, _ = self.graph_shape()
        cur = self.base
        for dels, ins in self.batches[: k + 1]:
            cur = np.union1d(np.setdiff1d(cur, dels, assume_unique=True), ins)
        return n_u, n_v, cur // n_v, cur % n_v

    def step(self, k: int):
        if k >= len(self.batches):
            raise RuntimeError(f"the mix holds {len(self.batches)} cycles; "
                               "raise its 'cycles'")
        n_v = int(self.cfg["n_v"])
        dels, ins = self.batches[k]
        svc = self.service
        t0 = time.perf_counter()
        with span("tipbench.mutate"):
            svc.delete_edges(self.NAME, dels // n_v, dels % n_v)
            svc.insert_edges(self.NAME, ins // n_v, ins % n_v)
        t1 = time.perf_counter()
        with span("tipbench.flush"):
            report = svc.flush(self.NAME)
        t2 = time.perf_counter()
        with span("tipbench.query"):
            dec = svc.query(self.NAME)
            theta = np.asarray(dec.theta, np.int64).copy()
        t3 = time.perf_counter()
        rec = {"flush_s": t2 - t1, "request_s": t3 - t0,
               "delta": int(report.get("refreshed", 0)),
               "full": int(report.get("full", 0)) + int(report.get("mapped",
                                                                   0)),
               **_stats(dec.stats)}
        return theta, rec

    def release(self) -> None:
        self.service.close()
        self.service = None


LOOPS = {"decompose": DecomposeLoop, "refresh": RefreshLoop}

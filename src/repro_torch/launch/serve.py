"""Decomposition service CLI: ``python -m repro_torch.launch.serve``
(port of ``repro.launch.serve``).

The CLI front of ``repro_torch.service`` (DESIGN.md §11): ingest a dataset,
decompose it, answer queries, stream edge mutations through the
incremental-refresh path.  Two modes:

* ``--selftest`` — the CI smoke: ingest → query → mutate → refresh →
  query on a small synthetic graph, asserting the refreshed numbers are
  bit-identical to a from-scratch decomposition (exit code 0/1).
* ``--soak`` — the scheduler soak (DESIGN.md §12): mixed
  ingest/mutate/query traffic over several datasets, optionally with
  the ``--background`` flush worker on, draining shutdown, and a final
  per-dataset exactness check against from-scratch decompositions.
  When a ``RECEIPT_FAULT`` env spec arms the ``refresh_worker`` site
  the soak additionally asserts the injected worker death was observed
  (crash counted, restart logged) AND results stayed exact (exit 0/1).
* default demo — ingest ``--n-u x --n-v x --edges`` synthetic datasets,
  run a mutation/query traffic loop and print the serving report.

Every mode runs on the card unless ``--device cpu`` is given (the kernels'
plain versions); the kernel backend follows the device.

The LM decode loop lives in ``launch/serve_lm.py`` (``BatchedServer`` is
re-exported below for compatibility, as in the reference).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _lazy_batched_server(name):
    if name == "BatchedServer":                     # compat shim
        from .serve_lm import BatchedServer

        return BatchedServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__getattr__ = _lazy_batched_server


def _fresh_edges(g, count, rng):
    """``count`` edges absent from ``g`` (uniform endpoints)."""
    have = set((g.edges_u.astype(np.int64) * g.n_v + g.edges_v).tolist())
    out = []
    while len(out) < count:
        u = int(rng.integers(g.n_u))
        v = int(rng.integers(g.n_v))
        k = u * g.n_v + v
        if k not in have:
            have.add(k)
            out.append((u, v))
    return np.array(out, np.int64)


def selftest(workload: str = "tip", verbose: bool = True,
             device=None) -> int:
    """Ingest → query → refresh → query smoke with an exactness check."""
    from ..api import EngineConfig, Executor
    from ..data.synthetic import interaction_graph
    from ..service import DecompositionService, ServiceConfig

    rng = np.random.default_rng(0)
    cfg = EngineConfig(num_partitions=6)
    svc = DecompositionService(cfg, ServiceConfig(
        refresh_dirty_threshold=0.10), device=device)
    g = interaction_graph(72, 48, 560, seed=11)
    svc.ingest("smoke", g, workload=workload)
    lvl0 = svc.max_level("smoke")
    ins = _fresh_edges(g, 4, rng)
    svc.insert_edges("smoke", ins[:, 0], ins[:, 1])
    drop = rng.choice(g.m, 4, replace=False)
    svc.delete_edges("smoke", g.edges_u[drop], g.edges_v[drop])
    dec = svc.query("smoke")                       # drains the refresh
    stats = dec.stats
    import dataclasses

    ref = Executor(dataclasses.replace(cfg, workload=workload),
                   device=svc.device).decompose(svc._datasets["smoke"].graph)
    exact = bool((np.asarray(dec.numbers) == np.asarray(ref.numbers)).all())
    if verbose:
        print(f"[serve] selftest {workload}: max_level {lvl0} -> "
              f"{dec.max_level()}, refresh={stats.refresh_mode} "
              f"stop={stats.refresh_stop:g} subsets="
              f"{stats.refresh_subsets_repeeled}/"
              f"{stats.refresh_subsets_total} exact={exact}")
    if not exact:
        print("[serve] SELFTEST FAILED: refreshed numbers differ from "
              "from-scratch decomposition")
        return 1
    return 0


def soak(workload: str = "tip", *, datasets: int = 3, rounds: int = 3,
         batch: int = 6, background: bool = True,
         cache_budget: int = None, verbose: bool = True,
         device=None) -> int:
    """Mixed-traffic soak of the serving scheduler (exit code 0/1).

    Drives ingest + mutate + query rounds over ``datasets`` datasets —
    with the background worker on when ``background`` — then stops the
    worker with a draining shutdown and checks every dataset's final
    numbers bit-exactly against a from-scratch decomposition.  With a
    ``RECEIPT_FAULT`` spec arming ``refresh_worker``, the soak also
    requires the injected worker death to have been observed (crashes
    counted in the RestartManager failure log) while staying exact —
    the crash-isolation story, end to end.
    """
    import dataclasses
    import os

    from ..api import EngineConfig, Executor
    from ..data.synthetic import interaction_graph
    from ..service import DecompositionService, ServiceConfig

    rng = np.random.default_rng(7)
    cfg = EngineConfig(num_partitions=6)
    scfg = ServiceConfig(background=background, worker_poll_s=0.01,
                         refresh_dirty_threshold=0.25,
                         cache_budget_bytes=cache_budget)
    svc = DecompositionService(cfg, scfg, device=device)
    names = []
    for i in range(datasets):
        g = interaction_graph(64, 48, 480 + 40 * i, seed=20 + i)
        name = f"soak{i}"
        svc.ingest(name, g, workload=workload)
        names.append(name)
    stale_served = 0
    for _ in range(rounds):
        for name in names:
            g = svc._datasets[name].graph
            half = max(batch // 2, 1)
            ins = _fresh_edges(g, half, rng)
            svc.insert_edges(name, ins[:, 0], ins[:, 1])
            drop = rng.choice(g.m, half, replace=False)
            svc.delete_edges(name, g.edges_u[drop], g.edges_v[drop])
            _, info = svc.query(name, with_info=True)
            if not info["fresh"]:
                stale_served += 1
    drained = svc.stop_worker(drain=True, timeout=120.0)
    svc.flush()                     # any abandoned remainder runs inline
    failures = 0
    for name in names:
        ds = svc._datasets[name]
        ref = Executor(dataclasses.replace(cfg, workload=workload),
                       device=svc.device).decompose(ds.graph)
        dec = svc.query(name)
        if not np.array_equal(np.asarray(dec.numbers),
                              np.asarray(ref.numbers)):
            failures += 1
            print(f"[serve] SOAK FAILED: {name} differs from "
                  "from-scratch decomposition")
    w = svc.report()["worker"] or {}
    cache = svc.cache_report()
    if verbose:
        print(f"[serve] soak {workload}: {len(names)} datasets x "
              f"{rounds} rounds, stale_served={stale_served}, "
              f"worker={{cycles: {w.get('cycles')}, crashes: "
              f"{w.get('crashes')}, restarts: {w.get('restarts')}, "
              f"dead: {w.get('dead')}}}, evicted="
              f"{cache['evicted_total']}, exact={failures == 0}")
    fault = os.environ.get("RECEIPT_FAULT", "")
    if background and "refresh_worker" in fault:
        if w.get("crashes", 0) < 1:
            print("[serve] SOAK FAILED: RECEIPT_FAULT armed "
                  "refresh_worker but no worker crash was observed")
            return 1
        if not w.get("failure_log"):
            print("[serve] SOAK FAILED: worker crashed but the "
                  "RestartManager failure log is empty")
            return 1
    if background and not drained:
        print("[serve] SOAK FAILED: draining shutdown timed out")
        return 1
    return 0 if failures == 0 else 1


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="decomposition service CLI (repro_torch.service)")
    ap.add_argument("--selftest", action="store_true",
                    help="ingest->query->refresh->query smoke; exit 0/1")
    ap.add_argument("--soak", action="store_true",
                    help="mixed-traffic scheduler soak with a final "
                         "exactness check; exit 0/1")
    ap.add_argument("--background", action="store_true",
                    help="run with the background flush worker on")
    ap.add_argument("--cache-budget-bytes", type=int, default=None,
                    help="CacheGovernor byte budget (default unbounded)")
    ap.add_argument("--workload", default="tip", choices=("tip", "wing"))
    ap.add_argument("--n-u", type=int, default=128)
    ap.add_argument("--n-v", type=int, default=96)
    ap.add_argument("--edges", type=int, default=1500)
    ap.add_argument("--datasets", type=int, default=2)
    ap.add_argument("--mutations", type=int, default=3,
                    help="mutation/query rounds per dataset")
    ap.add_argument("--batch", type=int, default=6,
                    help="edges inserted+deleted per mutation round")
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--describe", action="store_true",
                    help="print the resolved config and exit")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest(args.workload, device=args.device)
    if args.soak:
        return soak(args.workload, datasets=args.datasets,
                    rounds=args.mutations, batch=args.batch,
                    background=args.background,
                    cache_budget=args.cache_budget_bytes,
                    device=args.device)

    from ..api import EngineConfig
    from ..data.synthetic import interaction_graph
    from ..service import DecompositionService, ServiceConfig

    cfg = EngineConfig(num_partitions=args.partitions)
    svc = DecompositionService(cfg, ServiceConfig(
        background=args.background,
        cache_budget_bytes=args.cache_budget_bytes), device=args.device)
    if args.describe:
        print(svc.describe())
        return 0
    rng = np.random.default_rng(0)
    names = []
    for i in range(args.datasets):
        g = interaction_graph(args.n_u, args.n_v, args.edges, seed=i)
        name = f"ds{i}"
        svc.ingest(name, g, workload=args.workload)
        names.append(name)
    t0 = time.perf_counter()
    svc.flush()                                     # admission batching
    t_ingest = time.perf_counter() - t0
    print(f"[serve] ingested {len(names)} dataset(s) in {t_ingest:.2f}s "
          f"(flush: {svc.last_flush_report})")
    for rnd in range(args.mutations):
        for name in names:
            g = svc._datasets[name].graph
            half = max(args.batch // 2, 1)
            ins = _fresh_edges(g, half, rng)
            svc.insert_edges(name, ins[:, 0], ins[:, 1])
            drop = rng.choice(g.m, half, replace=False)
            svc.delete_edges(name, g.edges_u[drop], g.edges_v[drop])
            t1 = time.perf_counter()
            dec = svc.query(name)
            dt = time.perf_counter() - t1
            s = dec.stats
            print(f"[serve] round {rnd} {name}: refresh={s.refresh_mode} "
                  f"subsets={s.refresh_subsets_repeeled}/"
                  f"{s.refresh_subsets_total} max_level="
                  f"{dec.max_level()} ({dt:.2f}s)")
    svc.close()                          # draining worker shutdown if on
    rep = svc.report()
    print(f"[serve] queue: {rep['queue']}")
    for name in names:
        print(f"[serve] {name}: {rep['datasets'][name]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""RECEIPT x recsys integration on the PyTorch/CUDA port
(``repro_torch``): tip-number spam filtering for retrieval.

The counterpart of ``examples/recsys_tip_filtering.py``, step for step:

  1. builds synthetic interaction graphs with injected spam "farms"
     (dense user x item blocks) — one graph per regional COHORT,
  2. decomposes the whole fleet in a handful of batched calls with
     ``repro_torch.api.Executor.map`` on the card (the hand kernels:
     the counting form of the stack peel body and kernel 3's B2 stack),
  3. flags the users above each cohort's 95th tip-number percentile and
     prints the recall and precision of the flag,
  4. trains the two-tower retrieval model with
     ``repro_torch.launch.train.train_loop`` (synthetic batches; the
     flagged sets are reported rather than wired into it here).

    PYTHONPATH=src python examples/recsys_tip_filtering_torch.py
    PYTHONPATH=src python examples/recsys_tip_filtering_torch.py --device cpu

Set RECEIPT_SMOKE=1 to shrink the cohort count and training steps.
"""
import argparse
import os
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch.api import EngineConfig, Executor
from repro_torch.core.graph import BipartiteGraph
from repro_torch.launch.train import train_loop

SMOKE = os.environ.get("RECEIPT_SMOKE", "0") == "1"


def build_cohort_with_spam(n_users, n_items, n_spam, seed):
    rng = np.random.default_rng(seed)
    eu, ev = [], []
    for u in range(n_users):                       # organic long-tail traffic
        items = rng.choice(n_items, size=rng.integers(1, 6), replace=False)
        eu += [u] * len(items)
        ev += list(items)
    spam_users = rng.choice(n_users, size=n_spam, replace=False)
    spam_items = rng.choice(n_items, size=12, replace=False)
    for u in spam_users:                           # collusive dense block
        for i in spam_items:
            eu.append(u)
            ev.append(i)
    return BipartiteGraph.from_edges(n_users, n_items, eu, ev), set(spam_users)


def build_fleet(n_cohorts):
    """The cohorts and their spam sets.  Spam stays under 5% of each
    cohort so the 95th-percentile threshold sits below the farm's tip
    numbers."""
    cohorts, spam_sets = [], []
    for c in range(n_cohorts):
        g, spam = build_cohort_with_spam(n_users=200, n_items=150, n_spam=8,
                                         seed=c)
        cohorts.append(g)
        spam_sets.append(spam)
    return cohorts, spam_sets


def flag_spam(tds, spam_sets, show=3):
    """Per-cohort flag: theta above the cohort's 95th percentile (spam
    farm users share C(12, 2) = 66 butterflies pairwise, so their tip
    numbers are large).  Prints the first ``show`` cohorts and the fleet
    line; returns (true positives, flagged, spam users)."""
    tp_total = flagged_total = spam_total = 0
    for c, (td, spam) in enumerate(zip(tds, spam_sets)):
        theta = td.theta
        thr = np.percentile(theta, 95)
        flagged = set(np.where(theta > thr)[0])
        tp = len(flagged & spam)
        tp_total += tp
        flagged_total += len(flagged)
        spam_total += len(spam)
        if c < show:
            print(f"  cohort {c}: theta range [{theta.min()}, "
                  f"{theta.max()}], flagged {len(flagged)} users, "
                  f"{tp}/{len(spam)} true spam")
    print(f"fleet: {tp_total}/{spam_total} spam captured, precision "
          f"{tp_total/max(flagged_total, 1):.2f}")
    return tp_total, flagged_total, spam_total


def decompose_fleet(cohorts, device=None):
    """One Executor serves the whole fleet: cohorts bucket into shared
    stack shapes, each bucket costs one batched counting call + one
    batched level loop."""
    ex = Executor(EngineConfig(num_partitions=8), device=device)
    tds = ex.map(cohorts, strict=True)
    rep = ex.last_map_report
    print(f"decomposed {rep['n_graphs']} cohort graphs in "
          f"{rep['chunks']} batched dispatch(es): "
          f"{rep['device_loop_calls']} level loops + "
          f"{rep['counting_dispatches']} counting kernels + "
          f"{rep['host_round_trips']} blocking fetches "
          f"({rep['wall_s']:.2f}s wall)")
    return tds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cohorts, spam_sets = build_fleet(4 if SMOKE else 12)
    tds = decompose_fleet(cohorts, device=args.device)
    flag_spam(tds, spam_sets)

    # train the downstream retrieval tower (synthetic batches; a
    # production pipeline would drop the flagged users from its stream)
    steps = 5 if SMOKE else 30
    out = train_loop(arch="two-tower-retrieval", steps=steps, batch_size=32,
                     log_every=10, device=args.device)
    print(f"two-tower training: "
          f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}")
    return tds, out


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the device memory of a decomposition goes, and the precision
options of the edge closed form, measured on the card.

    python3 scripts/torch_memory_probe.py      # needs one CUDA card

For each route of ``Executor.decompose`` (dense + subset dispatch,
staircase + graph dispatch, the tiled representation at 64 x 64 tiles,
the wing workload) on the full-size Marvel-shaped graph of
``chip_smoke.py`` and on sp_mid: one warm run, then one run under the
caching allocator's history; prints ``plan.padded_bytes``, the peak above
what was resident (``max_memory_allocated``), their ratio, and the blocks
live at the peak summed by the line of ``repro_torch`` that allocated
them.  Then times ``A (A^T A)`` four ways at the full graph's wing shape
and at sp_mid's FD stack (float64 throughout, float32 ``A^T A`` then
float64, float32 with TF32 off, TF32), each held to the float64 result.
Prints the card's name and power limit first.
"""
import collections
import gc
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def site(frames):
    """The innermost ``repro_torch`` frame of an allocation."""
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name:
            return (f"{name.split('repro_torch/')[-1]}:{f.get('line')} "
                    f"{f.get('name')}")
    return "other"


def traced(torch, run):
    """Run ``run`` under the allocator's history; returns the peak above
    resident and the bytes live at the peak by allocation site."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, best, at_best = {}, 0, -1, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], site(ev.get("frames", [])))
            cur += ev["size"]
            if cur > best:
                best, at_best = cur, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    by_site = collections.Counter()
    for size, where in at_best.values():
        by_site[where] += size
    return peak, by_site


def closed_form_options(torch, np, g, shape):
    """Time A (A^T A) four ways on ``g``'s 0/1 matrix padded to
    ``shape`` ((R, C), or (G, R, C) repeating it)."""
    dev = torch.device("cuda")
    a = torch.zeros(shape[-2:], device=dev)
    a[torch.as_tensor(g.edges_u, device=dev).long(),
      torch.as_tensor(g.edges_v, device=dev).long()] = 1.0
    if len(shape) == 3:
        a = a.expand(shape).contiguous()
    at = a.transpose(-1, -2)

    def with_tf32(on, fn):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = on
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def f64():
        x = a.double()
        return x @ (x.transpose(-1, -2) @ x)

    options = {
        "float64": f64,
        "float32 A^T A, then float64": lambda: a.double() @ (at @ a).double(),
        "float32, TF32 off": lambda: with_tf32(False, lambda: a @ (at @ a)),
        "TF32": lambda: with_tf32(True, lambda: a @ (at @ a)),
    }
    want = f64()
    flop = 4.0 * a.numel() * a.shape[-1]
    for name, fn in options.items():
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(5):
            fn()
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / 5
        exact = torch.equal(fn().double(), want)
        print(f"closed form {tuple(shape)} {name}: {ms:.3f} ms "
              f"({flop / ms / 1e9:.1f} TFLOP/s), exact={exact}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import EngineConfig, Executor
    from repro_torch.core.graph import powerlaw_bipartite

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    full = powerlaw_bipartite(6486, 12942, 96662, seed=0)
    sp_mid = powerlaw_bipartite(4096, 4096, 24000, seed=14)
    routes = {
        "dense_subset": dict(num_partitions=150, backend="cuda"),
        "sparse_graph": dict(num_partitions=150, backend="cuda_sparse",
                             cd_dispatch="graph"),
        "tiled": dict(num_partitions=150, backend="cuda_sparse",
                      representation="tiled", kernel_blocks=(64, 64, 64)),
        "wing": dict(workload="wing", backend="cuda_sparse",
                     cd_dispatch="graph"),
    }
    for gname, g in (("full", full), ("sp_mid", sp_mid)):
        for rname, kw in routes.items():
            if rname == "wing" and gname == "full":
                continue                 # minutes of FD: see chip_smoke.py
            ex = Executor(EngineConfig(**kw))
            plan = ex.plan(g)
            ex.decompose(g, plan=plan)                   # warm
            peak, by_site = traced(torch,
                                   lambda: ex.decompose(g, plan=plan))
            print(f"{rname}/{gname}: padded_bytes {plan.padded_bytes} "
                  f"peak above resident {peak} "
                  f"(estimate / peak {plan.padded_bytes / peak:.3f})",
                  flush=True)
            for where, nbytes in by_site.most_common(8):
                print(f"    {nbytes:>12d} {where}", flush=True)
    closed_form_options(torch, np, full, (8192, 16384))
    closed_form_options(torch, np, sp_mid, (8, 4096, 4096))
    return 0


if __name__ == "__main__":
    sys.exit(main())

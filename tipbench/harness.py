"""One run of one cell: set-up, the measured window, the traced metrics,
the check against the plain reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
at the checkout's root, its configuration in the file that the
configuration's entry names, its traffic mix in
``tipbench/traffic/<traffic>.json`` and each per-layer metric's reader in
``tipbench/metrics/<metric>.py`` (a module with ``read(run)``, returning
a number or None).  A new configuration, mix or metric is a new file and a
new entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from . import loops, reference, trace

__all__ = ["ROOT", "load_cell", "run_cell", "check", "passes", "FORBIDDEN"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the float64 reference is exact for every support below it
REFERENCE_LIMIT = 2 ** 53


class CellError(RuntimeError):
    """The cell cannot run as ``BENCHMARK.json`` describes it."""


def load_cell(workload: str, root: Path = ROOT) -> Dict:
    """The cell, its configuration and mix, and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(known: {', '.join(sorted(cells))})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    limit = loops.exact_limit(cfg)
    if type(limit) is not int or not 0 < limit <= REFERENCE_LIMIT:
        raise CellError(f"configuration {conf['name']!r}: exact_limit "
                        f"{limit!r} is not a whole number from 1 to 2^53, "
                        "as far as the float64 reference is exact")
    traffic = json.loads(
        (root / "tipbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())

    def applies(metric):
        names = metric.get("workloads")
        return names is None or workload in names

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m) and m["moves"] in reported]
    return {"cell": cell, "config": cfg, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer, "root": root}


def _reader(root: Path, name: str):
    path = root / "tipbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "tipbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (``sys.modules`` by
    default), compared whole: ``repro_torch`` is not ``repro``."""
    tops = {m.split(".")[0] for m in (sys.modules if names is None
                                      else names)}
    return sorted(tops & set(FORBIDDEN))


def check(loop, sample: List[int], answer_of=None) -> Dict:
    """The numbers compared, each ``{"value": ..., "limit": ...}``: tip
    numbers that differ from the reference's over the answers ``sample``
    (indices into ``loop.answers``), and the largest butterfly support
    among their graphs against the configuration's exact limit
    (``loops.exact_limit``).  ``answer_of(k)`` gives the answer to judge
    (the program's by default)."""
    answer_of = answer_of or (lambda k: loop.answers[k])
    wrong = 0
    top = 0
    for k in sample:
        want, most = loop.expected(k)
        top = max(top, int(most))
        got = np.asarray(answer_of(k))
        wrong += (int(np.count_nonzero(got != want)) if got.shape == want.shape
                  else int(want.size))
    return {"theta_mismatches": {"value": wrong, "limit": 0},
            "max_support": {"value": top,
                            "limit": loops.exact_limit(loop.cfg) - 1}}


def passes(numbers: Dict) -> bool:
    """Whether every number compared is within its limit."""
    return all(c["value"] <= c["limit"] for c in numbers.values())


def _sample(loop, n: int, seed: int) -> List[int]:
    """Up to ``n`` answers drawn from the seed, the first window answer
    and the last among them."""
    total = len(loop.answers)
    if total <= n:
        return list(range(total))
    rng = np.random.default_rng((seed, 7))
    pick = {loop.n_warm, total - 1}
    rest = [k for k in range(total) if k not in pick]
    pick.update(rng.choice(rest, size=n - len(pick), replace=False).tolist())
    return sorted(int(k) for k in pick)


def device_info(device) -> Dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(spec: Dict, seed: int, seconds: float, traced: bool,
             device, t_start: float, log=print) -> Dict:
    """Run one cell; returns the result object (not printed)."""
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
        torch.empty(1, device=dev)
    marks.append(("kernels and card", time.perf_counter()))
    loop = loops.LOOPS[traffic["loop"]](cfg, traffic, seed, dev)
    loop.prepare()
    marks.append(("inputs drawn", time.perf_counter()))
    loop.setup()
    marks.append(("program set up", time.perf_counter()))
    loop.warm()
    marks.append(("warm requests", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    log("tipbench: set-up " + ", ".join(
        f"{name} {t1 - t0:.3f} s" for (_, t0), (name, t1)
        in zip(marks, marks[1:])), file=sys.stderr)

    tracer = (trace.Tracer(dev, float(traffic.get("trace_seconds", seconds)))
              if traced else None)
    failed = 0
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        try:
            loop.timed()
        except Exception:                    # noqa: BLE001 - a failed request
            failed += 1
            traceback.print_exc(file=sys.stderr)
            loop.answers.append(None)
            loop.records.append({"failed": True})
        if tracer:
            tracer.tick()
        if time.perf_counter() - t0 >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    if tracer:
        tracer.stop()
    done = sum(1 for r in loop.records if not r.get("failed"))
    log("tipbench: window %.3f s, requests (s, count+cd/fd, reads): %s"
        % (window_s, " ".join(
            "%.3f(%.3f/%.3f,%d)" % (r["request_s"], r["time_count"]
                                    + r["time_cd"], r["time_fd"],
                                    r["round_trips"])
            for r in loop.records if "request_s" in r)), file=sys.stderr)
    info = device_info(dev)

    run = {"loop": traffic["loop"], "records": [r for r in loop.records
                                                if not r.get("failed")],
           "window_s": window_s, "device": dev.type}
    if tracer:
        t1 = time.perf_counter()
        run.update(trace.summarize(tracer))
        tracer.prof = None
        t2 = time.perf_counter()
        run["idle_gaps"] = trace.host_profile(dev, loop.replay)
        t3 = time.perf_counter()
        if dev.type == "cuda":
            with trace.RooflineProbe(dev) as probe:
                loop.replay()
            run["roofline"] = probe.share()
            log(f"tipbench: roofline replay {probe.launches}, bound "
                f"{probe.bound_ms:.4f} ms of {probe.device_ms:.4f} device ms "
                f"launched in the calls ({probe.named_ms:.4f} ms of the "
                "hand kernels by name)", file=sys.stderr)
        log(f"tipbench: trace of {tracer.requests} requests read in "
            f"{t2 - t1:.3f} s, host-profiled request {t3 - t2:.3f} s, "
            f"roofline request {time.perf_counter() - t3:.3f} s",
            file=sys.stderr)
    loop.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    sample = [k for k in _sample(loop, int(traffic["check_answers"]), seed)
              if loop.answers[k] is not None]
    log(f"tipbench: {len(sample)} answers compared with the reference: "
        f"{sample}", file=sys.stderr)
    numbers = {"failed_requests": {"value": failed, "limit": 0},
               **check(loop, sample)}
    log(f"tipbench: the reference took {time.perf_counter() - t_check:.3f}"
        " s", file=sys.stderr)
    correct = passes(numbers)

    metrics = {}
    if traced:
        for m in spec["per_layer"]:
            value = _reader(spec["root"], m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        per = traffic["metric"]
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == per:
                value = window_s / done if done else None
            else:
                raise CellError(f"the cell reports {m['name']}, which its "
                                f"mix {spec['cell']['traffic']!r} does not "
                                "measure")
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced:
        info["busy_s"] = run.get("busy_s", 0.0)
        info["window_s"] = run.get("window_s", window_s)
    result = {"correct": bool(correct), "attempted": len(loop.records),
              "failed": failed, "metrics": metrics, "device": info}
    if traced:
        result["breakdown"] = {"device_ops": run.get("device_ops", []),
                               "idle_gaps": run.get("idle_gaps", [])}
    result["checks"] = numbers
    return result

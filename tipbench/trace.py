"""What a ``--trace 1`` run reads besides the program's counters: the
device's busy time, the idle gaps named by what the host was doing, and
the hand kernels' share of their roofline.

* ``Tracer`` profiles the window's first ``limit_s`` seconds (whole
  requests) with the device's activity alone (``ProfilerActivity.CUDA``),
  which slows the host least: ``busy_s`` is the union of the device's
  activity intervals, ``window_s`` the traced wall.  ``idle_share`` sets
  the busy time of a traced request against the wall of an untraced one
  (the rest of the window), since even that profile slows a launch-bound
  request.
* ``host_profile`` profiles one more request with the host's activity
  too; ``idle_gaps`` names each gap of that request by the innermost host
  range open at its middle (the benchmark's ``tipbench.*`` span, then the
  host operation, such as ``aten::item``).  The host profiler slows the
  request, so it gives the names and not the idle share.
* ``RooflineProbe`` wraps each hand-kernel entry point of
  ``repro_torch.kernels.ops`` over one more request, profiled with the
  host's activity: before a launch it computes the launch's least time
  from its actual arguments (``bounds.launch_bound``), then synchronizes
  and makes the call inside a host range ``tipbench.kernel.<entry>``,
  synchronizing again before the range closes.  The device time of a call
  is the time of the device operations whose launch lies inside its range
  (the profiler links each device operation to its launch), read from the
  profiler's device events; the share is the sum of the bounds over the
  sum of those times.  The bound arithmetic and the host's work
  in the entry point are outside what it divides by.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import bounds

__all__ = ["Tracer", "summarize", "host_profile", "idle_gaps", "idle_share",
           "RooflineProbe", "HAND_KERNELS"]

TOP = 10
SPAN = "tipbench."
ENTRIES = ("butterfly_update", "butterfly_update_batched", "b2_stack",
           "butterfly_update_tiled")
# the ``__global__`` functions of the port's ``kernels/csrc`` when this
# benchmark was written: a cross-check of the probe's device time, printed
HAND_KERNELS = frozenset({
    "count_update_kernel", "sparse_update_kernel", "peel_prep_kernel",
    "peel_update_kernel", "b2_stack_kernel", "b2_pairs_kernel",
    "s8_pack_kernel", "tiled_update_kernel", "tiled_peel_rows_kernel",
    "tiled_peel_prep_kernel", "tiled_peel_kernel"})


def _profile(device, host: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = []
    if host or torch.device(device).type != "cuda":
        acts.append(ProfilerActivity.CPU)
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """The device-only profiler over the window's first ``limit_s``
    seconds; ``tick()`` after each request stops it once that much has
    passed.  (On a CPU, where there is no device activity, it records the
    host's, so that the readers can be tested.)"""

    def __init__(self, device, limit_s: float):
        self.device = torch.device(device)
        self.limit_s = float(limit_s)
        self.prof = _profile(device, host=False)
        self.active = False
        self.window_s = 0.0
        self.requests = 0

    def start(self) -> None:
        _sync(self.device)
        self.prof.start()
        self.active = True
        self.t0 = time.perf_counter()

    def tick(self) -> None:
        if not self.active:
            return
        self.requests += 1
        if time.perf_counter() - self.t0 >= self.limit_s:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        _sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.active = False


def short_name(name: str) -> str:
    """A device operation's name without template and call arguments:
    ``void (anonymous namespace)::peel_update_kernel<...>(...)`` becomes
    ``peel_update_kernel``, ``Memcpy HtoD (Pageable -> Device)`` stays."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    words = "".join(out).split()
    parts = [p for p in words[-1].split("::") if p] if words else []
    if not parts:
        return name
    return "::".join(parts[-2:]) if parts[-1] == "kernel" else parts[-1]


def _union(intervals: List[tuple]) -> List[tuple]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def events(prof) -> Tuple[List[tuple], List[tuple], int, Dict[int, int]]:
    """The profile's device operations ``(start_ns, end_ns, name,
    correlation)``, host ranges ``(start_ns, end_ns, name, thread)``, the
    trace's start, and the host time of each launch by its correlation id
    (the runtime call that enqueued a device operation shares its id).  A
    host range (``record_function``) also appears on the device's
    timeline under its own name; it is not work on the device, and is left
    out of the device operations."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    dev, host, launched = [], [], {}
    for e in results.events():
        dur = e.duration_ns()
        corr = int(getattr(e, "correlation_id", lambda: 0)() or 0)
        if e.device_type() == DeviceType.CUDA:
            if dur > 0 and not getattr(e, "is_user_annotation",
                                       lambda: False)():
                dev.append((e.start_ns(), e.start_ns() + dur, e.name(),
                            corr))
            continue
        if corr > 0 and e.name().startswith("cu"):
            launched[corr] = e.start_ns()
        if dur > 0:
            host.append((e.start_ns(), e.start_ns() + dur, e.name(),
                         e.start_thread_id()))
    ranges = {n for _, _, n, _ in host}
    dev = [d for d in dev if d[2] not in ranges and not d[2].startswith(SPAN)]
    return dev, host, results.trace_start_ns(), launched


def busy(dev: List[tuple]) -> Tuple[float, List[tuple]]:
    """Seconds in which a device operation ran (the union of their
    intervals), and the device operations that took most time, by short
    name."""
    by_op: Dict[str, float] = {}
    for s, e, name, *_ in dev:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-9
    spans = _union([(s, e) for s, e, *_ in dev])
    return (sum(e - s for s, e in spans) * 1e-9,
            sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP])


def summarize(tracer: Tracer) -> Dict:
    """``busy_s``, ``window_s`` and ``device_ops`` of the traced window
    (seconds), and the number of requests it holds."""
    dev, _, _, _ = events(tracer.prof)
    busy_s, ops = busy(dev)
    return {"window_s": tracer.window_s, "busy_s": busy_s,
            "device_ops": ops, "traced_requests": tracer.requests}


def idle_share(run: Dict) -> Optional[float]:
    """The device's idle share (%) of a request at the program's own
    pace: 1 - (busy time a traced request) / (wall time an untraced
    request), the traced requests being the window's first ones and the
    untraced the rest of it.  The profiler slows a launch-bound request
    (a refresh cycle by about half, on the host), so the traced wall would
    count its own overhead as idle time.  None without a traced device or
    without an untraced request."""
    n = int(run.get("traced_requests") or 0)
    if run.get("device") != "cuda" or not n:
        return None
    rest = [r["request_s"] for r in run["records"][n:]]
    if not rest:
        return None
    return 100.0 * (1.0 - (run["busy_s"] / n) / (sum(rest) / len(rest)))


def idle_gaps(dev: List[tuple], host: List[tuple], t_start: int
              ) -> List[tuple]:
    """The idle gaps of the device between the trace's start and its last
    event, summed by the innermost host range open at each gap's middle
    on the thread that opened the benchmark's spans: ``[(name,
    seconds), ...]``, longest first."""
    spans = _union([(s, e) for s, e, *_ in dev])
    if not spans:
        return []
    # the host ranges of that thread nest, so one sweep in start order
    # with a stack of open ranges finds the innermost range and the
    # innermost tipbench span at each gap's middle
    main = {t for _, _, n, t in host if n.startswith(SPAN)}
    host = sorted((s, e, n) for s, e, n, t in host if t in main)
    t_end = max([spans[-1][1]] + [e for _, e, _ in host])
    edges = ([(t_start, spans[0][0])]
             + [(spans[i][1], spans[i + 1][0])
                for i in range(len(spans) - 1)]
             + [(spans[-1][1], t_end)])
    gaps: Dict[str, float] = {}
    stack: List[tuple] = []
    j = 0
    for g0, g1 in edges:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        open_ = [r for r in stack if r[1] >= mid]
        name_op = open_[-1][2] if open_ else ""
        names = [r[2] for r in open_ if r[2].startswith(SPAN)]
        name_span = names[-1] if names else "outside"
        key = name_span if name_op in ("", name_span) else (
            f"{name_span}/{name_op}")
        gaps[key] = gaps.get(key, 0.0) + (g1 - g0) * 1e-9
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]


def host_profile(device, request) -> List[tuple]:
    """``request()`` under the host and device profiler; its idle gaps."""
    prof = _profile(device, host=True)
    _sync(device)
    prof.start()
    request()
    _sync(device)
    prof.stop()
    dev, host, t0, _ = events(prof)
    return idle_gaps(dev, host, t0)


def inside(dev: List[tuple], ranges: List[tuple],
           launched: Dict[int, int]) -> float:
    """Seconds of the device operations launched inside one of the host
    ``ranges`` ``(start_ns, end_ns)`` (which do not overlap): each
    operation's launch is the host time that ``launched`` gives for its
    correlation id, so only host times are compared (the device's clock
    is offset from the host's by some microseconds).  An operation the
    profile links to no launch counts for none."""
    ranges = sorted(ranges)
    starts = [s for s, _ in ranges]
    total = 0
    for s, e, _, corr in dev:
        if corr not in launched:
            continue
        i = bisect.bisect_right(starts, launched[corr]) - 1
        if i >= 0 and launched[corr] <= ranges[i][1]:
            total += e - s
    return total * 1e-9


class RooflineProbe:
    """Wraps the hand-kernel entry points of ``repro_torch.kernels.ops``
    while in use (a ``with`` block, profiled); ``share()`` is the sum of
    the calls' bounds over the device time inside their ranges, or None
    when no call was seen."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.bound_ms = 0.0
        self.device_ms = 0.0
        self.named_ms = 0.0
        self.launches: Dict[str, int] = {}

    def __enter__(self):
        from repro_torch.kernels import ops

        self._ops = ops
        self._saved = {name: getattr(ops, name) for name in ENTRIES}
        for name, fn in self._saved.items():
            setattr(ops, name, self._wrap(name, fn))
        self._prof = _profile(self.device, host=True)
        _sync(self.device)
        self._prof.start()
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._ops, name, fn)
        _sync(self.device)
        self._prof.stop()
        dev, host, _, launched = events(self._prof)
        self._prof = None
        calls = [(s, e) for s, e, n, _ in host
                 if n.startswith(SPAN + "kernel.")]
        self.device_ms = 1e3 * inside(dev, calls, launched)
        self.named_ms = 1e3 * sum((e - s) * 1e-9 for s, e, n, *_ in dev
                                  if short_name(n) in HAND_KERNELS)

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            got = bounds.launch_bound(name, args, kwargs)
            if got is None:
                return fn(*args, **kwargs)
            self.bound_ms += got[0]
            self.launches[name] = self.launches.get(name, 0) + 1
            _sync(self.device)
            with torch.profiler.record_function(SPAN + "kernel." + name):
                out = fn(*args, **kwargs)
                _sync(self.device)
            return out
        return call

    def share(self) -> Optional[float]:
        if not self.launches or self.device_ms <= 0:
            return None
        return self.bound_ms / self.device_ms

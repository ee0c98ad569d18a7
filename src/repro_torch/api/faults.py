"""Deterministic fault injection for the decompose runtime (DESIGN.md §7).

The hardened runtime's degradation machinery (backend fallback chain,
overflow replay bounds, fleet isolation) is only trustworthy if its
failure paths are EXERCISED — so the engine exposes named injection
points at exactly the host-level boundaries where real failures surface:

    ``kernel_launch``   host-side kernel / device-loop dispatches
                        (engine/cd.py, engine/fd.py, Executor.map)
    ``peel_buffer``     CD peel-buffer sizing — an armed fault undersizes
                        the buffer to one row, forcing the overflow replay
    ``dgm_boundary``    DGM compaction at a subset boundary
    ``map_chunk``       the blocking per-chunk fetch in ``Executor.map``
    ``refresh_worker``  the serving layer's background flush worker, at
                        the top of each drain cycle (service/scheduler.py)
                        — fires as ``ServiceWorkerError`` into the
                        worker's restart-with-backoff path

Arming is declarative and deterministic.  A spec string is a
comma-separated list of rules::

    site[:key=value...][@nth[xcount]]

    "kernel_launch@2"               fire on the 2nd kernel launch, once
    "map_chunk@1x3"                 fire on chunk fetches 1, 2 and 3
    "peel_buffer"                   fire on EVERY peel-buffer sizing
    "kernel_launch:backend=interpret"   fire whenever an interpret-backend
                                    launch hits the point (context filter)

Each rule keeps its own hit counter (hits = triggers matching the rule's
site AND filters), so "fail the 2nd chunk's kernel once" is one rule and
replays/fallbacks — which re-trigger the same site — do not re-fire it.

Activation: ``EngineConfig.fault_spec`` (the Executor arms its own
injector, counters persisting across its calls) or the ``RECEIPT_FAULT``
environment variable (process-wide, for CI matrix jobs).  With neither,
``fault_point`` is a dict-lookup no-op on the hot path.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, List, Optional, Tuple, Type, Union

from .errors import ReceiptError

__all__ = [
    "KNOWN_SITES",
    "FaultRule",
    "FaultSpec",
    "FaultInjector",
    "fault_point",
    "inject",
    "suppressed",
    "active_injector",
    "reset",
]

KNOWN_SITES = ("kernel_launch", "peel_buffer", "dgm_boundary", "map_chunk",
               "refresh_worker")

ENV_VAR = "RECEIPT_FAULT"


class FaultRule:
    """One armed rule: site + context filters + trigger window."""

    __slots__ = ("site", "filters", "nth", "count", "hits", "fired")

    def __init__(self, site: str, filters: Tuple[Tuple[str, str], ...] = (),
                 nth: int = 0, count: int = 1):
        if site not in KNOWN_SITES:
            import difflib

            close = difflib.get_close_matches(site, KNOWN_SITES, n=1)
            hint = f" (did you mean {close[0]!r}?)" if close else ""
            raise ValueError(
                f"unknown fault-injection site {site!r}{hint}; known "
                f"sites: {', '.join(KNOWN_SITES)}")
        self.site = site
        self.filters = tuple(filters)
        self.nth = int(nth)        # 1-based first firing hit; 0 = every hit
        self.count = int(count)    # firings from nth on; <0 = unbounded
        self.hits = 0
        self.fired = 0

    def matches(self, site: str, context: Dict[str, Any]) -> bool:
        if site != self.site:
            return False
        return all(str(context.get(k)) == v for k, v in self.filters)

    def trigger(self) -> bool:
        """Count one matching hit; True when this hit is armed."""
        self.hits += 1
        if self.nth == 0:
            armed = True
        elif self.count < 0:
            armed = self.hits >= self.nth
        else:
            armed = self.nth <= self.hits < self.nth + self.count
        if armed:
            self.fired += 1
        return armed

    def describe(self) -> str:
        flt = "".join(f":{k}={v}" for k, v in self.filters)
        win = "" if self.nth == 0 else (
            f"@{self.nth}" + ("" if self.count == 1 else
                              ("x*" if self.count < 0 else f"x{self.count}")))
        return f"{self.site}{flt}{win}"


class FaultSpec:
    """Parsed fault specification (see module docstring for grammar)."""

    def __init__(self, rules: List[FaultRule]):
        self.rules = list(rules)

    @classmethod
    def parse(cls, spec: Optional[str]) -> "FaultSpec":
        rules: List[FaultRule] = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            nth, count = 0, 1
            if "@" in part:
                part, win = part.split("@", 1)
                if "x" in win:
                    n_s, c_s = win.split("x", 1)
                    count = -1 if c_s == "*" else int(c_s)
                else:
                    n_s = win
                nth = int(n_s)
                if nth < 1:
                    raise ValueError(
                        f"fault trigger index must be >= 1 (got {nth} in "
                        f"rule {part!r}@{win!r}); indices are 1-based")
            fields = part.split(":")
            site, filt = fields[0], []
            for f in fields[1:]:
                if "=" not in f:
                    raise ValueError(
                        f"fault context filter {f!r} must be key=value "
                        f"(in rule for site {site!r})")
                k, v = f.split("=", 1)
                filt.append((k, v))
            rules.append(FaultRule(site, tuple(filt), nth, count))
        return cls(rules)

    def describe(self) -> str:
        return ",".join(r.describe() for r in self.rules)


class FaultInjector:
    """Holds armed rules + deterministic per-rule hit counters.

    One injector per Executor (``EngineConfig.fault_spec``) — counters
    persist across that executor's calls, so trigger indices refer to a
    stable global ordering of the executor's launches/fetches.
    """

    def __init__(self, spec: Union[FaultSpec, str, None] = None):
        if isinstance(spec, str):
            spec = FaultSpec.parse(spec)
        self.spec = spec or FaultSpec([])
        self._lock = threading.Lock()

    @property
    def armed(self) -> bool:
        return bool(self.spec.rules)

    def fire(self, site: str, context: Dict[str, Any]) -> bool:
        """True when an armed rule fires at this (site, context) hit."""
        hit = False
        with self._lock:
            for rule in self.spec.rules:
                if rule.matches(site, context):
                    hit = rule.trigger() or hit
        return hit

    def report(self) -> List[Dict[str, Any]]:
        """Per-rule accounting: ``[{rule, hits, fired}, ...]``."""
        return [dict(rule=r.describe(), hits=r.hits, fired=r.fired)
                for r in self.spec.rules]

    def reset(self) -> None:
        for r in self.spec.rules:
            r.hits = r.fired = 0


_NULL = FaultInjector()
_STATE = threading.local()
_ENV_CACHE: Dict[str, FaultInjector] = {}


def active_injector() -> FaultInjector:
    """The injector in effect: the innermost ``inject()`` scope, else the
    process-wide ``RECEIPT_FAULT`` env injector, else an inert one."""
    stack = getattr(_STATE, "stack", None)
    if stack:
        return stack[-1]
    env = os.environ.get(ENV_VAR, "")
    if not env:
        return _NULL
    inj = _ENV_CACHE.get(env)
    if inj is None:
        inj = _ENV_CACHE[env] = FaultInjector(env)
    return inj


@contextlib.contextmanager
def inject(injector: Union[FaultInjector, FaultSpec, str, None]):
    """Scope an injector (or spec string) as the active one.  ``None``
    scopes an inert injector — i.e. suppresses any env-armed faults."""
    if not isinstance(injector, FaultInjector):
        injector = FaultInjector(injector) if injector else _NULL
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(injector)
    try:
        yield injector
    finally:
        stack.pop()


def suppressed():
    """Scope with ALL fault injection off (baselines inside faulty envs)."""
    return inject(None)


def reset() -> None:
    """Drop env-injector counters (test isolation)."""
    _ENV_CACHE.clear()
    getattr(_STATE, "stack", []).clear()


def fault_point(site: str,
                error: Optional[Type[ReceiptError]] = None,
                message: Optional[str] = None,
                **context: Any) -> bool:
    """Declare a named injection point.

    Returns False (no-op) unless an armed rule fires here.  When one
    fires: raises ``error(message, injected=True, **context)`` if an
    error class is given, else returns True (degrade-style points — the
    ``peel_buffer`` site shrinks a buffer instead of raising).
    """
    inj = active_injector()
    if not inj.armed:
        return False
    if not inj.fire(site, context):
        return False
    if error is not None:
        raise error(message or f"injected fault at {site!r}",
                    site=site, injected=True, **context)
    return True

"""`EngineConfig` — the frozen, serializable service-layer configuration
(port of ``repro.api.config``).

A FROZEN dataclass validated completely at construction, with a strict
``to_dict``/``from_dict`` round trip so service configs survive JSON/YAML
storage without silently dropping or inventing knobs.

Two validation tiers, as in the reference:

* the engine floor (shared with ``ReceiptConfig.__post_init__``):
  value-range and enum checks every config object must clear;
* the service layer's stricter cross-knob rules — combinations that run
  but silently diverge from the benchmarked configuration
  (``cd_dispatch="graph"`` with ``use_dgm=False``, a legacy ``fd_mode``
  with ``device_loop=False``) are rejected here with an actionable
  message.  ``ReceiptConfig`` keeps permitting them for A/B experiments.

``dtype`` is a STRING here (serializability); only ``"float32"`` is
accepted — the engine's exactness contract is the f32 integer regime
(DESIGN.md §8).  ``to_receipt_config`` maps it to ``torch.float32``.
Backends are the port's: ``"cuda"``, ``"cuda_sparse"``, ``"torch"``,
``"torch_sparse"``, or ``None``, which follows the device the Executor
runs on (``convert.engine_config_from_fields`` maps the reference's).
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.engine.peel_loop import ReceiptConfig

__all__ = ["EngineConfig"]

_DTYPES = ("float32",)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen service-layer configuration (see module docstring).

    Field semantics match ``ReceiptConfig`` (DESIGN.md §2.2 "Knobs") plus
    ``side``: which vertex set to peel (``"V"`` transposes the graph —
    exact by symmetry), ``workload`` (``"tip"``; ``"wing"`` validates but
    is planned only once the wing slice lands), and the hardened-runtime
    knobs below.
    """

    side: str = "U"
    workload: str = "tip"
    num_partitions: int = 8
    backend: Optional[str] = None
    kernel_blocks: Tuple[int, int, int] = (128, 128, 512)
    use_huc: bool = True
    use_dgm: bool = True
    degree_sort: bool = True
    dgm_row_threshold: float = 0.7
    fd_mode: str = "level"
    cd_dispatch: str = "subset"
    dtype: str = "float32"
    max_sweeps: int = 100_000
    device_loop: bool = True
    peel_width: Optional[int] = None
    fd_overlap: bool = True
    fd_update_mode: str = "auto"
    fd_b2_cells: int = 1 << 24
    representation: str = "auto"
    #   "dense", "tiled", or "auto": the Planner's cost model picks per
    #   graph (api/plan.py), memory admission overriding it
    tiled_regather_every: int = 1
    fd_prepeel_levels: int = 4
    # hardened-runtime knobs (DESIGN.md §7) — service-layer only, never
    # forwarded to the engine's ReceiptConfig:
    #   memory_budget_bytes  Planner admission control: plans whose
    #                        padded-bytes estimate exceeds this degrade
    #                        to smaller FD groups (more partitions), route
    #                        tiled, or raise PlanInfeasibleError.
    #                        None = no limit.
    #   fault_spec           arm the deterministic fault-injection
    #                        harness (repro_torch.api.faults grammar).
    memory_budget_bytes: Optional[int] = None
    fault_spec: Optional[str] = None

    def __post_init__(self):
        # normalize sequence-typed fields (from_dict hands us lists)
        object.__setattr__(self, "kernel_blocks",
                           tuple(int(b) for b in self.kernel_blocks))
        if self.side not in ("U", "V"):
            raise ValueError(
                f"side must be 'U' or 'V' (got {self.side!r}): tip "
                "decomposition peels one vertex set; 'V' transposes")
        if self.workload not in ("tip", "wing"):
            raise ValueError(
                f"workload must be 'tip' or 'wing' (got "
                f"{self.workload!r}): 'tip' peels vertices, 'wing' peels "
                "edges on the same engine (DESIGN.md §10)")
        if self.workload == "wing" and self.representation == "tiled":
            raise ValueError(
                "workload='wing' runs on the dense edge-axis geometry; "
                "the tiled representation is a vertex-axis path "
                "(use representation='dense' or 'auto')")
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"dtype must be one of {_DTYPES} (got {self.dtype!r}): "
                "the engine's exactness contract is the f32 integer "
                "regime (DESIGN.md §8)")
        if self.memory_budget_bytes is not None:
            if int(self.memory_budget_bytes) <= 0:
                raise ValueError(
                    f"memory_budget_bytes must be a positive byte count "
                    f"(got {self.memory_budget_bytes}); use None for no "
                    "admission-control budget")
            object.__setattr__(self, "memory_budget_bytes",
                               int(self.memory_budget_bytes))
        if self.fault_spec is not None:
            # parse eagerly so a typo'd site name fails at construction
            from .faults import FaultSpec

            FaultSpec.parse(self.fault_spec)
        # the engine floor: constructing a ReceiptConfig runs its checks
        self.to_receipt_config()
        # stricter service-layer cross-knob rules
        if self.cd_dispatch == "graph" and not self.use_dgm:
            raise ValueError(
                "cd_dispatch='graph' with use_dgm=False pays the stale "
                "whole-graph HUC recount bound for the entire run — the "
                "configuration silently diverges from the benchmarked "
                "wedge economics (BENCH_receipt.json "
                "derived.cd_graph_wedge_ratio).  Enable use_dgm, or use "
                "cd_dispatch='subset'; for A/B experiments construct a "
                "raw ReceiptConfig instead.")
        if self.fd_mode != "level" and not self.device_loop:
            raise ValueError(
                f"fd_mode={self.fd_mode!r} with device_loop=False mixes "
                "the legacy sequential FD with the blocking host CD "
                "engine — a comparator pairing the benchmarks never "
                "measure.  Use fd_mode='level', or pin one comparator "
                "through a raw ReceiptConfig.")

    # ------------------------------------------------------------------ #
    # conversions
    # ------------------------------------------------------------------ #
    # service-layer-only fields the engine's ReceiptConfig never sees
    _API_ONLY = ("side", "workload", "dtype", "memory_budget_bytes",
                 "fault_spec")

    def to_receipt_config(self) -> ReceiptConfig:
        """The engine-layer view of this config (drops the service-layer
        fields, maps the dtype string to the torch dtype)."""
        kw = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self)
              if f.name not in self._API_ONLY}
        return ReceiptConfig(dtype=getattr(torch, self.dtype), **kw)

    @staticmethod
    def from_receipt(cfg: ReceiptConfig, side: str = "U") -> "EngineConfig":
        """Lift a legacy ``ReceiptConfig`` into the service layer (raises
        where the service layer is stricter)."""
        known = {f.name for f in dataclasses.fields(EngineConfig)}
        kw = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)
              if f.name != "dtype" and f.name in known}
        return EngineConfig(side=side, dtype=str(cfg.dtype).split(".")[-1],
                            **kw)

    # ------------------------------------------------------------------ #
    # rendering
    # ------------------------------------------------------------------ #
    def describe(self) -> str:
        """Human-readable rendering of the RESOLVED knob set: the backend
        after auto-resolution (``None`` is the card's ``"cuda"``),
        non-default knobs flagged, the service-layer fields last."""
        from ..kernels import ops as kops

        resolved = kops.resolve_backend(self.backend)
        lines = [f"EngineConfig ({self.workload} workload, side={self.side})"]
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        backend_note = (f"{self.backend!r} -> {resolved}"
                        if self.backend != resolved else repr(resolved))
        lines.append(f"  backend:          {backend_note}")
        listed = ("num_partitions", "kernel_blocks", "representation",
                  "cd_dispatch", "fd_mode", "fd_update_mode", "degree_sort",
                  "use_huc", "use_dgm", "device_loop", "dtype")
        for name in listed:
            val = getattr(self, name)
            flag = "" if val == defaults.get(name) else "   [non-default]"
            lines.append(f"  {name + ':':<17} {val!r}{flag}")
        shown = {"side", "workload", "backend", *listed}
        extras = [f.name for f in dataclasses.fields(self)
                  if f.name not in shown
                  and getattr(self, f.name) != defaults.get(f.name)]
        for name in extras:
            lines.append(f"  {name + ':':<17} {getattr(self, name)!r}"
                         "   [non-default]")
        if self.memory_budget_bytes is None:
            lines.append("  memory budget:    unlimited")
        return "\n".join(lines)

    # ------------------------------------------------------------------ #
    # strict serialization round trip
    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        """JSON-able dict; ``from_dict`` round-trips it exactly."""
        d = dataclasses.asdict(self)
        d["kernel_blocks"] = list(self.kernel_blocks)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineConfig":
        """Strict deserialization: unknown keys are REJECTED (with a
        did-you-mean hint), never dropped — a typo'd service config must
        fail loudly, not silently run defaults."""
        if not isinstance(d, dict):
            raise ValueError(
                f"EngineConfig.from_dict expects a dict, got "
                f"{type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            hints = []
            for k in unknown:
                close = difflib.get_close_matches(k, known, n=1)
                hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                         if close else ""))
            raise ValueError(
                f"EngineConfig.from_dict: unknown key(s) "
                f"{', '.join(hints)}; known keys: {', '.join(sorted(known))}")
        return cls(**d)

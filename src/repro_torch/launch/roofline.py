"""Roofline terms of a dry-run cell on the H100 (port of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), per mesh position:

    compute    = sum over units of work_unit / peak_unit
    memory     = HBM bytes / 3.35 TB/s
    collective = wire bytes / 450 GB/s (NVLink, each way per card), or
                 / 50 GB/s where the group spans the ``pod`` axis

The constants are the H100 SXM 80GB data sheet's dense rates at the
700 W limit (this module imports nothing else, so ``chip_smoke.py``
reads its bounds' rates from here).  The work, bytes and collectives
come from ``utils.op_cost`` (a step traced over meta tensors), not from
HLO text: the port has none, so there is no ``parse_collectives``.  Collective
wire bytes use the ring formulas of the reference:

    all-reduce        2 * B_out * (g-1)/g
    all-gather            B_out * (g-1)/g
    reduce-scatter        B_out * (g-1)          (input = g * output)
    all-to-all            B_out * (g-1)/g
    collective-permute    B_out
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# H100 SXM 80GB, NVIDIA data sheet, dense (no sparsity), 700 W
PEAK_OPS = {
    "bf16": 989e12,      # bf16 / fp16 tensor cores
    "int8": 1979e12,     # int8 tensor cores (the butterfly kernels)
    "tf32": 495e12,      # f32 products with allow_tf32
    "fp32": 67e12,       # f32 outside the tensor cores
    "fp64": 67e12,       # FP64 tensor cores
}
HBM_BW = 3.35e12         # bytes/s
NVLINK_BW = 450e9        # bytes/s each way per card, the intra-node axes
# the pod axis crosses hosts: one 400 Gb/s NDR InfiniBand link per card
POD_BW = 50e9            # bytes/s

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")


@dataclasses.dataclass
class Collective:
    op: str
    out_bytes: int
    group_size: int

    @property
    def wire_bytes(self) -> float:
        g = max(self.group_size, 1)
        if self.op == "all-reduce":
            return 2.0 * self.out_bytes * (g - 1) / g
        if self.op == "all-gather":
            return self.out_bytes * (g - 1) / g
        if self.op == "reduce-scatter":
            return float(self.out_bytes) * (g - 1)
        if self.op == "all-to-all":
            return self.out_bytes * (g - 1) / g
        return float(self.out_bytes)      # collective-permute


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device: the functions' arithmetic
    hbm_bytes: float              # per device
    wire_bytes: float             # per device, every link
    n_collectives: int
    coll_by_op: Dict[str, float]
    peak_memory_bytes: Optional[float] = None
    model_flops: Optional[float] = None    # 6*N*D (global)
    chips: int = 256
    # the work each unit runs, per device (a hand kernel's int8 work in
    # place of its plain version's arithmetic)
    flops_by_unit: Dict[str, float] = dataclasses.field(default_factory=dict)
    # share of ``flops`` that is whole-activation work split evenly over
    # the positions
    even_split_share: float = 0.0
    # {stack: (traced depths, config depth)} where the layers were
    # extrapolated
    depths: Optional[Dict] = None
    pod_wire_bytes: float = 0.0   # the part of wire_bytes over the pod axis

    @property
    def t_compute(self) -> float:
        return sum(v / PEAK_OPS[u] for u, v in self.flops_by_unit.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return ((self.wire_bytes - self.pod_wire_bytes) / NVLINK_BW
                + self.pod_wire_bytes / POD_BW)

    @property
    def bottleneck(self) -> str:
        ts = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / (flops summed over chips)."""
        if not self.model_flops:
            return None
        return self.model_flops / max(self.flops * self.chips, 1.0)

    @property
    def roofline_fraction(self) -> Optional[float]:
        """t_compute / t_bound (1.0 = perfectly compute-bound)."""
        if self.t_bound == 0:
            return None
        return self.t_compute / self.t_bound

    def to_dict(self) -> Dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "wire_bytes_per_dev": self.wire_bytes,
            "n_collectives": self.n_collectives,
            "coll_by_op": self.coll_by_op,
            "peak_memory_bytes": self.peak_memory_bytes,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "flops_by_unit": self.flops_by_unit,
            "even_split_share": self.even_split_share,
            "depths": self.depths,
            "pod_wire_bytes_per_dev": self.pod_wire_bytes,
        }


# --------------------------------------------------------------------- #
# MODEL_FLOPS estimators
# --------------------------------------------------------------------- #
def lm_model_flops(n_params_total: int, n_params_active: int, tokens: int,
                   kind: str) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D for inference-like steps."""
    n = n_params_active
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def count_params(module) -> int:
    from ..train.tree import leaves_with_paths

    return int(sum(t.numel() for _, t in leaves_with_paths(module)))


def _is_routed(path) -> bool:
    parts = [str(p) for p in path]
    return ("moe" in parts and parts[-1] in ("gate", "up", "down")
            and "shared" not in parts)


def lm_active_params(module, cfg) -> int:
    """Total params minus non-selected routed experts (MoE active set)."""
    from ..train.tree import leaves_with_paths

    total = count_params(module)
    if not getattr(cfg, "moe", False):
        return total
    routed = sum(t.numel() for p, t in leaves_with_paths(module)
                 if _is_routed(p))
    active_routed = routed * cfg.top_k / max(cfg.n_routed, 1)
    return int(total - routed + active_routed)

"""Device meshes (port of ``repro.launch.mesh``, the engine's part).

A ``DeviceMesh`` is the port's counterpart of a single-controller
``jax.sharding.Mesh``: one Python process drives every device, and the
mesh only names how its devices are laid out.  Axes, as in the reference:

  * ``pod``   — the slow (inter-node) data-parallel axis;
  * ``data``  — the data-parallel axis;
  * ``model`` — the tensor-parallel axis.

``devices`` lists the mesh's ``torch.device`` per position in row-major
order over ``axis_names``.  ``make_mesh`` with ``devices=None`` takes the
visible CUDA cards (one per position; fewer cards than positions raise).
An explicit list may repeat a device: the CPU tests stack eight shards on
``cpu``, and one card can hold every shard of a small mesh.

The model-sharding helpers of the reference module
(``make_production_mesh``, ``filter_spec``, ``named``) serve the model
substrate only and have no counterpart yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["DeviceMesh", "make_mesh", "check_mesh", "dp_axes",
           "axis_size"]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Named axes over a row-major list of devices.

    ``shape`` maps each axis name to its size, in axis order; ``devices``
    has ``size`` entries, position ``(i0, i1, ...)`` at the row-major
    flat index.
    """

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.devices) != self.size:
            raise ValueError(f"a {tuple(self.shape.values())} mesh needs "
                             f"{self.size} devices, got {len(self.devices)}")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def device_at(self, **index: int) -> torch.device:
        """The device at the named position (axes not named: index 0)."""
        flat = 0
        for name, n in self.shape.items():
            i = int(index.get(name, 0))
            if not 0 <= i < n:
                raise IndexError(f"{name}={i} outside a {name} axis of {n}")
            flat = flat * n + i
        return self.devices[flat]

    def shards_per_device(self) -> Dict[torch.device, int]:
        """How many mesh positions each distinct device holds."""
        out: Dict[torch.device, int] = {}
        for d in self.devices:
            out[d] = out.get(d, 0) + 1
        return out


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes``.

    ``devices=None`` takes the first ``prod(shape)`` visible CUDA cards and
    raises when there are fewer (nothing falls back to the CPU, and no
    card is repeated unless the caller lists it twice).
    """
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"axis names repeat: {axes}")
    if any(n < 1 for n in shape):
        raise ValueError(f"every axis needs at least one device: {shape}")
    n = math.prod(shape)
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if avail < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} CUDA devices, {avail} visible; "
                "pass devices=[...] to place several shards on one device")
        devs: List[torch.device] = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
    return DeviceMesh(shape=dict(zip(axes, shape)), devices=tuple(devs))


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a ``DeviceMesh``; anything else (a JAX ``Mesh``
    among them) raises ``TypeError``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "repro_torch shards over a repro_torch.launch.mesh.DeviceMesh "
            f"(make_mesh); got {type(mesh).__module__}."
            f"{type(mesh).__name__}")
    return mesh


def dp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The data-parallel axes present in this mesh ((pod, data) or
    (data,))."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: DeviceMesh, name) -> int:
    """Size of one axis or the product over a tuple of axes; absent axes
    and ``None`` count 1."""
    if isinstance(name, (tuple, list)):
        return math.prod(axis_size(mesh, n) for n in name)
    if name is None:
        return 1
    return mesh.shape.get(name, 1)

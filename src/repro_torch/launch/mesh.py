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

The model substrate's part: ``PartitionSpec`` (a tuple of
entries: ``None``, an axis name, or a tuple of names), ``NamedSharding``
(a spec over a mesh, which lays a tensor out in pieces, one per mesh
position on that position's device, and puts the pieces back together),
``filter_spec``, ``named`` and ``make_production_mesh`` (the reference's
(16, 16) and (2, 16, 16) meshes; over an explicit device list such as
256 ``torch.device("meta")``, the rules' specs are computed without a
card).

The dry run's part: the mesh loops mark the position they run
(``at_position``), since every meta position is the same device, and
every exchange the port lays out calls ``record_collective``.  Both do
nothing outside a cost mode (``utils.op_cost.OpCost``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["DeviceMesh", "make_mesh", "check_mesh", "dp_axes",
           "axis_size", "PartitionSpec", "NamedSharding", "filter_spec",
           "named", "make_production_mesh", "at_position",
           "current_position", "record_collective"]

# the mesh position whose work the running code is (a row-major flat
# index), and the active cost mode's collective sink
_POSITION: contextvars.ContextVar = contextvars.ContextVar(
    "mesh_position", default=None)
_COLLECTIVE_SINK: list = [None]


@contextlib.contextmanager
def at_position(flat: int):
    """Book the work done inside to mesh position ``flat``."""
    token = _POSITION.set(int(flat))
    try:
        yield
    finally:
        _POSITION.reset(token)


def current_position():
    """The position marked by the innermost ``at_position``, else None."""
    return _POSITION.get()


def record_collective(op: str, out_bytes: int, group_size: int, *,
                      positions=None, axes=(), param: str = "") -> None:
    """Record one collective of ``launch.roofline.Collective``'s ``op``
    with ``out_bytes`` of output per participant over a group of
    ``group_size`` positions spanning the mesh ``axes``.  ``positions``
    lists the participants (None: the marked position, else every
    position); ``param`` names the parameters (a path suffix such as
    ``moe/gate``) an all-gather puts together.  A no-op outside a cost
    mode."""
    sink = _COLLECTIVE_SINK[0]
    if sink is not None and group_size > 1:
        sink(op, int(out_bytes), int(group_size), positions, tuple(axes),
             param)


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

    def flat_at(self, **index: int) -> int:
        """The row-major flat index of the named position (axes not
        named: index 0)."""
        flat = 0
        for name, n in self.shape.items():
            i = int(index.get(name, 0))
            if not 0 <= i < n:
                raise IndexError(f"{name}={i} outside a {name} axis of {n}")
            flat = flat * n + i
        return flat

    def device_at(self, **index: int) -> torch.device:
        """The device at the named position (axes not named: index 0)."""
        return self.devices[self.flat_at(**index)]

    def coords(self, flat: int) -> Dict[str, int]:
        """The named position at a row-major flat index."""
        out: Dict[str, int] = {}
        for name, n in reversed(tuple(self.shape.items())):
            flat, out[name] = divmod(flat, n)
        return {name: out[name] for name in self.shape}

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


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> DeviceMesh:
    """(16, 16) over ``("data", "model")``, or (2, 16, 16) over ``("pod",
    "data", "model")`` with ``multi_pod``.  ``devices=None`` needs that
    many CUDA cards (as ``make_mesh``); an explicit list (256 or 512
    ``torch.device("meta")``) gives the mesh the sharding rules need
    without cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per leading
    dim, each ``None`` (not split), an axis name, or a tuple of names (the
    dim split over their product, the first name major).  Dims past the
    entries are not split.  Equal to ``tuple(jax_spec)`` of the same
    entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over a ``DeviceMesh``: which piece of a tensor
    each mesh position holds.  A dim split over axes ``(a, b)`` has
    ``size(a) * size(b)`` pieces, position ``(i_a, i_b)`` holding piece
    ``i_a * size(b) + i_b``; positions that differ only on axes the spec
    does not name hold the same piece (replicas)."""

    mesh: DeviceMesh
    spec: PartitionSpec

    def __post_init__(self):
        object.__setattr__(self, "spec", PartitionSpec(*self.spec))
        used = [n for e in self.spec for n in _names(e)]
        missing = [n for n in used if n not in self.mesh.axis_names]
        if missing:
            raise ValueError(f"{self.spec} names axes {missing} that the "
                             f"mesh {self.mesh.axis_names} lacks")
        if len(set(used)) != len(used):
            raise ValueError(f"{self.spec} uses an axis twice")

    def _counts(self, rank: int) -> Tuple[int, ...]:
        if len(self.spec) > rank:
            raise ValueError(f"{self.spec} has more entries than a rank-"
                             f"{rank} tensor has dims")
        return tuple(axis_size(self.mesh, e) for e in self.spec) + (
            1,) * (rank - len(self.spec))

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of each piece; every split dim must divide."""
        shape = tuple(int(n) for n in global_shape)
        counts = self._counts(len(shape))
        for n, c in zip(shape, counts):
            if n % c:
                raise ValueError(f"{self.spec} splits a dim of {n} into "
                                 f"{c} pieces: {shape} does not divide")
        return tuple(n // c for n, c in zip(shape, counts))

    def index(self, flat: int) -> Tuple[int, ...]:
        """Which piece along each entry's dim the position at the
        row-major flat index holds."""
        at = self.mesh.coords(flat)
        out = []
        for e in self.spec:
            i = 0
            for name in _names(e):
                i = i * self.mesh.shape[name] + at[name]
            out.append(i)
        return tuple(out)

    def shard(self, t: torch.Tensor) -> List[torch.Tensor]:
        """The piece of every mesh position, in row-major order, on that
        position's device: a view of ``t`` where the position's device is
        ``t.device`` (no copy), a copy elsewhere.  Autograd flows through
        both."""
        local = self.shard_shape(t.shape)
        out = []
        for flat, dev in enumerate(self.mesh.devices):
            piece = t
            for dim, i in enumerate(self.index(flat)):
                if local[dim] != t.shape[dim]:
                    piece = piece.narrow(dim, i * local[dim], local[dim])
            out.append(piece.to(dev))
        return out

    def unshard(self, pieces: Sequence[torch.Tensor],
                device) -> torch.Tensor:
        """The whole tensor on ``device`` from every position's piece
        (the inverse of ``shard``, bit-equal; of replicas the first
        position's is read)."""
        if len(pieces) != self.mesh.size:
            raise ValueError(f"{len(pieces)} pieces for a mesh of "
                             f"{self.mesh.size} positions")
        rank = pieces[0].dim()
        counts = self._counts(rank)
        first: Dict[Tuple[int, ...], torch.Tensor] = {}
        for flat, piece in enumerate(pieces):
            first.setdefault(self.index(flat), piece)
        device = torch.device(device)

        def build(prefix):
            if len(prefix) == len(self.spec):
                return first[prefix].to(device)
            parts = [build(prefix + (i,)) for i in range(counts[len(prefix)])]
            return parts[0] if len(parts) == 1 else torch.cat(
                parts, dim=len(prefix))

        return build(())


def filter_spec(mesh: DeviceMesh, *entries) -> PartitionSpec:
    """PartitionSpec dropping axes that are absent from ``mesh``.

    Entries may be None, a name, or a tuple of names; absent names are
    removed (e.g. ``("pod", "data")`` -> ``("data",)`` on a single pod).
    """
    out = []
    for e in entries:
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in mesh.axis_names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(e if e in mesh.axis_names else None)
    return PartitionSpec(*out)


def named(mesh: DeviceMesh, spec) -> NamedSharding:
    return NamedSharding(mesh, spec)

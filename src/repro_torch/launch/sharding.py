"""Activation-sharding hooks of the models (port of the part of
``repro.launch.sharding`` that the models call on one device).

Model code annotates activations with LOGICAL axis names via
``shard_act(x, ("batch", "sp", None))``; a launcher activates a mesh with
``mesh_context``.  Without an active mesh (the CPU tests, one card)
``shard_act`` is the identity, as the reference's is without one.  The
logical-to-physical axis map comes with the sharding rules.

The port's models do not run sharded yet: the param rules
(``spec_by_rules``, ``lm_param_specs``, ...), ``moe_forward_sharded`` and
the Bundle's sharding methods are the next slice (ROADMAP.md, queue 1).
So ``shard_act`` under an active ``DeviceMesh`` raises instead of
silently computing unsharded.
"""
from __future__ import annotations

__all__ = ["mesh_context", "current_mesh", "shard_act"]

_MESH: list = [None]     # the active mesh, None without one


class mesh_context:
    """``with mesh_context(mesh): ...`` scoped activation constraints."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = _MESH[0]
        _MESH[0] = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        _MESH[0] = self.prev
        return False


def current_mesh():
    return _MESH[0]


def shard_act(x, logical_entries):
    """The identity without an active mesh; under one, raises: sharded
    activations come with the sharding rules (ROADMAP.md, queue 1)."""
    if _MESH[0] is None:
        return x
    raise NotImplementedError(
        "repro_torch's models do not run under a mesh yet: shard_act "
        f"{tuple(logical_entries)} needs the sharding rules (the sharded-LM "
        "slice); run without mesh_context")

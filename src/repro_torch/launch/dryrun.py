"""Multi-pod dry run: cost every (arch x shape x mesh) cell (port of
``repro.launch.dryrun``).

For each cell the step runs once on meta tensors (shapes only: no data,
no card) under ``utils.op_cost.OpCost``, over a production mesh of meta
positions (``make_production_mesh(devices=[torch.device("meta")] * n)``):
the meshes of cards the dry run does not have, as the reference's
placeholder host devices are.  The record holds:

  * ``memory_analysis``: the arguments one position holds (the state and
    the batch of a train step, else the params and the batch, each leaf's
    ``NamedSharding.shard_shape`` of its sharding), its outputs, and the
    temporaries at the peak of live bytes;
  * ``roofline`` (``launch.roofline.Roofline.to_dict``): FLOPs, HBM bytes
    and wire bytes per device, the work per unit and the H100 times.

The single-controller program computes activations whole (``shard_act``
returns ``x``): that work is split evenly over the positions, and
``even_split_share`` says how much of the FLOPs rests on the split.  Work
the mesh loops run position by position (the CD shards, the sharded
MoE) is booked to its position.  Collectives are the exchanges the port
lays out (``record_collective``) and the parameters' own, from the spec
trees over the data axes: a leaf split over a dp axis is all-gathered
before use, and in training its gradient is reduce-scattered, or
all-reduced where the leaf is replicated over dp.  The activation
collectives over ``model`` that the reference's partitioner inserts are
not invented, so ``t_collective`` is a floor.

An LM's layer stacks are traced at one and two layers each (and three
for training, whose backward is quadratic in the depth) and extrapolated
to the config's depth (``op_cost.Cost.combine``; the record's
``depths``), as the CD chunk loop is at one and two chunks; everything
else is traced whole.

Usage:
    python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod both \
        --out dryrun.json
    python -m repro_torch.launch.dryrun --arch receipt-tip --shape cd_sweep_1m
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from ..configs import ALL_ARCHS, get_bundle
from ..configs.families import ShapeDtype, make_lm_bundle
from ..configs.shapes import RECEIPT_SHAPES
from ..models.transformer import init_cache
from ..train.tree import leaves_with_paths
from ..utils.op_cost import ALL, Cost, OpCost
from . import roofline as rl
from .mesh import (NamedSharding, PartitionSpec, axis_size, dp_axes,
                   make_production_mesh)
from .sharding import _check_div, mesh_context, norm_path

__all__ = ["dryrun_cell", "main", "meta_mesh", "roofline_of",
           "trace_step", "cost_step", "all_cells"]

_META = torch.device("meta")


def meta_mesh(multi_pod: bool):
    """The production mesh over meta positions."""
    return make_production_mesh(multi_pod=multi_pod,
                                devices=[_META] * (512 if multi_pod else 256))


def _mesh_name(mesh) -> str:
    return "x".join(str(v) for v in mesh.shape.values())


def _bytes(shape, dtype) -> int:
    n = 1
    for k in shape:
        n *= int(k)
    return n * torch.empty((), dtype=dtype).element_size()


def _piece(sharding: NamedSharding, leaf) -> int:
    return _bytes(sharding.shard_shape(tuple(leaf.shape)), leaf.dtype)


def _paired(values, shardings):
    """(path, value, sharding) over the tensor leaves of ``values``."""
    sh = dict((norm_path(p), s) for p, s in leaves_with_paths(shardings))
    return [(norm_path(p), v, sh[norm_path(p)])
            for p, v in leaves_with_paths(values) if torch.is_tensor(v)]


def _out_sharding(mesh, leaf) -> NamedSharding:
    """The reference's output rule: scalars replicated, else the leading
    dim over the dp axes."""
    if leaf.dim() == 0:
        return NamedSharding(mesh, PartitionSpec())
    ent = [dp_axes(mesh)] + [None] * (leaf.dim() - 1)
    return NamedSharding(mesh, _check_div(tuple(leaf.shape), ent, mesh))


def _batch(bundle, shape: str):
    """Meta tensors of the shape's inputs; a decode cache from
    ``init_cache`` on the meta device with a host-int ``len`` (its last
    position: the step attends over the whole cache either way)."""
    specs = bundle.input_specs(shape)
    out = {}
    for k, v in specs.items():
        if isinstance(v, ShapeDtype):
            out[k] = torch.empty(v.shape, dtype=v.dtype, device=_META)
    if "cache" in specs:
        s = bundle.shapes[shape]
        cache = init_cache(bundle.cfg, s.global_batch, s.seq_len,
                           device=_META)
        cache["len"] = s.seq_len - 1
        out["cache"] = cache
    return out


def _param_collectives(cost: Cost, params, shardings, mesh, train: bool):
    """The parameters' collectives over the data axes (booked to every
    position): an all-gather of each leaf split over a dp axis (unless
    the program gathers it itself), and in training the gradient's
    reduce-scatter, or its all-reduce where the leaf is replicated over
    dp."""
    dp = dp_axes(mesh)
    n_dp = axis_size(mesh, dp)
    for path, leaf, sh in _paired(params, shardings):
        used = {n for e in sh.spec if e is not None
                for n in (e if isinstance(e, tuple) else (e,))}
        axes = tuple(a for a in dp if a in used)
        g = axis_size(mesh, axes)
        piece = _piece(sh, leaf)
        if g > 1:
            if not any(path.endswith(q) for q in cost.gathered):
                cost.add_collective(ALL, "all-gather", piece * g, g, axes)
            if train:
                cost.add_collective(ALL, "reduce-scatter", piece, g, axes)
        elif train and n_dp > 1:
            cost.add_collective(ALL, "all-reduce", piece, n_dp, dp)


def trace_step(bundle, shape: str, mesh) -> Cost:
    """One step of ``bundle`` at ``shape`` traced over meta tensors on
    ``mesh`` (its positions need not be meta: nothing is placed)."""
    kind, step = bundle.step_for(shape)
    train = kind.startswith("train")
    batch = _batch(bundle, shape)
    in_sh = bundle.input_shardings(shape, mesh)
    params = bundle.abstract_params()
    if train:
        from ..train.train_step import init_train_state

        first = init_train_state(params, bundle.opt_cfg)
        first_sh = bundle.state_shardings(mesh)
    else:
        first, first_sh = params, bundle.param_shardings(mesh)
    held = [(v, _piece(s, v)) for _, v, s in
            _paired(first, first_sh) + _paired(batch, in_sh)]
    with OpCost(mesh.size) as oc, mesh_context(mesh):
        oc.add_arguments(held)
        out = step(first, batch)
    # as the reference's executables, the arguments no op reads (the item
    # tower of a retrieval step) are not the step's
    cost = oc.cost
    unread = oc.unread_arguments()
    cost.args = sum(n for _, n in held) - unread
    cost.peak -= unread
    if train:
        new_state, metrics = out
        outs = _paired(new_state, first_sh) + [
            (p, v, _out_sharding(mesh, v)) for p, v in
            leaves_with_paths(metrics) if torch.is_tensor(v)]
    elif kind == "serve_decode":
        logits, cache = out
        outs = [("logits", logits, _out_sharding(mesh, logits))] + \
            _paired(cache, in_sh["cache"])
    else:
        outs = [(p, v, _out_sharding(mesh, v))
                for p, v in leaves_with_paths(out) if torch.is_tensor(v)]
    cost.outputs = sum(_piece(s, v) for _, v, s in outs)
    _param_collectives(cost, params, bundle.param_shardings(mesh), mesh,
                       train)
    return cost


def _depth_weights(n: int, k: int) -> List[int]:
    """Integer weights of traces at depths 1..k (k = 2: affine, k = 3:
    quadratic) that give the cost at depth ``n``."""
    if k == 2:
        return [2 - n, n - 1]
    t = (n - 1) * (n - 2) // 2
    return [1 - (n - 1) + t, (n - 1) - 2 * t, t]


def _lm_cost(bundle, shape: str, mesh) -> Cost:
    """An LM step traced at small depths of each layer stack and
    extrapolated to the config's depth.  Serving is affine in the depth
    (traces at 1 and 2 layers).  Training is quadratic: the backward of
    each layer's view of a stacked leaf writes a zero gradient of the
    whole stack, and autograd sums them, so each stack is traced at 1, 2
    and 3 layers.  For (dense, layers) stacks the other stack stays at
    one layer; the stacks share no leaf, so their terms add."""
    cfg = bundle.cfg
    nd, ns = cfg.n_dense_layers, cfg.n_scan_layers
    k = 3 if bundle.step_for(shape)[0].startswith("train") else 2
    base = (1 if nd else 0, 1)
    points, coeffs = [base], [1]
    depths = {"layers": {"traced": list(range(1, k + 1)), "config": ns}}
    stacks = [(1, ns)]
    if nd > 1:
        stacks.append((0, nd))
        depths["dense_layers"] = {"traced": list(range(1, k + 1)),
                                  "config": nd}
    elif nd:
        depths["dense_layers"] = {"traced": [1], "config": nd}
    for axis, n in stacks:
        w = _depth_weights(n, k)
        for j in range(2, k + 1):
            p = list(base)
            p[axis] = j
            points.append(tuple(p))
            coeffs.append(w[j - 1])
            coeffs[0] -= w[j - 1]
    costs = []
    for d, s in points:
        cut = dataclasses.replace(cfg, n_layers=d + s, n_dense_layers=d)
        costs.append(trace_step(
            make_lm_bundle(bundle.arch_id, cut, bundle.opt_cfg,
                           shapes=bundle.shapes), shape, mesh))
    return Cost.combine(costs, coeffs, depths=depths)


def cost_step(bundle, shape: str, mesh) -> Cost:
    """The cost of one step of ``bundle`` at ``shape`` on ``mesh``: an
    LM's extrapolated over its depth, any other traced whole."""
    if bundle.family == "lm":
        return _lm_cost(bundle, shape, mesh)
    return trace_step(bundle, shape, mesh)


def roofline_of(cost: Cost, *, chips: int,
                model_flops: Optional[float] = None) -> rl.Roofline:
    """The per-device roofline terms of a traced ``cost``."""
    keys = cost.keys()
    return rl.Roofline(
        flops=float(cost.per_device("flops")),
        hbm_bytes=float(cost.per_device("hbm")),
        wire_bytes=float(cost.per_device("wire")),
        n_collectives=int(cost.per_device("n_coll")),
        coll_by_op={k[3:]: float(cost.per_device(k)) for k in sorted(keys)
                    if k.startswith("op/")},
        peak_memory_bytes=float(cost.peak),
        model_flops=model_flops,
        chips=chips,
        flops_by_unit={k[5:]: float(cost.per_device(k))
                       for k in sorted(keys) if k.startswith("unit/")},
        even_split_share=cost.even_share(),
        depths=cost.depths,
        pod_wire_bytes=float(cost.per_device("pod_wire")),
    )


def _memory(cost: Cost) -> Dict[str, int]:
    return {"argument_size_in_bytes": int(cost.args),
            "output_size_in_bytes": int(cost.outputs),
            "temp_size_in_bytes": int(round(cost.peak - cost.args))}


def _line(arch, shape, mesh_name, mem, roof, secs) -> str:
    per_dev = mem["argument_size_in_bytes"] / 1e9
    return (f"[dryrun] {arch:24s} {shape:14s} mesh={mesh_name:8s} "
            f"args/dev={per_dev:8.2f}GB "
            f"t_comp={roof.t_compute * 1e3:10.3f}ms "
            f"t_mem={roof.t_memory * 1e3:10.3f}ms "
            f"t_coll={roof.t_collective * 1e3:10.3f}ms "
            f"bound={roof.bottleneck} ({secs:.1f}s)")


def dryrun_cell(arch: str, shape: str, *, multi_pod: bool,
                verbose: bool = True, mesh=None) -> Dict[str, Any]:
    """Cost one cell; returns its record.  ``mesh`` overrides the
    production mesh (tests use small meta meshes)."""
    mesh = mesh or meta_mesh(multi_pod)
    chips = mesh.size
    t0 = time.time()
    if arch == "receipt-tip":
        rec = _dryrun_receipt(mesh, shape, chips, verbose)
        rec["lower_compile_s"] = time.time() - t0
        return rec

    bundle = get_bundle(arch)
    kind, _ = bundle.step_for(shape)
    model_flops = None
    cost = cost_step(bundle, shape, mesh)
    if bundle.family == "lm":
        ab = bundle.abstract_params()
        s = bundle.shapes[shape]
        tokens = s.global_batch * (1 if s.kind == "decode" else s.seq_len)
        model_flops = rl.lm_model_flops(
            rl.count_params(ab), rl.lm_active_params(ab, bundle.cfg),
            tokens, "train" if s.kind == "train" else "serve")
    roof = roofline_of(cost, chips=chips, model_flops=model_flops)
    mem = _memory(cost)
    rec = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": _mesh_name(mesh),
        "chips": chips,
        "ok": True,
        "memory_analysis": mem,
        "roofline": roof.to_dict(),
        # the trace's wall time, under the reference's key
        "lower_compile_s": time.time() - t0,
    }
    if verbose:
        print(_line(arch, shape, rec["mesh"], mem, roof,
                    rec["lower_compile_s"]), flush=True)
    return rec


# --------------------------------------------------------------------- #
# RECEIPT distributed cells
# --------------------------------------------------------------------- #
def _dryrun_receipt(mesh, shape: str, chips: int,
                    verbose: bool = True) -> Dict[str, Any]:
    """Cost the distributed RECEIPT steps (``core/distributed.py``)."""
    from ..core import distributed as dist

    t0 = time.time()
    s = RECEIPT_SHAPES[shape]
    if s.kind == "cd_sweep":
        cost = dist.lower_cd_sweep(mesh, n_u=s.n_u, n_v=s.n_v,
                                   peel_rows=s.peel_rows)
    else:
        cost = dist.lower_fd_stack(mesh, n_subsets=s.n_subsets,
                                   rows=s.subset_rows, cols=s.subset_cols)
    roof = roofline_of(cost, chips=chips)
    mem = _memory(cost)
    if verbose:
        print(_line("receipt-tip", shape, _mesh_name(mesh), mem, roof,
                    time.time() - t0), flush=True)
    return {
        "arch": "receipt-tip", "shape": shape, "mesh": _mesh_name(mesh),
        "chips": chips, "ok": True, "kind": s.kind,
        "memory_analysis": mem, "roofline": roof.to_dict(),
    }


def all_cells() -> List:
    """Every (arch, shape) cell of ``--all``."""
    cells = [(a, sh) for a in ALL_ARCHS
             for sh in get_bundle(a, reduced=True).shapes]
    return cells + [("receipt-tip", sh) for sh in RECEIPT_SHAPES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        raise SystemExit("--arch/--shape or --all")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]

    existing = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for r in json.load(f):
                existing[(r["arch"], r["shape"], r["mesh"])] = r

    results = dict(existing)
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            if args.skip_existing and (arch, shape, mesh_name) in existing:
                continue
            try:
                rec = dryrun_cell(arch, shape, multi_pod=mp)
            except Exception as e:
                traceback.print_exc()
                rec = {
                    "arch": arch, "shape": shape, "mesh": mesh_name,
                    "ok": False, "error": f"{type(e).__name__}: {e}",
                }
                failures += 1
            results[(arch, shape, mesh_name)] = rec
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(list(results.values()), f, indent=1,
                              default=str)
    print(f"[dryrun] done: {len(results)} records, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

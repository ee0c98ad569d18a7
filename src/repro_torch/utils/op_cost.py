"""Cost of a step traced over meta tensors (the port's counterpart of
``repro.utils.hlo_cost``).

The reference re-derives FLOPs, bytes and collectives from a compiled
module's HLO text.  The port compiles nothing: every aten op is its own
kernel.  So ``OpCost``, a ``TorchDispatchMode``, runs the step on meta
tensors (shapes only, no data, no card) and counts, op by op:

  * FLOPs from ``torch.utils.flop_counter``'s formulas (the products, as
    the reference counts only dots and convolutions); the unit is the
    operands' dtype: bf16/fp16 on the tensor cores, f32 on TF32 where
    ``torch.backends.cuda.matmul.allow_tf32`` is set (else FP32 outside
    the tensor cores), f64 on FP64.  Any op with neither a formula nor a
    known zero (a view, a pointwise op, a listed data or reduction op)
    raises: nothing unknown is costed as zero;
  * HBM bytes as the eager program moves them: each op reads its
    operands and writes its outputs once (an operand written in place
    counts once; a view moves nothing).  Gathers count the rows they
    read, not the whole table, and an in-place scatter the rows it
    writes;
  * the peak of live bytes, from the meta storages' lifetimes (a weakref
    finalizer per storage); arguments are live from the start;
  * the hand kernels: a wrapper called on meta tensors runs its plain
    version through ``run_kernel``, and the cost mode books the kernel's
    own int8 work and bytes in place of the plain version's (whose
    products still count in ``flops``, the function's arithmetic);
  * collectives, recorded by the port's exchanges
    (``launch.mesh.record_collective``);
  * repeated calls: a call that costs the same whenever its inputs have
    the same shapes (an MoE layer's sharded exchange, once per layer)
    goes through ``repeat_call``, which traces its first call, forward
    and backward, in cost modes of their own, and books that cost for
    it and for every later call of the same shapes.

Every meta position of a mesh is the same device, so the mesh loops mark
the position they run (``launch.mesh.at_position``) and work is booked to
it; unmarked work (whole activations of the single-controller program)
is split evenly over the positions, and arguments held by every position
count on each.  Per-device figures take the maximum over the positions.
Totals stay exact integers (fractions for the ring formulas), so costs
traced at two depths extrapolate exactly (``Cost.combine``).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from fractions import Fraction
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..launch import mesh as mesh_lib

__all__ = ["Cost", "OpCost", "run_kernel", "wire_bytes", "matmul_unit"]

EVEN, ALL = "even", "all"      # the unmarked and every-position buckets

# ops that do no arithmetic the roofline counts (data movement,
# reductions, comparisons, factories); views and pointwise ops are known
# by their schema and tags
_NO_ARITH = {
    "_to_copy", "copy", "copy_", "clone", "cat", "stack", "contiguous",
    "index", "index_select", "gather", "embedding",
    "embedding_dense_backward", "index_put", "index_put_",
    "_index_put_impl_", "index_add", "index_add_", "index_copy",
    "index_copy_", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "masked_fill", "masked_fill_",
    "masked_scatter", "select_scatter", "slice_scatter", "slice_backward",
    "select_backward", "diagonal_scatter", "as_strided_scatter",
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "any", "all", "var", "var_mean", "std", "norm",
    "linalg_vector_norm", "cumsum", "cummax", "cummin", "logsumexp",
    "sort", "topk", "argsort",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "nll_loss_forward", "nll_loss_backward",
    "nll_loss2d_forward", "nll_loss2d_backward",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "arange",
    "fill", "fill_", "zero_", "eye", "scalar_tensor", "lift_fresh",
    "lift_fresh_copy", "constant_pad_nd", "repeat", "repeat_interleave",
    "triu", "tril", "flip", "roll", "one_hot", "expand_copy",
    "_unsafe_index", "_unsafe_index_put", "bernoulli_", "uniform_",
    "normal_", "random_", "native_dropout", "native_dropout_backward",
    "_local_scalar_dense", "detach_", "set_", "resize_", "equal",
    "is_nonzero", "masked_select", "nonzero", "bincount", "unique_dim",
    "_unique2", "searchsorted", "bucketize", "count_nonzero",
    "native_layer_norm", "native_layer_norm_backward",
    "_fused_rms_norm", "_fused_rms_norm_backward",
    "_unsafe_view", "alias",
}
# ops that move nothing (metadata, views the schema does not mark, or
# allocation without a write)
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "detach_", "set_", "resize_",
         "_local_scalar_dense", "is_nonzero", "equal", "_unsafe_view",
         "alias"}
# gathers read the rows they return (and their indices), not the table
_GATHERS = {"index", "index_select", "gather", "embedding",
            "_unsafe_index"}
# in-place scatters write the rows of their source (and read it, and the
# indices), not the whole of ``self``
_SCATTERS_INPLACE = {"index_put_", "_index_put_impl_", "index_add_",
                     "index_copy_", "scatter_", "scatter_add_",
                     "scatter_reduce_", "_unsafe_index_put"}

# products ``torch.utils.flop_counter`` has no formula for
_MORE_FLOPS = {
    "mv": lambda m, v, *_: 2 * m.shape[0] * m.shape[1],
    "addmv": lambda _s, m, v, *_: 2 * m.shape[0] * m.shape[1],
    "dot": lambda x, y: 2 * x.numel(),
    "vdot": lambda x, y: 2 * x.numel(),
}

_ACTIVE: list = [None]
_META = torch.device("meta")
# measured repeated calls: (key, grad, positions, unmarked bucket, TF32,
# input shapes) -> their record
_REPEATS: Dict = {}


def repeat_call(fn, tensors, key):
    """``fn(*tensors)``, a tuple of tensors.  Under a cost mode, on meta
    tensors, a call whose cost depends only on its inputs' shapes (and
    ``key``, hashable: the mesh, the options) is traced once, forward and
    backward, and its cost booked for every call of the same shapes; the
    outputs are fresh meta tensors of the traced call's shapes, and
    their gradients flow back as the traced call's cost.  Elsewhere a
    plain call."""
    mode = _ACTIVE[0]
    if mode is None or any(t.device.type != "meta" for t in tensors):
        return tuple(fn(*tensors))
    return mode.repeat(fn, tensors, key)


def _same(t):
    return t


class _Replay(torch.autograd.Function):
    """A measured call in an autograd graph: its forward books the
    traced forward, its backward the traced backward (on what the
    forward left live) and returns gradients of the inputs' shapes."""

    @staticmethod
    def forward(ctx, rec, *tensors):
        ctx.rec = rec
        ctx.shapes = [(t.shape, t.dtype) for t in tensors]
        # a saved input, unpacked in the backward: a checkpointed caller
        # then recomputes up to this call, as it would the traced one
        ctx.save_for_backward(tensors[0])
        _ACTIVE[0].book(rec["fwd"], rec["fwd"].peak)
        return tuple(torch.empty(s, dtype=d, device=_META)
                     for s, d in rec["outs"])

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors
        rec = ctx.rec
        if _ACTIVE[0] is not None:
            _ACTIVE[0].book(rec["bwd"], rec["held"] + rec["bwd"].peak)
        return (None,) + tuple(
            torch.empty(s, dtype=d, device=_META) if need else None
            for (s, d), need in zip(ctx.shapes, ctx.needs_input_grad[1:]))


def wire_bytes(op: str, out_bytes: int, g: int) -> Fraction:
    """The ring formula of ``launch.roofline.Collective``, exact."""
    if g <= 1:
        return Fraction(0)
    if op == "all-reduce":
        return Fraction(2 * out_bytes * (g - 1), g)
    if op in ("all-gather", "all-to-all"):
        return Fraction(out_bytes * (g - 1), g)
    if op == "reduce-scatter":
        return Fraction(out_bytes * (g - 1))
    if op == "collective-permute":
        return Fraction(out_bytes)
    raise ValueError(f"unknown collective {op!r}")


def matmul_unit(dtype: torch.dtype) -> str:
    """The roofline unit that runs a product of ``dtype`` operands."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32"
    if dtype == torch.float64:
        return "fp64"
    if dtype == torch.int8:
        return "int8"
    raise NotImplementedError(f"op_cost: no unit for {dtype} products")


def _nbytes(t: torch.Tensor) -> int:
    """Bytes one pass over ``t`` moves: its elements, at most its
    storage (an expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (lists, tuples and
    dicts of them)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class Cost:
    """Integer totals of a traced step, per bucket: a mesh position (an
    int), ``EVEN`` (split over the ``n`` positions) or ``ALL`` (held by
    every position).  Keys: ``flops``, ``hbm``, ``wire``, ``pod_wire``,
    ``n_coll``, ``unit/<u>`` (work per roofline unit), ``op/<op>`` (wire
    bytes per collective).  ``peak`` is the most live bytes of one
    position (a Fraction), ``args`` / ``outputs`` the bytes each position
    holds (set by the caller)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.buckets: Dict = defaultdict(lambda: defaultdict(int))
        self.peak = Fraction(0)
        self.args = 0
        self.outputs = 0
        self.gathered: set = set()   # param suffixes the program gathers
        self.depths: Optional[Dict] = None

    def add(self, bucket, key: str, value) -> None:
        self.buckets[bucket][key] += value

    def add_collective(self, bucket, op: str, out_bytes: int, group: int,
                       axes=()) -> None:
        w = wire_bytes(op, out_bytes, group)
        b = self.buckets[bucket]
        b["wire"] += w
        b["n_coll"] += 1
        b[f"op/{op}"] += w
        if "pod" in axes:
            b["pod_wire"] += w

    def keys(self) -> set:
        return {k for b in self.buckets.values() for k in b}

    def per_device(self, key: str) -> Fraction:
        """Max over positions of the position's own total, plus what
        every position holds and its even share."""
        own = [b.get(key, 0) for k, b in self.buckets.items()
               if isinstance(k, int)]
        return (Fraction(max(own, default=0))
                + self.buckets[ALL].get(key, 0)
                + Fraction(self.buckets[EVEN].get(key, 0), self.n))

    def even_share(self) -> float:
        total = self.per_device("flops")
        if not total:
            return 0.0
        return float(Fraction(self.buckets[EVEN].get("flops", 0), self.n)
                     / total)

    @staticmethod
    def combine(costs: List["Cost"], coeffs: List[int],
                depths: Optional[Dict] = None) -> "Cost":
        """The affine combination ``sum c_i cost_i``, bucket by bucket
        (the extrapolation of costs traced at two depths, recorded as
        ``depths``)."""
        out = Cost(costs[0].n)
        out.depths = depths
        for c, w in zip(costs, coeffs):
            for k, b in c.buckets.items():
                for key, v in b.items():
                    out.buckets[k][key] += w * v
            out.peak += w * c.peak
            out.args += w * c.args
            out.outputs += w * c.outputs
            out.gathered |= c.gathered
        return out


def run_kernel(plain, args, *, ops: int, nbytes: int, scratch: int = 0,
               unit: str = "int8"):
    """``plain(*args)`` (a hand kernel's plain version on meta tensors).
    Under a cost mode the kernel's own ``ops`` (on ``unit``: int8 tensor
    cores, or f32 FMAs for the f32 tile bodies) and ``nbytes`` replace
    the plain version's per-op work and bytes, its temporaries are not
    live (the kernel keeps them on chip) and ``scratch`` device bytes are
    live while it runs."""
    mode = _ACTIVE[0]
    if mode is None:
        return plain(*args)
    return mode.kernel(plain, args, ops, nbytes, scratch, unit)


class OpCost(TorchDispatchMode):
    """``with OpCost(n_positions) as oc: step(...)``; ``oc.cost`` holds
    the totals.  ``add_arguments`` declares the step's inputs live from
    the start.  Work done at no marked position goes to ``unmarked``:
    ``EVEN`` (whole activations, split over the positions) or ``ALL``
    (one position's program, which every position runs)."""

    def __init__(self, n_positions: int = 1, *, unmarked: str = EVEN):
        super().__init__()
        self.cost = Cost(n_positions)
        self._unmarked = unmarked
        self._known: Dict[int, tuple] = {}       # storage -> (bucket, bytes)
        self._live: Dict = defaultdict(int)      # bucket -> live bytes
        self._args: Dict[int, int] = {}          # argument -> its bytes
        self._read: set = set()                  # arguments read
        self._in_kernel = False

    # ---- context
    def __enter__(self):
        self._prev = (_ACTIVE[0], mesh_lib._COLLECTIVE_SINK[0])
        _ACTIVE[0] = self
        mesh_lib._COLLECTIVE_SINK[0] = self._collective
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE[0], mesh_lib._COLLECTIVE_SINK[0] = self._prev
        return super().__exit__(*exc)

    # ---- live bytes
    def _bucket(self):
        p = mesh_lib.current_position()
        return self._unmarked if p is None else p

    def _free(self, key: int) -> None:
        bucket, n = self._known.pop(key)
        self._live[bucket] -= n
        if isinstance(bucket, int) and not self._live[bucket]:
            del self._live[bucket]

    def _hold(self, t: torch.Tensor, bucket, nbytes: Optional[int] = None):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        n = st.nbytes() if nbytes is None else int(nbytes)
        self._known[key] = (bucket, n)
        self._live[bucket] += n
        weakref.finalize(st, self._free, key)

    def _check_peak(self, bucket, extra=0) -> None:
        if isinstance(bucket, int):
            own = self._live.get(bucket, 0)
        else:
            own = max((v for k, v in self._live.items()
                       if isinstance(k, int)), default=0)
        cur = (Fraction(own + self._live.get(ALL, 0)) + extra
               + Fraction(self._live.get(EVEN, 0), self.cost.n))
        if cur > self.cost.peak:
            self.cost.peak = cur

    # ---- repeated calls
    def book(self, cost: "Cost", extra_peak) -> None:
        """Add a measured call's totals; its own peak ``extra_peak``
        rests on what is live now."""
        for k, b in cost.buckets.items():
            for key, v in b.items():
                self.cost.buckets[k][key] += v
        self.cost.gathered |= cost.gathered
        self._check_peak(EVEN, extra_peak)

    def _measure(self, fn, tensors, grad: bool) -> Dict:
        """Trace ``fn(*tensors)`` on detached copies, forward and (with
        ``grad``) backward, each in a cost mode of its own."""
        from torch.utils._python_dispatch import _disable_current_modes

        xs = [t.detach().requires_grad_(t.requires_grad) for t in tensors]
        # its own graph: outside any saved-tensor hooks of the caller's
        # (a checkpointed layer's) and any cost mode
        with _disable_current_modes(), \
                torch.autograd.graph.saved_tensors_hooks(_same, _same):
            with OpCost(self.cost.n, unmarked=self._unmarked) as fwd, \
                    torch.set_grad_enabled(grad):
                outs = tuple(fn(*xs))
            held = fwd._live_now()
            rec = {"fwd": fwd.cost, "bwd": None, "held": held,
                   "outs": [(tuple(o.shape), o.dtype) for o in outs]}
            if grad:
                need = [x for x in xs if x.requires_grad]
                diff = [o for o in outs if o.requires_grad]
                with OpCost(self.cost.n, unmarked=self._unmarked) as bwd:
                    torch.autograd.grad(
                        diff, need, [torch.empty_like(o) for o in diff],
                        allow_unused=True)
                rec["bwd"] = bwd.cost
        return rec

    def _live_now(self) -> Fraction:
        own = max((v for k, v in self._live.items() if isinstance(k, int)),
                  default=0)
        return (Fraction(own + self._live.get(ALL, 0))
                + Fraction(self._live.get(EVEN, 0), self.cost.n))

    def repeat(self, fn, tensors, key):
        grad = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in tensors)
        full = (key, grad, self.cost.n, self._unmarked,
                torch.backends.cuda.matmul.allow_tf32,
                tuple((tuple(t.shape), t.dtype, t.requires_grad)
                      for t in tensors))
        rec = _REPEATS.get(full)
        if rec is None:
            rec = _REPEATS[full] = self._measure(fn, tensors, grad)
        if grad:
            return _Replay.apply(rec, *tensors)
        self.book(rec["fwd"], rec["fwd"].peak)
        return tuple(torch.empty(s, dtype=d, device=_META)
                     for s, d in rec["outs"])

    def add_arguments(self, held: Iterable) -> None:
        """Declare arguments live from the start: ``(tensor, bytes)``
        pairs held by every position, or ``(tensor, bytes, position)``
        held by one.  (``cost.args``, the bytes a position's arguments
        take, is the caller's to set.)"""
        for t, n, *at in held:
            bucket = at[0] if at else ALL
            self._hold(t, bucket, n)
            self._args[t.untyped_storage()._cdata] = int(n)
            self._check_peak(bucket)

    def unread_arguments(self) -> int:
        """Bytes of the arguments no op read (``jax.jit`` prunes such
        arguments from an executable)."""
        return sum(n for k, n in self._args.items() if k not in self._read)

    # ---- collectives
    def _collective(self, op, out_bytes, group, positions, axes, param):
        if positions is None:
            p = mesh_lib.current_position()
            positions = [ALL if p is None else p]
        if self._unmarked == ALL:
            positions = [ALL]
        for p in positions:
            self.cost.add_collective(p, op, out_bytes, group, axes)
        if param:
            self.cost.gathered.add(param)

    # ---- hand kernels
    def kernel(self, plain, args, ops, nbytes, scratch, unit):
        self._in_kernel = True
        try:
            out = plain(*args)
        finally:
            self._in_kernel = False
        bucket = self._bucket()
        self.cost.add(bucket, f"unit/{unit}", int(ops))
        self.cost.add(bucket, "hbm", int(nbytes))
        for t in _tensors(out):
            self._hold(t, bucket)
        self._check_peak(bucket, int(scratch))
        return out

    # ---- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.device.type == "meta" for t in ins + outs):
            return out                          # host work: not the card's
        packet = func.overloadpacket
        name = packet.__name__
        bucket = self._bucket()
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        elif name in _MORE_FLOPS:
            flops = int(_MORE_FLOPS[name](*args))
        elif (func.is_view or torch.Tag.pointwise in func.tags
              or name in _NO_ARITH):
            flops = 0
        else:
            raise NotImplementedError(f"op_cost: no cost rule for {func}")
        b = self.cost.buckets[bucket]
        b["flops"] += flops
        if self._in_kernel:
            return out
        if flops:
            b[f"unit/{matmul_unit(ins[0].dtype)}"] += flops
        b["hbm"] += self._bytes(func, name, ins, outs)
        for t in ins:
            key = t.untyped_storage()._cdata
            if key in self._args:
                self._read.add(key)
            elif key not in self._known:
                self._hold(t, EVEN, 0)          # made outside the trace
        fresh = False
        for t in outs:
            if t.untyped_storage()._cdata not in self._known:
                self._hold(t, bucket)
                fresh = True
        if fresh:
            self._check_peak(bucket)
        return out

    @staticmethod
    def _bytes(func, name, ins, outs) -> int:
        if func.is_view or name in _FREE:
            return 0
        if name in _GATHERS:
            return (2 * sum(_nbytes(t) for t in outs)
                    + sum(_nbytes(t) for t in ins[1:]))
        if name in _SCATTERS_INPLACE:
            src = [_nbytes(t) for t in ins[1:] if t.dtype == ins[0].dtype]
            return sum(_nbytes(t) for t in ins[1:]) + max(src, default=0)
        seen, total = set(), 0
        for t in ins + outs:
            key = (t.untyped_storage()._cdata, t.storage_offset(),
                   tuple(t.shape), t.stride())
            if key not in seen:
                seen.add(key)
                total += _nbytes(t)
        return total

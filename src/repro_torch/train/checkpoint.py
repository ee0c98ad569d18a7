"""Checkpoint manager: atomic, async-capable (port of
``repro.train.checkpoint``).

  * **atomic**: writes go to ``step_N.tmp/`` and are renamed to
    ``step_N/`` only after fsync — a killed job never leaves a torn
    checkpoint; restore picks the newest complete step and ignores
    ``.tmp``.  ``keep`` bounds the steps kept (the oldest go first).
  * **async**: ``save(..., blocking=False)`` copies every leaf to host
    memory first (the train step updates the card's tensors in place, so
    the copy is the snapshot), then writes on a thread; a pending write
    is joined before the next one, and ``wait`` (or the next ``save``)
    raises what a failed write raised.
  * **unsharded**: leaves are stored as numpy arrays (one ``.npz``) under
    the tree's paths (``tree.keystr``, the reference's keys), the keys in
    ``meta.json``; ``restore(template, device=...)`` rebuilds the
    template's structure and puts every leaf on ``device``.  A template
    leaf may be a tensor on the ``meta`` device (no allocation); an
    ``nn.Module`` in the template comes back as a copy of it with the
    stored parameters.  bfloat16 leaves are stored as their int16 bits
    (numpy has no bfloat16), their dtype in ``meta.json``.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..core.engine.peel_loop import resolve_device
from .tree import keystr, leaves_with_paths

__all__ = ["CheckpointManager"]

_SEP = "__"


def _host(leaf):
    """A host copy of one leaf as (numpy array, torch dtype name or
    None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), None
    return np.array(leaf), None


def _flatten(tree):
    flat, dtypes = {}, {}
    for path, leaf in leaves_with_paths(tree):
        key = keystr(path)
        flat[key], dt = _host(leaf)
        if dt is not None:
            dtypes[key] = dt
    return flat, dtypes


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------ save ------------------------------ #
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        # snapshot to host memory first (a copy: the card's leaves change)
        flat, dtypes = _flatten(tree)
        self.wait()
        if blocking:
            self._write(step, flat, dtypes)
        else:
            t = threading.Thread(target=self._write_async,
                                 args=(step, flat, dtypes))
            t.start()
            self._thread = t

    def _write_async(self, step, flat, dtypes):
        try:
            self._write(step, flat, dtypes)
        except Exception as e:           # raised again by wait()
            self._error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               dtypes: Dict[str, str]):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = os.path.join(tmp, "arrays.npz")
        with open(arrays, "wb") as f:
            np.savez(f, **{k.replace("/", _SEP): v for k, v in flat.items()})
            f.flush()
            os.fsync(f.fileno())
        meta = {
            "step": step,
            "keys": list(flat.keys()),
            "dtypes": dtypes,
            "time": time.time(),
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ----------------------------- restore ---------------------------- #
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, *, step: Optional[int] = None,
                device=None) -> Any:
        """Restore into the structure of ``template``, every leaf a tensor
        on ``device`` (None: the card), in its template leaf's dtype where
        that is a tensor."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        dev = resolve_device(device)
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            dtypes = json.load(f).get("dtypes", {})
        data = np.load(os.path.join(path, "arrays.npz"))

        def load(key, like):
            t = torch.from_numpy(np.array(data[key.replace("/", _SEP)]))
            if dtypes.get(key) == "bfloat16":
                t = t.view(torch.bfloat16)
            if isinstance(like, torch.Tensor):
                return t.to(device=dev, dtype=like.dtype)
            return t.to(dev)

        def build(node, prefix):
            if isinstance(node, nn.Module):
                mod = copy.deepcopy(node).to_empty(device=dev)
                with torch.no_grad():
                    for (p, _), (_, q) in zip(leaves_with_paths(node, prefix),
                                              leaves_with_paths(mod, prefix)):
                        q.copy_(load(keystr(p), q))
                return mod
            if isinstance(node, dict):
                return {k: build(v, prefix + (k,)) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                out = [build(v, prefix + (i,)) for i, v in enumerate(node)]
                return type(node)(out) if isinstance(node, tuple) else out
            return load(keystr(prefix), node)

        return build(template, ())

    def wait(self):
        """Join the pending async write; its failure, if any, raises
        here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

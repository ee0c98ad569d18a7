"""Trees of tensors: the train state's structure, the port's stand-in for
``jax.tree_util`` over nested dicts, lists and tuples.

An ``nn.Module`` is read as the tree of its named parameters, each name
split at its dots, integer parts as list indices: ``user_tables.0`` is
``['user_tables'][0]`` and ``user_mlp.layers.0.w`` is
``['user_mlp']['layers'][0]['w']``, the reference's own paths for the same
parameters.  ``keystr`` renders a path as ``jax.tree_util.keystr`` does,
so checkpoint keys match the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn

__all__ = ["leaves_with_paths", "keystr", "nest", "map_leaves",
           "map_with_paths"]

Path = Tuple[Any, ...]


def _split(name: str) -> Path:
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def leaves_with_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """Every leaf of ``tree`` with its path, depth first in insertion
    order (a module: ``named_parameters`` order)."""
    if isinstance(tree, nn.Module):
        return [(prefix + _split(n), p) for n, p in tree.named_parameters()]
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves_with_paths(v, prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def keystr(path: Path) -> str:
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]"
                   for p in path)


def nest(pairs: List[Tuple[Path, Any]]) -> Any:
    """Nested dicts from (path, value) pairs; a level whose keys are all
    ints becomes a list."""
    if len(pairs) == 1 and pairs[0][0] == ():
        return pairs[0][1]
    groups: Dict[Any, List[Tuple[Path, Any]]] = {}
    for path, v in pairs:
        groups.setdefault(path[0], []).append((path[1:], v))
    if all(isinstance(k, int) for k in groups):
        return [nest(groups[k]) for k in sorted(groups)]
    return {k: nest(v) for k, v in groups.items()}


def map_leaves(fn: Callable, tree) -> Any:
    """``fn`` over every leaf; a module maps to the nested dicts of its
    parameters' paths (the reference's param tree)."""
    if isinstance(tree, torch.Tensor) or not isinstance(
            tree, (nn.Module, dict, list, tuple)):
        return fn(tree)
    return nest([(p, fn(v)) for p, v in leaves_with_paths(tree)])


def map_with_paths(fn: Callable, tree) -> Any:
    """``fn(path, leaf)`` over every leaf, the result nested as the tree
    (a module maps to the nested dicts of its parameters' paths)."""
    return nest([(p, fn(p, v)) for p, v in leaves_with_paths(tree)])

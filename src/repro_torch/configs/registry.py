"""Arch registry: ``get_bundle(arch_id)`` for full or reduced configs
(port of ``repro.configs.registry``).

``ALL_ARCHS`` holds the reference's 10 assigned architectures in its
order: the five language models, the four GNNs, the recsys family.  The
paper's own distributed RECEIPT cells (arch id ``"receipt-tip"``,
``configs/receipt_tip.py``) are handled by ``launch/dryrun.py``'s
receipt path.  An arch that is not here raises ``KeyError``, as in the
reference.
"""
from __future__ import annotations

from typing import List

from . import (
    command_r_plus_104b,
    deepseek_67b,
    deepseek_v2_236b,
    deepseek_v3_671b,
    dimenet,
    graphcast,
    graphsage_reddit,
    meshgraphnet,
    minitron_8b,
    two_tower_retrieval,
)
from .families import (Bundle, make_gnn_bundle, make_lm_bundle,
                       make_recsys_bundle)

_LM = {
    m.ARCH_ID: m
    for m in (
        command_r_plus_104b,
        minitron_8b,
        deepseek_67b,
        deepseek_v2_236b,
        deepseek_v3_671b,
    )
}
_GNN = {
    m.ARCH_ID: m for m in (meshgraphnet, graphsage_reddit, dimenet, graphcast)
}
_REC = {two_tower_retrieval.ARCH_ID: two_tower_retrieval}

ALL_ARCHS: List[str] = list(_LM) + list(_GNN) + list(_REC)


def get_bundle(arch_id: str, *, reduced: bool = False) -> Bundle:
    if arch_id in _LM:
        m = _LM[arch_id]
        cfg = m.reduced_config() if reduced else m.full_config()
        return make_lm_bundle(arch_id, cfg, m.opt_config())
    if arch_id in _GNN:
        m = _GNN[arch_id]
        cfg = m.reduced_config() if reduced else m.full_config()
        return make_gnn_bundle(arch_id, cfg, m.opt_config())
    if arch_id in _REC:
        m = _REC[arch_id]
        cfg = m.reduced_config() if reduced else m.full_config()
        return make_recsys_bundle(arch_id, cfg, m.opt_config())
    raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCHS}")


def shapes_for(arch_id: str) -> List[str]:
    return list(get_bundle(arch_id, reduced=True).shapes)

"""Arch registry: ``get_bundle(arch_id)`` for full or reduced configs
(port of ``repro.configs.registry``).

``ALL_ARCHS`` holds the architectures the port has, in the reference's
order: the five language models and the recsys family (ROADMAP.md,
queue 1, has the GNNs).  An arch that is not here raises ``KeyError``,
as in the reference.
"""
from __future__ import annotations

from typing import List

from . import (
    command_r_plus_104b,
    deepseek_67b,
    deepseek_v2_236b,
    deepseek_v3_671b,
    minitron_8b,
    two_tower_retrieval,
)
from .families import Bundle, make_lm_bundle, make_recsys_bundle

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
_REC = {two_tower_retrieval.ARCH_ID: two_tower_retrieval}

ALL_ARCHS: List[str] = list(_LM) + list(_REC)


def get_bundle(arch_id: str, *, reduced: bool = False) -> Bundle:
    if arch_id in _LM:
        m = _LM[arch_id]
        cfg = m.reduced_config() if reduced else m.full_config()
        return make_lm_bundle(arch_id, cfg, m.opt_config())
    if arch_id in _REC:
        m = _REC[arch_id]
        cfg = m.reduced_config() if reduced else m.full_config()
        return make_recsys_bundle(arch_id, cfg, m.opt_config())
    raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCHS}")


def shapes_for(arch_id: str) -> List[str]:
    return list(get_bundle(arch_id, reduced=True).shapes)

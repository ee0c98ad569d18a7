"""Exact tip numbers past 2^24 on the CPU (the port's plain versions).

The port sums every support from ``C(W, 2)`` on in float64 (DESIGN.md
section 8, the port's paragraph), so its tip numbers stay exact while the
supports pass 2^24, where float32 integers stop.  Each graph here is a
seeded random dense-ish bipartite graph small enough for the CPU whose
supports run to 2-5 x 10^7, and each is first shown to defeat float32:
its exact int64 supports, rounded through float32, merge two distinct
values or move one, so a program that carried them in float32 would fail
these tests.  ``Executor.decompose`` must then return exactly the int64
bottom-up peel of ``core.peeling.bup_oracle`` on both plain backends,
both CD dispatches and both sides.

Past a route's exact limit the run is refused: ``PlanInfeasibleError``
(``dispatch="decompose"``) and no tip numbers.  Kernel 6's tiled route
stays float32 (limit 2^24); a stub limit exercises the float64 routes'
refusal.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.api import EngineConfig, Executor
from repro_torch.api.errors import PlanInfeasibleError
from repro_torch.core.engine import (EXACT_LIMIT, F32_EXACT_LIMIT,
                                     ReceiptConfig, parb_tip_decompose,
                                     peel_loop, tip_decompose)
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.peeling import bup_oracle, shared_butterfly_matrix

CPU = torch.device("cpu")

# (rows, columns, density, seed): the peeled side has the rows
GRAPHS = [(24, 6000, 0.5, 11), (32, 5000, 0.5, 12), (40, 7000, 0.4, 13)]


def _graph(rows, cols, density, seed, side="U") -> BipartiteGraph:
    """A seeded 0/1 graph whose peeled side (``side``) has ``rows``
    vertices and the other ``cols``."""
    rng = np.random.default_rng(seed)
    eu, ev = np.nonzero(rng.random((rows, cols)) < density)
    if side == "V":
        return BipartiteGraph.from_edges(cols, rows, ev, eu)
    return BipartiteGraph.from_edges(rows, cols, eu, ev)


def _peeled(g: BipartiteGraph, side: str) -> BipartiteGraph:
    return g.transposed() if side == "V" else g


def _exact_supports(g: BipartiteGraph) -> np.ndarray:
    return shared_butterfly_matrix(g).sum(axis=1)


def _defeats_float32(sup: np.ndarray) -> bool:
    """Whether float32 rounding moves one of the int64 supports or merges
    two distinct ones."""
    rounded = sup.astype(np.float32).astype(np.int64)
    return bool((rounded != sup).any()
                or len(np.unique(rounded)) < len(np.unique(sup)))


@pytest.mark.parametrize("shape", GRAPHS)
def test_graphs_pass_2_24_and_defeat_float32(shape):
    """Every graph of this file has supports past 2^24 (up to 5 x 10^7)
    that float32 cannot hold."""
    sup = _exact_supports(_graph(*shape))
    assert sup.max() >= 2 ** 24
    assert sup.max() < 6 * 10 ** 7
    assert _defeats_float32(sup)
    theta, _ = bup_oracle(_graph(*shape))
    assert theta.max() >= 2 ** 24


@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("shape", GRAPHS)
def test_executor_exact_past_2_24(shape, backend, dispatch, side):
    """``Executor.decompose`` equals the int64 oracle on graphs past 2^24,
    on both plain backends, both CD dispatches and both sides; the count
    it read is the oracle's largest support, below the float64 limit."""
    g = _graph(*shape, side=side)
    want, _ = bup_oracle(_peeled(g, side))
    sup = _exact_supports(_peeled(g, side))
    assert _defeats_float32(sup)
    cfg = EngineConfig(side=side, backend=backend, cd_dispatch=dispatch,
                       num_partitions=4, representation="dense")
    td = Executor(cfg, device=CPU).decompose(g)
    assert td.theta.dtype == np.int64
    assert np.array_equal(td.theta, want)
    assert td.stats.trace.max_support == float(sup.max())
    assert td.stats.trace.calls["count"] == 1
    assert td.stats.trace.wide_bytes > 0


@pytest.mark.parametrize("fd_mode", ["b2", "matvec"])
def test_legacy_fd_modes_exact_past_2_24(fd_mode):
    """The sequential FD comparators carry float64 supports too."""
    g = _graph(*GRAPHS[0])
    want, _ = bup_oracle(g)
    cfg = ReceiptConfig(backend="torch", num_partitions=4, fd_mode=fd_mode)
    theta, _stats = tip_decompose(g, cfg, device=CPU)
    assert np.array_equal(theta, want)


@pytest.mark.parametrize("device_loop", [True, False])
def test_parb_exact_past_2_24(device_loop):
    """ParB's min-peel records theta in the supports' dtype (float64)."""
    g = _graph(*GRAPHS[1])
    want, _ = bup_oracle(g)
    cfg = ReceiptConfig(backend="torch", device_loop=device_loop)
    theta, stats = parb_tip_decompose(g, cfg, device=CPU)
    assert np.array_equal(theta, want)
    assert stats.trace.max_support == float(_exact_supports(g).max())


def test_limits_and_routes():
    """The named limits, and the route each applies to."""
    assert EXACT_LIMIT == 2 ** 53 and F32_EXACT_LIMIT == 2 ** 24
    assert peel_loop.exact_limit("dense") == EXACT_LIMIT
    assert peel_loop.exact_limit("tiled") == F32_EXACT_LIMIT
    assert peel_loop.exact_limit("dense", mesh=object()) == F32_EXACT_LIMIT


def test_tiled_route_refuses_past_2_24():
    """Kernel 6 sums in float32: the tiled route refuses a graph past
    2^24 and returns no numbers; below 2^24 it still answers exactly."""
    g = _graph(*GRAPHS[0])
    cfg = EngineConfig(backend="torch", representation="tiled")
    with pytest.raises(PlanInfeasibleError) as err:
        Executor(cfg, device=CPU).decompose(g)
    assert err.value.dispatch == "decompose"
    assert err.value.context["exact_limit"] == F32_EXACT_LIMIT
    assert err.value.context["max_support"] >= F32_EXACT_LIMIT
    small = _graph(24, 600, 0.5, 21)
    assert _exact_supports(small).max() < F32_EXACT_LIMIT
    td = Executor(cfg, device=CPU).decompose(small)
    assert np.array_equal(td.theta, bup_oracle(small)[0])


@pytest.mark.parametrize("dispatch", ["subset", "graph"])
def test_float64_routes_refuse_at_their_limit(dispatch, monkeypatch):
    """With the float64 limit stubbed just under a graph's largest
    support, ``Executor.decompose`` raises ``PlanInfeasibleError`` after
    the count and returns nothing; at one above it, it answers."""
    g = _graph(*GRAPHS[2])
    top = int(_exact_supports(g).max())
    cfg = EngineConfig(backend="torch", cd_dispatch=dispatch,
                       num_partitions=4, representation="dense")
    monkeypatch.setattr(peel_loop, "EXACT_LIMIT", top)
    with pytest.raises(PlanInfeasibleError) as err:
        Executor(cfg, device=CPU).decompose(g)
    assert err.value.dispatch == "decompose"
    assert err.value.context["max_support"] == float(top)
    assert err.value.context["exact_limit"] == top
    monkeypatch.setattr(peel_loop, "EXACT_LIMIT", top + 1)
    td = Executor(cfg, device=CPU).decompose(g)
    assert np.array_equal(td.theta, bup_oracle(g)[0])


def test_byte_model_counts_eight_byte_supports_and_b2():
    """The memory model behind ``plan.padded_bytes`` and the FD budget
    counts the float64 state exactly: four row vectors (supports, theta,
    a sweep's delta and its capped successor) of 8 bytes, 16 more a row
    than the float32 model's 64, the column state unchanged, and 8-byte
    B2 entries in the stack and in a sweep's gathered B2 rows.  The tiled
    route keeps the float32 row."""
    from repro_torch.api import plan as plan_mod
    from repro_torch.core.engine import fd
    from repro_torch.kernels import butterfly as kbfly

    n, mm, cc, w1 = 3, 512, 1024, 128
    assert fd.ROW_STATE_BYTES == 64 + 4 * 4 == 80
    assert fd.COL_STATE_BYTES == 64 and fd.B2_BYTES == 8
    f32_state = 4 * n * mm * cc + 64 * n * (mm + cc)
    assert fd.fd_state_bytes(n, mm, cc) - f32_state == 16 * n * mm
    # b2 mode, a gathered sweep: its B2 rows outgrow kernel 3's s8 copy
    f32_sweep = 4 * n * w1 * (3 * mm + 2 * cc)
    assert f32_sweep > n * kbfly.count_scratch_bytes(mm, cc)
    f32_update = 4 * n * mm * mm + f32_sweep
    assert (fd.fd_update_bytes(n, mm, cc, w1, True) - f32_update
            == 4 * n * mm * mm + 4 * n * w1 * 3 * mm)
    # b2 mode, the mask form: the B2-sized product is f64 too
    assert (fd.fd_update_bytes(n, mm, cc, mm, True)
            - 2 * 4 * n * mm * mm == 2 * 4 * n * mm * mm)
    # kernel mode moves no B2 entry: unchanged
    assert fd.fd_update_bytes(n, mm, cc, w1, False) == max(
        4 * n * mm * cc + kbfly.peel_scratch_bytes(mm, cc, n),
        4 * n * w1 * cc + kbfly.peel_scratch_bytes(mm, cc, n))
    # the dense CD's row state: 16 bytes a row more; the tiled one's not
    r, c, b = 4096, 2048, 128
    w0 = peel_loop.cd_gather_width(r, b)
    peak = max(kbfly.count_scratch_bytes(r, c),
               4 * w0 * c + kbfly.peel_scratch_bytes(w0, c))
    assert plan_mod._dense_cd_bytes(r, c, b, False) == (
        4 * r * c + peak + (64 + 16) * r + 32 * c)
    assert plan_mod._F32_ROW_STATE_BYTES == 64

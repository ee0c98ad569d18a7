"""The port on the card: each CUDA kernel against its plain version, and
the main paths (dense and staircase backends, both CD dispatches, the
tiled representation, the legacy FD modes and the ParB baseline) against
the exact oracle.

Every test here is marked ``gpu`` and skips without a card (the kernels
have no CPU mode).  The file imports nothing of JAX, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from conftest import make_vhub_graph
from repro_torch.convert import graph_from_arrays
from repro_torch.core import peeling
from repro_torch.core.engine import ReceiptConfig, peel_loop
from repro_torch.core.engine import tiled as engine_tiled
from repro_torch.core.graph import (TiledGraph, paper_fig1_graph,
                                    powerlaw_bipartite, random_bipartite)
from repro_torch.core.receipt import parb_tip_decompose, tip_decompose
from repro_torch.kernels import butterfly as bfly
from repro_torch.kernels import butterfly_sparse as bsp
from repro_torch.kernels import butterfly_tiled as btl
from repro_torch.kernels import ops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _adj(gen, *shape, density=0.3):
    return (torch.rand(*shape, generator=gen) < density).float()


@pytest.mark.gpu
@pytest.mark.parametrize("n_a,n_b,n_v", [(8, 8, 8), (70, 33, 129),
                                         (300, 257, 1000)])
def test_kernels_equal_plain(card, n_a, n_b, n_v):
    """Ragged shapes (no tile multiple) on purpose: the kernels mask the
    edge themselves.  torch.equal: the f32 integer regime is exact."""
    gen = torch.Generator().manual_seed(n_a)
    a = _adj(gen, n_a, n_v).to(card)
    rows = torch.randint(0, n_a, (n_b,), generator=gen).to(card)
    valid = (torch.arange(n_b) < n_b // 2).float().to(card)
    b = a[rows] * valid[:, None]
    ids = torch.arange(n_a, dtype=torch.int32, device=card)
    rows = rows.to(torch.int32)
    assert torch.equal(bfly.butterfly_update(a, b, valid, ids, rows),
                       bfly.butterfly_update_plain(a, b, valid, ids, rows))
    a3 = _adj(gen, 3, n_a, n_v).to(card)
    ids3 = ids.expand(3, n_a).contiguous()
    s3 = (torch.rand(3, n_a, generator=gen) < 0.7).float().to(card)
    assert torch.equal(
        bfly.butterfly_update_batched(a3, a3, s3, ids3, ids3),
        bfly.butterfly_update_batched_plain(a3, a3, s3, ids3, ids3))
    cut = torch.randint(0, n_v + 1, (2, n_a, 1), generator=gen)
    st = (_adj(gen, 2, n_a, n_v) * (torch.arange(n_v) < cut)).to(card)
    for blocks in [(8, 8, 8), (16, 8, 32), (128, 128, 512)]:
        assert torch.equal(ops.b2_stack(st, blocks=blocks),
                           bsp.b2_stack_plain(st, None, None, blocks=blocks))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(32, 32, 64), (128, 128, 512)])
@pytest.mark.parametrize("n_a,n_b,n_v", [(128, 64, 256), (300, 257, 1000)])
def test_sparse_kernels_equal_plain(card, n_a, n_b, n_v, blocks):
    """Kernels 4 and 5 on staircase operands with their real extents
    (upper bounds, so the skip is exact), ragged shapes on purpose."""
    bi, bj, bk = blocks
    gen = torch.Generator().manual_seed(n_v + bk)
    cut = torch.randint(0, n_v + 1, (3, n_a, 1), generator=gen)
    a3 = (_adj(gen, 3, n_a, n_v) * (torch.arange(n_v) < cut)).to(card)
    rows3 = torch.randint(0, n_a, (3, n_b), generator=gen).to(card)
    valid3 = (torch.arange(n_b)[None, :]
              < torch.tensor([[n_b], [n_b // 2], [1]])).float().to(card)
    b3 = torch.take_along_dim(a3, rows3[:, :, None], dim=1) * valid3[..., None]
    ids3 = torch.arange(n_a, dtype=torch.int32, device=card).expand(
        3, n_a).contiguous()
    rows3 = rows3.to(torch.int32)
    row_ext = bsp.row_extents_device(a3, bk)
    ka = bsp.tile_extents(row_ext, bi).to(torch.int32).contiguous()
    kb = bsp.batched_gathered_tile_extents(row_ext, rows3, valid3, bj)
    args = (a3, b3, valid3, ids3, rows3, ka, kb)
    assert torch.equal(bsp.butterfly_update_sparse_batched(*args, blocks=blocks),
                       bsp.butterfly_update_sparse_batched_plain(
                           *args, blocks=blocks))
    args1 = (a3[0], b3[0], valid3[0], ids3[0], rows3[0], ka[0].contiguous(),
             kb[0].contiguous())
    assert torch.equal(bsp.butterfly_update_sparse(*args1, blocks=blocks),
                       bsp.butterfly_update_sparse_plain(*args1,
                                                         blocks=blocks))
    assert torch.equal(bsp.butterfly_update_sparse(*args1, blocks=blocks),
                       bfly.butterfly_update_plain(*args1[:5]))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
def test_sparse_backend_on_card_matches_oracle(card, dispatch):
    ops.reset_launch_counts()
    for g in (paper_fig1_graph(), powerlaw_bipartite(200, 120, 1500, seed=5)):
        for mode in ("b2", "kernel"):
            theta, _ = tip_decompose(g, ReceiptConfig(
                backend="cuda_sparse", cd_dispatch=dispatch,
                fd_update_mode=mode))
            np.testing.assert_array_equal(theta, peeling.bup_oracle(g)[0])
    counts = ops.launch_counts()
    assert counts["butterfly_update_sparse"] > 0
    assert counts["butterfly_update_sparse_batched"] > 0
    assert counts["butterfly_update"] == counts["butterfly_update_batched"] == 0


@pytest.mark.gpu
def test_graph_boundary_never_waits_for_the_card(card, monkeypatch):
    """A subset boundary of the graph loop (DGM, extents, ``w``,
    ``find_hi_device``) makes no synchronizing call on the card — no read
    to the host, no blocking copy from it: CUDA's sync debug mode raises
    on any."""
    boundary = peel_loop._graph_boundary
    calls = []

    def watched(*args, **kwargs):
        calls.append(1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return boundary(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(peel_loop, "_graph_boundary", watched)
    vhub = make_vhub_graph(seed=6)
    g = graph_from_arrays(vhub.n_u, vhub.n_v, vhub.edges_u, vhub.edges_v)
    theta, stats = tip_decompose(g, ReceiptConfig(
        backend="cuda_sparse", cd_dispatch="graph", num_partitions=4))
    np.testing.assert_array_equal(theta, peeling.bup_oracle(g)[0])
    assert len(calls) > 2 and stats.dgm_device_compactions > 0


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse"])
def test_exact_under_tf32_matmul_precision(card, backend):
    """The engine's own products stay full f32 when the caller lets
    PyTorch use TF32 for float32 matrix products: on the V-hub graph, and
    on a dense graph whose pairwise butterfly counts C(W, 2) reach 3003,
    past the integers TF32 holds exactly (2048)."""
    vhub = make_vhub_graph(seed=6)
    graphs = (graph_from_arrays(vhub.n_u, vhub.n_v, vhub.edges_u,
                                vhub.edges_v),
              random_bipartite(200, 150, 0.6, seed=1))
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        for g in graphs:
            want = peeling.bup_oracle(g)[0]
            for dispatch in ("subset", "graph"):
                theta, _ = tip_decompose(g, ReceiptConfig(
                    backend=backend, cd_dispatch=dispatch, num_partitions=4))
                np.testing.assert_array_equal(theta, want)
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.gpu
def test_wide_operand_products_exact_under_tf32(card):
    """TF32 holds integers exactly only up to 2048.  Under
    ``set_float32_matmul_precision("high")`` the engine's products with a
    wider operand — the residual wedge counts ``a @ max(dv - 1, 0)`` and
    the B2 row reductions of the FD level loop — still equal their f64
    values, on operands past 2048 whose sums stay below 2^24.  The
    residual degrees (a product of 0/1 operands) are exact either way."""
    gen = torch.Generator().manual_seed(12)
    a = _adj(gen, 512, 1024, density=0.5).to(card)
    dv = torch.randint(2050, 4097, (1024,), generator=gen).float().to(card)
    alive = (torch.rand(512, generator=gen) < 0.5).to(card)
    b2 = torch.randint(2049, 1 << 15, (4, 256, 256),
                       generator=gen).float().to(card)
    mask = (torch.rand(4, 256, generator=gen) < 0.5).to(card)
    # the wide operands hold odd integers past 2048, which TF32 rounds
    assert bool(((dv - 1.0) % 2 == 1).any()) and bool((dv - 1.0 > 2048).all())
    assert bool(((b2 % 2 == 1) & (b2 > 2048)).any())
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        w = peel_loop.residual_wedges(a, dv)
        b2_sum = peel_loop._masked_rows_sum(b2, mask)
        dv_alive = peel_loop.residual_dv(a, alive)
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(w.double(), a.double() @ (dv.double() - 1.0))
    assert torch.equal(b2_sum.double(), torch.einsum(
        "gm,gmn->gn", mask.double(), b2.double()))
    assert torch.equal(dv_alive.double(), alive.double() @ a.double())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["b2", "kernel"])
def test_main_path_on_card_matches_oracle(card, mode):
    ops.reset_launch_counts()
    vhub = make_vhub_graph(seed=6)
    for g in (paper_fig1_graph(), powerlaw_bipartite(200, 120, 1500, seed=5),
              graph_from_arrays(vhub.n_u, vhub.n_v, vhub.edges_u,
                                vhub.edges_v)):
        theta, _ = tip_decompose(g, ReceiptConfig(fd_update_mode=mode))
        np.testing.assert_array_equal(theta, peeling.bup_oracle(g)[0])
    counts = ops.launch_counts()
    assert counts["butterfly_update"] > 0
    assert counts["butterfly_update_batched"] > 0
    assert (counts["b2_stack"] > 0) == (mode == "b2")


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(8, 8), (64, 64), (128, 512)])
def test_tiled_kernel_equals_plain(card, blocks):
    """Kernel 6 against its plain version on a degree-sorted power-law
    graph's slot list, with filler slots and, after a regather, dead
    slots; masks: zero, one row, 16 rows (the plain version's gathered
    path), sparse and all (its band-streaming path)."""
    br, bk = blocks
    g = powerlaw_bipartite(700, 1300, 9000, seed=3).relabel_by_degree()
    tg = TiledGraph.from_graph(g, block_rows=br, block_k=bk)
    tg = TiledGraph.from_graph(g, block_rows=br, block_k=bk,
                               pad_slots_to=tg.n_slots + 7)
    up = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    td = up(tg.tile_data)
    lists = (up(tg.srow), up(tg.scol), up(tg.sptr), up(tg.pos))
    gen = torch.Generator().manual_seed(br + bk)
    rows = (torch.rand(tg.rows_pad, generator=gen) < 0.6).float()
    rows[br: 2 * br] = 0.0               # band 1 loses every row
    rows = rows.to(card)
    cols = (torch.rand(tg.cols_pad, generator=gen) < 0.6).float().to(card)
    dead = btl.regather_tiles(td.clone(), lists[0], lists[1], rows, cols)
    assert int(dead[1].sum()) < tg.n_slots - 7
    n = tg.rows_pad
    masks = {"zero": torch.zeros(n), "one": torch.zeros(n),
             "w16": torch.zeros(n),
             "sparse": (torch.rand(n, generator=gen) < 0.05).float(),
             "all": (torch.arange(n) < g.n_u).float()}
    masks["one"][n // 3] = 1.0
    masks["w16"][torch.randperm(g.n_u, generator=gen)[:16]] = 1.0
    ops.reset_launch_counts()
    launched = 0
    for tdata, live in ((td, btl.slot_liveness(td)), dead):
        for name, s in masks.items():
            s = s.to(card)
            got = btl.butterfly_update_tiled(tdata, *lists, live, s)
            want = btl.butterfly_update_tiled_plain(tdata, *lists, live, s)
            assert torch.equal(got, want), name
            launched += 1
    torch.cuda.synchronize()
    assert ops.launch_counts()["butterfly_update_tiled"] == launched


@pytest.mark.gpu
def test_tiled_legacy_fd_and_parb_on_card_match_oracle(card):
    """The tiled path (both backend names), ``fd_mode="b2"`` and
    ``"matvec"`` and ParB (both backends) on the card: theta equal to
    ``bup_oracle``, and kernel 6 launched by the tiled path."""
    vhub = make_vhub_graph(seed=6)
    for g in (paper_fig1_graph(), powerlaw_bipartite(200, 120, 1500, seed=5),
              graph_from_arrays(vhub.n_u, vhub.n_v, vhub.edges_u,
                                vhub.edges_v)):
        want = peeling.bup_oracle(g)[0]
        for backend in ("cuda", "cuda_sparse"):
            ops.reset_launch_counts()
            theta, _ = tip_decompose(g, ReceiptConfig(
                backend=backend, representation="tiled",
                tiled_compact_every=8))
            np.testing.assert_array_equal(theta, want)
            assert ops.launch_counts()["butterfly_update_tiled"] > 0
            theta, _ = parb_tip_decompose(g, ReceiptConfig(backend=backend))
            np.testing.assert_array_equal(theta, want)
        for mode in ("b2", "matvec"):
            theta, _ = tip_decompose(g, ReceiptConfig(fd_mode=mode))
            np.testing.assert_array_equal(theta, want)


@pytest.mark.gpu
def test_tiled_sweep_reads_only_through_fetch(card, monkeypatch):
    """A sweep of the tiled path makes no synchronizing call on the card
    beyond its one counted ``fetch``: CUDA's sync debug mode raises on
    any other, and is lifted only inside ``fetch``."""
    sweep, fetch = engine_tiled._tiled_sweep, engine_tiled.fetch
    sweeps = []

    def lifted_fetch(*args, **kwargs):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            return fetch(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def watched(*args, **kwargs):
        sweeps.append(1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return sweep(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(engine_tiled, "fetch", lifted_fetch)
    monkeypatch.setattr(engine_tiled, "_tiled_sweep", watched)
    g = powerlaw_bipartite(200, 120, 1500, seed=5)
    theta, stats = tip_decompose(g, ReceiptConfig(
        representation="tiled", tiled_compact_every=16))
    np.testing.assert_array_equal(theta, peeling.bup_oracle(g)[0])
    assert len(sweeps) > 16
    assert stats.host_round_trips == len(sweeps) + stats.device_loop_calls

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
    want = bfly.butterfly_update_plain(a, b, valid, ids, rows)
    assert torch.equal(bfly.butterfly_update(a, b, valid, ids, rows), want)
    assert torch.equal(bfly.butterfly_update(a, b, valid, ids, rows,
                                             body="tile"), want)
    # the counting form through every body (the peel and tile bodies are
    # right for any operands, s = alive of every row included)
    alive = (torch.rand(n_a, generator=gen) < 0.8).float().to(card)
    want = bfly.butterfly_update_plain(a, a, alive, ids, ids)
    for body in ("count", "peel", "tile"):
        assert torch.equal(bfly.butterfly_update(a, a, alive, ids, ids,
                                                 body=body), want)
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
    want = bsp.butterfly_update_sparse_plain(*args1, blocks=blocks)
    assert torch.equal(bsp.butterfly_update_sparse(*args1, blocks=blocks),
                       want)
    for body in ("peel", "tile"):
        assert torch.equal(bsp.butterfly_update_sparse(*args1, blocks=blocks,
                                                       body=body), want)
    assert torch.equal(want, bfly.butterfly_update_plain(*args1[:5]))
    # the counting form of the same staircase, its shared extents
    a0, k0 = a3[0], ka[0].contiguous()
    s0 = (torch.rand(n_a, generator=gen) < 0.7).float().to(card)
    want = bsp.butterfly_update_sparse_plain(a0, a0, s0, ids3[0], ids3[0],
                                             k0, k0, blocks=blocks)
    for body in ("count", "peel", "tile"):
        assert torch.equal(bsp.butterfly_update_sparse(
            a0, a0, s0, ids3[0], ids3[0], k0, k0, blocks=blocks, body=body),
            want)
    torch.cuda.synchronize()


def _peel_operands(gen, card, n_a, n_b, n_v, n_valid):
    """A gathered peel update as hard as the engine's can be: rows drawn
    with repeats, ``n_valid`` valid ones at random positions (not a
    prefix), a valid row that is all zero, invalid rows that keep their
    content (s = 0 must zero them), global ids (a gathered row meets its
    own A row: the self-pair)."""
    a = _adj(gen, n_a, n_v).to(card)
    rows = torch.randint(0, n_a, (n_b,), generator=gen)
    valid = torch.zeros(n_b)
    valid[torch.randperm(n_b, generator=gen)[:n_valid]] = 1.0
    b = a[rows.to(card)].clone()
    if n_valid:
        b[int(torch.nonzero(valid)[0])] = 0.0
    ids = torch.arange(n_a, dtype=torch.int32, device=card)
    return (a, b, valid.to(card), ids, rows.to(torch.int32).to(card))


@pytest.mark.gpu
@pytest.mark.parametrize("n_valid", [0, 1, 63, 64, 65, 256, 300])
@pytest.mark.parametrize("n_a,n_b,n_v", [(70, 33, 129), (300, 257, 1000),
                                         (130, 300, 64)])
def test_peel_body_equals_plain(card, n_a, n_b, n_v, n_valid):
    """Kernel 1's peel body (int8 tensor cores over the live stripes) on
    ragged shapes (n_a, n_b, n_v not multiples of 16, 8 or 32; rows of
    129 floats are not 16-byte aligned), every count of valid rows up to
    n_b, and against the tile body it replaced; then kernel 4's
    instantiation with full extents.  Each launch is counted under its
    own body's key only."""
    gen = torch.Generator().manual_seed(n_a + n_v + n_valid)
    args = _peel_operands(gen, card, n_a, n_b, n_v, min(n_valid, n_b))
    want = bfly.butterfly_update_plain(*args)
    ops.reset_launch_counts()
    assert torch.equal(bfly.butterfly_update(*args), want)
    assert torch.equal(bfly.butterfly_update(*args, body="tile"), want)
    bk = 32
    ka = torch.full((-(-n_a // 16),), -(-n_v // bk), dtype=torch.int32,
                    device=card)
    kb = torch.full((-(-n_b // 8),), -(-n_v // bk), dtype=torch.int32,
                    device=card)
    assert torch.equal(bsp.butterfly_update_sparse(
        *args, ka, kb, blocks=(16, 8, bk)), want)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["butterfly_update[peel]"] == 1
    assert counts["butterfly_update[tile]"] == 1
    assert counts["butterfly_update_sparse[peel]"] == 1
    assert sum(counts.values()) == 3


def _count_operands(gen, card, n, n_v):
    """A counting form as hard as the engine's can be: a degree-sorted
    staircase with all-zero rows, s with zeros (dead rows on both sides
    of a tile pair), distinct ids that are not the row positions.  The
    density is 0.3, and 0.25 on the largest shape (1024 x 4097), whose
    supports pass 2^24 at 0.3: every support stays below 2^24, where
    float32 sums are exact in any order (DESIGN.md section 8)."""
    cut = torch.randint(0, n_v + 1, (n, 1), generator=gen).sort(
        dim=0, descending=True).values
    density = 0.25 if n * n_v > 1 << 22 else 0.3
    a = _adj(gen, n, n_v, density=density) * (torch.arange(n_v) < cut)
    a[torch.rand(n, generator=gen) < 0.1] = 0.0
    s = (torch.rand(n, generator=gen) < 0.7).float()
    ids = (torch.randperm(n, generator=gen) + 5).to(torch.int32)
    return a.to(card), s.to(card), ids.to(card)


@pytest.mark.gpu
@pytest.mark.parametrize("n_v", [1, 33, 777, 4097])
@pytest.mark.parametrize("n", [1, 127, 129, 300, 1024])
def test_count_body_equals_plain(card, n, n_v):
    """The count body of kernels 1 and 4 (int8 wgmma over the 128-row
    tile pairs I <= J, fed by TMA) against the plain versions on ragged
    shapes (n and n_v not multiples of 128; rows of 33 or 777 floats are
    not 16-byte aligned); then kernel 4's instantiation with the
    staircase's own extents at bi = 8, 16 and 128 (tiles that divide the
    body's 128 rows or are them) and bk = 16, 64, 512.  Each launch is
    counted under the count key only."""
    gen = torch.Generator().manual_seed(7 * n + n_v)
    a, s, ids = _count_operands(gen, card, n, n_v)
    want = bfly.butterfly_update_plain(a, a, s, ids, ids)
    # the operands stay in the exact regime: the plain version equals a
    # float64 count, every support below 2^24
    w64 = a.double() @ a.double().T
    b2 = (w64 * (w64 - 1) / 2).fill_diagonal_(0)
    exact = (b2 * s.double()[None, :]).sum(dim=1)
    assert float(exact.max()) < 2 ** 24
    assert torch.equal(want.double(), exact)
    ops.reset_launch_counts()
    assert torch.equal(bfly.butterfly_update(a, a, s, ids, ids,
                                             body="count"), want)
    for bi, bk in ((8, 16), (16, 64), (128, 512)):
        blocks = (bi, bi, bk)
        kmax = bsp.column_extents(a, bi, bk).to(torch.int32).contiguous()
        assert torch.equal(bsp.butterfly_update_sparse_plain(
            a, a, s, ids, ids, kmax, kmax, blocks=blocks), want)
        assert torch.equal(bsp.butterfly_update_sparse(
            a, a, s, ids, ids, kmax, kmax, blocks=blocks, body="count"),
            want)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["butterfly_update[count]"] == 1
    assert counts["butterfly_update_sparse[count]"] == 3
    assert sum(counts.values()) == 4


@pytest.mark.gpu
def test_count_body_rejects_other_operands(card):
    """``body="count"`` with B not A (a copy, a slice, other ids or
    other extents) raises before any launch; it is never rerouted."""
    gen = torch.Generator().manual_seed(2)
    a, s, ids = _count_operands(gen, card, 200, 300)
    k = bsp.column_extents(a, 16, 32).to(torch.int32).contiguous()
    ops.reset_launch_counts()
    for args in ((a, a.clone(), s, ids, ids), (a, a, s, ids, ids.clone()),
                 (a, a[:100], s[:100], ids, ids[:100])):
        with pytest.raises(ValueError, match="counting form"):
            bfly.butterfly_update(*args, body="count")
    with pytest.raises(ValueError, match="counting form"):
        bsp.butterfly_update_sparse(a, a, s, ids, ids, k, k.clone(),
                                    blocks=(16, 16, 32), body="count")
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.gpu
def test_each_body_counts_only_its_own_launches(card):
    """Kernels 1 and 4 count each body's launches under its own key
    (``[count]``, ``[peel]``, ``[tile]``), and every body gives the plain
    version's bits on the counting form."""
    gen = torch.Generator().manual_seed(3)
    a, s, ids = _count_operands(gen, card, 300, 1000)
    blocks = (16, 16, 32)
    k = bsp.column_extents(a, 16, 32).to(torch.int32).contiguous()
    want = bfly.butterfly_update_plain(a, a, s, ids, ids)
    ops.reset_launch_counts()
    times = {"count": 1, "peel": 2, "tile": 3}
    for body, reps in times.items():
        for _ in range(reps):
            assert torch.equal(bfly.butterfly_update(a, a, s, ids, ids,
                                                     body=body), want)
            assert torch.equal(bsp.butterfly_update_sparse(
                a, a, s, ids, ids, k, k, blocks=blocks, body=body), want)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for body, reps in times.items():
        assert counts[f"butterfly_update[{body}]"] == reps
        assert counts[f"butterfly_update_sparse[{body}]"] == reps
    assert sum(counts.values()) == 2 * sum(times.values())


def _stack_operands(gen, card, g_n, m, n_v):
    """A stack as the FD level loop builds them: each group a
    degree-sorted staircase with all-zero rows; group 1 (when there is
    one) all zero."""
    cut = torch.randint(0, n_v + 1, (g_n, m, 1), generator=gen).sort(
        dim=1, descending=True).values
    a = _adj(gen, g_n, m, n_v) * (torch.arange(n_v) < cut)
    a[torch.rand(g_n, m, generator=gen) < 0.1] = 0.0
    if g_n > 1:
        a[1] = 0.0
    return a.to(card)


@pytest.mark.gpu
@pytest.mark.parametrize("n_v", [33, 1000])
@pytest.mark.parametrize("m", [1, 33, 128, 777])
@pytest.mark.parametrize("g_n", [1, 3, 16])
def test_b2_pairs_body_equals_plain(card, g_n, m, n_v):
    """Kernel 3's pairs body (int8 wgmma over each group's 128-row tile
    pairs I <= J, both triangles written) against the plain version on
    ragged shapes (m and n_v not multiples of 128; odd m takes the
    single-column stores; rows of 33 floats are not 16-byte aligned),
    with each group's real extents at square tiles and at bi != bj (the
    B side rebuilt at bj from the same per-row bound, as ``ops.b2_stack``
    does), and with all-zero extents over an all-zero stack; then the
    tile body it replaced.  Each launch is counted under its own body's
    key only."""
    gen = torch.Generator().manual_seed(100 * g_n + m + n_v)
    a = _stack_operands(gen, card, g_n, m, n_v)
    want = bsp.b2_stack_plain(a, None, None, blocks=None)
    ops.reset_launch_counts()
    launched = 0
    for blocks in [(128, 128, 512), (8, 8, 16), (16, 64, 32), (64, 8, 128)]:
        bi, bj, bk = blocks
        row_ext = bsp.row_extents_device(a, bk)
        ka = bsp.tile_extents(row_ext, bi).to(torch.int32).contiguous()
        kb = bsp.tile_extents(row_ext, bj).to(torch.int32).contiguous()
        assert torch.equal(bsp.b2_stack(a, ka, kb, blocks=blocks), want)
        assert torch.equal(ops.b2_stack(a, blocks=blocks), want)
        launched += 2
    zero = torch.zeros_like(a)
    ka = torch.zeros((g_n, -(-m // 16)), dtype=torch.int32, device=card)
    kb = torch.zeros((g_n, -(-m // 8)), dtype=torch.int32, device=card)
    assert torch.equal(bsp.b2_stack(zero, ka, kb, blocks=(16, 8, 32)),
                       bsp.b2_stack_plain(zero, ka, kb, blocks=(16, 8, 32)))
    launched += 1
    ka = bsp.column_extents(a, 16, 64).to(torch.int32).contiguous()
    assert torch.equal(bsp.b2_stack(a, ka, ka, blocks=(16, 16, 64),
                                    body="tile"), want)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["b2_stack[pairs]"] == launched
    assert counts["b2_stack[tile]"] == 1
    assert sum(counts.values()) == launched + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_v", [33, 1000])
@pytest.mark.parametrize("m", [1, 33, 128, 777])
@pytest.mark.parametrize("g_n", [1, 3, 16])
def test_stack_peel_body_equals_plain(card, g_n, m, n_v):
    """The stack form of the peel body (kernels 2 and 5: the peel body
    over G groups, four stripes a K-stage) against the plain versions on
    ragged shapes: the gathered form (up to 128 gathered rows with
    repeats, each group its own count of valid rows at random positions,
    group 0 none, invalid rows that keep their content, gathered ids from
    past the group's rows as the FD first-level delta has them, and the
    gathered rows' own ids as the level loop has them), and the full-mask
    form (B = A, s = a peel mask); kernel 5 with the real per-group
    extents, with all-zero extents, and at bi != bj; then the tile body
    on the same operands.  Each launch is counted under its own body's
    key only."""
    gen = torch.Generator().manual_seed(7 * g_n + 3 * m + n_v)
    a = _stack_operands(gen, card, g_n, m, n_v)
    w = min(128, 2 * m)
    rows = torch.randint(0, m, (g_n, w), generator=gen)
    valid = torch.zeros(g_n, w)
    for g in range(1, g_n):
        valid[g, torch.randperm(w, generator=gen)[:int(
            torch.randint(1, w + 1, (1,), generator=gen))]] = 1.0
    b = torch.take_along_dim(a, rows.to(card)[:, :, None], dim=1)
    ids = torch.arange(m, dtype=torch.int32, device=card).expand(
        g_n, m).contiguous()
    peel = (torch.rand(g_n, m, generator=gen) < 0.3).float().to(card)
    valid, rows = valid.to(card), rows.to(torch.int32).to(card)
    forms = {
        "gathered": (b, valid, rows),
        "first_level": (b, valid, (m + torch.arange(
            w, dtype=torch.int32, device=card)).expand(g_n, w).contiguous()),
        "full_mask": (a, peel, ids),
    }
    ops.reset_launch_counts()
    peel_launches = 0
    for name, (bb, s, ids_b) in forms.items():
        args = (a, bb, s, ids, ids_b)
        want = bfly.butterfly_update_batched_plain(*args)
        assert torch.equal(bfly.butterfly_update_batched(*args), want), name
        assert torch.equal(bfly.butterfly_update_batched(*args, body="tile"),
                           want), name
        peel_launches += 1
        for blocks in [(32, 32, 64), (128, 128, 512), (16, 64, 32)]:
            bi, bj, bk = blocks
            row_ext = bsp.row_extents_device(a, bk)
            ka = bsp.tile_extents(row_ext, bi).to(torch.int32).contiguous()
            kb = bsp.tile_extents(
                bsp.row_extents_device(bb, bk), bj).to(torch.int32)
            kb = kb.contiguous()
            for ext in ((ka, kb), (torch.zeros_like(ka),
                                   torch.zeros_like(kb))):
                want5 = bsp.butterfly_update_sparse_batched_plain(
                    *args, *ext, blocks=blocks)
                assert torch.equal(bsp.butterfly_update_sparse_batched(
                    *args, *ext, blocks=blocks), want5), (name, blocks)
                peel_launches += 1
            assert torch.equal(want5, torch.zeros_like(want5))
        assert torch.equal(bsp.butterfly_update_sparse_batched(
            *args, ka, kb, blocks=blocks, body="tile"),
            bsp.butterfly_update_sparse_batched_plain(
                *args, ka, kb, blocks=blocks)), name
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["butterfly_update_batched[peel]"] == len(forms)
    assert counts["butterfly_update_batched[tile]"] == len(forms)
    assert (counts["butterfly_update_sparse_batched[peel]"]
            == peel_launches - len(forms))
    assert counts["butterfly_update_sparse_batched[tile]"] == len(forms)
    assert sum(counts.values()) == peel_launches + 2 * len(forms)


@pytest.mark.gpu
def test_each_stack_body_counts_only_its_own_launches(card):
    """Kernels 2, 3 and 5 count each body's launches under its own key
    (``[peel]`` / ``[tile]``, ``[pairs]`` / ``[tile]``), every body gives
    the plain version's bits, and a body a stack does not take raises
    before any launch."""
    gen = torch.Generator().manual_seed(4)
    a = _stack_operands(gen, card, 3, 300, 1000)
    ids = torch.arange(300, dtype=torch.int32, device=card).expand(
        3, 300).contiguous()
    s = (torch.rand(3, 300, generator=gen) < 0.5).float().to(card)
    blocks = (16, 16, 32)
    k = bsp.column_extents(a, 16, 32).to(torch.int32).contiguous()
    want = bfly.butterfly_update_batched_plain(a, a, s, ids, ids)
    want3 = bsp.b2_stack_plain(a, k, k, blocks=blocks)
    ops.reset_launch_counts()
    times = {"peel": 1, "tile": 2}
    for body, reps in times.items():
        for _ in range(reps):
            assert torch.equal(bfly.butterfly_update_batched(
                a, a, s, ids, ids, body=body), want)
            assert torch.equal(bsp.butterfly_update_sparse_batched(
                a, a, s, ids, ids, k, k, blocks=blocks, body=body), want)
    times3 = {"pairs": 3, "tile": 1}
    for body, reps in times3.items():
        for _ in range(reps):
            assert torch.equal(bsp.b2_stack(a, k, k, blocks=blocks,
                                            body=body), want3)
    for bad in ("count", "dense"):
        with pytest.raises(ValueError, match="body"):
            bfly.butterfly_update_batched(a, a, s, ids, ids, body=bad)
        with pytest.raises(ValueError, match="body"):
            bsp.butterfly_update_sparse_batched(a, a, s, ids, ids, k, k,
                                                blocks=blocks, body=bad)
        with pytest.raises(ValueError, match="body"):
            bsp.b2_stack(a, k, k, blocks=blocks, body=bad)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for body, reps in times.items():
        assert counts[f"butterfly_update_batched[{body}]"] == reps
        assert counts[f"butterfly_update_sparse_batched[{body}]"] == reps
    for body, reps in times3.items():
        assert counts[f"b2_stack[{body}]"] == reps
    assert sum(counts.values()) == (2 * sum(times.values())
                                    + sum(times3.values()))


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
    assert counts["butterfly_update_sparse[count]"] > 0
    assert counts["butterfly_update_sparse[peel]"] > 0
    assert counts["butterfly_update_sparse_batched[peel]"] > 0
    assert counts["b2_stack[pairs]"] > 0
    assert (counts["butterfly_update[count]"] == counts["butterfly_update[peel]"]
            == counts["butterfly_update_batched[peel]"] == 0)
    assert not any(counts[k] for k in counts if k.endswith("[tile]"))


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
    assert counts["butterfly_update[count]"] > 0
    assert counts["butterfly_update[peel]"] > 0
    assert counts["butterfly_update_batched[peel]"] > 0
    assert (counts["b2_stack[pairs]"] > 0) == (mode == "b2")
    assert not any(counts[k] for k in counts if k.endswith("[tile]"))


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(8, 8), (64, 64), (128, 512)])
def test_tiled_kernel_equals_plain(card, blocks):
    """Kernel 6's two bodies against its plain version on a degree-sorted
    power-law graph's slot list, with filler slots and, after a regather,
    dead slots and dead partners; masks: zero, one row, 16 and 17 rows
    (one and two chunks of the peel body), 300 rows, rows of one band,
    rows across bands, sparse and all.  The peel body given no size (every
    row), the mask's size, a size above it, and the mask's size with a
    scratch cap of one chunk (one launch per 16-row window); the count
    body; each launch counted under its own body's key only."""
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
    n_ct = tg.n_col_tiles
    masks = {"zero": torch.zeros(n), "sparse":
             (torch.rand(n, generator=gen) < 0.05).float(),
             "all": (torch.arange(n) < g.n_u).float()}
    for name, width in (("one", 1), ("w16", 16), ("w17", 17), ("w300", 300)):
        masks[name] = torch.zeros(n)
        masks[name][torch.randperm(g.n_u, generator=gen)[:width]] = 1.0
    masks["one_band"] = torch.zeros(n)
    masks["one_band"][2 * br: 2 * br + min(br, 5)] = 1.0
    masks["across"] = torch.zeros(n)
    masks["across"][torch.arange(3, g.n_u, max(1, g.n_u // 12))] = 1.0
    ops.reset_launch_counts()
    launched = {"count": 0, "peel": 0}
    for tdata, live in ((td, btl.slot_liveness(td)), dead):
        default_cap = 4 * tdata.numel()
        for name, s in masks.items():
            s = s.to(card)
            n_s = int((s != 0).sum())
            want = btl.butterfly_update_tiled_plain(tdata, *lists, live, s)
            for n_srows, cap in ((None, None), (n_s, None), (n_s + 40, None),
                                 (n_s, 1)):
                got = btl.butterfly_update_tiled(tdata, *lists, live, s,
                                                 n_srows=n_srows,
                                                 max_scratch=cap)
                assert torch.equal(got, want), (name, n_srows, cap)
                stated = n if n_srows is None else n_srows
                if stated:
                    windows, _ = btl.peel_windows(
                        n, stated, n_ct, bk,
                        default_cap if cap is None else cap)
                    launched["peel"] += len(windows)
            got = btl.butterfly_update_tiled(tdata, *lists, live, s,
                                             body="count")
            assert torch.equal(got, want), (name, "count")
            launched["count"] += 1
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["butterfly_update_tiled[count]"] == launched["count"]
    assert counts["butterfly_update_tiled[peel]"] == launched["peel"]
    with pytest.raises(ValueError, match="body"):
        btl.butterfly_update_tiled(td, *lists, live, s, body="tile")
    with pytest.raises(ValueError, match="n_srows"):
        btl.butterfly_update_tiled(td, *lists, live, s, n_srows=-1)


@pytest.mark.gpu
def test_tiled_legacy_fd_and_parb_on_card_match_oracle(card):
    """The tiled path (both backend names), ``fd_mode="b2"`` and
    ``"matvec"`` and ParB (both backends) on the card: theta equal to
    ``bup_oracle``, and kernel 6 launched by the tiled path, its peel
    body only."""
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
            counts = ops.launch_counts()
            assert counts["butterfly_update_tiled[count]"] == 0
            assert counts["butterfly_update_tiled[peel]"] > 0
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


# ---------------------------------------------------------------------- #
# the API layer on the card
# ---------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse"])
def test_executor_decompose_on_card_matches_oracle(card, backend, dispatch):
    """``Executor()`` with no device runs on the card; a cache hit on a
    permuted copy stays exact, and each path launches the hand kernels."""
    from repro_torch.api import EngineConfig, Executor

    g = powerlaw_bipartite(300, 200, 2400, seed=3)
    rng = np.random.default_rng(7)
    pu, pv = rng.permutation(g.n_u), rng.permutation(g.n_v)
    copy = graph_from_arrays(g.n_u, g.n_v, pu[g.edges_u], pv[g.edges_v])
    ex = Executor(EngineConfig(backend=backend, cd_dispatch=dispatch,
                               num_partitions=6))
    assert ex.device.type == "cuda"
    for gg in (g, copy):
        ops.reset_launch_counts()
        td = ex.decompose(gg, verify=True)
        np.testing.assert_array_equal(td.theta, peeling.bup_oracle(gg)[0])
        assert td.stats.verified and td.stats.backend_used == backend
        assert sum(ops.launch_counts().values()) > 0
    assert ex.cache_stats["hits"] == 1


@pytest.mark.gpu
def test_executor_kernel_fault_on_card_raises_without_reroute(card):
    from repro_torch.api import EngineConfig, Executor
    from repro_torch.api.errors import KernelBackendError

    g = powerlaw_bipartite(120, 80, 700, seed=1)
    ex = Executor(EngineConfig(fault_spec="kernel_launch@1"))
    ops.reset_launch_counts()
    with pytest.raises(KernelBackendError, match="chain failed: cuda "):
        ex.decompose(g)
    assert ex.decompose(g).stats.backend_used == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("backend,mode", [("cuda", "auto"),
                                          ("cuda", "kernel"),
                                          ("cuda_sparse", "kernel"),
                                          ("cuda_sparse", "b2")])
def test_executor_map_on_card_matches_per_graph(card, backend, mode):
    """A small fleet through the batched counting (kernel 2 or 5 over the
    stack, every live row with mass) and the level loop."""
    from repro_torch.api import EngineConfig, Executor

    fleet = [powerlaw_bipartite(200, 100, 900, seed=s) for s in range(6)]
    ex = Executor(EngineConfig(backend=backend, fd_update_mode=mode))
    ops.reset_launch_counts()
    tds = ex.map(fleet)
    counts = ops.launch_counts()
    stack = ("butterfly_update_sparse_batched[peel]"
             if backend == "cuda_sparse" else
             "butterfly_update_batched[peel]")
    assert counts[stack] >= 1
    if mode == "b2":
        assert counts["b2_stack[pairs]"] >= 1
    for g, td in zip(fleet, tds):
        np.testing.assert_array_equal(td.theta, peeling.bup_oracle(g)[0])
        np.testing.assert_array_equal(
            td.theta, ex.decompose(g).theta)
    assert ex.last_map_report["chunks"] == 1


# ---------------------------------------------------------------------- #
# the edge axis, the incremental re-peel and admission on the card
# ---------------------------------------------------------------------- #
def _closed_form_host(a):
    """Per-cell edge supports of a 0/1 matrix in float64 on the host."""
    a = a.astype(np.float64)
    m3 = a @ (a.T @ a)
    return (m3 - a.sum(1, keepdims=True) - a.sum(0, keepdims=True)
            + 1.0) * a


@pytest.mark.gpu
def test_edge_support_all_exact_under_tf32(card):
    """The closed form's products hold co-degrees past 2048, where a TF32
    product rounds: with ``set_float32_matmul_precision("high")`` set for
    the whole process, ``edge_support_all`` still equals a float64 count,
    2-D and stacked."""
    rng = np.random.default_rng(0)
    a = (rng.random((2, 3000, 700)) < 0.9).astype(np.float32)
    want = [_closed_form_host(x) for x in a]
    assert max(w.max() for w in want) < 2 ** 24
    eu, ev = np.nonzero(a[0])
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        a_dev = torch.from_numpy(a).to(card)
        e = (torch.from_numpy(eu).to(card), torch.from_numpy(ev).to(card))
        got = ops.edge_support_all(a_dev[0], *e)
        assert torch.equal(got.cpu(), torch.from_numpy(
            want[0][eu, ev].astype(np.float32)))
        got3 = ops.edge_support_all(a_dev, *e).cpu()
        for k in range(2):
            assert torch.equal(got3[k], torch.from_numpy(
                want[k][eu, ev].astype(np.float32)))
    finally:
        torch.set_float32_matmul_precision(old)


def _sequential_edge_delta(a, eu, ev, rows):
    """The reference's composition, plainly: each removed edge's support
    loss of every slot against the matrix its predecessors left, summed
    (float64 closed forms on the card)."""
    a = a.double().clone()
    total = torch.zeros(eu.shape, dtype=torch.float64, device=a.device)
    for e in rows.tolist():
        before = ops.edge_support_all(a, eu, ev).double()
        a[eu[e], ev[e]] = 0.0
        total += before - ops.edge_support_all(a, eu, ev).double()
    return total


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse"])
def test_before_minus_after_deltas_equal_sequential_on_card(card, backend):
    """``edge_support_delta`` on every slot outside the removed set and
    ``vertex_support_edge_delta`` on every row (kernel 1's or 4's count
    body, twice) equal the sequential per-edge form on the card."""
    g = powerlaw_bipartite(300, 160, 2500, seed=9)
    a = torch.zeros((g.n_u, g.n_v), device=card)
    eu = torch.as_tensor(g.edges_u, device=card).long()
    ev = torch.as_tensor(g.edges_v, device=card).long()
    a[eu, ev] = 1.0
    rows = torch.as_tensor([3, 17, 40, 41, 99, 250, 600], device=card)
    got = ops.edge_support_delta(a, eu, ev, rows,
                                 torch.ones(7, dtype=torch.bool, device=card))
    want = _sequential_edge_delta(a, eu, ev, rows)
    read = torch.ones(g.m, dtype=torch.bool, device=card)
    read[rows] = False
    assert torch.equal(got[read].double(), want[read])
    ops.reset_launch_counts()
    gains = ops.vertex_support_edge_delta(
        a, eu[rows], ev[rows], torch.ones(7, dtype=torch.bool, device=card),
        backend=backend)
    key = ("butterfly_update_sparse[count]" if backend == "cuda_sparse"
           else "butterfly_update[count]")
    assert ops.launch_counts()[key] == 2
    seq = torch.zeros(g.n_u, dtype=torch.float64)
    a_h = a.double().cpu()
    for e in rows.tolist():
        u, v = int(eu[e]), int(ev[e])
        w = a_h @ a_h[u]
        c = a_h[:, v] * (w - 1.0)
        c[u] = 0.0
        c[u] = c.sum()
        seq += c
        a_h[u, v] = 0.0
    assert torch.equal(gains.cpu().double(), seq)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse"])
def test_refresh_level_peel_equals_plain(card, backend):
    """The tip refresh's update at its own shape: an unsorted,
    column-compacted matrix and a level's rows gathered for the peel body
    (kernel 1, or kernel 4 with the matrix's extents), ``torch.equal`` to
    the same update through the plain versions."""
    from repro_torch.core.engine.peel_loop import peel_delta

    g = powerlaw_bipartite(900, 600, 7000, seed=12)
    sub, _ = g.induced_on_u(np.arange(g.n_u), min_degree_v=2)
    rng = np.random.default_rng(1)
    blocks = (128, 128, 512)
    out = {}
    for dev, be in ((card, backend), (torch.device("cpu"),
                                      backend.replace("cuda", "torch"))):
        a = torch.zeros((1024, 1024), device=dev)
        a[torch.as_tensor(sub.edges_u).long(),
          torch.as_tensor(sub.edges_v).long()] = 1.0
        peel = torch.zeros(1024, dtype=torch.bool)
        peel[torch.as_tensor(rng.choice(g.n_u, 37, replace=False))] = True
        rng = np.random.default_rng(1)
        ids = torch.arange(1024, dtype=torch.int32, device=dev)
        row_ext = bsp.row_extents_device(a, blocks[2])
        kmax = bsp.tile_extents(row_ext, blocks[0])
        ops.reset_launch_counts()
        out[dev.type] = peel_delta(a, peel.to(dev), 37, ids, row_ext, kmax,
                                   backend=be, blocks=blocks)
        if dev.type == "cuda":
            key = ("butterfly_update_sparse[peel]" if be == "cuda_sparse"
                   else "butterfly_update[peel]")
            assert ops.launch_counts()[key] == 1
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


_ADMISSION_ROUTES = {
    "dense_subset": dict(num_partitions=150, backend="cuda"),
    "sparse_graph": dict(num_partitions=150, backend="cuda_sparse",
                         cd_dispatch="graph"),
    "tiled": dict(num_partitions=150, backend="cuda_sparse",
                  representation="tiled", kernel_blocks=(64, 64, 64)),
    "wing": dict(workload="wing", backend="cuda_sparse",
                 cd_dispatch="graph"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("graph", ["full", "sp_mid"])
@pytest.mark.parametrize("route", sorted(_ADMISSION_ROUTES))
def test_admitted_plan_peaks_within_its_estimate(card, route, graph):
    """A plan admitted at ``memory_budget_bytes = padded_bytes`` peaks at
    or below it (``max_memory_allocated`` above what was resident), and
    the estimate is within 1.3x of the peak, so admission does not
    over-reject.  The full-size Marvel-shaped graph and sp_mid; the wing
    route at sp_mid only (the full graph's wing FD is minutes).  The
    process has run a matrix product of each type first, so that
    cuBLAS's workspace, which it keeps for its life, is resident (the
    estimate counts the run's own allocations)."""
    import gc

    from repro_torch.api import EngineConfig, Executor

    if route == "wing" and graph == "full":
        pytest.skip("the wing route is measured at sp_mid")
    g = (powerlaw_bipartite(6486, 12942, 96662, seed=0) if graph == "full"
         else powerlaw_bipartite(4096, 4096, 24000, seed=14))
    cfg = EngineConfig(**_ADMISSION_ROUTES[route])
    est = Executor(cfg).plan(g).padded_bytes
    ex = Executor(EngineConfig(**_ADMISSION_ROUTES[route],
                               memory_budget_bytes=est))
    plan = ex.plan(g)
    assert plan.padded_bytes == est and plan.degraded_from_partitions is None
    for dtype in (torch.float32, torch.float64):
        x = torch.ones((64, 64), dtype=dtype, device=card)
        x @ x
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ex.decompose(g, plan=plan)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    print(f"{route}/{graph}: padded_bytes {est} peak {peak} "
          f"ratio {est / peak:.3f}")
    assert peak <= est <= 1.3 * peak


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
def test_wing_and_repeel_on_card_match_oracle(card, dispatch):
    """``Executor(EngineConfig(workload="wing"))`` with no device runs on
    the card (side V too), and ``Executor.repeel`` refreshes a mutated
    graph exactly through the peel body."""
    from repro_torch.api import EngineConfig, Executor
    from repro_torch.core.wing import wing_bup_oracle

    g = powerlaw_bipartite(120, 80, 700, seed=4)
    want = wing_bup_oracle(g)[0]
    for side in "UV":
        ex = Executor(EngineConfig(workload="wing", cd_dispatch=dispatch,
                                   backend="cuda_sparse", side=side))
        assert ex.device.type == "cuda"
        wd = ex.decompose(g, verify=True)
        np.testing.assert_array_equal(wd.edge_wing, want)
    # tip refresh: one edge inserted at the densest vertex, one deleted
    ex = Executor(EngineConfig(cd_dispatch=dispatch, num_partitions=4))
    base = ex.decompose(g)
    top = int(np.argmax(base.theta))
    v = int(np.setdiff1d(np.arange(g.n_v), g.edges_v[g.edges_u == top])[0])
    g1 = graph_from_arrays(g.n_u, g.n_v, np.append(g.edges_u[1:], top),
                           np.append(g.edges_v[1:], v))
    a = torch.zeros((g.n_u, g.n_v), device=card)
    a[torch.as_tensor(g.edges_u).long(), torch.as_tensor(g.edges_v).long()] = 1
    ones = torch.ones(1, dtype=torch.bool, device=card)
    a0 = a.clone()
    a[top, v] = 1.0
    sup = (ops.butterfly_support(a0, torch.ones(g.n_u, device=card))
           + ops.vertex_support_edge_delta(
               a, torch.tensor([top], device=card),
               torch.tensor([v], device=card), ones)
           - ops.vertex_support_edge_delta(
               a, torch.tensor([int(g.edges_u[0])], device=card),
               torch.tensor([int(g.edges_v[0])], device=card), ones))
    floor = float(base.theta[g.edges_u[0]])
    stops = sorted({b for b in base.stats.bounds if b > floor + 0.5})
    ops.reset_launch_counts()
    theta, st = ex.repeel(g1, sup0=sup.cpu().numpy(),
                          numbers_old=base.theta, stops=stops + [np.inf],
                          watch=np.array([top]))
    np.testing.assert_array_equal(theta, peeling.bup_oracle(g1)[0])
    assert st.refresh_mode == "delta" and st.backend_used == "cuda"
    assert ops.launch_counts()["butterfly_update[peel]"] > 0


def _service_mutation(g, count, seed):
    """``count`` absent edges to insert and ``count`` present edges to
    delete, drawn from a seed."""
    rng = np.random.default_rng(seed)
    have = set((g.edges_u.astype(np.int64) * g.n_v + g.edges_v).tolist())
    ins = []
    while len(ins) < count:
        u, v = int(rng.integers(g.n_u)), int(rng.integers(g.n_v))
        if u * g.n_v + v not in have:
            have.add(u * g.n_v + v)
            ins.append((u, v))
    drop = rng.choice(g.m, count, replace=False)
    return np.array(ins, np.int64), drop


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse"])
def test_service_on_card_matches_oracle(card, backend):
    """``DecompositionService()`` with no device runs on the card: an
    ingest, a delta refresh after a mutation batch (the count body
    primes the supports, ``vertex_support_edge_delta`` maintains them)
    and a wing dataset, each equal to the exact oracle."""
    from repro_torch.api import EngineConfig
    from repro_torch.core.wing import wing_bup_oracle
    from repro_torch.service import DecompositionService, ServiceConfig

    svc = DecompositionService(EngineConfig(num_partitions=6,
                                            backend=backend),
                               ServiceConfig(refresh_dirty_threshold=0.2))
    assert svc.device.type == "cuda"
    g = powerlaw_bipartite(160, 96, 1200, seed=21)
    svc.ingest("tip", g)
    np.testing.assert_array_equal(svc.query("tip").numbers,
                                  peeling.bup_oracle(g)[0])
    ins, drop = _service_mutation(g, 6, seed=21)
    svc.insert_edges("tip", ins[:, 0], ins[:, 1])
    svc.delete_edges("tip", g.edges_u[drop], g.edges_v[drop])
    ops.reset_launch_counts()
    dec = svc.query("tip")
    assert dec.stats.refresh_mode == "delta"
    key = ("butterfly_update_sparse" if backend == "cuda_sparse"
           else "butterfly_update")
    counts = ops.launch_counts()
    assert counts[f"{key}[count]"] > 0 and counts[f"{key}[peel]"] > 0
    np.testing.assert_array_equal(
        dec.numbers, peeling.bup_oracle(svc._datasets["tip"].graph)[0])
    w = powerlaw_bipartite(60, 40, 360, seed=22)
    svc.ingest("wing", w, workload="wing")
    np.testing.assert_array_equal(svc.query("wing").numbers,
                                  wing_bup_oracle(w)[0])
    ins, drop = _service_mutation(w, 3, seed=22)
    svc.insert_edges("wing", ins[:, 0], ins[:, 1])
    svc.delete_edges("wing", w.edges_u[drop], w.edges_v[drop])
    dec = svc.query("wing")
    assert dec.stats.refresh_mode == "delta"
    np.testing.assert_array_equal(
        dec.numbers, wing_bup_oracle(svc._datasets["wing"].graph)[0])


@pytest.mark.gpu
def test_service_worker_on_card_stale_then_fresh(card, monkeypatch):
    """The background worker drives the card from its own thread: a read
    while it is inside a refresh returns the old version at once, then
    the fresh read equals the oracle; ``close()`` joins the thread."""
    import threading
    import time

    from repro_torch.api import EngineConfig
    from repro_torch.service import DecompositionService, ServiceConfig

    svc = DecompositionService(EngineConfig(num_partitions=6),
                               ServiceConfig(background=True,
                                             worker_poll_s=0.01))
    g = powerlaw_bipartite(160, 96, 1200, seed=23)
    release = threading.Event()
    try:
        svc.ingest("d", g)
        first = svc.query("d", wait=True, timeout=120)
        ex = svc._executor("tip")
        entered, real = threading.Event(), ex.repeel

        def held_repeel(*args, **kwargs):
            entered.set()
            assert release.wait(120)
            return real(*args, **kwargs)

        monkeypatch.setattr(ex, "repeel", held_repeel)
        ins, drop = _service_mutation(g, 6, seed=23)
        svc.insert_edges("d", ins[:, 0], ins[:, 1])
        svc.delete_edges("d", g.edges_u[drop], g.edges_v[drop])
        assert entered.wait(120)
        t0 = time.perf_counter()
        dec, info = svc.query("d", with_info=True)
        stale_s = time.perf_counter() - t0
        release.set()
        assert dec is first and not info["fresh"] and stale_s < 1.0
        assert svc.wait_until_idle(timeout=120)
        dec, info = svc.query("d", with_info=True)
        assert info["fresh"] and dec.stats.refresh_mode == "delta"
        np.testing.assert_array_equal(
            dec.numbers, peeling.bup_oracle(svc._datasets["d"].graph)[0])
    finally:
        release.set()
        svc.close()
    assert not svc.worker._thread.is_alive()


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse"])
def test_service_support_prime_on_card_equals_host_count(card, backend):
    """The on-card support prime (kernel 1's or 4's count body on the
    raw, unsorted matrix) equals a host float64 count."""
    from repro_torch.service.refresh import _matrix, tip_supports

    g = powerlaw_bipartite(700, 1300, 9000, seed=24)
    a_host = np.zeros((g.n_u, g.n_v))
    a_host[g.edges_u, g.edges_v] = 1.0
    w = a_host @ a_host.T
    per = w * (w - 1.0) / 2.0
    np.fill_diagonal(per, 0.0)
    a = _matrix(g.n_u, g.n_v, g.edges_u, g.edges_v, card)
    got = tip_supports(a, backend=backend)
    np.testing.assert_array_equal(got.double().cpu().numpy(),
                                  per.sum(axis=1))


# ---------------------------------------------------------------------- #
# the distributed engine: every shard of a mesh on this card
# ---------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["auto", "kernel"])
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse"])
def test_mesh_fd_on_card_equals_plain(card, backend, mode):
    """``Executor(mesh=...)`` with four shards on the card: theta equal to
    the oracle, and theta and every FD counter equal to the same mesh
    decompose on CPU shards (the plain versions); the stack kernels of
    the backend launched (kernel 3 in b2 mode, kernels 2 / 5 for the
    first level and in kernel mode), no f32 tile body."""
    from repro_torch.api import EngineConfig, Executor
    from repro_torch.launch.mesh import make_mesh

    g = powerlaw_bipartite(300, 200, 2400, seed=3)
    plain = {"cuda": "torch", "cuda_sparse": "torch_sparse"}[backend]
    out = {}
    for be, dev in ((backend, card), (plain, torch.device("cpu"))):
        mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
        ops.reset_launch_counts()
        td = Executor(EngineConfig(backend=be, num_partitions=6,
                                   fd_update_mode=mode), device=dev,
                      mesh=mesh).decompose(g)
        out[dev.type] = td
        if dev.type == "cuda":
            counts = ops.launch_counts()
    np.testing.assert_array_equal(out["cuda"].theta,
                                  peeling.bup_oracle(g)[0])
    np.testing.assert_array_equal(out["cuda"].theta, out["cpu"].theta)
    for k in ("rho_fd", "wedges_fd", "fd_groups", "fd_shards",
              "fd_shard_rho", "fd_shard_wedges", "fd_padding_waste",
              "device_loop_calls"):
        assert getattr(out["cuda"].stats, k) == getattr(out["cpu"].stats, k)
    stack = ("butterfly_update_sparse_batched[peel]"
             if backend == "cuda_sparse" else "butterfly_update_batched[peel]")
    assert counts[stack] > 0
    assert (counts["b2_stack[pairs]"] > 0) == (mode == "auto")
    assert not [k for k, n in counts.items() if k.endswith("[tile]") and n]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_mesh_cd_sweep_on_card_equals_plain(card, shape):
    """The sharded count, sweep and range loop with four shards on the
    card equal the same calls on CPU shards; on a (4, 1) mesh each
    shard's local body is kernel 1's peel body (one launch per dp shard
    and chunk), on (2, 2) a plain product (no kernel 1 launch)."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh

    g = powerlaw_bipartite(256, 128, 2500, seed=2)
    a = torch.zeros((256, 128))
    a[g.edges_u, g.edges_v] = 1.0
    gen = torch.Generator().manual_seed(0)
    s = (torch.rand(256, generator=gen) < 0.6).float()
    rows = torch.randperm(256, generator=gen)[:64].sort().values.int()
    valid = (torch.arange(64) < 50).float()
    res, counts = {}, {}
    for dev in (card, torch.device("cpu")):
        mesh = make_mesh(shape, ("data", "model"), devices=[dev] * 4)
        ops.reset_launch_counts()
        sup = dist.distributed_butterfly_support(mesh, a.to(dev), s.to(dev))
        alive = torch.ones(256, dtype=torch.bool, device=dev)
        sw = dist.distributed_cd_sweep(mesh, a.to(dev), sup, alive,
                                       rows.to(dev), valid.to(dev), 0.0,
                                       chunk=32)
        hi = float(sup.float().quantile(0.4)) + 1.0
        loop = dist.distributed_cd_fused_loop(mesh, a.to(dev), sup, alive,
                                              hi, 0.0, peel_width=256)
        res[dev.type] = (sup, *sw, *loop[:2], loop[2], loop[3])
        counts[dev.type] = ops.launch_counts()
    for x, y in zip(res["cuda"], res["cpu"]):
        if torch.is_tensor(x):
            assert torch.equal(x.cpu(), y)
        else:
            assert x == y
    assert res["cuda"][-2] > 0 and not res["cuda"][-1]
    peel = counts["cuda"]["butterfly_update[peel]"]
    assert (peel > 0) == (shape[1] == 1)
    if shape[1] == 1:
        # count (1 chunk) + sweep (2 chunks of 32) + one per loop sweep,
        # each on every dp shard
        assert peel == shape[0] * (1 + 2 + res["cuda"][-2])


@pytest.mark.gpu
@pytest.mark.parametrize("partitions", [4, 16])
def test_mesh_plan_peaks_within_its_estimate_where_fd_sets_it(card,
                                                              partitions,
                                                              monkeypatch):
    """A (2, 2) mesh of four shards on the card, on a narrow graph whose
    FD stacks set the peak: the mesh decompose and the single-device one
    each peak (``max_memory_allocated`` above what was resident) at or
    below ``plan.padded_bytes`` and at least 1/1.3 of it.  The FD
    estimate predicts the engine's subsets (``plan._predict_fd_subsets``)
    and counts the engine's own LPT slots per shard on the mesh; at P = 4
    it sets the plan's bytes, at P = 16 the CD phase's count is larger.
    The FD phase's own peak is at or below the plan's bytes, which it
    keeps as a budget (``fd._pipeline``).  The test prints each ratio,
    the estimate with the earlier slot count (``ceil(n_g / mesh.size)``)
    beside it, and the FD groups the plan predicted beside the ones the
    engine laid out."""
    import gc

    from repro_torch.api import EngineConfig, Executor
    from repro_torch.api import plan as plan_mod
    from repro_torch.core import distributed, engine
    from repro_torch.launch.mesh import make_mesh

    laid_out = []
    real_layout = distributed.shard_level_group

    def recording(built, n_shards, init_loads=None):
        sharded, slots = real_layout(built, n_shards, init_loads=init_loads)
        laid_out.append((tuple(built["a"].shape), sharded["per_shard"]))
        return sharded, slots

    monkeypatch.setattr(distributed, "shard_level_group", recording)
    # the FD phase's own peak above what was resident when it began
    fd_peaks = []
    real_fd = engine.receipt_fd

    def fd_phase(*args, **kwargs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = real_fd(*args, **kwargs)
        torch.cuda.synchronize()
        fd_peaks.append(torch.cuda.max_memory_allocated() - base)
        return out

    monkeypatch.setattr(engine, "receipt_fd", fd_phase)

    def peak_of(ex, plan):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        peaks = []
        # the whole run's peak: the FD phase resets the counter, so keep
        # the larger of what was seen before it and in it
        real_reset = torch.cuda.reset_peak_memory_stats

        def keep():
            peaks.append(torch.cuda.max_memory_allocated())
            real_reset()

        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "reset_peak_memory_stats", keep)
            td = ex.decompose(g, plan=plan)
            torch.cuda.synchronize()
        np.testing.assert_array_equal(td.theta, peeling.bup_oracle(g)[0])
        return max(peaks + [torch.cuda.max_memory_allocated()]) - resident

    g = powerlaw_bipartite(4096, 256, 20000, seed=3)
    mesh = make_mesh((2, 2), ("data", "model"), devices=[card] * 4)
    cfg = EngineConfig(num_partitions=partitions)
    ex = Executor(cfg, mesh=mesh)
    plan = ex.plan(g)
    assert (plan.padded_bytes > plan.cost_model["dense_fixed_bytes"]) == (
        partitions == 4)
    single = Executor(cfg)
    single_plan = single.plan(g)
    with monkeypatch.context() as mp:
        mp.setattr(plan_mod, "_mesh_fd_slots",
                   lambda groups, n: [-(-len(w) // n) for w in groups])
        earlier = Executor(cfg, mesh=mesh).plan(g).padded_bytes
    assert plan.padded_bytes >= earlier
    for dtype in (torch.float32, torch.float64):
        x = torch.ones((64, 64), dtype=dtype, device=card)
        x @ x
    peak = peak_of(ex, plan)
    single_peak = peak_of(single, single_plan)
    print(f"mesh P={partitions}: padded_bytes {plan.padded_bytes} peak "
          f"{peak} ratio {plan.padded_bytes / peak:.3f} | earlier slot "
          f"count: padded_bytes {earlier} ratio {earlier / peak:.3f} | "
          f"single device: padded_bytes {single_plan.padded_bytes} peak "
          f"{single_peak} ratio {single_plan.padded_bytes / single_peak:.3f}")
    planner = plan_mod.Planner(cfg, device=card)
    fd_mesh = planner._estimate_fd_bytes(g, planner.rcfg, mesh=mesh)
    fd_one = planner._estimate_fd_bytes(g, planner.rcfg)
    print(f"FD phase P={partitions}: mesh FD estimate {fd_mesh} FD peak "
          f"{fd_peaks[-2]} ratio {fd_mesh / fd_peaks[-2]:.3f} | single "
          f"device FD estimate {fd_one} FD peak {fd_peaks[-1]} ratio "
          f"{fd_one / fd_peaks[-1]:.3f}")
    print(f"mesh P={partitions}: predicted FD subsets (survivor rows, "
          "columns) " + ", ".join(
              f"({s[0]}, {s[1]})"
              for s in plan_mod._predict_fd_subsets(
                  g, partitions, planner.rcfg.fd_prepeel_levels))
          + " | laid out ((G, rows, cols), slots per shard) "
          + ", ".join(str(x) for x in laid_out))
    assert peak <= plan.padded_bytes <= 1.3 * peak
    assert single_peak <= single_plan.padded_bytes <= 1.3 * single_peak
    assert fd_peaks[-2] <= plan.padded_bytes
    assert fd_peaks[-1] <= single_plan.padded_bytes


# --------------------------------------------------------------------- #
# the training substrate and the two-tower model on the card
# --------------------------------------------------------------------- #
def _reduced_pair(card, seed=0):
    import copy

    from repro_torch.configs import get_bundle

    bundle = get_bundle("two-tower-retrieval", reduced=True)
    cpu = bundle.init_params(torch.Generator().manual_seed(seed))
    return bundle, cpu, copy.deepcopy(cpu).to(card)


@pytest.mark.gpu
def test_reduced_train_step_on_card_matches_cpu(card, monkeypatch):
    """Three steps of the reduced two-tower on the card against the same
    steps on the CPU from the same params and batches (TF32 off): losses
    and params within the CPU tests' rtol 1e-5 (atol 1e-7)."""
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.train.train_step import init_train_state

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bundle, cpu, dev = _reduced_pair(card)
    step = bundle._steps["train"]
    s_cpu = init_train_state(cpu, bundle.opt_cfg)
    s_dev = init_train_state(dev, bundle.opt_cfg)
    for s in range(3):
        s_cpu, m_cpu = step(s_cpu, recsys_batch(bundle.cfg, 64, seed=s,
                                                device="cpu"))
        s_dev, m_dev = step(s_dev, recsys_batch(bundle.cfg, 64, seed=s,
                                                device=card))
        assert float(m_dev["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                     rel=1e-5)
    assert all(p.device.type == "cuda" for p in dev.parameters())
    for (n, a), (_, b) in zip(cpu.named_parameters(), dev.named_parameters()):
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=n)


@pytest.mark.gpu
def test_untouched_rows_move_by_weight_decay_alone_on_card(card,
                                                           monkeypatch):
    """One step on the card: every table row the batch did not touch
    moved by the decoupled weight decay alone, p (1 - lr wd) within one
    float32 ulp, so the in-place chunked update covered every row."""
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import init_train_state

    bundle, _, params = _reduced_pair(card)
    tables = (*params.user_tables, *params.item_tables)
    before = [t.detach().clone() for t in tables]
    batch = recsys_batch(bundle.cfg, 4, seed=0, device=card)
    state = init_train_state(params, bundle.opt_cfg)
    loss, _ = bundle._loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    # small chunks: every table is updated in several pieces
    monkeypatch.setattr(topt, "_CHUNK_ELEMS", 64)
    _, _, metrics = topt.adamw_update(params, list(grads), state["opt"],
                                      bundle.opt_cfg)
    lr, wd = float(metrics["lr"]), bundle.opt_cfg.weight_decay
    ids = [batch["user_ids"][:, i] for i in range(len(params.user_tables))]
    ids += [batch["item_ids"][:, i] for i in range(len(params.item_tables))]
    moved = total = 0
    for t, old, used in zip(tables, before, ids):
        untouched = torch.ones(t.shape[0], dtype=torch.bool, device=card)
        untouched[used.reshape(-1).long()] = False
        new, old = t.detach()[untouched], old[untouched]
        want = old.double() * (1.0 - lr * wd)
        ulp = torch.nextafter(new.abs(), torch.full_like(new, np.inf)) - \
            new.abs()
        assert bool(((new.double() - want).abs() <= ulp.double()).all())
        moved += int((new != old).sum())
        total += new.numel()
    assert moved > 0.5 * total


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(card, tmp_path):
    """A reduced train state saved from the card (async) and restored
    onto it from a meta template: every leaf ``torch.equal``."""
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_step import init_train_state
    from repro_torch.train.tree import leaves_with_paths

    bundle, _, params = _reduced_pair(card)
    state = init_train_state(params, bundle.opt_cfg)
    state, _ = bundle._steps["train"](
        state, recsys_batch(bundle.cfg, 16, seed=0, device=card))
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, state, blocking=False)
    ck.wait()
    back = ck.restore(bundle.state_abstract(), device=card)
    a, b = leaves_with_paths(state), leaves_with_paths(back)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert y.device.type == "cuda" and torch.equal(x, y)


# --------------------------------------------------------------------- #
# the language-model serving path on the card
# --------------------------------------------------------------------- #
def _lm_pair(card, arch):
    import copy

    from repro_torch.configs import get_bundle

    bundle = get_bundle(arch, reduced=True)
    cpu = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    return bundle, cpu, copy.deepcopy(cpu).to(card)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-v3-671b"])
def test_lm_decode_and_prefill_on_card_match_cpu(card, arch, monkeypatch):
    """A reduced LM (GQA; MLA + sigmoid-routed MoE + MTP) on the card
    against the CPU from the same params, float32 with TF32 off:
    ``lm_prefill`` and eight decode steps within rtol / atol 1e-4, the
    card's cache written in place, and no hand kernel launched."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf_lib

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bundle, cpu, dev = _lm_pair(card, arch)
    cfg = bundle.cfg
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 16), dtype=np.int32))
    ops.reset_launch_counts()
    pairs = [(tf_lib.lm_prefill(dev, toks.to(card), cfg),
              tf_lib.lm_prefill(cpu, toks, cfg))]
    c_dev = tf_lib.init_cache(cfg, 2, 8, device=card)
    c_cpu = tf_lib.init_cache(cfg, 2, 8, device="cpu")
    first = {k: v for k, v in c_dev.items() if torch.is_tensor(v)}
    for t in range(8):
        a, c_dev = tf_lib.lm_decode_step(dev, c_dev, toks[:, t].to(card),
                                         cfg)
        b, c_cpu = tf_lib.lm_decode_step(cpu, c_cpu, toks[:, t], cfg)
        pairs.append((a, b))
    for a, b in pairs:
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    assert all(c_dev[k] is v for k, v in first.items())
    assert c_dev["len"] == 8
    assert not any(ops.launch_counts().values())


@pytest.mark.gpu
def test_batched_server_on_card_defaults_to_it(card):
    """``BatchedServer`` with no device serves on the card (params drawn
    there from a generator seeded 0): tokens in range, the cache length,
    no hand kernel launched."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_lm import BatchedServer

    bundle = get_bundle("deepseek-v2-236b", reduced=True)
    server = BatchedServer(bundle, 4, 28)
    assert server.device.type == "cuda"
    prompts = np.random.default_rng(0).integers(
        0, bundle.cfg.vocab, (4, 8), dtype=np.int32)
    ops.reset_launch_counts()
    out = server.run(prompts, 16)
    assert out.shape == (4, 16) and 0 <= out.min() and \
        out.max() < bundle.cfg.vocab
    assert server.cache["len"] == 24
    assert not any(ops.launch_counts().values())


# --------------------------------------------------------------------- #
# the GNN family on the card
# --------------------------------------------------------------------- #
@pytest.mark.gpu
def test_nbr_table_on_card_equals_host_build(card):
    """The vectorized neighbour table built on the card (its stable sort)
    ``torch.equal`` to the same build on the CPU, at 500,000 edges with
    senders truncated at 32 neighbours."""
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models.sampler import build_nbr_table

    snd, rcv = random_graph(20_000, 500_000, seed=3)
    t_dev, d_dev = build_nbr_table(snd, rcv, 20_000, 32, device=card)
    t_cpu, d_cpu = build_nbr_table(snd, rcv, 20_000, 32, device="cpu")
    assert t_dev.device.type == "cuda"
    assert torch.equal(t_dev.cpu(), t_cpu) and torch.equal(d_dev.cpu(), d_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["train", "train_sampled"])
def test_reduced_gnn_train_step_on_card_matches_cpu(card, kind, monkeypatch):
    """One train step of the reduced DimeNet (``train``) and of GraphSAGE
    on sampled blocks (``train_sampled``) on the card against the same
    step on the CPU (TF32 off): loss and params within rtol 1e-4 / atol
    1e-5 (the card's scatter adds in no fixed order)."""
    import copy

    from repro_torch.configs import get_bundle
    from repro_torch.data import synthetic as syn
    from repro_torch.train.train_step import init_train_state

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    if kind == "train":
        bundle = get_bundle("dimenet", reduced=True)
        batch = syn.dimenet_batch(bundle.cfg, 24, 60, n_graphs=4,
                                  triplet_fanout=6, seed=0, device="cpu")
    else:
        bundle = get_bundle("graphsage-reddit", reduced=True)
        batch = syn.graphsage_sampled_batch(
            bundle.cfg, batch_nodes=16, fanouts=bundle.cfg.sample_sizes,
            n_nodes=200, n_edges=900, seed=0, device="cpu")
    cpu = bundle.init_params(torch.Generator().manual_seed(0))
    dev = copy.deepcopy(cpu).to(card)
    step = bundle._steps[kind]
    _, m_cpu = step(init_train_state(cpu, bundle.opt_cfg), batch)
    _, m_dev = step(init_train_state(dev, bundle.opt_cfg),
                    {k: v.to(card) for k, v in batch.items()})
    assert float(m_dev["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                 rel=1e-4, abs=1e-5)
    for (n, a), (_, b) in zip(cpu.named_parameters(), dev.named_parameters()):
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def _moe_sharded_against_local(mesh, d, f, ne, k, n_shared, x_shape, gen):
    """One MoE (bf16 weights and x from ``gen`` on the first mesh
    device) run locally and under ``mesh`` with cf = E / k and a
    backward through each: the outputs' and the gradients' relative L2."""
    from repro_torch.launch.sharding import mesh_context
    from repro_torch.models import moe as moe_lib

    dev = mesh.devices[0]
    p = moe_lib.init_moe(gen, d, f, ne, n_shared, dtype=torch.bfloat16,
                         device=dev)
    x0 = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(x_shape, generator=gen, device=dev)
    arms = {}
    for name, ctx in (("local", None), ("sharded", mesh)):
        p.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(True)
        if ctx is None:
            out, _ = moe_lib.moe_forward(p, x, top_k=k,
                                         capacity_factor=ne / k)
        else:
            with mesh_context(ctx):
                out, _ = moe_lib.moe_forward(p, x, top_k=k,
                                             capacity_factor=ne / k)
        (out.float() * w).sum().backward()
        arms[name] = dict(out=out.detach(), x=x.grad, gate=p.gate.grad,
                          down=p.down.grad)
    torch.cuda.synchronize()

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).double())
                     / torch.linalg.vector_norm(b.double()))

    return {key: rel(arms["sharded"][key], arms["local"][key])
            for key in arms["local"]}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_moe_sharded_on_one_card_equals_local(card, shape):
    """The expert exchange with every mesh position on ``cuda:0`` at a
    reduced width (deepseek-v2's layout: top-6 of 32 experts, 2 shared),
    sharded against local, bf16: outputs within relative L2 5e-2, the
    gradients of x and of the routed weights within 1e-2."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, ("data", "model"), devices=[card] * 4)
    gen = torch.Generator(device=card).manual_seed(0)
    errs = _moe_sharded_against_local(mesh, 256, 128, 32, 6, 2,
                                      (4, 512, 256), gen)
    assert errs["out"] <= 5e-2, errs
    assert max(errs[k] for k in ("x", "gate", "down")) <= 1e-2, errs


@pytest.mark.gpu
def test_moe_sharded_on_four_cards_equals_local(card):
    """The same comparison on a (1, 4) mesh of four distinct cards: each
    position's pieces, exchange buffers and experts on its own card.
    Skips with fewer than four cards visible."""
    from repro_torch.launch.mesh import make_mesh

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    mesh = make_mesh((1, 4), ("data", "model"))
    assert len(set(mesh.devices)) == 4
    gen = torch.Generator(device=mesh.devices[0]).manual_seed(0)
    errs = _moe_sharded_against_local(mesh, 256, 128, 32, 6, 2,
                                      (4, 512, 256), gen)
    assert errs["out"] <= 5e-2, errs
    assert max(errs[k] for k in ("x", "gate", "down")) <= 1e-2, errs


# ---------------------------------------------------------------------- #
# past 2^24: the float64 epilogues (DESIGN.md section 8, the port's
# paragraph)
# ---------------------------------------------------------------------- #
def _wide_operands(gen, card, n, n_v, density):
    """A 0/1 matrix whose supports pass 2^24, s with zeros, ids that are
    not the row positions; the plain versions' inputs on the CPU (no
    TF32 there), the kernels' on the card."""
    a = _adj(gen, n, n_v, density=density)
    s = (torch.rand(n, generator=gen) < 0.8).float()
    s[0] = 1.0
    ids = (torch.randperm(n, generator=gen) + 3).to(torch.int32)
    return a, s, ids, (a.to(card), s.to(card), ids.to(card))


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_v", [(64, 6000), (300, 2500)])
def test_wide_bodies_equal_float64_plain_past_2_24(card, n, n_v):
    """Kernels 1 and 4 (count, peel and tile bodies) and kernels 2 and 5
    (stack peel and tile bodies) on supports past 2^24: every output is
    float64 and ``torch.equal`` to the float64 plain version, which equals
    the exact count; the float32 rounding of that count differs."""
    gen = torch.Generator().manual_seed(n + n_v)
    a, s, ids, (ac, sc, idc) = _wide_operands(gen, card, n, n_v, 0.5)
    want = bfly.butterfly_update_plain(a, a, s, ids, ids)
    w64 = a.double() @ a.double().T
    exact = ((w64 * (w64 - 1) / 2).fill_diagonal_(0)
             * s.double()[None, :]).sum(dim=1)
    assert float(exact.max()) >= 2 ** 24
    assert torch.equal(want, exact)
    assert not torch.equal(exact.float().double(), exact)
    for body in ("count", "peel", "tile"):
        got = bfly.butterfly_update(ac, ac, sc, idc, idc, body=body)
        assert got.dtype == torch.float64
        assert torch.equal(got.cpu(), want), body
    for bi, bk in ((16, 64), (128, 512)):
        blocks = (bi, bi, bk)
        kmax = bsp.column_extents(a, bi, bk).to(torch.int32).contiguous()
        kc = kmax.to(card)
        for body in ("count", "peel", "tile"):
            got = bsp.butterfly_update_sparse(ac, ac, sc, idc, idc, kc, kc,
                                              blocks=blocks, body=body)
            assert torch.equal(got.cpu(), want), (blocks, body)
    # a gathered peel set: 40 rows, 30 of them valid
    rows = torch.randint(0, n, (40,), generator=gen)
    valid = (torch.arange(40) < 30).float()
    b = a[rows] * valid[:, None]
    rid = ids[rows]
    want_p = bfly.butterfly_update_plain(a, b, valid, ids, rid)
    for body in ("peel", "tile"):
        got = bfly.butterfly_update(ac, b.to(card), valid.to(card), idc,
                                    rid.to(card), body=body)
        assert torch.equal(got.cpu(), want_p), body
    # the stacks: two graphs of the same shape
    a3 = torch.stack([a, a.flip(1)])
    s3 = torch.stack([s, s.flip(0)])
    i3 = torch.arange(n, dtype=torch.int32).expand(2, n).contiguous()
    want3 = bfly.butterfly_update_batched_plain(a3, a3, s3, i3, i3)
    args3 = tuple(x.to(card) for x in (a3, a3, s3, i3, i3))
    for body in ("peel", "tile"):
        got = bfly.butterfly_update_batched(*args3, body=body)
        assert got.dtype == torch.float64
        assert torch.equal(got.cpu(), want3), body
    blocks = (16, 16, 64)
    k3 = bsp.column_extents(a3, 16, 64).to(torch.int32).contiguous()
    got = bsp.butterfly_update_sparse_batched(*args3, k3.to(card),
                                              k3.to(card), blocks=blocks)
    assert torch.equal(got.cpu(), want3)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["pairs", "tile"])
def test_b2_bodies_equal_float64_plain_past_2_24(card, body):
    """Kernel 3 writes float64 entries: entries past 2^24 (W near 6,700)
    equal the float64 plain version, odd and even m (the pairs body's
    scalar and double2 stores)."""
    gen = torch.Generator().manual_seed(5)
    for m in (40, 37):
        a = _adj(gen, 2, m, 12000, density=0.75)
        want = bsp.b2_stack_plain(a, None, None, blocks=(16, 16, 64))
        assert float(want.max()) >= 2 ** 24
        for blocks in ((16, 16, 64), (128, 128, 512)):
            bi, _bj, bk = blocks
            k = bsp.column_extents(a, bi, bk).to(torch.int32).contiguous()
            got = bsp.b2_stack(a.to(card), k.to(card), k.to(card),
                               blocks=blocks, body=body)
            assert got.dtype == torch.float64
            assert torch.equal(got.cpu(), want), (m, blocks)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("dispatch", ["subset", "graph"])
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse"])
def test_main_path_on_card_exact_past_2_24(card, backend, dispatch, side):
    """``Executor.decompose`` on the card equals the int64 oracle on a
    graph whose supports pass 2^24 (float32 rounding would merge or move
    them), and records the largest count it read."""
    from repro_torch.api import EngineConfig, Executor
    from repro_torch.core.graph import BipartiteGraph

    rng = np.random.default_rng(13)
    eu, ev = np.nonzero(rng.random((40, 7000)) < 0.4)
    peeled = BipartiteGraph.from_edges(40, 7000, eu, ev)
    g = peeled if side == "U" else peeled.transposed()
    want, _ = peeling.bup_oracle(peeled)
    sup = peeling.shared_butterfly_matrix(peeled).sum(axis=1)
    assert sup.max() >= 2 ** 24
    assert (sup.astype(np.float32).astype(np.int64) != sup).any()
    ex = Executor(EngineConfig(side=side, backend=backend,
                               cd_dispatch=dispatch, num_partitions=4,
                               representation="dense"))
    td = ex.decompose(g)
    np.testing.assert_array_equal(td.theta, want)
    assert td.stats.trace.max_support == float(sup.max())
    assert td.stats.trace.wide_bytes > 0

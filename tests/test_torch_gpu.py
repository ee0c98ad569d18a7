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

"""The port's kernel modules against the reference's Pallas kernels.

Every plain version in ``repro_torch.kernels`` must be bit-identical to the
Pallas kernel body of ``repro.kernels`` run under the interpreter
(``interpret=True``), on the same random padded inputs made with numpy.
The f32 integer regime (DESIGN.md section 8) makes the comparison exact,
so the tolerance is zero.  The CUDA kernels are held against the plain
versions on the card by tests/test_torch_gpu.py.
"""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.butterfly import (butterfly_support_pallas,
                                     butterfly_update_pallas_batched)
from repro.kernels import butterfly_sparse as jbs
from repro.kernels.butterfly_sparse import (b2_stack_pallas_sparse,
                                            batched_row_extents as j_bre,
                                            row_extents as j_re,
                                            row_extents_device as j_red)
from repro_torch.kernels import _build
from repro_torch.kernels import butterfly as tbf
from repro_torch.kernels import butterfly_sparse as tbs
from repro_torch.kernels import butterfly_tiled as tbt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _adj(rng, *shape, density=0.3):
    return (rng.random(shape) < density).astype(np.float32)


def _gathered(rng, a, width, n_valid):
    """Peel rows of ``a`` gathered into a padded buffer: global ids in
    ``rows`` (padding rows id 0, as the reference gathers), validity mask."""
    rows = np.zeros(width, np.int32)
    rows[:n_valid] = np.sort(rng.choice(a.shape[0], n_valid, replace=False))
    valid = (np.arange(width) < n_valid).astype(np.float32)
    return a[rows] * valid[:, None], rows, valid


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("blocks,n_a,n_v,width,n_valid", [
    ((8, 8, 8), 32, 16, 8, 5),
    ((8, 16, 8), 48, 24, 16, 11),
    ((16, 8, 32), 32, 64, 8, 8),
])
def test_update_plain_matches_interpret(blocks, n_a, n_v, width, n_valid):
    """Kernel 1, gathered form: global ids, the self-mask drops (u, u)."""
    rng = np.random.default_rng(n_a * n_v + width)
    a = _adj(rng, n_a, n_v)
    b, rows, valid = _gathered(rng, a, width, n_valid)
    ids = np.arange(n_a, dtype=np.int32)
    want = np.asarray(butterfly_support_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid), jnp.asarray(ids),
        jnp.asarray(rows), blocks=blocks, interpret=True))
    got = tbf.butterfly_update_plain(_t(a), _t(b), _t(valid), _t(ids),
                                     _t(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    via_ops = tops.butterfly_update(_t(a), _t(b), _t(valid), _t(ids),
                                    _t(rows), backend="torch", blocks=blocks)
    np.testing.assert_array_equal(via_ops.numpy(), want)


@pytest.mark.parametrize("density", [0.0, 0.2, 0.9])
def test_counting_plain_matches_interpret(density):
    """Kernel 1, counting form (A = B, s = alive)."""
    rng = np.random.default_rng(7)
    a = _adj(rng, 32, 24, density=density)
    s = (rng.random(32) < 0.7).astype(np.float32)
    want = np.asarray(jops.butterfly_support(
        jnp.asarray(a), jnp.asarray(s), backend="interpret", blocks=(8, 8, 8)))
    got = tops.butterfly_support(_t(a), _t(s), blocks=(8, 8, 8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.butterfly_support_ref(_t(a), _t(s)).numpy(),
        np.asarray(jref.butterfly_support_ref(jnp.asarray(a),
                                              jnp.asarray(s))))


@pytest.mark.parametrize("blocks,g_n,n_a,n_v,width", [
    ((8, 8, 8), 3, 16, 16, 8),
    ((8, 8, 16), 2, 24, 32, 16),
])
def test_batched_plain_matches_interpret(blocks, g_n, n_a, n_v, width):
    """Kernel 2: a stack with LOCAL ids, gathered rows per group."""
    rng = np.random.default_rng(g_n * n_a)
    a = _adj(rng, g_n, n_a, n_v)
    parts = [_gathered(rng, a[g], width, int(rng.integers(1, width + 1)))
             for g in range(g_n)]
    b = np.stack([p[0] for p in parts])
    rows = np.stack([p[1] for p in parts])
    valid = np.stack([p[2] for p in parts])
    ids = np.broadcast_to(np.arange(n_a, dtype=np.int32), (g_n, n_a)).copy()
    want = np.asarray(butterfly_update_pallas_batched(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid), jnp.asarray(ids),
        jnp.asarray(rows), blocks=blocks, interpret=True))
    got = tbf.butterfly_update_batched_plain(_t(a), _t(b), _t(valid),
                                             _t(ids), _t(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    via_ops = tops.butterfly_update_batched(
        _t(a), _t(b), _t(valid), _t(ids), _t(rows), blocks=blocks)
    np.testing.assert_array_equal(via_ops.numpy(), want)


def _staircase(rng, g_n, m, n_v, density=0.4):
    cut = rng.integers(0, n_v + 1, size=(g_n, m, 1))
    return (_adj(rng, g_n, m, n_v, density=density)
            * (np.arange(n_v)[None, None, :] < cut)).astype(np.float32)


@pytest.mark.parametrize("blocks", [(8, 8, 8), (16, 8, 8), (8, 16, 16)])
def test_b2_stack_plain_matches_interpret(blocks):
    """Kernel 3 with real staircase extents (B-side rebuilt when bi != bj)."""
    rng = np.random.default_rng(sum(blocks))
    a = _staircase(rng, 2, 32, 48)
    want = np.asarray(jops.b2_stack(jnp.asarray(a), backend="interpret",
                                    blocks=blocks))
    got = tops.b2_stack(_t(a), blocks=blocks)
    np.testing.assert_array_equal(got.numpy(), want)
    # the Pallas entry point itself, fed the extents the port derives
    bi, bj, bk = blocks
    kmax = tbs.tile_extents(tbs.row_extents_device(_t(a), bk), bi)
    direct = np.asarray(b2_stack_pallas_sparse(
        jnp.asarray(a), jnp.asarray(kmax.numpy()), blocks=blocks,
        interpret=True))
    plain = tbs.b2_stack_plain(_t(a), kmax, kmax, blocks=blocks)
    np.testing.assert_array_equal(plain.numpy(), direct)


def _extents(rng, a, b, rows, valid, blocks, tight):
    """Row-tile extents of ``a`` and of the gathered ``b`` (B-side read
    off ``a``'s per-row extents, padding rows 0); ``tight`` cuts them at
    random below the true ones, where the skip is no longer exact."""
    bi, bj, bk = blocks
    lead = a.shape[:-2]
    kmax_a = tbs.column_extents(_t(a), bi, bk)
    row_ext = tbs.row_extents_device(_t(a), bk)
    if a.ndim == 2:
        kmax_b = tbs.gathered_tile_extents(row_ext, _t(rows), _t(valid), bj)
    else:
        kmax_b = tbs.batched_gathered_tile_extents(row_ext, _t(rows),
                                                   _t(valid), bj)
    if tight:
        kmax_a = torch.minimum(kmax_a, _t(rng.integers(
            0, 3, (*lead, kmax_a.shape[-1])).astype(np.int32)))
        kmax_b = torch.minimum(kmax_b, _t(rng.integers(
            0, 3, (*lead, kmax_b.shape[-1])).astype(np.int32)))
    return kmax_a.to(torch.int32), kmax_b.to(torch.int32)


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("blocks,n_a,n_v,width,n_valid", [
    ((8, 8, 8), 32, 48, 16, 11),
    ((16, 8, 16), 48, 64, 16, 9),
])
def test_sparse_update_plain_matches_interpret(blocks, n_a, n_v, width,
                                               n_valid, tight):
    """Kernel 4, gathered form: the plain version skips what the Pallas
    grid skips, with real extents and with too-tight ones."""
    rng = np.random.default_rng(n_a + n_v + width + tight)
    a = _staircase(rng, 1, n_a, n_v)[0]
    b, rows, valid = _gathered(rng, a, width, n_valid)
    ids = np.arange(n_a, dtype=np.int32)
    kmax_a, kmax_b = _extents(rng, a, b, rows, valid, blocks, tight)
    want = np.asarray(jbs.butterfly_update_pallas_sparse(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid), jnp.asarray(ids),
        jnp.asarray(rows), jnp.asarray(kmax_a.numpy()),
        jnp.asarray(kmax_b.numpy()), blocks=blocks, interpret=True))
    got = tbs.butterfly_update_sparse(_t(a), _t(b), _t(valid), _t(ids),
                                      _t(rows), kmax_a, kmax_b, blocks=blocks)
    np.testing.assert_array_equal(got.numpy(), want)
    via_ops = tops.butterfly_update(
        _t(a), _t(b), _t(valid), _t(ids), _t(rows), backend="torch_sparse",
        blocks=blocks, kmax_a=kmax_a, kmax_b=kmax_b)
    np.testing.assert_array_equal(via_ops.numpy(), want)
    if not tight:
        dense = tbf.butterfly_update_plain(_t(a), _t(b), _t(valid), _t(ids),
                                           _t(rows))
        np.testing.assert_array_equal(got.numpy(), dense.numpy())


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("blocks,g_n,n_a,n_v,width", [
    ((8, 8, 8), 3, 16, 32, 8),
    ((16, 8, 16), 2, 32, 48, 16),
])
def test_sparse_batched_plain_matches_interpret(blocks, g_n, n_a, n_v, width,
                                                tight):
    """Kernel 5: one staircase per group member, local ids."""
    rng = np.random.default_rng(g_n * n_a + tight)
    a = _staircase(rng, g_n, n_a, n_v)
    parts = [_gathered(rng, a[g], width, int(rng.integers(1, width + 1)))
             for g in range(g_n)]
    b = np.stack([p[0] for p in parts])
    rows = np.stack([p[1] for p in parts])
    valid = np.stack([p[2] for p in parts])
    ids = np.broadcast_to(np.arange(n_a, dtype=np.int32), (g_n, n_a)).copy()
    kmax_a, kmax_b = _extents(rng, a, b, rows, valid, blocks, tight)
    want = np.asarray(jbs.butterfly_update_pallas_sparse_batched(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid), jnp.asarray(ids),
        jnp.asarray(rows), jnp.asarray(kmax_a.numpy()),
        jnp.asarray(kmax_b.numpy()), blocks=blocks, interpret=True))
    got = tbs.butterfly_update_sparse_batched(
        _t(a), _t(b), _t(valid), _t(ids), _t(rows), kmax_a, kmax_b,
        blocks=blocks)
    np.testing.assert_array_equal(got.numpy(), want)
    via_ops = tops.butterfly_update_batched(
        _t(a), _t(b), _t(valid), _t(ids), _t(rows), backend="torch_sparse",
        blocks=blocks, kmax_a=kmax_a, kmax_b=kmax_b)
    np.testing.assert_array_equal(via_ops.numpy(), want)


def test_sparse_counting_form_defaults_to_full_extents():
    """``butterfly_support`` on the sparse backend: the reference's
    counting form with real extents, and full extents when none given."""
    rng = np.random.default_rng(11)
    a = _staircase(rng, 1, 32, 48)[0]
    s = (rng.random(32) < 0.7).astype(np.float32)
    kmax = tbs.column_extents(_t(a), 8, 8)
    want = np.asarray(jbs.butterfly_support_pallas_sparse(
        jnp.asarray(a), jnp.asarray(s), jnp.asarray(kmax.numpy()),
        blocks=(8, 8, 8), interpret=True))
    for k in (kmax, None):
        got = tops.butterfly_support(_t(a), _t(s), backend="torch_sparse",
                                     blocks=(8, 8, 8), kmax=k)
        np.testing.assert_array_equal(got.numpy(), want)


def test_extent_helpers_match_reference():
    rng = np.random.default_rng(12)
    a = _staircase(rng, 2, 32, 64)
    for bi, bk in ((8, 8), (16, 16)):
        np.testing.assert_array_equal(
            tbs.column_extents(_t(a[0]), bi, bk).numpy(),
            jbs.column_extents(a[0], bi, bk))
    row_ext = j_re(a[0], 8)
    rows, valid = np.zeros(16, np.int32), np.arange(16) < 11
    rows[:11] = np.sort(rng.choice(32, 11, replace=False))
    np.testing.assert_array_equal(
        tbs.gathered_tile_extents(_t(row_ext), _t(rows), _t(valid), 8).numpy(),
        np.asarray(jbs.gathered_tile_extents(
            jnp.asarray(row_ext), jnp.asarray(rows), jnp.asarray(valid), 8)))
    bre = j_bre(a, 8)
    rows2 = np.stack([rng.permutation(32)[:16] for _ in range(2)]).astype(
        np.int32)
    valid2 = np.arange(16)[None, :] < np.array([[5], [16]])
    np.testing.assert_array_equal(
        tbs.batched_gathered_tile_extents(_t(bre), _t(rows2), _t(valid2),
                                          8).numpy(),
        np.asarray(jbs.batched_gathered_tile_extents(
            jnp.asarray(bre), jnp.asarray(rows2), jnp.asarray(valid2), 8)))


@pytest.mark.parametrize("tgt", [1.0, 30.0, 57.0, 1e9, float("inf")])
def test_find_hi_device_matches_reference(tgt):
    """Ties in the supports (values 0..11 over 40 rows), a target exactly
    on a prefix sum, one above the remaining mass, and inf (catch-all)."""
    rng = np.random.default_rng(2)
    sup = rng.integers(0, 12, 40).astype(np.float32)
    w = rng.integers(0, 9, 40).astype(np.float32)
    alive = rng.random(40) < 0.8
    sup[~alive] = np.inf
    want = float(jops.find_hi_device(jnp.asarray(sup), jnp.asarray(alive),
                                     jnp.asarray(w), jnp.float32(tgt)))
    got = tops.find_hi_device(_t(sup), _t(alive), _t(w),
                              torch.tensor(tgt, dtype=torch.float32))
    assert got.dtype == torch.float32 and float(got) == want


def test_tighten_extents_device_matches_reference():
    rng = np.random.default_rng(13)
    a = _staircase(rng, 1, 32, 64)[0]
    for n_live in (0, 13, 40, 64):
        for bi, bk in ((8, 8), (16, 16)):
            want = jops.tighten_extents_device(
                jnp.asarray(a), jnp.int32(n_live), block_rows=bi, block_k=bk)
            got = tops.tighten_extents_device(
                _t(a), torch.tensor(n_live), block_rows=bi, block_k=bk)
            for g_, w_ in zip(got, want):
                np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def test_row_extents_match_reference():
    rng = np.random.default_rng(3)
    a = _staircase(rng, 3, 16, 32)
    for bk in (4, 8, 16):
        np.testing.assert_array_equal(tbs.row_extents(a[0], bk),
                                      j_re(a[0], bk))
        np.testing.assert_array_equal(tbs.batched_row_extents(a, bk),
                                      j_bre(a, bk))
        np.testing.assert_array_equal(
            tbs.row_extents_device(_t(a[1]), bk).numpy(),
            np.asarray(j_red(jnp.asarray(a[1]), bk)))
        np.testing.assert_array_equal(
            tbs.row_extents_device(_t(a), bk).numpy(), j_bre(a, bk))


def test_extents_of_ragged_shapes_are_upper_bounds():
    """Columns or rows that are not a multiple of the stripe/tile still
    get exact extents: a ragged last stripe or tile counts as one."""
    rng = np.random.default_rng(4)
    a = _staircase(rng, 1, 13, 27)[0]
    ext = tbs.row_extents_device(_t(a), 8).numpy()
    padded = np.zeros((13, 32), np.float32)
    padded[:, :27] = a
    np.testing.assert_array_equal(ext, j_re(padded, 8))
    tiles = tbs.tile_extents(_t(ext), 4).numpy()
    np.testing.assert_array_equal(
        tiles, np.pad(ext, (0, 3)).reshape(-1, 4).max(axis=1))


# ---------------------------------------------------------------------- #
# backend registry
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("typo,hint", [("cdua", "cuda"), ("troch", "torch"),
                                       ("tourch", "torch")])
def test_unknown_backend_did_you_mean(typo, hint):
    with pytest.raises(ValueError, match=f"did you mean '{hint}'"):
        tops.resolve_backend(typo)


@pytest.mark.parametrize("name", ["xla", "interpret", "pallas",
                                  "pallas_sparse", "interpret_sparse"])
def test_reference_backend_names_are_not_backends_here(name):
    with pytest.raises(ValueError, match="unknown kernel backend"):
        tops.resolve_backend(name)


def test_backend_must_match_the_tensors_device():
    assert tops.resolve_backend(None, "cpu") == "torch"
    assert tops.resolve_backend(None, torch.device("cuda")) == "cuda"
    assert tops.resolve_backend(None) == "cuda"
    assert tops.resolve_backend("torch_sparse", "cpu") == "torch_sparse"
    assert tops.resolve_backend("cuda_sparse", "cuda") == "cuda_sparse"
    for card, plain in (("cuda", "torch"), ("cuda_sparse", "torch_sparse")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tops.resolve_backend(card, "cpu")
        with pytest.raises(ValueError, match="CPU tensors only"):
            tops.resolve_backend(plain, torch.device("cuda"))
    a = torch.zeros(8, 8)
    ids = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.butterfly_update(a, a, torch.ones(8), ids, ids, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.butterfly_update(a, a, torch.ones(8), ids, ids,
                              backend="cuda_sparse")


def test_no_degradation_chain():
    assert set(tops.SPARSE_BACKENDS) == {"cuda_sparse", "torch_sparse"}
    assert set(tops.SPARSE_BACKENDS) < set(tops.KNOWN_BACKENDS)
    for b in tops.KNOWN_BACKENDS:
        assert tops.fallback_chain(b) == (b,)
        assert b in tops.route_label(b)


def test_cpu_tensors_take_the_plain_version_uncounted():
    tops.reset_launch_counts()
    rng = np.random.default_rng(5)
    a = _t(_adj(rng, 16, 16))
    ids = torch.arange(16, dtype=torch.int32)
    tbf.butterfly_update(a, a, torch.ones(16), ids, ids)
    tbf.butterfly_update_batched(a[None], a[None], torch.ones(1, 16),
                                 ids[None], ids[None])
    tops.b2_stack(a[None], blocks=(8, 8, 8))
    k = torch.full((2,), 2, dtype=torch.int32)
    tbs.butterfly_update_sparse(a, a, torch.ones(16), ids, ids, k, k,
                                blocks=(8, 8, 8))
    tbs.butterfly_update_sparse_batched(a[None], a[None], torch.ones(1, 16),
                                        ids[None], ids[None], k[None],
                                        k[None], blocks=(8, 8, 8))
    i32 = torch.int32
    tops.butterfly_update_tiled(
        a.reshape(2, 8, 16), torch.tensor([0, 1], dtype=i32),
        torch.zeros(2, dtype=i32), torch.tensor([0, 1, 2], dtype=i32),
        torch.tensor([[0], [1]], dtype=i32), torch.ones(2, dtype=i32),
        torch.ones(16))
    assert tops.launch_counts() == {"butterfly_update[count]": 0,
                                    "butterfly_update[peel]": 0,
                                    "butterfly_update[tile]": 0,
                                    "butterfly_update_batched[peel]": 0,
                                    "butterfly_update_batched[tile]": 0,
                                    "butterfly_update_sparse[count]": 0,
                                    "butterfly_update_sparse[peel]": 0,
                                    "butterfly_update_sparse[tile]": 0,
                                    "butterfly_update_sparse_batched[peel]": 0,
                                    "butterfly_update_sparse_batched[tile]": 0,
                                    "b2_stack[pairs]": 0,
                                    "b2_stack[tile]": 0,
                                    "butterfly_update_tiled[count]": 0,
                                    "butterfly_update_tiled[peel]": 0}


@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
def test_callers_name_the_wedge_body(backend, monkeypatch):
    """Kernels 1 and 4 launch the body their caller names: the count body
    for counting (``ops.butterfly_support``) and for the engine's
    initial counts and HUC recounts (``support_all``), the peel body for
    the engine's peel updates (``support_delta``) and by default, the
    tile body (the f32 yardstick) only when named.  The counting form
    reaches the wrapper with one tensor for both sides (and one extent
    tensor), as the count body requires."""
    from repro_torch.core.engine import peel_loop as tpl

    seen = []

    def spy(a, b, s, ids_a, ids_b, *extents, blocks=None, body):
        seen.append(body)
        if body == "count":
            assert b is a and ids_b is ids_a
            assert not extents or extents[1] is extents[0]
        return torch.zeros(a.shape[0])

    monkeypatch.setattr(tbf, "butterfly_update", spy)
    monkeypatch.setattr(tbs, "butterfly_update_sparse", spy)
    a = torch.zeros(16, 8)
    ids = torch.arange(16, dtype=torch.int32)
    alive = torch.ones(16)
    blocks = (8, 8, 8)
    kmax = torch.ones(2, dtype=torch.int32) if backend == "torch_sparse" \
        else None
    tops.butterfly_support(a, alive, backend=backend, blocks=blocks,
                           kmax=kmax)
    tpl.support_all(a, alive, ids, kmax, backend=backend, blocks=blocks)
    b = a[:8]
    tpl.support_delta(a, b, torch.ones(8), ids, ids[:8], kmax,
                      None if kmax is None else kmax[:1], backend=backend,
                      blocks=blocks)
    tops.butterfly_update(a, b, torch.ones(8), ids, ids[:8],
                          backend=backend, blocks=blocks)
    tops.butterfly_update(a, b, torch.ones(8), ids, ids[:8],
                          backend=backend, blocks=blocks, body="tile")
    # the counting form with no extents given and an operand to convert
    tops.butterfly_support(a.double(), alive, backend=backend, blocks=blocks)
    assert seen == ["count", "count", "peel", "peel", "tile", "count"]


def test_count_body_takes_only_the_counting_form():
    """``body="count"`` holds on every device: B must be A, ids_b ids_a
    and kmax_b kmax_a, the same storage (a view of the same elements
    counts, a copy does not); anything else raises, it is never rerouted.
    An unknown body raises too."""
    rng = np.random.default_rng(9)
    a = _t(_adj(rng, 16, 12))
    ids = torch.arange(16, dtype=torch.int32)
    s = torch.ones(16)
    k = torch.full((2,), 2, dtype=torch.int32)
    want = tbf.butterfly_update_plain(a, a, s, ids, ids)
    assert torch.equal(tbf.butterfly_update(a, a, s, ids, ids, body="count"),
                       want)
    assert torch.equal(tbf.butterfly_update(a, a[:], s, ids, ids,
                                            body="count"), want)
    assert torch.equal(tbs.butterfly_update_sparse(
        a, a, s, ids, ids, k, k, blocks=(8, 8, 8), body="count"), want)
    for args in ((a, a.clone(), s, ids, ids), (a, a, s, ids, ids.clone()),
                 (a, a[:8], s[:8], ids, ids[:8])):
        with pytest.raises(ValueError, match="counting form"):
            tbf.butterfly_update(*args, body="count")
    with pytest.raises(ValueError, match="counting form"):
        tbs.butterfly_update_sparse(a, a, s, ids, ids, k, k.clone(),
                                    blocks=(8, 8, 8), body="count")
    with pytest.raises(ValueError, match="body"):
        tbf.butterfly_update(a, a, s, ids, ids, body="dense")
    for body in ("peel", "tile"):
        assert torch.equal(tbf.butterfly_update(a, a.clone(), s, ids, ids,
                                                body=body), want)


# ---------------------------------------------------------------------- #
# the count body's split (csrc/butterfly_count.cu) in plain PyTorch
# ---------------------------------------------------------------------- #
def _count_split(a, s, ids, tile, kmax=None, blocks=None):
    """The count body's arithmetic at ``tile`` rows a tile (128 on the
    card): the pre-pass keeps row tile R's columns below kcut_R = the
    covering extent of its rows (``kmax`` of ``blocks`` tiles, which
    need not divide ``tile``) times bk, else n_v; only the tile pairs
    I <= J are multiplied; C(W, 2) in the reference's order, the not-self
    mask on the ids; a pair adds its rows' sums weighted by s[j] into
    out[I rows] and, off the diagonal, its columns' sums weighted by s[i]
    into out[J rows].  Integer-valued f32 sums, as the kernel's."""
    n, n_v = a.shape
    n_t = -(-n // tile)
    rows = [slice(t * tile, min(t * tile + tile, n)) for t in range(n_t)]
    a8 = torch.zeros(n, n_v, dtype=torch.int64)
    for r in rows:
        kcut = n_v
        if kmax is not None:
            bi, _, bk = blocks
            cover = kmax[r.start // bi: (r.stop - 1) // bi + 1]
            kcut = min(int(cover.max()) * bk, n_v)
        a8[r, :kcut] = (a[r, :kcut] != 0).to(torch.int64)
    out = torch.zeros(n)
    for j in range(n_t):
        rj = rows[j]
        for i in range(j + 1):
            ri = rows[i]
            w = (a8[ri] @ a8[rj].T).to(torch.float32)
            b2 = torch.where(ids[ri][:, None] != ids[rj][None, :],
                             w * (w - 1.0) * 0.5, 0.0)
            out[ri] += (b2 * s[rj][None, :]).sum(dim=1)
            if i != j:
                out[rj] += (b2 * s[ri][:, None]).sum(dim=0)
    return out


# the reference's staircase count at its own (16, 16, 16) tiles, padded as
# its Pallas entry points need, once per graph: the interpreter is slow
_REF_BLOCKS = (16, 16, 16)


@functools.lru_cache(maxsize=None)
def _reference_counts(case):
    from conftest import GRAPH_CASES

    a = GRAPH_CASES[case]().relabel_by_degree().dense()
    n = a.shape[0]
    s = (np.random.default_rng(n).random(n) < 0.7).astype(np.float32)
    bi, _, bk = _REF_BLOCKS
    a_pad = np.zeros((-(-n // bi) * bi, -(-a.shape[1] // bk) * bk),
                     np.float32)
    a_pad[:n, :a.shape[1]] = a
    s_pad = np.zeros(a_pad.shape[0], np.float32)
    s_pad[:n] = s
    kmax = tbs.column_extents(_t(a_pad), bi, bk)
    xla = np.asarray(jops.butterfly_support(jnp.asarray(a), jnp.asarray(s),
                                            backend="xla"))
    sparse = np.asarray(jops.butterfly_support(
        jnp.asarray(a_pad), jnp.asarray(s_pad), backend="interpret_sparse",
        blocks=_REF_BLOCKS, kmax=jnp.asarray(kmax.numpy())))[:n]
    return a, s, xla, sparse


@pytest.mark.parametrize("extents", [None, (8, 8, 8), (12, 12, 4)])
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("case", ["fig1", "er_small", "er_dense", "powerlaw",
                                  "vhub", "empty_edges", "single_bfly",
                                  "star"])
def test_count_split_matches_plain_and_reference(case, tile, extents):
    """The count body's split (upper-triangle tile pairs, row plus column
    sums, self-exclusion on the ids) bit-identical to kernel 1's plain
    version, to kernel 4's with the same extents, and to the reference's
    counting form (``xla``; ``interpret_sparse``, the Pallas staircase
    kernel under the interpreter); on the degree-sorted GRAPH_CASES with
    ~30% dead rows in s, extents of tiles that do not divide the count
    tile among them (12 rows against 8 and 16)."""
    a_np, s_np, xla, sparse = _reference_counts(case)
    a, s = _t(a_np), _t(s_np)
    n = a.shape[0]
    ids = torch.arange(n, dtype=torch.int32)
    kmax = None
    if extents is not None:
        kmax = tbs.column_extents(a, extents[0], extents[2])
    got = _count_split(a, s, ids, tile, kmax, extents)
    want = tbf.butterfly_update_plain(a, a, s, ids, ids)
    assert torch.equal(got, want)
    if extents is not None:
        assert torch.equal(got, tbs.butterfly_update_sparse_plain(
            a, a, s, ids, ids, kmax, kmax, blocks=extents))
        via_ops = tops.butterfly_support(a, s, backend="torch_sparse",
                                         blocks=extents, kmax=kmax)
    else:
        via_ops = tops.butterfly_support(a, s, backend="torch")
    assert torch.equal(via_ops, want)
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), sparse)


def test_peel_body_helpers_read_nothing_on_the_host():
    """The host side of the peel launches (scratch sizing, kernel 6's row
    windows, the scratch's allocation) reads no tensor's value: under a
    dispatch mode that raises on every such read, with the operands of an
    engine peel update."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoHostReads(TorchDispatchMode):
        READS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::item",
                 "aten::is_nonzero")

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.name in self.READS:
                raise AssertionError(f"host read: {func}")
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(3)
    a = _t(_adj(rng, 300, 257))
    with NoHostReads():
        peel = torch.zeros(300, dtype=torch.bool)
        peel[7] = True
        order = torch.argsort((~peel).to(torch.int8), stable=True)[:128]
        b = a[order]
        n = tbf.peel_scratch_bytes(b.shape[0], a.shape[1])
        scratch = torch.empty(n, dtype=torch.uint8)
        windows, cap = tbt.peel_windows(300, 17, 16, 512, 4 * a.numel())
        n6 = tbt.peel_scratch_bytes(cap, 16, 512)
        scratch6 = torch.empty(n6, dtype=torch.uint8)
    assert windows == [(0, 300)] and cap == 17
    # flags (1 chunk x 9 stripes, 16-byte rounded) + s8 rows (128 x 288)
    assert n == 48 + 128 * 9 * 32 and scratch.numel() == n
    # count + row list (2 chunks x 16) + masks (2 x 16 x 1) + s8 rows
    assert n6 == 16 + 128 + 128 + 2 * 16 * 16 * 512 and scratch6.numel() == n6


def test_wrapper_checks_reject_bad_inputs():
    a = torch.zeros(8, 4)
    ids = torch.arange(8, dtype=torch.int32)
    s = torch.ones(8)
    with pytest.raises(TypeError, match="int32"):
        tbf._check(a, a, s, ids.long(), ids, batched=False)
    with pytest.raises(ValueError, match="contiguous"):
        tbf._check(torch.zeros(4, 8).T, a, s, ids, ids, batched=False)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        tbf._check(a, torch.zeros(8, 5), s, ids, ids, batched=False)
    k = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        tbs._check_extents(a, a, k, k, (4, 8, 4))
    with pytest.raises(TypeError, match="int32"):
        tbs._check_extents(a, a, k.long(), k, (8, 8, 4))


# ---------------------------------------------------------------------- #
# build
# ---------------------------------------------------------------------- #
def test_nvcc_command_targets_sm90a(tmp_path):
    cmd = _build.nvcc_command("butterfly_sparse", "nvcc", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd
    src = cmd[-1]
    assert src.endswith("kernels/csrc/butterfly_sparse.cu")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
    assert _build.build_dir().parts[-2:] == ("build", "repro_torch")


def test_build_without_toolkit_raises(tmp_path, monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="no CUDA toolkit"):
        _build.build_all()


# ---------------------------------------------------------------------- #
# the recounted peel bound of chip_smoke.py
# ---------------------------------------------------------------------- #
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extents", [False, True])
@pytest.mark.parametrize("n_valid", [0, 1, 5])
def test_peel_live_bound_matches_brute_force(n_valid, extents):
    """The gathered peel form's recounted bound (``chip_smoke.
    peel_live_work``) against a count over every (A row, gathered row,
    column): 2 operations per (A row, valid gathered row, column) where
    some valid row holds a nonzero and, with extents, the column lies
    below the pair's bound min(kmax_a, kmax_b) * bk; bytes for each A
    row's live columns below its farthest bound, the valid rows of B (a
    row with s = 0 is never needed), s, A's ids and the valid rows' ids,
    out and the extents.  Valid rows in no particular order (a non-prefix
    mask), and invalid rows that keep their content."""
    cs = _chip_smoke()
    rng = np.random.default_rng(11 + n_valid)
    n_a, n_b, n_v = 21, 9, 37
    blocks = (4, 2, 8)
    a = _adj(rng, n_a, n_v, density=0.2)
    b = _adj(rng, n_b, n_v, density=0.15)
    s = np.zeros(n_b, np.float32)
    s[rng.choice(n_b, n_valid, replace=False)] = 1.0
    ka = rng.integers(0, 6, -(-n_a // blocks[0])).astype(np.int32)
    kb = rng.integers(0, 6, -(-n_b // blocks[1])).astype(np.int32)
    ops, want_bytes, live = _peel_brute_force(a, b, s, ka, kb, blocks,
                                              extents)
    args = (torch, _t(a), _t(b), _t(s))
    if extents:
        args += (_t(ka), _t(kb), blocks)
    got_ops, got_bytes, got_live = cs.peel_live_work(*args)
    assert got_ops == ops
    assert got_bytes == want_bytes
    assert got_live == live


def _peel_brute_force(a, b, s, ka, kb, blocks, extents):
    """The gathered peel form's operations, bytes and live columns, counted
    over every (A row, gathered row, column)."""
    n_a, n_v = a.shape
    n_b = b.shape[0]
    n_valid = int((s != 0).sum())
    live = (b[s != 0] != 0).any(axis=0)

    def lim(i, j):
        if not extents:
            return n_v
        return min(ka[i // blocks[0]], kb[j // blocks[1]]) * blocks[2]

    ops = a_bytes = 0
    for i in range(n_a):
        reach = 0
        for j in np.nonzero(s)[0]:
            ops += 2 * sum(1 for c in range(n_v) if live[c] and c < lim(i, j))
            reach = max(reach, lim(i, j))
        a_bytes += 4 * sum(1 for c in range(n_v) if live[c] and c < reach)
    want_bytes = a_bytes + 4.0 * (n_valid * n_v + n_b + n_valid + 2 * n_a)
    if extents:
        want_bytes += 4.0 * (ka.size + kb.size)
    return ops, want_bytes, live.sum()


@pytest.mark.parametrize("extents", [False, True])
def test_stack_peel_bound_matches_brute_force(extents):
    """The stack form's bound (``chip_smoke.stack_peel_live_work``, kernels
    2 and 5) is the gathered peel form's, counted over every (A row,
    gathered row, column) of each group with the group's own extents,
    summed over the groups: a group with no valid row, one with one, one
    with several at random positions, invalid rows that keep their
    content."""
    cs = _chip_smoke()
    rng = np.random.default_rng(21)
    g_n, n_a, n_b, n_v = 3, 21, 9, 37
    blocks = (4, 2, 8)
    a = _adj(rng, g_n, n_a, n_v, density=0.2)
    b = _adj(rng, g_n, n_b, n_v, density=0.15)
    s = np.zeros((g_n, n_b), np.float32)
    for g, n_valid in enumerate((0, 1, 5)):
        s[g, rng.choice(n_b, n_valid, replace=False)] = 1.0
    ka = rng.integers(0, 6, (g_n, -(-n_a // blocks[0]))).astype(np.int32)
    kb = rng.integers(0, 6, (g_n, -(-n_b // blocks[1]))).astype(np.int32)
    ops = nbytes = 0.0
    for g in range(g_n):
        o, n, _ = _peel_brute_force(a[g], b[g], s[g], ka[g], kb[g], blocks,
                                    extents)
        ops += o
        nbytes += n
    ext = (_t(ka), _t(kb), blocks) if extents else ()
    got_ops, got_bytes = cs.stack_peel_live_work(torch, _t(a), _t(b), _t(s),
                                                 *ext)
    assert got_ops == ops
    assert got_bytes == nbytes


@pytest.mark.parametrize("extents", [None, (4, 4, 8), (4, 8, 8), (5, 3, 3)])
def test_b2_pair_bound_matches_brute_force(extents):
    """Kernel 3's bound (``chip_smoke.b2_pair_ops``) against a count over
    every pair x < y of distinct rows of each group that both hold a
    nonzero: 2 operations per column some row of the group holds a
    nonzero in, below min(lim_x, lim_y), lim_x = min(kmax_a[x / bi],
    kmax_b[x / bj]) * bk (clipped at n_v); all-zero rows, an all-zero
    column band and an all-zero group, a ragged last row tile, square
    tiles and bi != bj."""
    cs = _chip_smoke()
    rng = np.random.default_rng(31)
    g_n, m, n_v = 3, 23, 37
    a = (rng.random((g_n, m, n_v)) < 0.3).astype(np.float32)
    a[0, rng.choice(m, 6, replace=False)] = 0.0
    a[:, m - 3:] = 0.0
    a[:, :, 9:13] = 0.0
    a[2] = 0.0
    ka = kb = None
    if extents is not None:
        bi, bj, bk = extents
        ka = rng.integers(0, 7, (g_n, -(-m // bi))).astype(np.int32)
        kb = rng.integers(0, 7, (g_n, -(-m // bj))).astype(np.int32)
    ops = 0
    for g in range(g_n):
        full = (a[g] != 0).any(axis=1)
        live = (a[g] != 0).any(axis=0)

        def lim(x):
            if ka is None:
                return n_v
            return min(min(ka[g, x // bi], kb[g, x // bj]) * bk, n_v)

        for x in range(m):
            for y in range(x + 1, m):
                if full[x] and full[y]:
                    ops += 2 * int(live[:min(lim(x), lim(y))].sum())
    ext = () if ka is None else (_t(ka), _t(kb), extents)
    assert cs.b2_pair_ops(torch, _t(a), *ext) == ops


def test_b2_and_stack_peel_scratch_sizes():
    """Kernel 3's pairs body takes the s8 copy of the stack, each group
    padded to 128-row tiles and a 128-byte pitch; the peel body over a
    stack takes one flag per 32-column stripe of every group's 128-row
    chunks (all rounded once to 16 bytes), then every chunk's s8 rows; a
    one-graph launch is a stack of one."""
    assert tbs.b2_scratch_bytes(1, 1, 1) == 128 * 128
    assert tbs.b2_scratch_bytes(3, 777, 1000) == 3 * 896 * 1024
    assert tbs.b2_scratch_bytes(16, 1024, 1024) == 16 * 1024 * 1024
    assert tbf.peel_scratch_bytes(257, 1000) == 384 + 3 * 128 * 32 * 32
    assert tbf.peel_scratch_bytes(257, 1000, 1) == \
        tbf.peel_scratch_bytes(257, 1000)
    # 3 groups x 3 chunks x 32 stripes of flags, 1,152 bytes
    assert tbf.peel_scratch_bytes(257, 1000, 3) == 1152 + 9 * 128 * 32 * 32
    # 3 groups x 1 chunk x 2 stripes of flags, 24 bytes rounded to 32
    assert tbf.peel_scratch_bytes(1, 33, 3) == 32 + 3 * 128 * 2 * 32


def test_stack_wrappers_check_their_body_on_every_device():
    """Kernels 2 and 5 take the peel or the tile body, kernel 3 the pairs
    or the tile body; any other body raises on CPU tensors too (it would
    on the card, before any launch), and on CPU tensors every body named
    takes the plain version, uncounted."""
    rng = np.random.default_rng(13)
    a = _t(_adj(rng, 2, 16, 12))
    b = a[:, :5].contiguous()
    s = torch.ones(2, 5)
    ids = torch.arange(16, dtype=torch.int32).expand(2, 16).contiguous()
    ids_b = ids[:, :5].contiguous()
    ka = torch.full((2, 2), 2, dtype=torch.int32)
    kb = torch.full((2, 1), 2, dtype=torch.int32)
    blocks = (8, 8, 8)
    tops.reset_launch_counts()
    want = tbf.butterfly_update_batched_plain(a, b, s, ids, ids_b)
    want5 = tbs.butterfly_update_sparse_batched_plain(a, b, s, ids, ids_b, ka,
                                                      kb, blocks=blocks)
    want3 = tbs.b2_stack_plain(a, ka, ka, blocks=blocks)
    for body in tbf.STACK_BODIES:
        assert torch.equal(tbf.butterfly_update_batched(
            a, b, s, ids, ids_b, body=body), want)
        assert torch.equal(tbs.butterfly_update_sparse_batched(
            a, b, s, ids, ids_b, ka, kb, blocks=blocks, body=body), want5)
    for body in tbs.B2_BODIES:
        assert torch.equal(tbs.b2_stack(a, ka, ka, blocks=blocks, body=body),
                           want3)
    for bad in ("count", "pairs", "dense"):
        with pytest.raises(ValueError, match="body"):
            tbf.butterfly_update_batched(a, b, s, ids, ids_b, body=bad)
        with pytest.raises(ValueError, match="body"):
            tbs.butterfly_update_sparse_batched(a, b, s, ids, ids_b, ka, kb,
                                                blocks=blocks, body=bad)
    for bad in ("count", "peel", "dense"):
        with pytest.raises(ValueError, match="body"):
            tbs.b2_stack(a, ka, ka, blocks=blocks, body=bad)
    assert sum(tops.launch_counts().values()) == 0


@pytest.mark.parametrize("extents", [None, (4, 4, 8), (5, 5, 3)])
@pytest.mark.parametrize("dead", [0, 7, 23])
def test_count_triangle_bound_matches_brute_force(dead, extents):
    """The counting form's triangle bound (``chip_smoke.count_pair_ops``)
    against a count over every ordered pair of distinct rows that both
    hold a nonzero, with s mass on a side: 2 operations per unordered
    pair and live column (one some row with mass holds a nonzero in),
    over every column or below the pair's bound min(kmax[i / bi],
    kmax[j / bi]) * bk (clipped at n_v); all-zero rows (padding), an
    all-zero column band and dead rows at random positions, a ragged
    last row tile."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5 + dead)
    n, n_v = 23, 37
    a = (rng.random((n, n_v)) < 0.3).astype(np.float32)
    a[rng.choice(n, 6, replace=False)] = 0.0
    a[n - 3:] = 0.0
    a[:, 9:13] = 0.0
    s = np.ones(n, np.float32)
    s[rng.choice(n, dead, replace=False)] = 0.0
    live = (a[s != 0] != 0).any(axis=0)
    full = (a != 0).any(axis=1)
    kmax = None
    if extents is not None:
        bi, _, bk = extents
        kmax = rng.integers(0, 7, -(-n // bi)).astype(np.int32)

    def cols(i, j):
        if kmax is None:
            lim = n_v
        else:
            lim = min(min(kmax[i // bi], kmax[j // bi]) * bk, n_v)
        return int(live[:lim].sum())

    ops = sum(cols(i, j) for i in range(n) for j in range(n)
              if i != j and full[i] and full[j] and (s[i] or s[j]))
    got = cs.count_pair_ops(torch, _t(a), _t(s),
                            None if kmax is None else _t(kmax), extents)
    assert got == ops

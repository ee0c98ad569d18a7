"""The port's kernel modules against the reference's Pallas kernels.

Every plain version in ``repro_torch.kernels`` must be bit-identical to the
Pallas kernel body of ``repro.kernels`` run under the interpreter
(``interpret=True``), on the same random padded inputs made with numpy.
The f32 integer regime (DESIGN.md section 8) makes the comparison exact,
so the tolerance is zero.  The CUDA kernels are held against the plain
versions on the card by tests/test_torch_gpu.py.
"""
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
    assert tops.launch_counts() == {"butterfly_update": 0,
                                    "butterfly_update_batched": 0,
                                    "butterfly_update_sparse": 0,
                                    "butterfly_update_sparse_batched": 0,
                                    "b2_stack": 0,
                                    "butterfly_update_tiled": 0}


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

"""The port's attention (flash, decode, GQA, MLA) and MoE layers against
the reference's, on the CPU, from carried-across parameters
(``convert.load_params``) and the same seeded numpy inputs.

Mirrors ``tests/test_arch_smoke.py``'s layer tests (flash attention
equals naive, the MoE dispatch equals a dense per-token loop) and holds
each function to the reference's on the same inputs.  Tolerances, float32
throughout: rtol / atol 1e-4, 5e-4 for MLA (the reference test's own);
MoE routing indices, dispatch slots and keep masks exactly equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro.models import moe as jm
from repro_torch.convert import load_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import current_mesh, mesh_context, shard_act
from repro_torch.models import attention as ta
from repro_torch.models import moe as tm

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
MLA_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors; the test
    workers' pools would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _gen():
    return torch.Generator().manual_seed(0)


# --------------------------------------------------------------------- #
# flash and decode attention
# --------------------------------------------------------------------- #
def test_flash_attention_matches_naive():
    """The port's counterpart of the reference's test: causal GQA flash
    attention over 16 x 16 blocks equals masked softmax attention."""
    rng = np.random.default_rng(0)
    b, h, hkv, s, d = 2, 4, 2, 64, 16
    q, k, v = (_t(_normal(rng, (b, n, s, d))) for n in (h, hkv, hkv))
    out = ta.flash_attention(q, k, v, causal=True, q_block=16, kv_block=16)
    kr = torch.repeat_interleave(k, h // hkv, dim=1)
    vr = torch.repeat_interleave(v, h // hkv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, kr) / np.sqrt(d)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool))
    scores = torch.where(mask, scores, -1e30)
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), vr)
    _close(out, want.numpy(), dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("h,hkv,sq,sk,q_offset,causal,qb,kb", [
    (4, 2, 64, 64, 0, True, 16, 16),
    (4, 1, 32, 64, 32, True, 16, 32),     # prefill continuation, GQA 4:1
    (6, 3, 48, 48, 0, False, 16, 16),     # no mask: every block
    (2, 2, 64, 64, 0, True, 32, 16),      # q blocks over two kv blocks
])
def test_flash_attention_matches_reference(h, hkv, sq, sk, q_offset, causal,
                                           qb, kb):
    rng = np.random.default_rng(h * sq + q_offset)
    q = _normal(rng, (2, h, sq, 16))
    k = _normal(rng, (2, hkv, sk, 16))
    v = _normal(rng, (2, hkv, sk, 8))
    want = ja.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_block=qb, kv_block=kb,
                              q_offset=q_offset)
    got = ta.flash_attention(_t(q), _t(k), _t(v), causal=causal, q_block=qb,
                             kv_block=kb, q_offset=q_offset)
    assert got.shape == want.shape
    _close(got, want)


def test_flash_attention_keeps_the_value_dtype():
    """bf16 inputs: float32 scores and statistics, a bf16 accumulator and
    output, as in the reference (compared at bf16's tolerance)."""
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, (1, 2, 32, 16)) for _ in range(3))
    want = ja.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)), q_block=16, kv_block=16)
    got = ta.flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                             q_block=16, kv_block=16)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32),
           dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("n", [7, 12])
def test_decode_attention_matches_reference(n):
    """A part-filled and a full cache of 12 positions."""
    rng = np.random.default_rng(1)
    q = _normal(rng, (2, 4, 1, 16))
    kc = _normal(rng, (2, 2, 12, 16))
    vc = _normal(rng, (2, 2, 12, 16))
    want = ja.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(n))
    got = ta.decode_attention(_t(q), _t(kc), _t(vc), n)
    _close(got, want)


# --------------------------------------------------------------------- #
# GQA and MLA
# --------------------------------------------------------------------- #
GQA_DIMS = dict(n_heads=4, n_kv=2, d_head=8)


def _gqa_pair():
    jp = ja.init_gqa(jax.random.PRNGKey(1), 32, 4, 2, 8)
    tp = load_params(ta.init_gqa(_gen(), 32, 4, 2, 8, device=CPU), _np(jp))
    return jp, tp


def test_gqa_forward_matches_reference():
    jp, tp = _gqa_pair()
    x = _normal(np.random.default_rng(2), (2, 32, 32))
    want = ja.gqa_forward(jp, jnp.asarray(x), q_block=16, kv_block=16,
                          rope_theta=500.0, **GQA_DIMS)
    got = ta.gqa_forward(tp, _t(x), q_block=16, kv_block=16,
                         rope_theta=500.0, **GQA_DIMS)
    _close(got, want)


@pytest.mark.parametrize("steps", [5, 8])
def test_gqa_decode_writes_the_cache_in_place_and_matches(steps):
    """Five decode steps, and eight that fill the cache, from a zero
    cache: outputs and the cache as the reference's; the port writes into
    the same cache tensors and keeps ``len`` a host int."""
    jp, tp = _gqa_pair()
    rng = np.random.default_rng(3)
    jc = {"k": jnp.zeros((2, 2, 8, 8)), "v": jnp.zeros((2, 2, 8, 8)),
          "len": jnp.zeros((), jnp.int32)}
    k0, v0 = torch.zeros((2, 2, 8, 8)), torch.zeros((2, 2, 8, 8))
    tc = {"k": k0, "v": v0, "len": 0}
    decode = jax.jit(functools.partial(ja.gqa_decode, **GQA_DIMS))
    for _ in range(steps):
        x = _normal(rng, (2, 1, 32))
        jo, jc = decode(jp, jnp.asarray(x), jc)
        to, tc = ta.gqa_decode(tp, _t(x), tc, **GQA_DIMS)
        _close(to, jo)
    assert tc["k"] is k0 and tc["v"] is v0
    assert type(tc["len"]) is int and tc["len"] == steps
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


MLA_DIMS = dict(n_heads=4, kv_lora=16, d_nope=16, d_rope=8, d_v=16)


def _mla_pair(q_lora):
    jp = ja.init_mla(jax.random.PRNGKey(2), 64, 4, q_lora, 16, 16, 8, 16)
    tp = load_params(ta.init_mla(_gen(), 64, 4, q_lora, 16, 16, 8, 16,
                                 device=CPU), _np(jp))
    return jp, tp


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_forward_and_absorbed_decode_match_reference(q_lora):
    """The naive prefill form and eight steps of the weight-absorbed
    decode against the compressed cache, each against the reference's;
    then the decode steps against the prefill's outputs (the reference's
    decode-equals-prefill at its 5e-4)."""
    jp, tp = _mla_pair(q_lora)
    x = _normal(np.random.default_rng(4), (2, 8, 64))
    want = jax.jit(functools.partial(ja.mla_forward, q_block=4, kv_block=4,
                                     **MLA_DIMS))(jp, jnp.asarray(x))
    got = ta.mla_forward(tp, _t(x), q_block=4, kv_block=4, **MLA_DIMS)
    _close(got, want, MLA_TOL)
    jc = {"c_kv": jnp.zeros((2, 8, 16)), "k_rope": jnp.zeros((2, 8, 8)),
          "len": jnp.zeros((), jnp.int32)}
    tc = {"c_kv": torch.zeros((2, 8, 16)), "k_rope": torch.zeros((2, 8, 8)),
          "len": 0}
    decode = jax.jit(functools.partial(ja.mla_decode, **MLA_DIMS))
    for t in range(8):
        jo, jc = decode(jp, jnp.asarray(x[:, t:t + 1]), jc)
        to, tc = ta.mla_decode(tp, _t(x[:, t:t + 1]), tc, **MLA_DIMS)
        _close(to, jo, MLA_TOL)
        _close(to[:, 0], np.asarray(got.detach())[:, t], MLA_TOL)
    _close(tc["c_kv"], jc["c_kv"], MLA_TOL)
    _close(tc["k_rope"], jc["k_rope"], MLA_TOL)


def test_mla_params_carry_the_reference_paths():
    from repro_torch.train.tree import keystr, leaves_with_paths

    for q_lora in (0, 32):
        jp, tp = _mla_pair(q_lora)
        want = {jax.tree_util.keystr(p): leaf.shape for p, leaf in
                jax.tree_util.tree_flatten_with_path(jp)[0]}
        got = {keystr(p): tuple(t.shape) for p, t in leaves_with_paths(tp)}
        assert got == want


# --------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------- #
def _moe_pair(d=16, f=32, ne=8, n_shared=1, bias=False, ties=False):
    jp = jm.init_moe(jax.random.PRNGKey(3), d, f, ne, n_shared)
    jp = dict(_np(jp))
    rng = np.random.default_rng(6)
    if bias:
        jp["router_bias"] = (0.1 * rng.normal(size=ne)).astype(np.float32)
    if ties:
        # experts 1 and 5, 2 and 6 score alike: top-k must take the lower
        # index first, as lax.top_k does
        r = np.array(jp["router"])
        r[:, 5], r[:, 6] = r[:, 1], r[:, 2]
        jp["router"] = r
    tp = load_params(tm.init_moe(_gen(), d, f, ne, n_shared, device=CPU), jp)
    return jax.tree.map(jnp.asarray, jp), tp


@pytest.mark.parametrize("mode", ["softmax_topk", "sigmoid_bias"])
@pytest.mark.parametrize("ties", [False, True])
def test_route_indices_equal_reference(mode, ties):
    jp, tp = _moe_pair(bias=mode == "sigmoid_bias", ties=ties)
    x = _normal(np.random.default_rng(7), (24, 16))
    jidx, jg, jaux = jax.jit(functools.partial(jm.route, top_k=3,
                                               mode=mode))(jp, jnp.asarray(x))
    tidx, tg, taux = tm.route(tp, _t(x), top_k=3, mode=mode)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tg, jg)
    _close(taux, jaux)


def test_route_over_groups_equals_route_per_group():
    """The port routes every token group at once; each group's indices,
    gates and aux equal the reference's ``route`` of that group alone."""
    jp, tp = _moe_pair()
    x = _normal(np.random.default_rng(8), (3, 10, 16))
    tidx, tg, taux = tm.route(tp, _t(x), top_k=2)
    for i in range(3):
        jidx, jg, jaux = jm.route(jp, jnp.asarray(x[i]), top_k=2)
        np.testing.assert_array_equal(tidx[i].numpy(), np.asarray(jidx))
        _close(tg[i], jg)
        _close(taux[i], jaux)


@pytest.mark.parametrize("cap", [1, 2, 6])
def test_dispatch_slots_and_keep_mask_equal_reference(cap):
    """With capacity drops (cap 1, 2) and without (6): the dispatched
    tensor, and the combine metadata (slots, token order, gates, keep
    mask) of every group exactly the reference's ``_dispatch_group``."""
    jp, tp = _moe_pair()
    x = _normal(np.random.default_rng(9), (2, 6, 16))
    with torch.no_grad():
        idx, gates, _ = tm.route(tp, _t(x), top_k=2)
        disp, (slot, stok, sgate, keep) = tm._dispatch(_t(x), idx, gates,
                                                       8, cap)
    for i in range(2):
        jd, (js, jt, jg, jk) = jm._dispatch_group(
            jnp.asarray(x[i]), jnp.asarray(idx[i].numpy()),
            jnp.asarray(gates[i].numpy()), 8, cap)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(slot[i].numpy(), np.asarray(js))
        np.testing.assert_array_equal(stok[i].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(sgate[i].numpy(), np.asarray(jg))
        np.testing.assert_array_equal(disp[i].numpy(), np.asarray(jd))
    assert (cap < 6) == (not bool(keep.all()))


@pytest.mark.parametrize("mode", ["softmax_topk", "sigmoid_bias"])
@pytest.mark.parametrize("kw", [dict(capacity_factor=0.5),
                                dict(capacity_factor=1.25),
                                dict(no_drop=True)])
def test_moe_forward_matches_reference(mode, kw):
    """Out and aux, with drops (capacity factor 0.5, 1.25) and without,
    over (B, G) = (2, 2) token groups of 8, shared expert included."""
    jp, tp = _moe_pair(bias=mode == "sigmoid_bias")
    x = _normal(np.random.default_rng(10), (2, 16, 16))
    jo, jaux = jax.jit(functools.partial(
        jm.moe_forward, top_k=2, mode=mode, group_size=8, **kw))(
        jp, jnp.asarray(x))
    to, taux = tm.moe_forward(tp, _t(x), top_k=2, mode=mode, group_size=8,
                              **kw)
    _close(to, jo)
    _close(taux, jaux)


def test_moe_dispatch_matches_dense_compute():
    """The port's counterpart of the reference's test: index-dispatched
    MoE == an explicit per-token expert loop (huge capacity: no drops)."""
    jp, tp = _moe_pair(d=8, f=16, ne=4, n_shared=0)
    x = _t(_normal(np.random.default_rng(11), (2, 8, 8)))
    with torch.no_grad():
        out, _ = tm.moe_forward(tp, x, top_k=2, capacity_factor=8.0)
        x2 = x.reshape(-1, 8)
        idx, gates, _ = tm.route(tp, x2, top_k=2)
        want = torch.zeros_like(x2)
        for t in range(x2.shape[0]):
            for j in range(2):
                e = int(idx[t, j])
                h = (torch.nn.functional.silu(x2[t] @ tp.gate[e])
                     * (x2[t] @ tp.up[e]))
                want[t] += gates[t, j] * (h @ tp.down[e])
    _close(out.reshape(-1, 8), want.numpy(), dict(rtol=1e-4, atol=1e-5))


# --------------------------------------------------------------------- #
# the activation-sharding hooks
# --------------------------------------------------------------------- #
def test_shard_act_is_the_identity_without_a_mesh_and_raises_under_one():
    """Without a mesh ``shard_act`` returns its input.  Since the sharding
    slice it returns it under a ``DeviceMesh`` too (the spec checked and
    recorded), and ``moe_forward`` there takes the expert-parallel
    schedule, equal to the local path without drops; what still raises
    is a mesh that is not a ``DeviceMesh`` (a JAX mesh among them)."""
    x = torch.ones(2, 3)
    assert current_mesh() is None
    assert shard_act(x, ("batch", None)) is x
    mesh = make_mesh((2,), ("data",), devices=[CPU] * 2)
    _, tp = _moe_pair()
    xm = _t(_normal(np.random.default_rng(12), (2, 4, 16)))
    with torch.no_grad():
        local, _ = tm.moe_forward(tp, xm, top_k=2, no_drop=True)
    ctx = mesh_context(mesh)
    with ctx as entered:
        assert entered is mesh and current_mesh() is mesh
        assert shard_act(x, ("batch", None)) is x
        assert ctx.record[("batch", None), (2, 3)] == ("data", None)
        with torch.no_grad():
            out, _ = tm.moe_forward(tp, xm, top_k=2, no_drop=True)
        assert torch.equal(out, local)       # no model axis: local path
    mesh2 = make_mesh((2, 2), ("data", "model"), devices=[CPU] * 4)
    with mesh_context(mesh2), torch.no_grad():
        out, _ = tm.moe_forward(tp, xm, top_k=2, no_drop=True)
    _close(out, local.numpy(), dict(rtol=2e-5, atol=2e-5))
    assert current_mesh() is None
    with pytest.raises(TypeError, match="DeviceMesh"):
        with mesh_context(object()):
            pass
    assert current_mesh() is None

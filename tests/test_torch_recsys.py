"""The port's model layers, the two-tower recsys model, its bundle, the
train launcher and the recsys example against the reference's, on the
CPU, from carried-across parameters (``convert.load_params``) and the
same seeded numpy batches.

Mirrors ``tests/test_arch_smoke.py``'s recsys tests (train, serve and
retrieval smokes, the embedding bag against a loop).  Tolerances: the
layer functions rtol 1e-6 (atol 1e-6 where an output crosses zero); the
model's forward rtol 1e-5; five train steps of the reduced two-tower
losses and params rtol 1e-5 (atol 1e-7).
"""
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as j_get_bundle
from repro.data import synthetic as jsyn
from repro.models import layers as jl
from repro.models import recsys as jrec
from repro.train.train_step import init_train_state as j_init_state
from repro_torch.configs import ALL_ARCHS, get_bundle
from repro_torch.convert import load_params, params_tree
from repro_torch.data import synthetic as tsyn
from repro_torch.models import layers as tl
from repro_torch.models import recsys as trec
from repro_torch.train.train_step import init_train_state

ARCH = "two-tower-retrieval"
ROOT = Path(__file__).resolve().parents[1]
GEN = torch.Generator


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


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _carried(reduced=True, seed=0):
    """The reference bundle, its params, and the port's bundle holding the
    same params."""
    jb = j_get_bundle(ARCH, reduced=reduced)
    tb = get_bundle(ARCH, reduced=reduced)
    jp = jb.init_params(jax.random.PRNGKey(seed))
    tp = load_params(tb.init_params(GEN().manual_seed(seed)), _np(jp))
    return jb, jp, tb, tp


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
def test_initializers_shapes_dtypes_and_scales():
    g = GEN().manual_seed(0)
    w = tl.dense_init(g, 256, 64)
    e = tl.embed_init(g, 1000, 32, dtype=torch.bfloat16)
    jw = jl.dense_init(jax.random.PRNGKey(0), 256, 64)
    assert tuple(w.shape) == jw.shape and w.dtype == torch.float32
    assert e.dtype == torch.bfloat16 and tuple(e.shape) == (1000, 32)
    assert float(w.std()) == pytest.approx(float(jnp.std(jw)), rel=0.05)
    assert float(e.float().std()) == pytest.approx(0.02, rel=0.05)
    meta = tl.dense_init(None, 8, 4, device="meta")
    assert meta.device.type == "meta" and tuple(meta.shape) == (8, 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
@pytest.mark.parametrize("init", [
    lambda: tl.dense_init(None, 8, 4), lambda: tl.embed_init(None, 8, 4),
    lambda: tl.init_mlp(None, [4, 3]), lambda: tl.init_rmsnorm(4),
    lambda: tl.init_layernorm(4), lambda: tl.rope_freqs(4, 8),
    lambda: trec.init_two_tower(None, get_bundle(ARCH, reduced=True).cfg)],
    ids=["dense", "embed", "mlp", "rmsnorm", "layernorm", "rope",
         "two_tower"])
def test_initializers_default_to_the_card(init):
    """With neither a device nor a generator, an initializer builds on
    the card, and raises where there is none."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init()


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    rms = load_params(tl.init_rmsnorm(16, device="cpu"),
                      {"scale": scale})
    _close(tl.rmsnorm(rms, _t(x)), jl.rmsnorm({"scale": scale}, x),
           atol=1e-6)
    ln = load_params(tl.init_layernorm(16, device="cpu"),
                     {"scale": scale, "bias": bias})
    _close(tl.layernorm(ln, _t(x)),
           jl.layernorm({"scale": scale, "bias": bias}, x), atol=1e-6)
    # bfloat16 activations: f32 inside, cast back
    xb = _t(x).to(torch.bfloat16)
    out = tl.rmsnorm(rms, xb)
    assert out.dtype == torch.bfloat16
    want = jl.rmsnorm({"scale": scale}, jnp.asarray(x, jnp.bfloat16))
    _close(out.float(), np.asarray(want.astype(jnp.float32)), rtol=1e-2,
           atol=1e-2)


def test_swiglu_and_mlp_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 8)).astype(np.float32)
    jsw = _np(jl.init_swiglu(jax.random.PRNGKey(1), 8, 12))
    tsw = load_params(tl.init_swiglu(GEN().manual_seed(1), 8, 12), jsw)
    _close(tl.swiglu(tsw, _t(x)), jl.swiglu(jsw, x), atol=1e-6)
    for bias in (True, False):
        jm = _np(jl.init_mlp(jax.random.PRNGKey(2), [8, 16, 4], bias=bias))
        tm = load_params(tl.init_mlp(GEN().manual_seed(2), [8, 16, 4],
                                     bias=bias), jm)
        assert [n for n, _ in tm.named_parameters()] == (
            ["layers.0.w", "layers.0.b", "layers.1.w", "layers.1.b"]
            if bias else ["layers.0.w", "layers.1.w"])
        for final_act in (False, True):
            _close(tl.mlp(tm, _t(x), final_act=final_act),
                   jl.mlp(jm, x, final_act=final_act), atol=1e-6)


def test_rope_matches_reference():
    _close(tl.rope_freqs(16, 40, device="cpu"), jl.rope_freqs(16, 40))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 3, 10)).astype(np.int32)
    _close(tl.apply_rope(_t(x), _t(pos)), jl.apply_rope(x, pos), rtol=1e-5,
           atol=1e-5)


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(4, 7, 33)) * 5).astype(np.float32)
    labels = rng.integers(0, 33, (4, 7)).astype(np.int32)
    mask = (rng.random((4, 7)) > 0.3).astype(np.float32)
    _close(tl.softmax_cross_entropy(_t(logits), _t(labels)),
           jl.softmax_cross_entropy(logits, labels))
    _close(tl.softmax_cross_entropy(_t(logits), _t(labels), _t(mask)),
           jl.softmax_cross_entropy(logits, labels, mask))
    zero = np.zeros_like(mask)
    _close(tl.softmax_cross_entropy(_t(logits), _t(labels), _t(zero)),
           jl.softmax_cross_entropy(logits, labels, zero))


# --------------------------------------------------------------------- #
# the two-tower model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_embedding_bag_matches_loop_and_reference(mode):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(20, 4)).astype(np.float32)
    ids = np.array([[1, 3, -1], [0, -1, -1], [5, 5, 5], [-1, -1, -1]],
                   np.int32)
    out = trec.embedding_bag(_t(table), _t(ids), mode=mode)
    for r, row in enumerate(ids):
        valid = [i for i in row if i >= 0]
        want = table[valid].sum(axis=0) if valid else np.zeros(4, np.float32)
        if mode == "mean" and valid:
            want = want / len(valid)
        np.testing.assert_allclose(out[r].numpy(), want, rtol=1e-6)
    _close(out, jrec.embedding_bag(table, ids, mode=mode))


def test_carried_params_have_the_reference_paths():
    jb, jp, tb, tp = _carried()
    assert isinstance(tp, trec.TwoTower)
    names = [n for n, _ in tp.named_parameters()]
    assert names[0] == "user_tables.0" and "user_mlp.layers.0.w" in names
    back = params_tree(tp)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jp))):
        np.testing.assert_array_equal(a, b)


def test_towers_loss_and_retrieval_match_reference():
    jb, jp, tb, tp = _carried()
    jbatch = jsyn.recsys_batch(jb.cfg, 16, seed=3)
    tbatch = tsyn.recsys_batch(tb.cfg, 16, seed=3, device="cpu")
    u, v = trec.two_tower_embeddings(tp, tbatch, tb.cfg)
    ju, jv = jrec.two_tower_embeddings(jp, jbatch, jb.cfg)
    _close(u, ju, rtol=1e-5, atol=1e-6)
    _close(v, jv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(u.detach().numpy(), axis=-1),
                               1.0, rtol=1e-5)
    _close(trec.sampled_softmax_loss(tp, tbatch, tb.cfg),
           jrec.sampled_softmax_loss(jp, jbatch, jb.cfg), rtol=1e-5)
    _close(tb._steps["serve"](tp, tbatch),
           jb._steps["serve"](jp, jbatch), rtol=1e-5, atol=1e-6)
    cand = np.random.default_rng(4).normal(
        size=(100, tb.cfg.tower_mlp[-1])).astype(np.float32)
    q = {"user_ids": tbatch["user_ids"][:2], "cand_emb": _t(cand)}
    vals, idx = tb._steps["retrieval"](tp, q)
    jvals, jidx = jb._steps["retrieval"](
        jp, {"user_ids": jbatch["user_ids"][:2], "cand_emb": cand})
    assert tuple(vals.shape) == (2, 100) == jvals.shape
    _close(vals, jvals, rtol=1e-5, atol=1e-6)
    # indices equal wherever the score is not tied with a neighbour
    jv_ = np.asarray(jvals)
    untied = np.ones_like(jv_, bool)
    gaps = np.abs(np.diff(jv_, axis=1)) > 1e-5
    untied[:, 1:] &= gaps
    untied[:, :-1] &= gaps
    np.testing.assert_array_equal(idx.numpy()[untied],
                                  np.asarray(jidx)[untied])


def test_recsys_batch_equals_reference():
    for reduced in (True, False):
        jcfg = j_get_bundle(ARCH, reduced=reduced).cfg
        tcfg = get_bundle(ARCH, reduced=reduced).cfg
        for seed, logq in ((0, True), (7, False)):
            jbt = jsyn.recsys_batch(jcfg, 64, seed=seed, with_logq=logq)
            tbt = tsyn.recsys_batch(tcfg, 64, seed=seed, with_logq=logq,
                                    device="cpu")
            assert sorted(jbt) == sorted(tbt)
            for k in jbt:
                assert tbt[k].dtype == getattr(torch, str(jbt[k].dtype))
                np.testing.assert_array_equal(tbt[k].numpy(),
                                              np.asarray(jbt[k]))


def test_bundle_specs_and_abstract_params_match_reference():
    """At the FULL published widths: the input specs of every recsys
    shape, and the meta-device params (nothing allocated) against the
    reference's ``eval_shape``."""
    jb = j_get_bundle(ARCH)
    tb = get_bundle(ARCH)
    assert tb.family == jb.family == "recsys" and tb.shapes.keys() == \
        jb.shapes.keys()
    for sn in jb.shapes:
        assert tb.step_for(sn)[0] == jb.step_for(sn)[0]
        js, ts = jb.input_specs(sn), tb.input_specs(sn)
        assert js.keys() == ts.keys()
        for k in js:
            assert ts[k].shape == js[k].shape
            assert ts[k].dtype == getattr(torch, str(js[k].dtype))
    ab = tb.abstract_params()
    assert all(p.device.type == "meta" for p in ab.parameters())
    jab = jb.abstract_params()
    want = {jax.tree_util.keystr(p): leaf.shape for p, leaf in
            jax.tree_util.tree_flatten_with_path(jab)[0]}
    from repro_torch.train.tree import keystr, leaves_with_paths

    got = {keystr(p): tuple(t.shape) for p, t in leaves_with_paths(ab)}
    assert got == want
    n = sum(p.numel() for p in ab.parameters())
    assert n == 16_652_048 * 256 + sum(
        int(np.prod(s)) for k, s in want.items() if "mlp" in k)
    st = tb.state_abstract()
    assert st["opt"]["m"]["user_tables"][0].device.type == "meta"


def test_get_bundle_of_an_arch_the_port_lacks_raises():
    from repro.configs import ALL_ARCHS as J_ALL

    # every arch of the reference, in its order (the language models, the
    # GNNs, the two-tower); an arch it does not have raises
    assert ALL_ARCHS == J_ALL
    assert ALL_ARCHS[-1] == ARCH and len(ALL_ARCHS) == 10
    with pytest.raises(KeyError):
        get_bundle("no-such-arch")
    with pytest.raises(KeyError):
        get_bundle("receipt-tip")


def test_reduced_two_tower_trains_like_the_reference():
    """The slice as a whole: five train steps of the reduced two-tower in
    both packages from carried-across params and the same batches; the
    per-step losses and the final params within rtol 1e-5."""
    jb, jp, tb, tp = _carried()
    js = j_init_state(jp, jb.opt_cfg)
    ts = init_train_state(tp, tb.opt_cfg)
    jstep = jax.jit(jb._steps["train"])
    tstep = tb._steps["train"]
    for s in range(5):
        js, jm = jstep(js, jsyn.recsys_batch(jb.cfg, 16, seed=s))
        ts, tm = tstep(ts, tsyn.recsys_batch(tb.cfg, 16, seed=s,
                                             device="cpu"))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5)
    for a, b in zip(jax.tree.leaves(_np(js["params"])),
                    jax.tree.leaves(params_tree(ts["params"]))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------- #
# the launcher and the example
# --------------------------------------------------------------------- #
REF_KEYS = {"final_loss", "first_loss", "losses", "steps", "wall_s", "state"}


def test_train_loop_runs_restarts_and_returns_the_reference_keys(tmp_path):
    from repro.launch.train import train_loop as j_train_loop
    from repro_torch.launch.train import train_loop

    want = j_train_loop(arch=ARCH, steps=2, batch_size=8, log_every=0)
    out = train_loop(arch=ARCH, steps=4, batch_size=8, log_every=0,
                     device="cpu", ckpt_dir=str(tmp_path), save_every=2)
    assert REF_KEYS <= set(out) and set(want) <= set(out)
    assert out["start_step"] == 0 and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))
    again = train_loop(arch=ARCH, steps=1, batch_size=8, log_every=0,
                       device="cpu", ckpt_dir=str(tmp_path), save_every=2)
    assert again["start_step"] == 4
    whole = train_loop(arch=ARCH, steps=5, batch_size=8, log_every=0,
                       device="cpu")
    # the resumed fifth step is the uninterrupted run's fifth step
    assert again["losses"][0] == pytest.approx(whole["losses"][4],
                                               rel=1e-6)


def test_launch_train_main_on_cpu(capsys):
    from repro_torch.launch import train as launch_train

    assert launch_train.main(["--arch", ARCH, "--steps", "3",
                              "--batch-size", "8", "--device", "cpu"]) == 0
    assert "[train] done: loss" in capsys.readouterr().out


def _load_example(monkeypatch):
    monkeypatch.setenv("RECEIPT_SMOKE", "1")
    spec = importlib.util.spec_from_file_location(
        "recsys_tip_filtering_torch",
        ROOT / "examples" / "recsys_tip_filtering_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_recsys_example_on_cpu_matches_reference_map(monkeypatch, capsys):
    """``examples/recsys_tip_filtering_torch.py`` with RECEIPT_SMOKE=1 on
    the CPU: its fleet's theta equals the reference example's
    ``Executor.map`` (``auto`` mode), and it prints the reference's
    lines."""
    from repro.api import EngineConfig as JEngineConfig
    from repro.api import Executor as JExecutor
    from repro.core.graph import BipartiteGraph as JGraph

    mod = _load_example(monkeypatch)
    monkeypatch.chdir(ROOT)
    tds, out = mod.main(["--device", "cpu"])
    assert mod.SMOKE and len(tds) == 4
    cohorts, _ = mod.build_fleet(4)
    jfleet = [JGraph.from_edges(g.n_u, g.n_v, g.edges_u, g.edges_v)
              for g in cohorts]
    want = JExecutor(JEngineConfig(num_partitions=8, kernel_blocks=(8, 8, 8),
                                   backend="xla")).map(jfleet)
    for td, w in zip(tds, want):
        np.testing.assert_array_equal(td.theta, w.theta)
    text = capsys.readouterr().out
    assert "decomposed 4 cohort graphs" in text
    assert "fleet: 32/32 spam captured" in text
    assert "two-tower training: loss" in text
    assert len(out["losses"]) == 5

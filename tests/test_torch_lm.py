"""The port's LM transformer, its configs and bundle, and the decode
server against the reference's, on the CPU, from carried-across
parameters (``convert.load_params``) and the same seeded numpy tokens.

Mirrors ``tests/test_arch_smoke.py``'s LM tests (train, prefill and
decode smokes, decode equals prefill for GQA and MLA) and holds every
reduced arch's ``lm_hidden``, ``lm_logits``, ``lm_prefill``, decode loop
and ``lm_loss`` (MTP and the MoE aux included) to the reference's.
Tolerances, float32: rtol / atol 1e-4, 5e-4 for the MLA archs (the
reference's own decode-equals-prefill tolerance there).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as j_get_bundle
from repro.data import synthetic as jsyn
from repro.launch.serve_lm import BatchedServer as JServer
from repro.models import transformer as jtf
from repro.train.train_step import init_train_state as j_init_state
from repro_torch.configs import get_bundle
from repro_torch.convert import load_params, params_tree
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import serve, serve_lm
from repro_torch.models import transformer as ttf
from repro_torch.train.train_step import init_train_state

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LM_ARCHS = ["command-r-plus-104b", "minitron-8b", "deepseek-67b",
            "deepseek-v2-236b", "deepseek-v3-671b"]


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


def _tol(arch):
    mla = j_get_bundle(arch, reduced=True).cfg.attn_kind == "mla"
    return dict(rtol=5e-4, atol=5e-4) if mla else dict(rtol=1e-4, atol=1e-4)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


_CARRIED = {}


def _carried(arch, seed=0):
    """The reference bundle and params, and the port's bundle holding the
    same params (built once per arch; the tests only read them)."""
    if arch not in _CARRIED:
        jb = j_get_bundle(arch, reduced=True)
        tb = get_bundle(arch, reduced=True)
        jp = jax.jit(jb.init_params)(jax.random.PRNGKey(seed))
        tp = load_params(tb.init_params(torch.Generator().manual_seed(seed)),
                         _np(jp))
        _CARRIED[arch] = (jb, jp, tb, tp)
    return _CARRIED[arch]


def _tokens(vocab, b, s, seed):
    j = jsyn.lm_train_batch(vocab, b, s, seed=seed)
    t = tsyn.lm_train_batch(vocab, b, s, seed=seed, device=CPU)
    return j, t


# --------------------------------------------------------------------- #
# data, configs, bundle
# --------------------------------------------------------------------- #
def test_lm_batches_equal_reference():
    j, t = _tokens(128, 3, 10, 7)
    for k in ("tokens", "labels"):
        assert t[k].dtype == torch.int32
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    stream = tsyn.lm_token_stream(128, 2, 4, seed=3, device=CPU)
    jstream = jsyn.lm_token_stream(128, 2, 4, seed=3)
    for _ in range(2):
        np.testing.assert_array_equal(next(stream)["tokens"].numpy(),
                                      np.asarray(next(jstream)["tokens"]))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_equal_reference(arch):
    """Full, reduced and optimizer configs field by field (dtypes by
    name)."""
    def name(v):
        return (str(v).split(".")[-1] if isinstance(v, torch.dtype)
                else np.dtype(v).name)

    def fields(cfg):
        return {k: (name(v) if "dtype" in k else v)
                for k, v in vars(cfg).items()}

    for reduced in (False, True):
        jb, tb = j_get_bundle(arch, reduced=reduced), get_bundle(
            arch, reduced=reduced)
        assert fields(tb.cfg) == fields(jb.cfg)
        assert tb.cfg.n_scan_layers == jb.cfg.n_scan_layers
    assert fields(tb.opt_cfg) == fields(jb.opt_cfg)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_bundle_specs_and_abstract_params_match_reference(arch):
    """At the FULL published widths: every LM shape's step kind and input
    specs (the decode cache from ``init_cache`` on the meta device), and
    the meta-device params (nothing allocated) against the reference's
    ``eval_shape``, path by path."""
    from repro_torch.train.tree import keystr, leaves_with_paths

    jb, tb = j_get_bundle(arch), get_bundle(arch)
    assert tb.family == jb.family == "lm" and tb.shapes.keys() == \
        jb.shapes.keys()
    for sn in jb.shapes:
        assert tb.step_for(sn)[0] == jb.step_for(sn)[0]
        js, ts = jb.input_specs(sn), tb.input_specs(sn)
        assert js.keys() == ts.keys()
        for k in js:
            jl = js[k] if isinstance(js[k], dict) else {"": js[k]}
            tl = ts[k] if isinstance(ts[k], dict) else {"": ts[k]}
            assert jl.keys() == tl.keys()
            for kk in jl:
                assert tl[kk].shape == jl[kk].shape
                assert tl[kk].dtype == getattr(torch, str(jl[kk].dtype))
    ab = tb.abstract_params()
    assert all(p.device.type == "meta" for p in ab.parameters())
    want = {jax.tree_util.keystr(p): (leaf.shape, str(leaf.dtype))
            for p, leaf in
            jax.tree_util.tree_flatten_with_path(jb.abstract_params())[0]}
    got = {keystr(p): (tuple(t.shape), str(t.dtype).split(".")[-1])
           for p, t in leaves_with_paths(ab)}
    assert got == want


def test_full_width_parameter_counts():
    """minitron-8b at its published widths and deepseek-v2-236b cut to 3
    layers (1 dense + 2 MoE), as served on the card."""
    from repro_torch.configs.families import make_lm_bundle

    n = sum(p.numel() for p in get_bundle("minitron-8b")
            .abstract_params().parameters())
    assert n == 9_882_046_464
    v2 = get_bundle("deepseek-v2-236b")
    cut = make_lm_bundle(v2.arch_id, dataclasses.replace(v2.cfg, n_layers=3))
    assert sum(p.numel() for p in cut.abstract_params().parameters()) == \
        9_330_795_840


def test_entry_points_default_to_the_card():
    """No device and no generator: the card, raising without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would allocate there")
    b = get_bundle("minitron-8b", reduced=True)
    for call in (lambda: b.init_params(),
                 lambda: ttf.init_cache(b.cfg, 1, 4),
                 lambda: serve_lm.BatchedServer(b, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert b.init_params(device=CPU).embed.device == CPU


def test_stacked_init_draws_into_the_param_dtype():
    """bf16 params are drawn a layer (and a row chunk) at a time into the
    bf16 stack: every layer differs, and each has the reference's scale
    (std 1/sqrt(d_in) of the float32 draws)."""
    from repro_torch.models import layers as tl

    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 256, 64, torch.bfloat16, n_stack=3, device=CPU)
    assert w.shape == (3, 256, 64) and w.dtype == torch.bfloat16
    assert not torch.equal(w[0], w[1])
    np.testing.assert_allclose(w.float().std(dim=(1, 2)).numpy(),
                               [1 / 16] * 3, rtol=0.05)


# --------------------------------------------------------------------- #
# the model against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_prefill_decode_and_loss_match_reference(arch):
    """The slice as a whole at each reduced arch: ``lm_hidden`` (and its
    MoE aux), ``lm_logits``, ``lm_prefill``, eight decode steps from an
    empty cache and ``lm_loss`` with its metrics (``mtp_ce`` on
    deepseek-v3) against the reference's on the same params and tokens."""
    jb, jp, tb, tp = _carried(arch)
    cfg, jcfg = tb.cfg, jb.cfg
    tol = _tol(arch)
    j, t = _tokens(cfg.vocab, 2, 16, seed=2)

    @jax.jit
    def ref(p, batch):                  # one compile for the four
        h, aux = jtf.lm_hidden(p, batch["tokens"], jcfg)
        return (h, aux, jtf.lm_logits(p, h, jcfg),
                jtf.lm_prefill(p, batch["tokens"], jcfg),
                jtf.lm_loss(p, batch, jcfg)[1])

    jh, jaux, jlogits, jpre, jm = ref(jp, j)
    th, taux = ttf.lm_hidden(tp, t["tokens"], cfg)
    _close(th, jh, tol)
    _close(taux, jaux, tol)
    _close(ttf.lm_logits(tp, th, cfg), jlogits, tol)
    _close(ttf.lm_prefill(tp, t["tokens"], cfg), jpre, tol)
    tl, tm = ttf.lm_loss(tp, t, cfg)
    assert tm.keys() == jm.keys()
    assert ("mtp_ce" in tm) == cfg.mtp
    for k in jm:
        _close(tm[k], jm[k], tol)

    jc = jtf.init_cache(jcfg, 2, 10)
    tc = ttf.init_cache(cfg, 2, 10, device=CPU)
    dec = jax.jit(lambda p, c, x: jtf.lm_decode_step(p, c, x, jcfg))
    for s in range(8):
        jlg, jc = dec(jp, jc, j["tokens"][:, s])
        tlg, tc = ttf.lm_decode_step(tp, tc, t["tokens"][:, s], cfg)
        _close(tlg, jlg, tol)
    assert tc["len"] == int(jc["len"]) == 8
    for k in tc:
        if k != "len":
            _close(tc[k], jc[k], tol)


def _decode_matches_prefill(arch, s, seed, tol):
    _, _, tb, tp = _carried(arch)
    cfg = tb.cfg
    toks = tsyn.lm_train_batch(cfg.vocab, 2, s, seed=seed,
                               device=CPU)["tokens"]
    with torch.no_grad():
        h, _ = ttf.lm_hidden(tp, toks, cfg)
        full = ttf.lm_logits(tp, h, cfg)
    cache = ttf.init_cache(cfg, 2, s, device=CPU)
    for t in range(s):
        lg, cache = ttf.lm_decode_step(tp, cache, toks[:, t], cfg)
        _close(lg, full[:, t].numpy(), tol)


def test_decode_matches_prefill_gqa():
    """The port's counterpart of the reference's test: token-by-token
    decode reproduces teacher-forced prefill logits."""
    _decode_matches_prefill("minitron-8b", 8, 3, dict(rtol=2e-4, atol=2e-4))


def test_decode_matches_prefill_mla():
    """The same for the weight-absorbed MLA decode path."""
    _decode_matches_prefill("deepseek-v2-236b", 6, 4,
                            dict(rtol=5e-4, atol=5e-4))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_smoke(arch):
    """The reference's smoke on the port's bundle steps: prefill logits
    (B, V), two decode steps, finite, the cache at length 2."""
    _, _, tb, tp = _carried(arch)
    cfg = tb.cfg
    toks = tsyn.lm_train_batch(cfg.vocab, 2, 16, seed=2,
                               device=CPU)["tokens"]
    kind, prefill = tb.step_for("prefill_32k")
    logits = prefill(tp, {"tokens": toks})
    assert kind == "serve_prefill" and logits.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    _, decode = tb.step_for("decode_32k")
    cache = ttf.init_cache(cfg, 2, 24, device=CPU)
    for tok in ([1, 2], [3, 4]):
        lg, cache = decode(tp, {"cache": cache,
                                "token": torch.tensor(tok, dtype=torch.int32)})
    assert lg.shape == (2, cfg.vocab) and cache["len"] == 2
    assert bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_smoke(arch):
    """The reference's smoke on the port: one step of the port's train
    step on the reduced LM bundle, finite metrics and params, a positive
    loss.  On minitron-8b the step is held to the reference's jitted
    step from the same params and batch: metrics and the updated params
    within 1e-4 (every arch's forward and loss are held in
    ``test_forward_prefill_decode_and_loss_match_reference``; the
    update is the optimizer's, held in ``tests/test_torch_train.py``)."""
    jb, jp, tb, _ = _carried(arch)
    tp = load_params(tb.init_params(torch.Generator().manual_seed(0)),
                     _np(jp))                       # the step mutates it
    j, t = _tokens(tb.cfg.vocab, 4, 32, seed=1)
    kind, step = tb.step_for("train_4k")
    tstate, tmet = step(init_train_state(tp, tb.opt_cfg), t)
    assert kind == "train" and float(tmet["loss"]) > 0
    assert all(bool(torch.isfinite(v).all()) for v in tmet.values())
    assert all(bool(torch.isfinite(p).all())
               for p in tstate["params"].parameters())
    if arch != "minitron-8b":
        return
    jstate, jmet = jax.jit(jb._steps["train"])(
        j_init_state(jp, jb.opt_cfg), j)
    tol = _tol(arch)
    for k in ("loss", "ce", "aux"):
        _close(tmet[k], jmet[k], tol)
    want = _np(jstate["params"])
    got = params_tree(tstate["params"])
    for (pj, lj), (pt, lt) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        assert jax.tree_util.keystr(pj) == jax.tree_util.keystr(pt)
        np.testing.assert_allclose(lt, lj, **tol)


# --------------------------------------------------------------------- #
# the server and its CLI
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-v2-236b",
                                  "deepseek-v3-671b"])
def test_batched_server_matches_reference(arch):
    """``BatchedServer.run`` on the reference server's params: the tokens equal the reference server's at every step up to the
    first where its top-2 logit margin is within 10x the tolerance in
    some slot (there a near-tie may pick the other token and the streams
    part).  Then the port's server decode fed the reference's stream
    (prompt and generated tokens) gives its logits at every step."""
    jb, jp, tb, _ = _carried(arch)
    tol = _tol(arch)
    prompts = np.random.default_rng(0).integers(
        0, jb.cfg.vocab, (4, 8), dtype=np.int32)
    # the reference server draws its params with PRNGKey(0): the ones
    # ``_carried`` drew
    jserver = JServer(dataclasses.replace(jb, _init_fn=lambda rng: jp),
                      batch_slots=4, max_len=28)
    want = jserver.run(prompts, 16)
    tp = load_params(tb.init_params(device=CPU), _np(jserver.params))
    got = serve_lm.BatchedServer(tb, 4, 28, params=tp).run(prompts, 16)
    assert got.shape == want.shape == (4, 16) and got.dtype == np.int32

    feed = np.concatenate([prompts, want], axis=1)
    forced = serve_lm.BatchedServer(tb, 4, 28, params=tp)
    cache = jtf.init_cache(jb.cfg, 4, 28)
    first_tie = 16
    for s in range(8 + 16 - 1):
        lg, cache = jserver._decode(jserver.params, cache,
                                    jnp.asarray(feed[:, s]))
        _close(forced._decode(torch.from_numpy(feed[:, s].copy())), lg, tol)
        if s >= 7:                      # logits of generated token s - 7
            top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
            if not (top2[:, 1] - top2[:, 0] > 10 * tol["atol"]).all():
                first_tie = min(first_tie, s - 7)
    np.testing.assert_array_equal(got[:, :first_tie + 1],
                                  want[:, :first_tie + 1])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_lm_main_runs_each_arch(arch, capsys):
    assert serve_lm.main(["--arch", arch, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4 slots x (8+16) tokens" in out and "on cpu" in out


def test_serve_shim_and_the_example(monkeypatch, capsys):
    """``launch.serve.BatchedServer`` is the decode server (the reference's
    shim); the example runs on the CPU and serves 4 requests."""
    assert serve.BatchedServer is serve_lm.BatchedServer
    with pytest.raises(AttributeError):
        serve.NoSuchThing
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 4 requests: 12 prompt + 20 generated" in out

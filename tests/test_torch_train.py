"""The port's training substrate (``repro_torch.train``) against the
reference's (``repro.train``) on the same numpy inputs, on the CPU.

Mirrors ``tests/test_substrate.py``'s optimizer, train-step, checkpoint,
restart and elastic-mesh tests.  Tolerances: float32 optimizer state
rtol 1e-6 / atol 1e-7 (the two packages fuse multiply-adds differently);
bfloat16 state one bfloat16 ulp on the moments (a float32 ulp apart can
round to neighbouring bfloat16 values), rtol 1e-6 on the params.

LM training through ``launch/train.py``: its token batches equal the
reference's, remat on and off give the same loss and gradients, the
loop's losses are the reference loop's (rtol / atol 1e-4, the LM tests'
float32 tolerance) and ``main`` trains every reduced LM.
"""
import dataclasses
import importlib.util
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as j_get_bundle
from repro.launch import train as jtrain
from repro.train import optimizer as jopt
from repro.train.train_step import init_train_state as j_init_state
from repro.train.train_step import make_train_step as j_make_step
from repro_torch.configs import get_bundle
from repro_torch.configs.families import make_lm_bundle
from repro_torch.convert import (adamw_config_from_fields, load_params,
                                 params_tree)
from repro_torch.launch import train as ttrain
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import ElasticMesh, RestartManager
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.tree import keystr, leaves_with_paths, map_leaves

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors; the test
    workers' pools would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    """The same AdamW config in both packages."""
    jc = jopt.AdamWConfig(**kw)
    d = dataclasses.asdict(jc)
    d["state_dtype"] = np.dtype(jc.state_dtype).name
    return jc, adamw_config_from_fields(d)


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_matches_reference(schedule):
    """Steps 0-120 of warmup 10 and decay to 110; near the end of the
    cosine 1 + cos(pi t) cancels, so the two libraries' cos (an ulp
    apart, 6e-8 near -1) meet within 1e-7 of lr = 1, not relatively."""
    jc, tc = _pair(lr=1.0, warmup_steps=10, total_steps=110,
                   schedule=schedule)
    for s in range(121):
        want = float(jopt.lr_at(jc, jnp.asarray(s)))
        got = float(topt.lr_at(tc, torch.tensor(s)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), s
    assert float(topt.lr_at(tc, torch.tensor(0))) == 0.0
    assert abs(float(topt.lr_at(tc, torch.tensor(10))) - 1.0) < 1e-6
    if schedule == "cosine":
        assert float(topt.lr_at(tc, torch.tensor(110))) < 1e-6


def _adamw_case():
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(37, 5)).astype(np.float32),
              "b": [rng.normal(size=(7,)).astype(np.float32)],
              "s": np.float32(0.5)}
    grads = [{"w": rng.normal(size=(37, 5)).astype(np.float32) * 3,
              "b": [rng.normal(size=(7,)).astype(np.float32) * 3],
              "s": np.float32(rng.normal() * 3)} for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk_elems", [1 << 22, 16])
def test_adamw_update_matches_reference(state_dtype, chunk_elems,
                                        monkeypatch):
    """Five steps with the clip active (grad norms ~30 against a clip of
    1), warmup and weight decay; the port's in-place chunked update (also
    in chunks of 16 elements, rows of 5) against the reference's."""
    monkeypatch.setattr(topt, "_CHUNK_ELEMS", chunk_elems)
    params, grads = _adamw_case()
    jc, tc = _pair(lr=0.05, warmup_steps=2, total_steps=20,
                   state_dtype=getattr(jnp, state_dtype))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.adamw_init(jp, jc)
    tp = jax.tree.map(_t, params)
    ts = topt.adamw_init(tp, tc)
    assert ts["m"]["w"].dtype == getattr(torch, state_dtype)
    for g in grads:
        jp, js, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                       js, jc)
        tp, ts, tm = topt.adamw_update(tp, jax.tree.map(_t, g), ts, tc)
        assert float(jm["grad_norm"]) > 1.0          # the clip is active
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params_tree(tp))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)
    for part in ("m", "v"):
        want = jax.tree.leaves(jax.tree.map(
            lambda x: np.asarray(x.astype(jnp.float32)), js[part]))
        got = jax.tree.leaves(params_tree(ts[part]))
        for a, b in zip(want, got):
            if state_dtype == "float32":
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_allclose(b, a, rtol=2.0 ** -7, atol=1e-30)


def test_grad_clip_reports_pre_clip_norm():
    jc, tc = _pair(lr=1.0, grad_clip=1e-3, weight_decay=0.0,
                   warmup_steps=0, schedule="constant")
    tparams = {"w": torch.tensor([0.0])}
    _, _, m = topt.adamw_update(tparams, {"w": torch.tensor([1e9])},
                                topt.adamw_init(tparams, tc), tc)
    _, _, jm = jopt.adamw_update({"w": jnp.array([0.0])},
                                 {"w": jnp.array([1e9])},
                                 jopt.adamw_init({"w": jnp.array([0.0])}, jc),
                                 jc)
    assert float(m["grad_norm"]) > 1e8                  # reported pre-clip
    assert float(m["grad_norm"]) == float(jm["grad_norm"])
    # the clipped step moved the param by lr * sign, not by 1e9
    assert abs(float(tparams["w"][0])) <= 1.0 + 1e-6


def _ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.nextafter(x, np.float32(np.inf)) - x


def test_compress_int8_matches_reference():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(257,)).astype(np.float32)
    g[:4] = [1.5, -2.5, 0.5, 127.0 / 254.0]              # round-half cases
    err = (rng.normal(size=(257,)) * 1e-3).astype(np.float32)
    jq, js, je = jopt.compress_int8(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = topt.compress_int8(_t(g), _t(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert abs(float(ts) - float(js)) <= _ulp(float(js))
    assert np.all(np.abs(te.numpy() - np.asarray(je))
                  <= np.maximum(_ulp(np.asarray(je)), _ulp(float(js))))
    np.testing.assert_allclose(topt.decompress_int8(tq, ts).numpy(),
                               np.asarray(jopt.decompress_int8(jq, js)),
                               rtol=1e-6)


def test_int8_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = _t(rng.normal(size=(64,)).astype(np.float32))
    total = torch.zeros_like(g)
    acc_err = torch.zeros_like(g)
    for _ in range(50):
        q, s, acc_err = topt.compress_int8(g, acc_err)
        total = total + topt.decompress_int8(q, s)
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=2e-2)


# --------------------------------------------------------------------- #
# train step
# --------------------------------------------------------------------- #
def _quad_loss_t(params, batch):
    err = params["w"] - batch["target"]
    return torch.sum(err * err), {}


def _quad_loss_j(params, batch):
    err = params["w"] - batch["target"]
    return jnp.sum(err * err), {}


def test_adamw_converges_on_quadratic():
    _, cfg = _pair(lr=0.1, weight_decay=0.0, warmup_steps=0,
                   total_steps=1000, schedule="constant")
    state = init_train_state({"w": torch.zeros((4,))}, cfg)
    step = make_train_step(_quad_loss_t, cfg)
    target = torch.tensor([1.0, -2.0, 3.0, 0.5])
    for _ in range(300):
        state, metrics = step(state, {"target": target})
    np.testing.assert_allclose(state["params"]["w"].detach().numpy(),
                               target.numpy(), atol=1e-2)


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_microbatches_match_each_other_and_reference(compress):
    """microbatches 1 and 4 on the same batch, three steps each, against
    each other and against the reference's ``lax.scan`` form; losses and
    params."""
    jc, tc = _pair(lr=0.01, weight_decay=0.01, warmup_steps=0,
                   schedule="constant")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)

    def tloss(p, b):
        r = (p["w"] * b["x"] - b["y"]) ** 2
        return torch.mean(r), {"max": torch.max(r)}

    def jloss(p, b):
        r = (p["w"] * b["x"] - b["y"]) ** 2
        return jnp.mean(r), {"max": jnp.max(r)}

    out = {}
    for mb in (1, 4):
        ts = init_train_state({"w": torch.ones((3,))}, tc)
        js = j_init_state({"w": jnp.ones((3,))}, jc)
        tstep = make_train_step(tloss, tc, microbatches=mb,
                                compress_grads=compress)
        jstep = jax.jit(j_make_step(jloss, jc, microbatches=mb,
                                    compress_grads=compress))
        for _ in range(3):
            ts, tm = tstep(ts, {"x": _t(x), "y": _t(y)})
            js, jm = jstep(js, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
            for k in ("loss", "max", "grad_norm", "lr"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-6)
        w = ts["params"]["w"].detach().numpy()
        np.testing.assert_allclose(w, np.asarray(js["params"]["w"]),
                                   rtol=1e-6, atol=1e-7)
        out[mb] = w
    np.testing.assert_allclose(out[1], out[4], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# checkpoint
# --------------------------------------------------------------------- #
def _state():
    return {
        "params": {"a": torch.arange(6.0).reshape(2, 3),
                   "b": [torch.ones(4), torch.tensor([1.5, -2.0],
                                                     dtype=torch.bfloat16)]},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _meta_like(tree):
    return map_leaves(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), tree)


def test_checkpoint_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        s = _state()
        ck.save(5, s)
        r = ck.restore(_meta_like(s), device="cpu")
        flat_s, flat_r = leaves_with_paths(s), leaves_with_paths(r)
        assert [keystr(p) for p, _ in flat_s] == [keystr(p) for p, _ in flat_r]
        assert keystr(flat_s[1][0]) == "['params']['b'][0]"
        for (_, a), (_, b) in zip(flat_s, flat_r):
            assert b.device == CPU and b.dtype == a.dtype
            assert torch.equal(a, b)


def test_checkpoint_restores_a_module_from_a_meta_template():
    from repro_torch.models.layers import init_mlp

    mlp = init_mlp(torch.Generator().manual_seed(1), [4, 3, 2])
    state = {"params": mlp, "step": torch.tensor(3)}
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        ck.save(1, state)
        tmpl = {"params": init_mlp(None, [4, 3, 2], device="meta"),
                "step": torch.empty((), dtype=torch.int64, device="meta")}
        r = ck.restore(tmpl, device="cpu")
    assert type(r["params"]) is type(mlp) and int(r["step"]) == 3
    for (n, a), (m, b) in zip(mlp.named_parameters(),
                              r["params"].named_parameters()):
        assert n == m and b.device == CPU and torch.equal(a, b)


def test_checkpoint_atomicity_tmp_ignored():
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        ck.save(1, _state())
        # a torn write (tmp dir without rename) must be invisible
        os.makedirs(os.path.join(d, "step_9.tmp"))
        assert ck.latest_step() == 1


def test_checkpoint_gc_keeps_latest():
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2)
        for step in (1, 2, 3, 4):
            ck.save(step, _state())
        assert ck.all_steps() == [3, 4]


def test_checkpoint_async_snapshots_before_returning():
    """An async save copies to host first: a leaf changed in place right
    after ``save`` returns does not reach the file."""
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        s = _state()
        ck.save(1, s, blocking=False)
        s["params"]["a"].add_(100.0)
        ck.wait()
        assert ck.latest_step() == 1
        r = ck.restore(_meta_like(s), device="cpu")
        assert torch.equal(r["params"]["a"], torch.arange(6.0).reshape(2, 3))


def test_restart_manager_resume():
    with tempfile.TemporaryDirectory() as d:
        rm = RestartManager(CheckpointManager(d), save_every=2)
        s = _state()
        rm.maybe_save(1, s, blocking=True)              # off the cadence
        assert rm.ckpt.latest_step() is None
        fresh, step = rm.resume_or_init(_meta_like(s), device="cpu",
                                        init_fn=lambda: "init")
        assert (fresh, step) == ("init", 0)
        rm.maybe_save(2, s, blocking=True)
        restored, step = rm.resume_or_init(_meta_like(s), device="cpu")
        assert step == 2
        assert torch.equal(restored["params"]["a"], s["params"]["a"])


def test_restart_manager_without_checkpoints_keeps_failure_log():
    rm = RestartManager(max_failures=1)
    assert rm.ckpt is None and rm.save_every == 100
    assert rm.record_failure(RuntimeError("x"))
    assert not rm.record_failure(RuntimeError("y"))


# --------------------------------------------------------------------- #
# elastic mesh
# --------------------------------------------------------------------- #
def test_elastic_mesh_shrinks_preserving_model_axis():
    em = ElasticMesh([torch.device("cpu")] * 8, model_axis=2)
    m = em.make_mesh()
    assert m.shape["model"] == 2 and m.shape["data"] == 4
    em.mark_failed([6, 7])
    m2 = em.make_mesh()
    assert m2.shape["model"] == 2 and m2.shape["data"] == 3
    em.mark_failed([0])                                 # 5 left: model 1
    m3 = em.make_mesh()
    assert dict(m3.shape) == {"data": 5, "model": 1}
    assert len(m3.devices) == 5


def test_checkpoint_async_write_failure_raises_on_wait(monkeypatch):
    """A write that fails on the save thread is not lost: ``wait`` raises
    it, and nothing is published."""
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)

        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(np, "savez", boom)
        ck.save(3, _state(), blocking=False)
        with pytest.raises(OSError, match="disk full"):
            ck.wait()
        assert ck.latest_step() is None
        ck.wait()                                       # raised once


# --------------------------------------------------------------------- #
# LM training through the launcher
# --------------------------------------------------------------------- #
LM_ARCHS = ["command-r-plus-104b", "minitron-8b", "deepseek-67b",
            "deepseek-v2-236b", "deepseek-v3-671b"]


def test_make_batch_fn_lm_batches_equal_reference():
    jb = j_get_bundle("deepseek-v3-671b", reduced=True)
    tb = get_bundle("deepseek-v3-671b", reduced=True)
    for step in (0, 1, 9):
        want = jtrain.make_batch_fn(jb, 8, 64)(step)
        got = ttrain.make_batch_fn(tb, 8, 64, device=CPU)(step)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == torch.int32 and got[k].shape == (8, 64)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-v3-671b"])
def test_remat_on_and_off_give_equal_gradients(arch):
    """The reduced LM's loss and every gradient with each layer
    rematerialized (``cfg.remat``, the default) and without: equal."""
    tb = get_bundle(arch, reduced=True)
    assert tb.cfg.remat
    params = tb.init_params(torch.Generator().manual_seed(0))
    batch = ttrain.make_batch_fn(tb, 2, 32, device=CPU)(0)
    leaves = list(params.parameters())
    out = []
    for remat in (True, False):
        b = make_lm_bundle(arch, dataclasses.replace(tb.cfg, remat=remat),
                           tb.opt_cfg)
        loss = b._loss_fn(params, batch)[0]
        # (deepseek-v3's router bias takes no gradient)
        out.append((loss, torch.autograd.grad(loss, leaves,
                                              allow_unused=True)))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    assert sum(g is not None for g in g1) > len(leaves) // 2
    assert all(a is b is None or torch.equal(a, b) for a, b in zip(g1, g2))


def test_lm_train_loop_matches_reference():
    """``train_loop`` on the reduced minitron-8b from the reference's
    params (each package's loop, its own batch function): three steps'
    losses and the final params within the LM tests' tolerance."""
    jb = j_get_bundle("minitron-8b", reduced=True)
    tb = get_bundle("minitron-8b", reduced=True)
    jp = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    tp = load_params(tb.init_params(torch.Generator().manual_seed(0)),
                     jax.tree.map(np.asarray, jp))
    kw = dict(arch="minitron-8b", steps=3, batch_size=4, seq_len=32,
              log_every=0)
    want = jtrain.train_loop(bundle=dataclasses.replace(
        jb, _init_fn=lambda rng: jp), **kw)
    got = ttrain.train_loop(bundle=dataclasses.replace(
        tb, _init_fn=lambda gen, device: tp), device=CPU, **kw)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray,
                                                 want["state"]["params"])),
                    jax.tree.leaves(params_tree(got["state"]["params"]))):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_main_runs_each_lm_arch(arch, capsys):
    """``python -m repro_torch.launch.train --arch A`` for every LM, at
    the reference's defaults (reduced, batch 8 x 64 tokens)."""
    assert ttrain.main(["--arch", arch, "--steps", "2", "--device",
                        "cpu"]) == 0
    assert "[train] done" in capsys.readouterr().out


def test_train_lm_example_runs(capsys):
    """``examples/train_lm_torch.py`` (the ~100M LM) for two steps of 8 x
    32 tokens on the CPU, its checkpoints in a temporary directory; the
    example's own check (no divergence) holds."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", root / "examples" / "train_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu", "--steps", "2", "--seq-len", "32"])
    out = capsys.readouterr().out
    assert "96.8M params" in out and "(2 steps" in out

"""The port's GNN family (``repro_torch.models.gnn``, ``models.sampler``,
the GNN batches, configs and bundle, the train launcher's GNN branch)
against the reference's, on the CPU, from carried-across parameters
(``convert.load_params``) and the same seeded numpy batches.

Mirrors ``tests/test_arch_smoke.py``'s GNN tests (the four train smokes,
the sampled smoke, the sampler on the graph's structure) and holds each
reduced arch's forward, loss and one train step to the reference's, the
sampled GraphSAGE on the reference's own blocks, the bf16-carry variants,
the neighbour table and the triplets bit for bit.  Tolerances: float32
rtol 1e-4 / atol 1e-5; a bfloat16 carry relative L2 2e-2.
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
from repro.configs.families import make_gnn_bundle as j_make_gnn_bundle
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import gnn as jgnn
from repro.models import layers as jl
from repro.models import sampler as jsampler
from repro.train.train_step import init_train_state as j_init_state
from repro_torch.configs import ALL_ARCHS, get_bundle
from repro_torch.configs.families import make_gnn_bundle
from repro_torch.convert import load_params, params_tree
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models import gnn as tgnn
from repro_torch.models import layers as tl
from repro_torch.models import sampler as tsampler
from repro_torch.train.train_step import init_train_state
from repro_torch.train.tree import keystr, leaves_with_paths

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GNN_ARCHS = ["meshgraphnet", "graphsage-reddit", "dimenet", "graphcast"]
CARRY_ARCHS = ["meshgraphnet", "dimenet", "graphcast"]
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL_L2 = 2e-2


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


def _close(got, want, tol=F32):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def _rel_l2(got, want):
    g = np.asarray(got.detach(), np.float64)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _bundles(arch, carry=None):
    """The reduced bundle in both packages, with a bfloat16 carry where
    ``carry`` says so.  Its AdamW runs at the full learning rate from step
    0 (no warmup: the default's lr is 0 at step 0, where one step would
    leave every param as it was)."""
    jb, tb = j_get_bundle(arch, reduced=True), get_bundle(arch, reduced=True)
    jcfg, tcfg = jb.cfg, tb.cfg
    if carry:
        jcfg = dataclasses.replace(jcfg, carry_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, carry_dtype=torch.bfloat16)
    hot = dict(warmup_steps=0, schedule="constant")
    return (j_make_gnn_bundle(arch, jcfg, dataclasses.replace(jb.opt_cfg,
                                                              **hot)),
            make_gnn_bundle(arch, tcfg, dataclasses.replace(tb.opt_cfg,
                                                            **hot)))


_J_PARAMS = {}


def _carried(arch, carry=None, seed=0):
    """Both bundles, the reference's params (drawn once per case) and the
    port's holding the same values (a fresh module each call: the step
    mutates it)."""
    jb, tb = _bundles(arch, carry)
    if (arch, carry, seed) not in _J_PARAMS:
        _J_PARAMS[arch, carry, seed] = jax.jit(jb.init_params)(
            jax.random.PRNGKey(seed))
    jp = _J_PARAMS[arch, carry, seed]
    tp = load_params(tb.init_params(torch.Generator().manual_seed(seed)),
                     _np(jp))
    return jb, jp, tb, tp


def _smoke_batch(arch, cfg, syn, **kw):
    """The reference smoke's batch (``test_arch_smoke._gnn_smoke_batch``)
    from either package's builders."""
    if arch == "meshgraphnet":
        return syn.meshgraphnet_batch(cfg, n_nodes=40, n_edges=120, seed=0,
                                      **kw)
    if arch == "graphsage-reddit":
        return syn.graphsage_full_batch(cfg, n_nodes=50, n_edges=200, seed=0,
                                        **kw)
    if arch == "dimenet":
        return syn.dimenet_batch(cfg, n_nodes=24, n_edges=60, n_graphs=4,
                                 triplet_fanout=6, seed=0, **kw)
    return syn.graphcast_batch(cfg, n_grid=30, seed=0, **kw)


_SAMPLED = dict(batch_nodes=16, n_nodes=200, n_edges=900, seed=0)
_J_BLOCKS = []


def _reference_blocks(cfg):
    """The reference's sampled batch of the smoke's graph (built once)."""
    if not _J_BLOCKS:
        _J_BLOCKS.append(jsyn.graphsage_sampled_batch(
            cfg, fanouts=cfg.sample_sizes, **_SAMPLED))
    return _J_BLOCKS[0]


def _batches(arch, jb, tb):
    return (_smoke_batch(arch, jb.cfg, jsyn),
            _smoke_batch(arch, tb.cfg, tsyn, device=CPU))


_FORWARD = {
    "meshgraphnet": (jgnn.meshgraphnet_forward, tgnn.meshgraphnet_forward),
    "graphsage-reddit": (jgnn.graphsage_forward_full,
                         tgnn.graphsage_forward_full),
    "dimenet": (lambda p, b, c: jgnn.dimenet_forward(p, b, c, n_graphs=4),
                lambda p, b, c: tgnn.dimenet_forward(p, b, c, n_graphs=4)),
    "graphcast": (jgnn.graphcast_forward, tgnn.graphcast_forward),
}


def _dtype_name(dt):
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


# --------------------------------------------------------------------- #
# the layers the GNNs add
# --------------------------------------------------------------------- #
def test_seg_sum_and_seg_mean_match_segment_sum():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    idx = rng.integers(0, 7, 50).astype(np.int32)
    _close(tgnn.seg_sum(_t(x), _t(idx), 9),
           jax.ops.segment_sum(x, idx, num_segments=9), dict(rtol=1e-6))
    _close(tgnn.seg_mean(_t(x), _t(idx), 9), jgnn.seg_mean(x, idx, 9),
           dict(rtol=1e-6))


def test_mlp_promotes_a_bf16_carry_like_jnp():
    """bf16 activations against f32 weights compute in f32 (JAX's
    promotion); equal dtypes are untouched."""
    rng = np.random.default_rng(1)
    jp = jl.init_mlp(jax.random.PRNGKey(0), [8, 6, 4])
    tp = load_params(tl.init_mlp(torch.Generator().manual_seed(0), [8, 6, 4]),
                     _np(jp))
    x = rng.normal(size=(5, 8)).astype(np.float32)
    want = jl.mlp(jp, jnp.asarray(x).astype(jnp.bfloat16))
    got = tl.mlp(tp, _t(x).to(torch.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, dict(rtol=1e-6, atol=1e-6))
    assert tl.mlp(tp, _t(x)).dtype == torch.float32


def test_remat_recomputes_only_under_grad(monkeypatch):
    calls = []

    def f(a, k):
        calls.append(1)
        return torch.sin(a) * k          # sin saves its input

    a = torch.ones(3, requires_grad=True)
    out = tl.remat(f, a, 2.0)
    out.sum().backward()
    assert len(calls) == 2
    assert torch.equal(a.grad, torch.cos(torch.ones(3)) * 2.0)
    with torch.no_grad():
        tl.remat(f, a, 2.0)
    assert len(calls) == 3


# --------------------------------------------------------------------- #
# configs, bundle, specs
# --------------------------------------------------------------------- #
def test_registry_holds_the_reference_archs():
    from repro.configs import ALL_ARCHS as J_ALL

    assert ALL_ARCHS == J_ALL
    for arch in GNN_ARCHS:
        assert get_bundle(arch).family == "gnn"


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_configs_equal_reference(arch):
    for reduced in (False, True):
        jc = j_get_bundle(arch, reduced=reduced).cfg
        tc = get_bundle(arch, reduced=reduced).cfg
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        for k in ("param_dtype", "carry_dtype"):
            if k in jd:
                jd[k], td[k] = _dtype_name(jd[k]), _dtype_name(td[k])
        assert td == jd
        if arch == "graphcast":
            for prop in ("n_mesh_nodes", "n_mesh_edges",
                         "n_mesh_nodes_padded", "n_mesh_edges_padded"):
                assert getattr(tc, prop) == getattr(jc, prop)


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_input_specs_equal_reference(arch, shape):
    for reduced in (False, True):
        jb = j_get_bundle(arch, reduced=reduced)
        tb = get_bundle(arch, reduced=reduced)
        assert tb.step_for(shape)[0] == jb.step_for(shape)[0]
        want = jb.input_specs(shape)
        got = tb.input_specs(shape)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].shape == tuple(v.shape), k
            assert _dtype_name(got[k].dtype) == np.dtype(v.dtype).name, k


# the full configs' parameter counts (jax.eval_shape of the reference)
FULL_PARAMS = {"meshgraphnet": 2_333_827, "graphsage-reddit": 192_128,
               "dimenet": 1_153_633, "graphcast": 38_864_611}


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_abstract_params_match_reference(arch):
    for reduced in (False, True):
        jab = j_get_bundle(arch, reduced=reduced).abstract_params()
        tb = get_bundle(arch, reduced=reduced)
        ab = tb.abstract_params()
        assert all(p.device.type == "meta" for p in ab.parameters())
        want = {jax.tree_util.keystr(p): tuple(leaf.shape) for p, leaf in
                jax.tree_util.tree_flatten_with_path(jab)[0]}
        got = {keystr(p): tuple(t.shape) for p, t in leaves_with_paths(ab)}
        assert got == want
        if not reduced:
            assert sum(p.numel() for p in ab.parameters()) == \
                FULL_PARAMS[arch]
    assert tb.state_abstract()["opt"]["m"] is not None


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
@pytest.mark.parametrize("make", [
    lambda cfg: tsyn.meshgraphnet_batch(cfg, 8, 16),
    lambda cfg: tsampler.build_nbr_table(np.zeros(3, np.int32),
                                         np.ones(3, np.int32), 4, 2),
    lambda cfg: get_bundle("meshgraphnet", reduced=True).init_params(),
    lambda cfg: ttrain.train_loop(arch="dimenet", steps=1)],
    ids=["batch", "nbr_table", "init_params", "train_loop"])
def test_entry_points_default_to_the_card(make):
    """Without a device, the batch builders, the table build, the params
    and the train loop go to the card, and raise where there is none."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(get_bundle("meshgraphnet", reduced=True).cfg)


# --------------------------------------------------------------------- #
# data: the batches, the neighbour table, the triplets
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_batches_equal_reference(arch):
    """Every array of each builder, and of the train launcher's batch
    function, equal to the reference's (values and dtypes)."""
    jb, tb = _bundles(arch)
    pairs = [_batches(arch, jb, tb)]
    if arch == "dimenet":
        pairs.append((jsyn.dimenet_batch(jb.cfg, 30, 64, seed=3),
                      tsyn.dimenet_batch(tb.cfg, 30, 64, seed=3, device=CPU)))
    for step in (0, 5):
        pairs.append((jtrain.make_batch_fn(jb, 8, 64)(step),
                      ttrain.make_batch_fn(tb, 8, 64, device=CPU)(step)))
    for want, got in pairs:
        assert list(got) == list(want)
        for k, v in want.items():
            assert _dtype_name(got[k].dtype) == np.dtype(v.dtype).name, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def test_sampled_batch_shares_the_reference_draws():
    """The sampled blocks: the seeds' features and the labels are the
    reference's numpy draws, every block has the reference's shape and
    dtype, and each ``idx_l`` is the local layout (position or -1)."""
    cfg = get_bundle("graphsage-reddit", reduced=True).cfg
    want = _reference_blocks(j_get_bundle("graphsage-reddit",
                                          reduced=True).cfg)
    got = tsyn.graphsage_sampled_batch(cfg, fanouts=cfg.sample_sizes,
                                       device=CPU, **_SAMPLED)
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert _dtype_name(got[k].dtype) == np.dtype(v.dtype).name, k
    for k in ("feats_l0", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for i, f in enumerate(cfg.sample_sizes):
        idx = got[f"idx_l{i}"]
        local = torch.arange(idx.numel(), dtype=torch.int32).reshape(idx.shape)
        assert bool(((idx == local) | (idx == -1)).all())


_GRAPHS = [(30, 100, 1, 16), (200, 900, 0, 32), (5, 60, 2, 3),
           (50, 40, 3, 1), (1000, 4000, 4, 8), (7, 7, 5, 32)]


@pytest.mark.parametrize("n,e,seed,max_deg", _GRAPHS)
def test_build_nbr_table_bit_equals_reference(n, e, seed, max_deg):
    """The vectorized build against the reference's loop: truncated
    senders (max_deg below their degree), isolated nodes, int32."""
    snd, rcv = jsyn.random_graph(n, e, seed)
    want_t, want_d = jsampler.build_nbr_table(snd, rcv, n, max_deg)
    got_t, got_d = tsampler.build_nbr_table(snd, rcv, n, max_deg,
                                            device=CPU)
    assert got_t.dtype == got_d.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


@pytest.mark.parametrize("n,e,seed,_", _GRAPHS)
def test_build_triplets_bit_equals_reference(n, e, seed, _, monkeypatch):
    """Every truncation (one triplet, a few, the builders' fanouts, none
    reached), also expanded a few candidates at a time."""
    snd, rcv = jsyn.random_graph(n, e, seed)
    for chunk in (1 << 22, 3):
        monkeypatch.setattr(tsyn, "_TRIPLET_CHUNK", chunk)
        for mt in (1, 5, 2 * e, 8 * e, 100 * e):
            want = jsyn.build_triplets(snd, rcv, mt)
            got = tsyn.build_triplets(snd, rcv, mt)
            for w, g in zip(want, got):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------- #
def _loss_and_forward(arch, jb, jp, tb, tp, jbatch, tbatch):
    jfwd, tfwd = _FORWARD[arch]
    jout, jloss = jax.jit(lambda p, b: (jfwd(p, b, jb.cfg),
                                        jb._loss_fn(p, b)[0]))(jp, jbatch)
    tout, tloss = tfwd(tp, tbatch, tb.cfg), tb._loss_fn(tp, tbatch)[0]
    return jout, jloss, tout, tloss


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_and_loss_match_reference(arch):
    jb, jp, tb, tp = _carried(arch)
    jbatch, tbatch = _batches(arch, jb, tb)
    jout, jloss, tout, tloss = _loss_and_forward(arch, jb, jp, tb, tp,
                                                 jbatch, tbatch)
    assert tout.shape == jout.shape and tout.dtype == torch.float32
    _close(tout, jout)
    _close(tloss, jloss)


def _step_matches(jb, jp, tb, tp, jbatch, tbatch, kind="train"):
    jstate, jmet = jax.jit(jb._steps[kind])(j_init_state(jp, jb.opt_cfg),
                                            jbatch)
    tstate, tmet = tb._steps[kind](init_train_state(tp, tb.opt_cfg), tbatch)
    assert all(bool(torch.isfinite(v).all()) for v in tmet.values())
    assert float(tmet["lr"]) > 0
    for k in ("loss", "grad_norm", "lr"):
        _close(tmet[k], jmet[k])
    # the updated params, and the moments (the gradients' own record)
    for part, want, got in (
            ("params", jstate["params"], tstate["params"]),
            ("m", jstate["opt"]["m"], tstate["opt"]["m"]),
            ("v", jstate["opt"]["v"], tstate["opt"]["v"])):
        want = jax.tree_util.tree_flatten_with_path(_np(want))[0]
        got = jax.tree_util.tree_flatten_with_path(params_tree(got))[0]
        assert len(got) == len(want)
        for (pj, lj), (pt, lt) in zip(want, got):
            assert jax.tree_util.keystr(pj) == jax.tree_util.keystr(pt)
            np.testing.assert_allclose(lt, lj, err_msg=part, **F32)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_train_smoke(arch):
    """The reference's smoke on the port (one step of the reduced bundle,
    finite metrics), held to the reference's step from the same params
    and batch: the metrics and every updated param."""
    jb, jp, tb, tp = _carried(arch)
    jbatch, tbatch = _batches(arch, jb, tb)
    assert tb.step_for("molecule")[0] == "train"
    _step_matches(jb, jp, tb, tp, jbatch, tbatch)


def test_graphsage_sampled_on_the_reference_blocks():
    """``train_sampled`` on the reference's own sampled blocks: the
    forward, the loss and one step's params."""
    jb, jp, tb, tp = _carried("graphsage-reddit")
    jblocks = _reference_blocks(jb.cfg)
    tblocks = {k: _t(v) for k, v in jblocks.items()}
    _close(tgnn.graphsage_forward_sampled(tp, tblocks, tb.cfg),
           jgnn.graphsage_forward_sampled(jp, jblocks, jb.cfg))
    assert tb.step_for("minibatch_lg")[0] == "train_sampled"
    _step_matches(jb, jp, tb, tp, jblocks, tblocks, kind="train_sampled")


def test_graphsage_sampled_smoke():
    """The port's own sampler feeding its sampled step (the reference's
    smoke): finite metrics."""
    b = get_bundle("graphsage-reddit", reduced=True)
    blocks = tsyn.graphsage_sampled_batch(
        b.cfg, fanouts=b.cfg.sample_sizes, device=CPU, **_SAMPLED)
    params = b.init_params(torch.Generator().manual_seed(0))
    _, metrics = b._steps["train_sampled"](init_train_state(params, b.opt_cfg),
                                           blocks)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())


def test_sampler_respects_graph_structure():
    """Sampled neighbours are actual graph neighbours (within the first
    max_deg edges of their node), -1 only at isolated nodes."""
    snd, rcv = tsyn.random_graph(30, 100, seed=1)
    table, deg = tsampler.build_nbr_table(snd, rcv, 30, max_deg=16,
                                          device=CPU)
    adj = {s: set() for s in range(30)}
    for s, r in zip(snd, rcv):
        if len(adj[int(s)]) < 16:
            adj[int(s)].add(int(r))
    nodes = torch.arange(30, dtype=torch.int32)
    nb, nxt = tsampler.sample_block(torch.Generator().manual_seed(0), table,
                                    deg, nodes, fanout=5)
    assert nb.shape == (30, 5) and nxt.shape == (150,)
    assert int(deg.eq(0).sum()) > 0          # the graph has isolated nodes
    for i in range(30):
        for x in nb[i].tolist():
            if x >= 0:
                assert x in adj[i]
            else:
                assert deg[i] == 0
    assert torch.equal(nxt, torch.clamp(nb, min=0).reshape(-1))


@pytest.mark.parametrize("arch", CARRY_ARCHS)
def test_bf16_carry_matches_reference(arch):
    """The full configs' bfloat16 carry at the reduced widths: the
    forward, the loss and the gradients within relative L2 2e-2, the
    output float32 as the reference's."""
    jb, jp, tb, tp = _carried(arch, carry=True)
    jbatch, tbatch = _batches(arch, jb, tb)
    jout, jloss, tout, tloss = _loss_and_forward(arch, jb, jp, tb, tp,
                                                 jbatch, tbatch)
    assert jout.dtype == jnp.float32 and tout.dtype == torch.float32
    assert _rel_l2(tout, jout) <= BF16_REL_L2
    assert _rel_l2(tloss, jloss) <= BF16_REL_L2
    jg = jax.jit(jax.grad(lambda p: jb._loss_fn(p, jbatch)[0]))(jp)
    want = {jax.tree_util.keystr(p): np.ravel(v) for p, v in
            jax.tree_util.tree_flatten_with_path(_np(jg))[0]}
    paths = [keystr(p) for p, _ in leaves_with_paths(tp)]
    tg = torch.autograd.grad(tb._loss_fn(tp, tbatch)[0],
                             list(tp.parameters()))
    assert sorted(paths) == sorted(want)
    got = torch.cat([g.reshape(-1) for g in tg])
    assert _rel_l2(got, np.concatenate([want[k] for k in paths])) \
        <= BF16_REL_L2


@pytest.mark.parametrize("arch", CARRY_ARCHS)
def test_remat_changes_no_gradient(arch, monkeypatch):
    """The three ``jax.checkpoint`` sites as ``remat``: the loss and every
    gradient equal to the same step without rematerialization."""
    _, _, tb, tp = _carried(arch)
    batch = _smoke_batch(arch, tb.cfg, tsyn, device=CPU)
    leaves = list(tp.parameters())

    def grads():
        loss = tb._loss_fn(tp, batch)[0]
        return loss, torch.autograd.grad(loss, leaves)

    l1, g1 = grads()
    monkeypatch.setattr(tgnn, "remat", lambda fn, *a: fn(*a))
    l2, g2 = grads()
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_all_zero_row_gradient_is_the_references():
    """GraphSAGE's normalization at an all-zero row: its gradient there is
    NaN in both packages (``jnp.linalg.norm``'s, which ``sqrt(sum(h h))``
    reproduces; ``torch.linalg.norm``'s would be finite).  In the model
    the ReLU in front masks it: a featureless node whose in-edges are all
    masked has exactly zero rows in both layers, and the loss's gradients
    stay finite and equal to the reference's."""
    h = np.array([[0.0, 0.0, 0.0], [1.0, -2.0, 0.5]], np.float32)
    jgrad = jax.grad(lambda x: jnp.sum(
        x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-6)))
    want = np.asarray(jgrad(jnp.asarray(h)))
    x = _t(h).requires_grad_(True)
    (got,) = torch.autograd.grad(tgnn.l2_normalize(x).sum(), x)
    assert np.isnan(want[0]).all() and torch.isnan(got[0]).all()
    _close(got[1], want[1], dict(rtol=1e-6))

    jb, jp, tb, tp = _carried("graphsage-reddit")
    jbatch, tbatch = _batches("graphsage-reddit", jb, tb)
    lonely = 0
    feats = np.array(jbatch["node_feats"])
    feats[lonely] = 0.0
    emask = np.array(jbatch["edge_mask"])
    emask[np.asarray(jbatch["receivers"]) == lonely] = 0.0
    jbatch = dict(jbatch, node_feats=jnp.asarray(feats),
                  edge_mask=jnp.asarray(emask))
    tbatch = dict(tbatch, node_feats=_t(feats), edge_mask=_t(emask))
    jout = jgnn.graphsage_forward_full(jp, jbatch, jb.cfg)
    assert not np.asarray(jout)[lonely].any()
    assert not tgnn.graphsage_forward_full(tp, tbatch, tb.cfg)[lonely].any()
    _step_matches(jb, jp, tb, tp, jbatch, tbatch)


# --------------------------------------------------------------------- #
# the launcher and the example
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_main_runs_each_gnn_arch(arch, capsys):
    assert ttrain.main(["--arch", arch, "--steps", "3", "--device",
                        "cpu"]) == 0
    assert "[train] done" in capsys.readouterr().out


def test_gnn_example_trains_every_arch(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "gnn_full_stack_torch", ROOT / "examples" / "gnn_full_stack_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr("sys.argv", ["gnn_full_stack_torch.py", "--device",
                                     "cpu", "--steps", "4",
                                     "--minibatches", "3"])
    example.main()
    out = capsys.readouterr().out
    for arch in GNN_ARCHS:
        assert f"[{arch}] loss" in out
    assert "[graphsage minibatch] final loss" in out

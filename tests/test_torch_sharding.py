"""The port's sharding layer (``repro_torch.launch.mesh`` /
``launch.sharding``, the Bundle's sharding methods, the expert-parallel
``moe_forward_sharded``, ``train_loop(mesh=...)``) against the
reference's, on the CPU.

Specs need no devices: the reference's side runs on
``jax.sharding.AbstractMesh``, the port's on a ``DeviceMesh`` over meta
devices, and every spec tree is compared leaf by leaf as slash path ->
``tuple(spec)``.  The reference's sharded MoE needs eight devices: it
runs in ONE subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(module fixture ``ref_moe``), fed the same seeded numpy weights and
inputs as JSON.  Tolerances, float32: the sharded MoE against the
reference's and against the port's local path 2e-5 absolute; gradients
through the exchange 1e-5 relative L2; ``train_loop`` losses 1e-5
relative.
"""
import contextlib
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ALL_ARCHS
from repro.configs import get_bundle as j_get_bundle
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsh
from repro.models import moe as jm
from repro_torch.configs import get_bundle
from repro_torch.convert import load_params
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch.train import make_batch_fn, train_loop
from repro_torch.models import gnn as tgnn
from repro_torch.models import moe as tm
from repro_torch.models import transformer as ttf
from repro_torch.train.tree import leaves_with_paths

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
META = torch.device("meta")
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
LM_ARCHS = ALL_ARCHS[:5]
GNN_ARCHS = ["meshgraphnet", "graphsage-reddit", "dimenet", "graphcast"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors; the test
    workers' pools would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(i):
    """The port's mesh over meta devices and the reference's abstract
    mesh of the same shape and axes."""
    shape, axes = MESHES[i]
    n = int(np.prod(shape))
    return (tmesh.make_mesh(shape, axes, devices=[META] * n),
            AbstractMesh(shape, axes))


def _cpu_mesh(shape=(2, 4), axes=("data", "model")):
    return tmesh.make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


# --------------------------------------------------------------------- #
# 1. spec helpers
# --------------------------------------------------------------------- #
SHAPES = [(6, 8), (16, 32), (2, 3, 4), (256, 512), (1,), (512, 7, 16),
          (4096, 128)]
ENTRIES = [("data", "model"), (("pod", "data"), None), ("model", None,
           ("pod", "data")), (None, "model"), (("pod", "data", "model"),),
           ("absent", "data"), (("data", "model"),
           "pod"), ()]


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_check_div_and_simple_spec_equal_reference(i):
    tm_, jm_ = _meshes(i)
    for shape in SHAPES:
        for ent in ENTRIES:
            got = tsh._check_div(shape, ent, tm_)
            want = jsh._check_div(shape, ent, jm_)
            assert isinstance(got, tmesh.PartitionSpec)
            assert tuple(got) == tuple(want), (shape, ent)
            assert tuple(tsh.simple_spec(tm_, ent, shape).spec) == tuple(
                jsh.simple_spec(jm_, ent, shape).spec), (shape, ent)


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_filter_spec_axis_size_dp_axes_equal_reference(i):
    tm_, jm_ = _meshes(i)
    assert tmesh.dp_axes(tm_) == jmesh.dp_axes(jm_)
    names = [None, "data", "model", "pod", "absent", ("pod", "data"),
             ("pod", "data", "model"), ["data", "model"]]
    for n in names:
        assert tmesh.axis_size(tm_, n) == jmesh.axis_size(jm_, n), n
    for ent in ENTRIES:
        assert tuple(tmesh.filter_spec(tm_, *ent)) == tuple(
            jmesh.filter_spec(jm_, *ent)), ent
        assert tuple(tsh.simple_spec(tm_, ent).spec) == tuple(
            jsh.simple_spec(jm_, ent).spec), ent
    assert tmesh.named(tm_, tmesh.PartitionSpec("model")).spec == ("model",)


def test_divisibility_fallback():
    """The port's counterpart of the reference's test: 6 % 4 != 0 drops
    ``data``; 8 % 2 == 0 keeps ``model``."""
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), devices=[META] * 8)
    assert tsh._check_div((6, 8), ("data", "model"), mesh) == (None, "model")


def test_partition_spec_is_a_tuple_of_entries():
    ps = tmesh.PartitionSpec(["pod", "data"], None, "model")
    assert ps == (("pod", "data"), None, "model")
    assert tuple(ps) == tuple(jax.sharding.PartitionSpec(("pod", "data"),
                                                         None, "model"))
    assert tmesh.PartitionSpec() == ()
    assert "PartitionSpec" in repr(ps)


# --------------------------------------------------------------------- #
# 2. paths
# --------------------------------------------------------------------- #
def _ref_paths(tree):
    return {jsh.norm_path(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_paths(tree):
    return {tsh.norm_path(p): leaf for p, leaf in leaves_with_paths(tree)}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_norm_path_gives_the_reference_paths(arch):
    params = get_bundle(arch, reduced=True).init_params(
        torch.Generator().manual_seed(0), device=CPU)
    want = _ref_paths(j_get_bundle(arch, reduced=True).abstract_params())
    names = {tsh.norm_path(n) for n, _ in params.named_parameters()}
    assert names == set(want)
    assert set(_port_paths(params)) == set(want)
    for n, t in params.named_parameters():
        assert tuple(t.shape) == tuple(want[tsh.norm_path(n)].shape), n
    assert tsh.norm_path("['layers']['attn']['wq']") == "layers/attn/wq"
    assert tsh.norm_path(("user_tables", 0)) == "user_tables/0"


# --------------------------------------------------------------------- #
# 3. spec trees
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _ref_abstract(arch, reduced):
    return j_get_bundle(arch, reduced=reduced).abstract_params()


def _specs_of(tree, port):
    flat = _port_paths(tree) if port else _ref_paths(tree)
    return {k: tuple(s.spec) for k, s in flat.items()}


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_trees_equal_reference(arch, i):
    """param_shardings, state_shardings and input_shardings of every
    shape cell, reduced and full, leaf by leaf; the port's from
    ``abstract_params()`` on the meta device."""
    tm_, jm_ = _meshes(i)
    for reduced in (True, False):
        jb = j_get_bundle(arch, reduced=reduced)
        tb = get_bundle(arch, reduced=reduced)
        ab = _ref_abstract(arch, reduced)
        jp = jb._param_shardings_fn(jm_, ab)
        got = tb.param_shardings(tm_)
        assert _specs_of(got, True) == _specs_of(jp, False)
        got_state = tb.state_shardings(tm_)
        want_state = jsh.train_state_specs(jp)
        assert _specs_of(got_state, True) == _specs_of(want_state, False)
        assert set(got_state) == {"params", "opt"}
        assert set(got_state["opt"]) == {"m", "v", "step"}
        for shape in tb.shapes:
            got_in = _specs_of(tb.input_shardings(shape, tm_), True)
            want_in = _specs_of(jb.input_shardings(shape, jm_), False)
            assert got_in == want_in, (reduced, shape)
            # each input leaf's spec divides the leaf's shape
            for path, sd in _port_paths(tb.input_specs(shape)).items():
                spec = _port_paths(tb.input_shardings(shape, tm_))[path]
                spec.shard_shape(sd.shape)


RULES = [(r"moe/(gate|up)$", (None, "model", ("pod", "data"), None)),
         (r"attn/w", (None, ("pod", "data"), "model")),
         (r"(embed|lm_head)$", ("model", None))]


@pytest.mark.parametrize("i", [1, 3, 5], ids=[MESH_IDS[i] for i in (1, 3, 5)])
def test_spec_by_rules_equals_reference(i):
    """First matching rule, unshifted entries, and the divisibility-
    checked default for the rest, over reduced deepseek-v2-236b."""
    tm_, jm_ = _meshes(i)
    for default in ((), (("pod", "data"),)):
        got = tsh.spec_by_rules(get_bundle("deepseek-v2-236b", reduced=True)
                                .abstract_params(), RULES, tm_, default)
        want = jsh.spec_by_rules(_ref_abstract("deepseek-v2-236b", True),
                                 RULES, jm_, default)
        assert _specs_of(got, True) == _specs_of(want, False)


def test_lm_param_specs_match_paths():
    """The reference's spot checks on reduced deepseek-v3-671b at (1, 1)."""
    mesh = tmesh.make_mesh((1, 1), ("data", "model"), devices=[META])
    by_path = _specs_of(get_bundle("deepseek-v3-671b", reduced=True)
                        .param_shardings(mesh), True)
    assert by_path["layers/moe/gate"][1] == "model"       # EP on experts
    assert by_path["embed"][0] == "model"                 # vocab sharded
    assert by_path["layers/attn/wkv_b"][2] == "model"     # MLA up-proj TP


# --------------------------------------------------------------------- #
# 4. the sharded MoE against the reference's
# --------------------------------------------------------------------- #
D, F_, NE, K, B, S = 16, 32, 8, 2, 4, 16
MOE_CASES = [(mode, shared, cf) for mode in ("softmax_topk", "sigmoid_bias")
             for shared in (0, 1) for cf in (1.25, NE / K)]
MOE_IDS = [f"{m}-shared{s}-cf{c}" for m, s, c in MOE_CASES]


def _moe_inputs(mode, shared, seed=0):
    """Numpy weights (the reference's init layout) and x."""
    rng = np.random.default_rng(seed + 10 * shared)
    f32 = np.float32
    p = {"router": (rng.normal(size=(D, NE)) / D ** 0.5).astype(f32),
         "router_bias": (0.1 * rng.normal(size=NE) if mode == "sigmoid_bias"
                         else np.zeros(NE)).astype(f32),
         "gate": (rng.normal(size=(NE, D, F_)) / D ** 0.5).astype(f32),
         "up": (rng.normal(size=(NE, D, F_)) / D ** 0.5).astype(f32),
         "down": (rng.normal(size=(NE, F_, D)) / F_ ** 0.5).astype(f32)}
    if shared:
        p["shared"] = {
            "gate": (rng.normal(size=(D, F_)) / D ** 0.5).astype(f32),
            "up": (rng.normal(size=(D, F_)) / D ** 0.5).astype(f32),
            "down": (rng.normal(size=(F_, D)) / F_ ** 0.5).astype(f32)}
    x = rng.normal(size=(B, S, D)).astype(f32)
    return p, x


def _port_moe(p):
    mod = tm.init_moe(torch.Generator().manual_seed(0), D, F_, NE,
                      1 if "shared" in p else 0, device=CPU)
    return load_params(mod, p)


REF_MOE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.models.moe import moe_forward
from repro.launch.mesh import make_mesh
from repro.launch.sharding import mesh_context

inp = json.loads(sys.stdin.read())
mesh = make_mesh((2, 4), ("data", "model"))
out = []
for case in inp["cases"]:
    p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                     case["p"], is_leaf=lambda a: isinstance(a, list))
    x = jnp.asarray(np.asarray(case["x"], np.float32))
    with mesh, mesh_context(mesh):
        got, aux = jax.jit(lambda p, x: moe_forward(
            p, x, top_k=inp["k"], capacity_factor=case["cf"],
            mode=case["mode"]))(p, x)
    out.append({"out": np.asarray(got).tolist(), "aux": float(aux)})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_moe():
    """The reference's sharded MoE of every case, from one subprocess."""
    cases = []
    for mode, shared, cf in MOE_CASES:
        p, x = _moe_inputs(mode, shared)
        cases.append({"p": jax.tree.map(lambda a: a.tolist(), p),
                      "x": x.tolist(), "cf": cf, "mode": mode})
    res = subprocess.run(
        [sys.executable, "-c", REF_MOE_SCRIPT],
        input=json.dumps({"cases": cases, "k": K}), capture_output=True,
        text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(MOE_CASES)), ids=MOE_IDS)
def test_moe_forward_sharded_matches_reference(case, ref_moe):
    """(2, 4) mesh of ``cpu`` positions against the reference's forced
    host mesh: with drops (cf 1.25) and without (cf = E / k)."""
    mode, shared, cf = MOE_CASES[case]
    p, x = _moe_inputs(mode, shared)
    tp = _port_moe(p)
    with torch.no_grad(), tsh.mesh_context(_cpu_mesh()):
        out, aux = tm.moe_forward(tp, torch.from_numpy(x), top_k=K,
                                  capacity_factor=cf, mode=mode)
    want = np.asarray(ref_moe[case]["out"], np.float32)
    assert out.shape == want.shape
    assert float(np.max(np.abs(out.numpy() - want))) <= 2e-5
    assert abs(float(aux) - ref_moe[case]["aux"]) <= 2e-5


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.mark.parametrize("shape,axes", [
    ((2, 4), ("data", "model")), ((1, 4), ("data", "model")),
    ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
    ((4,), ("model",))])
@pytest.mark.parametrize("mode,shared", [("softmax_topk", 1),
                                         ("sigmoid_bias", 0)])
def test_moe_sharded_equals_local_path_with_gradients(shape, axes, mode,
                                                      shared):
    """Without drops the sharded path equals the local path (2e-5), and
    the gradients of x and of the expert weights through the exchange
    agree to 1e-5 relative L2."""
    p, x = _moe_inputs(mode, shared, seed=3)
    grads = {}
    for arm in ("local", "sharded"):
        tp = _port_moe(p)
        xt = torch.from_numpy(x).requires_grad_(True)
        mesh = _cpu_mesh(shape, axes) if arm == "sharded" else None
        with tsh.mesh_context(mesh) if mesh else contextlib.nullcontext():
            out, _ = tm.moe_forward(tp, xt, top_k=K, capacity_factor=NE / K,
                                    mode=mode)
        w = torch.from_numpy(np.random.default_rng(4).normal(
            size=out.shape).astype(np.float32))
        (out * w).sum().backward()
        grads[arm] = dict(out=out.detach(), x=xt.grad,
                          **{n: getattr(tp, n).grad for n in
                             ("gate", "up", "down", "router")})
        if shared:
            grads[arm]["shared_up"] = tp.shared.up.grad
    loc, sh = grads["local"], grads["sharded"]
    assert float((sh["out"] - loc["out"]).abs().max()) <= 2e-5
    for k in loc:
        if k != "out":
            assert _rel_l2(sh[k], loc[k]) <= 1e-5, k


def test_sharded_pieces_stay_views_on_the_tensors_device(monkeypatch):
    """Positions that share ``x``'s device take views of x and of the
    expert weights (no copy at n_dp = 1); the exchange buffers are each
    one position's (E / n_model, n_model * cap, d)."""
    p, x = _moe_inputs("softmax_topk", 0)
    tp = _port_moe(p)
    own = {t.untyped_storage().data_ptr() for t in (tp.gate, tp.up,
                                                      tp.down)}
    for shape, views in (((1, 4), True), ((2, 2), False)):
        seen = []
        real = tm._gathered

        def spy(pieces, dim):
            out = real(pieces, dim)
            seen.append(out.untyped_storage().data_ptr() in own)
            return out

        monkeypatch.setattr(tm, "_gathered", spy)
        with torch.no_grad(), tsh.mesh_context(_cpu_mesh(shape)):
            tm.moe_forward(tp, torch.from_numpy(x), top_k=K,
                           capacity_factor=1.0)
        monkeypatch.setattr(tm, "_gathered", real)
        # one gather per weight per position: views at n_dp = 1, the
        # concatenation of the data positions' slices at n_dp = 2
        assert len(seen) == 12 and all(v == views for v in seen)


# --------------------------------------------------------------------- #
# 5. the dispatch condition
# --------------------------------------------------------------------- #
DISPATCH = [((2, 4), 4, 16, 8), ((2, 4), 3, 16, 8), ((2, 4), 4, 6, 8),
            ((2, 4), 4, 16, 6), ((2, 4), 2, 1, 8), ((1, 1), 2, 1, 8),
            ((4, 2), 4, 2, 8), ((2, 2, 2), 4, 8, 8), ((2, 2, 2), 2, 8, 8),
            ((1, 4), 1, 4, 4), ((1, 4), 1, 2, 4)]


@pytest.mark.parametrize("shape,b,s,ne", DISPATCH)
def test_moe_dispatch_condition_matches_reference(shape, b, s, ne,
                                                  monkeypatch):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    n = int(np.prod(shape))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, s, D)).astype(np.float32)
    jp = {"router": rng.normal(size=(D, ne)).astype(np.float32),
          "router_bias": np.zeros(ne, np.float32),
          "gate": rng.normal(size=(ne, D, F_)).astype(np.float32),
          "up": rng.normal(size=(ne, D, F_)).astype(np.float32),
          "down": rng.normal(size=(ne, F_, D)).astype(np.float32)}

    # the reference's decision, traced on an abstract mesh: its sharded
    # entry point replaced by a marker, shard_act by the identity
    took = []

    def marker(p, x, **kw):
        took.append(1)
        return x, jnp.zeros(())

    monkeypatch.setattr(jm, "moe_forward_sharded", marker)
    monkeypatch.setattr(jsh, "shard_act", lambda t, e: t)
    with jsh.mesh_context(AbstractMesh(shape, axes)):
        jax.eval_shape(functools.partial(jm.moe_forward, top_k=K,
                                         group_size=s),
                       jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    want = "sharded" if took else "local"

    def marker(*a, **kw):
        return "sharded", None

    monkeypatch.setattr(tm, "moe_forward_sharded", marker)
    tp = load_params(tm.init_moe(torch.Generator().manual_seed(0), D, F_,
                                 ne, 0, device=CPU), jp)
    with torch.no_grad(), tsh.mesh_context(
            tmesh.make_mesh(shape, axes, devices=[CPU] * n)):
        got, _ = tm.moe_forward(tp, torch.from_numpy(x), top_k=K,
                                group_size=s)
        got = got if isinstance(got, str) else "local"
    assert got == want
    assert tm.sharded_dispatch_applies(
        tmesh.make_mesh(shape, axes, devices=[CPU] * n), b, s, ne) == (
        want == "sharded")


def test_decode_stays_local_under_a_model_axis(monkeypatch):
    """A reduced MoE decode step under the (2, 4) mesh never takes the
    sharded schedule, and its logits equal the step's without a mesh."""
    tb = get_bundle("deepseek-v2-236b", reduced=True)
    cfg = tb.cfg
    params = tb.init_params(torch.Generator().manual_seed(0), device=CPU)
    called = []
    monkeypatch.setattr(tm, "moe_forward_sharded",
                        lambda *a, **kw: called.append(1))
    toks = torch.tensor([3, 5])
    outs = []
    for mesh in (None, _cpu_mesh()):
        cache = ttf.init_cache(cfg, 2, 4, device=CPU)
        with tsh.mesh_context(mesh) if mesh else contextlib.nullcontext():
            lg, _ = ttf.lm_decode_step(params, cache, toks, cfg)
        outs.append(lg)
    assert not called
    assert torch.equal(outs[0], outs[1])


# --------------------------------------------------------------------- #
# 6. shard_act under a mesh
# --------------------------------------------------------------------- #
def _check_records(record, jmesh_):
    """Every recorded spec equals the reference's ``_check_div`` of the
    same shape and the default map's physical entries."""
    amap = jsh.LOGICAL_DEFAULT
    for (logical, shape), spec in record.items():
        phys = tuple(None if e is None else amap.get(e, e) for e in logical)
        assert tuple(spec) == tuple(jsh._check_div(shape, phys, jmesh_)), (
            logical, shape)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_under_a_mesh_equals_without(arch):
    """Reduced forward (hidden, logits, loss) and two decode steps under
    ``mesh_context((2, 4))``: ``torch.equal`` to the calls without a mesh
    (the MoE archs' reduced capacity factor 8 >= E / k: no drops).  The
    softmax router's load-balance aux is a mean over token groups, and
    the sharded schedule's groups are its positions' tokens (the
    reference's too), so for deepseek-v2-236b ``aux`` and the loss that
    adds it are not compared; its CE and every tensor are."""
    tb = get_bundle(arch, reduced=True)
    cfg = tb.cfg
    params = tb.init_params(torch.Generator().manual_seed(0), device=CPU)
    batch = make_batch_fn(tb, 2, 16, device=CPU)(0)
    results = []
    for mesh in (None, _cpu_mesh()):
        ctx = tsh.mesh_context(mesh) if mesh else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            h, aux = ttf.lm_hidden(params, batch["tokens"], cfg)
            logits = ttf.lm_logits(params, h, cfg)
            loss, mets = ttf.lm_loss(params, batch, cfg)
            cache = ttf.init_cache(cfg, 2, 4, device=CPU)
            lg = []
            for t in range(2):
                out, cache = ttf.lm_decode_step(params, cache,
                                                batch["tokens"][:, t], cfg)
                lg.append(out)
        res = dict(h=h, logits=logits, ce=mets["ce"], dec0=lg[0], dec1=lg[1])
        if cfg.router_mode != "softmax_topk" or not cfg.moe:
            res.update(aux=aux, loss=loss,
                       **{f"metric_{k}": v for k, v in mets.items()})
        results.append(res)
        if mesh:
            _check_records(ctx.record, AbstractMesh((2, 4), ("data",
                                                             "model")))
            assert {e for e, _ in ctx.record} >= {
                ("batch", "sp", None), ("batch", "tp", None, None),
                (None, None, "batch")}
    assert results[0].keys() == results[1].keys()
    for k, a in results[0].items():
        assert torch.equal(a, results[1][k]), k


def _gnn_batch(arch, cfg):
    from repro_torch.data import synthetic as syn
    if arch == "meshgraphnet":
        return syn.meshgraphnet_batch(cfg, 40, 120, seed=0, device=CPU)
    if arch == "graphsage-reddit":
        return syn.graphsage_full_batch(cfg, 48, 200, seed=0, device=CPU)
    if arch == "dimenet":
        return syn.dimenet_batch(cfg, 24, 64, n_graphs=4, triplet_fanout=6,
                                 seed=0, device=CPU)
    return syn.graphcast_batch(cfg, 32, seed=0, device=CPU)


@pytest.mark.parametrize("arch", GNN_ARCHS + ["graphsage-sampled"])
def test_gnn_forward_under_a_mesh_equals_without(arch):
    from repro_torch.data import synthetic as syn
    name = "graphsage-reddit" if arch == "graphsage-sampled" else arch
    tb = get_bundle(name, reduced=True)
    cfg = tb.cfg
    params = tb.init_params(torch.Generator().manual_seed(0), device=CPU)
    if arch == "graphsage-sampled":
        batch = syn.graphsage_sampled_batch(cfg, 8, cfg.sample_sizes, 64,
                                            256, seed=0, device=CPU)

        def loss(p, b):
            return tgnn.graphsage_loss(p, b, cfg, mode="sampled")
    else:
        batch = _gnn_batch(arch, cfg)

        def loss(p, b):
            return tb._loss_fn(p, b)[0]
    outs = []
    for mesh in (None, _cpu_mesh()):
        ctx = tsh.mesh_context(mesh) if mesh else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            outs.append(loss(params, batch))
        if mesh:
            _check_records(ctx.record, AbstractMesh((2, 4), ("data",
                                                             "model")))
            # the sampled forward annotates nothing, as the reference's
            assert bool(ctx.record) == (arch != "graphsage-sampled")
    assert torch.isfinite(outs[0])
    assert torch.equal(outs[0], outs[1])


def test_shard_act_records_and_filters_unknown_names():
    x = torch.ones(8, 6)
    assert tsh.current_mesh() is None
    assert tsh.shard_act(x, ("batch", None)) is x
    mesh = _cpu_mesh()
    ctx = tsh.mesh_context(mesh)
    with ctx as m:
        assert m is mesh and tsh.current_mesh() is mesh
        assert tsh.shard_act(x, ("batch", "foo")) is x
        assert tsh.shard_act(x, ("tp", "batch")) is x
    assert tsh.current_mesh() is None
    assert ctx.record[("batch", "foo"), (8, 6)] == ("data", None)
    # 6 % 2 == 0 keeps data on dim 1; tp -> model divides 8
    assert ctx.record[("tp", "batch"), (8, 6)] == ("model", "data")
    with pytest.raises(TypeError):
        tsh.mesh_context(AbstractMesh((2,), ("data",))).__enter__()


# --------------------------------------------------------------------- #
# 7. train_loop(mesh=...)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "meshgraphnet"])
def test_train_loop_under_a_mesh_equals_without(arch):
    """Reduced deepseek-v3-671b (the MoE layers on the sharded schedule,
    capacity factor 8 >= E / k) and meshgraphnet: three steps' losses
    within 1e-5 relative of the run without a mesh; the params every run
    moves (all but ``router_bias``, which takes no gradient: it selects
    experts only, and its zeros stay zero under decay) move in both."""
    runs = {}
    calls = []
    real = tm.moe_forward_sharded

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    tm.moe_forward_sharded = spy
    try:
        for mesh in (None, _cpu_mesh()):
            out = train_loop(arch=arch, steps=3, batch_size=4, seq_len=16,
                             mesh=mesh, device=CPU, log_every=0)
            runs[mesh is not None] = out
    finally:
        tm.moe_forward_sharded = real
    assert tsh.current_mesh() is None
    assert (len(calls) > 0) == (arch == "deepseek-v3-671b")
    a, b = runs[False]["losses"], runs[True]["losses"]
    np.testing.assert_allclose(b, a, rtol=1e-5)
    start = get_bundle(arch, reduced=True).init_params(
        torch.Generator().manual_seed(0), device=CPU)
    first = dict(start.named_parameters())
    for on_mesh, out in runs.items():
        moved = {n for n, t in out["state"]["params"].named_parameters()
                 if not torch.equal(t.detach(), first[n])}
        assert moved == {n for n in first if not n.endswith("router_bias")}


# --------------------------------------------------------------------- #
# 8. the production mesh
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh(multi_pod):
    n = 512 if multi_pod else 256
    if torch.cuda.device_count() < n:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            tmesh.make_production_mesh(multi_pod=multi_pod)
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                      devices=[META] * n)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert mesh.shape == want and list(mesh.axis_names) == list(want)
    assert all(d.type == "meta" for d in mesh.devices)
    specs = _specs_of(get_bundle("deepseek-v3-671b").param_shardings(mesh),
                      True)
    jmesh_ = AbstractMesh(tuple(want.values()), tuple(want))
    assert specs == _specs_of(jsh.lm_param_specs(
        _ref_abstract("deepseek-v3-671b", False), jmesh_), False)
    assert specs["layers/moe/gate"] == (None, "model", (
        ("pod", "data") if multi_pod else "data"), None)


# --------------------------------------------------------------------- #
# 9. placement
# --------------------------------------------------------------------- #
PLACE = [((8, 12), ("data", "model")), ((8, 12), (("data", "model"),)),
         ((8, 12), ("model", None)), ((8, 12), ()),
         ((4, 8, 6), (None, "model", "data")),
         ((4, 8, 12), (("pod", "data"), None, "model"))]


@pytest.mark.parametrize("mesh_i", [1, 3])
@pytest.mark.parametrize("shape,spec", PLACE)
def test_shard_unshard_round_trip(shape, spec, mesh_i):
    mshape, axes = MESHES[mesh_i]
    n = int(np.prod(mshape))
    mesh = tmesh.make_mesh(mshape, axes, devices=[CPU] * n)
    spec = tmesh.filter_spec(mesh, *spec)
    ns = tmesh.NamedSharding(mesh, spec)
    t = torch.from_numpy(np.random.default_rng(6).normal(size=shape))
    pieces = ns.shard(t)
    local = ns.shard_shape(shape)
    assert len(pieces) == n
    seen = {}
    for k, pc in enumerate(pieces):
        assert tuple(pc.shape) == local
        assert pc.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()          # a view: no copy
        idx = ns.index(k)
        if idx in seen:                              # a replica
            assert torch.equal(pc, seen[idx])
        seen[idx] = pc
    assert len(seen) == int(np.prod([tmesh.axis_size(mesh, e)
                                     for e in spec]))
    back = ns.unshard(pieces, CPU)
    assert torch.equal(back, t)


def test_shard_raises_on_a_dim_that_does_not_divide():
    mesh = _cpu_mesh()
    ns = tmesh.NamedSharding(mesh, tmesh.PartitionSpec("model"))
    with pytest.raises(ValueError, match="does not divide"):
        ns.shard(torch.zeros(6, 2))
    with pytest.raises(ValueError, match="lacks"):
        tmesh.NamedSharding(mesh, tmesh.PartitionSpec("pod"))


def test_shard_to_another_device_copies():
    """A position whose device is not the tensor's gets a copy there
    (here the meta device): the piece's shape, the original untouched."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"),
                           devices=[CPU, META, CPU, META])
    ns = tmesh.NamedSharding(mesh, tmesh.PartitionSpec("data", "model"))
    t = torch.arange(16.0).reshape(4, 4)
    pieces = ns.shard(t)
    assert [p.device.type for p in pieces] == ["cpu", "meta", "cpu", "meta"]
    assert all(tuple(p.shape) == (2, 2) for p in pieces)
    assert torch.equal(pieces[2], t[2:, :2])

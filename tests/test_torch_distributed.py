"""The port's distributed engine (``repro_torch.core.distributed``, the mesh
FD behind ``tip_decompose(mesh=...)`` and ``Executor(mesh=...)``) against
the reference's ``repro.core.distributed``.

The reference needs eight devices, which jax fixes at its first start:
one subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
as ``tests/test_distributed.py`` does) computes every reference result of
this module from inputs built here with numpy and returns them as one
JSON, so the module pays for one JAX start.  The port runs in this
process on ``make_mesh((4, 2), ("data", "model"), devices=[cpu] * 8)``
(and, for the CD entry points, on other shapes of the same eight CPU
shards: the answer does not depend on the layout).  Everything is
compared with ``==``: the f32 integer regime is exact (DESIGN.md
section 8).  The reference's mesh decompose runs its
``interpret``/``interpret_sparse`` backends (CD) with kernel blocks
(8, 8, 8), where the port's padding (to the kernel blocks) and the
reference's mesh FD padding (to 8) agree.  Host round trips differ by
design and are not compared.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import GRAPH_CASES
from repro.api import EngineConfig as JEngineConfig
from repro.core.graph import powerlaw_bipartite, random_bipartite
from repro_torch.api import EngineConfig, Executor, Planner
from repro_torch.api.errors import PlanInfeasibleError
from repro_torch.convert import engine_config_from_fields, graph_from_arrays
from repro_torch.core import distributed as tdist
from repro_torch.core import receipt as treceipt
from repro_torch.core.engine import ReceiptConfig, RunStats
from repro_torch.core.engine import tip_decompose as t_engine_tip_decompose
from repro_torch.core.engine.cd import receipt_cd
from repro_torch.core.engine.fd import (_aligns, _level_pad,
                                        build_fd_tasks, build_level_stack,
                                        pre_peel_tasks)
from repro_torch.core.scheduler import lpt_shard_plan, pack_by_shape
from repro_torch.launch.mesh import (DeviceMesh, axis_size, dp_axes,
                                     make_mesh)

ROOT = Path(__file__).resolve().parents[1]
BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")
REF_BACKEND = {"torch": "interpret", "torch_sparse": "interpret_sparse"}
E2E_FIELDS = ("rho_fd", "wedges_fd", "fd_groups", "fd_shards",
              "fd_shard_rho", "fd_shard_wedges", "fd_padding_waste",
              "device_loop_calls")
CD_MESHES = {"4x2": ((4, 2), ("data", "model")),
             "8x1": ((8, 1), ("data", "model")),
             "2x4": ((2, 4), ("data", "model")),
             "1x8": ((1, 8), ("data", "model")),
             "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
FUSED_WIDTHS = (128, 8)          # 8: the first peel set overflows it


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors; the test
    workers' pools would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape=(4, 2), axes=("data", "model")):
    return make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


# --------------------------------------------------------------------- #
# the inputs, built once with numpy
# --------------------------------------------------------------------- #
def _dense(g):
    a = np.zeros((g.n_u, g.n_v), np.float32)
    a[g.edges_u, g.edges_v] = 1.0
    return a


def _b2(a):
    w = a.astype(np.float64) @ a.T.astype(np.float64)
    b2 = w * (w - 1.0) / 2.0
    np.fill_diagonal(b2, 0.0)
    return b2


def _cd_inputs():
    """The counting / sweep / fused-loop case: a (256, 128) power-law
    matrix, a 60% alive mask, a 30% peel set padded to 32 rows."""
    g = powerlaw_bipartite(256, 128, 2500, seed=2)
    a = _dense(g)
    s = (np.random.default_rng(0).random(256) < 0.6).astype(np.float32)
    sup0 = _b2(a).sum(1).astype(np.float32)
    peel = np.random.default_rng(1).random(256) < 0.3
    idx = np.where(peel)[0]
    pad = (-len(idx)) % 32
    rows = np.concatenate([idx, np.zeros(pad, np.int64)]).astype(np.int32)
    valid = np.concatenate([np.ones(len(idx), np.float32),
                            np.zeros(pad, np.float32)])
    hi = float(np.quantile(sup0, 0.4)) + 1.0
    return dict(a=a, s=s, sup0=sup0, rows=rows, valid=valid, hi=hi)


def _fd_stack_inputs():
    """A stack of 12 independent small subsets (the reference test's)."""
    rng = np.random.default_rng(0)
    g_n, mm, cc = 12, 16, 12
    a = np.zeros((g_n, mm, cc), np.float32)
    sup0 = np.full((g_n, mm), np.inf, np.float32)
    nmem = np.zeros(g_n, np.int32)
    weights = np.zeros(g_n)
    for k in range(g_n):
        n_u = int(rng.integers(4, mm + 1))
        g = random_bipartite(n_u, cc, float(rng.uniform(0.15, 0.5)), seed=k)
        a[k, g.edges_u, g.edges_v] = 1.0
        nmem[k] = n_u
        weights[k] = g.wedge_counts_u().sum()
        sup0[k, :n_u] = _b2(a[k]).sum(1)[:n_u]
    lo = np.zeros(g_n, np.float32)
    return dict(a=a, sup0=sup0, nmem=nmem, lo=lo, weights=weights)


def _e2e_graphs():
    gs = {k: f() for k, f in GRAPH_CASES.items()}
    gs["pl240"] = powerlaw_bipartite(240, 130, 1800, seed=9)
    return gs


GROUP_GRAPH = (240, 130, 1800, 9)       # shard_level_group's pipeline


def _tolist(x):
    return np.asarray(x).tolist()


# --------------------------------------------------------------------- #
# the reference, in one subprocess
# --------------------------------------------------------------------- #
REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.api import EngineConfig, Executor
from repro.core import distributed as D
from repro.core.engine.cd import receipt_cd
from repro.core.engine.fd import (_aligns, _level_pad, build_fd_tasks,
                                  build_level_stack, pre_peel_tasks)
from repro.core.engine.peel_loop import ReceiptConfig, RunStats
from repro.core.graph import BipartiteGraph, powerlaw_bipartite
from repro.core.scheduler import pack_by_shape
from repro.launch.mesh import make_mesh

inp = json.load(sys.stdin)
mesh = make_mesh((4, 2), ("data", "model"))
f32 = jnp.float32
L = lambda x: np.asarray(x).tolist()
out = {}

cd = inp["cd"]
a = jnp.asarray(np.asarray(cd["a"], np.float32))
n_u = a.shape[0]
out["count"] = L(D.distributed_butterfly_support(
    mesh, a, jnp.asarray(np.asarray(cd["s"], np.float32))))
sup0 = jnp.asarray(np.asarray(cd["sup0"], np.float32))
for impl in ("gspmd", "shardmap"):
    sup, alive = D.distributed_cd_sweep(
        mesh, a, sup0, jnp.ones(n_u, bool),
        jnp.asarray(np.asarray(cd["rows"], np.int32)),
        jnp.asarray(np.asarray(cd["valid"], np.float32)),
        jnp.zeros((), f32), impl=impl, chunk=16)
    out["sweep_" + impl] = dict(sup=L(sup), alive=L(alive))
for pw in inp["fused_widths"]:
    sup, alive, rho, ovf = D.distributed_cd_fused_loop(
        mesh, a, sup0, jnp.ones(n_u, bool), cd["hi"], 0.0,
        peel_width=pw, chunk=16)
    out["fused_%d" % pw] = dict(sup=L(sup), alive=L(alive), rho=int(rho),
                                overflow=bool(ovf))

st = inp["stack"]
a_s, sup_s, alive_s, dv_s, lo_s, slots = D.shard_fd_stack(
    np.asarray(st["a"], np.float32), np.asarray(st["sup0"], np.float32),
    np.asarray(st["nmem"], np.int32), np.asarray(st["lo"], np.float32),
    np.asarray(st["weights"]), mesh.size)
out["shard_fd_stack"] = dict(a=L(a_s), sup=L(sup_s), alive=L(alive_s),
                             dv=L(dv_s), lo=L(lo_s), slots=L(slots))
res = {}
for mode in ("b2", "kernel"):
    th, rho, wedges = D.distributed_fd_level_peel(
        mesh, a_s, sup_s, alive_s, dv_s, lo_s, update_mode=mode)
    full = D.distributed_fd_level_peel(
        mesh, a_s, sup_s, alive_s, dv_s, lo_s, update_mode=mode,
        peel_width=8, full_state=True)
    res[mode] = dict(theta=L(th), rho=L(rho), wedges=L(wedges),
                     full=[L(x) for x in full])
out["fd_level_peel"] = res
out["fd_stack_step"] = L(jax.jit(D.fd_stack_step)(
    jnp.asarray(np.asarray(st["a"], np.float32)),
    jnp.asarray(np.asarray(st["sup0"], np.float32)),
    jnp.asarray(np.asarray(st["nmem"], np.int32)),
    jnp.asarray(np.asarray(st["lo"], np.float32))))

n_u, n_v, m, seed = inp["group_graph"]
g = powerlaw_bipartite(n_u, n_v, m, seed=seed)
cfg = ReceiptConfig(num_partitions=8, kernel_blocks=(8, 8, 8), backend="xla")
stats = RunStats()
sid, isup, bounds, _ = receipt_cd(g, cfg, stats)
theta = np.zeros(g.n_u)
tasks = pre_peel_tasks(build_fd_tasks(g, sid, bounds, stats), isup, theta,
                       stats, levels=cfg.fd_prepeel_levels)
ra, ca, _ = _aligns(cfg, "xla")
groups = pack_by_shape(
    tasks, size_of=lambda t: (len(t["surv"]), max(t["sub"].n_v, 1)),
    weight_of=lambda t: t["wedges"], bucket=lambda n: _level_pad(n, ra),
    bucket_cols=lambda n: _level_pad(n, ca))
loads = np.zeros(mesh.size)
out["groups"] = []
for group in groups:
    built = build_level_stack(group, cfg, "xla")
    arr, slots = D.shard_level_group(built, mesh.size, init_loads=loads)
    loads = loads + arr["shard_load"]
    full = D.distributed_fd_level_peel(
        mesh, arr["a"], arr["sup"], arr["alive"], arr["dv"], arr["lo"],
        a_l1=arr["a_l1"], n_l1=arr["n_l1"], cap1=arr["cap1"],
        update_mode=built["update_mode"], peel_width=built["peel_width"],
        full_state=True)
    out["groups"].append(dict(
        slots=L(slots), arrays={k: L(v) for k, v in arr.items()},
        peeled=[L(x) for x in full]))

out["e2e"] = {}
for name, (n_u, n_v, eu, ev) in inp["graphs"].items():
    g = BipartiteGraph.from_edges(n_u, n_v, eu, ev)
    for be in inp["backends"]:
        td = Executor(EngineConfig(num_partitions=8, kernel_blocks=(8, 8, 8),
                                   backend=be), mesh=mesh).decompose(g)
        s = td.stats
        out["e2e"][name + "/" + be] = dict(
            theta=L(td.theta), mesh_shards=td.plan.mesh_shards,
            representation=td.plan.representation,
            **{k: getattr(s, k) for k in inp["fields"]})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    """Every reference result of this module, from one subprocess."""
    cd = _cd_inputs()
    st = _fd_stack_inputs()
    inp = dict(
        cd={k: _tolist(v) for k, v in cd.items()},
        fused_widths=list(FUSED_WIDTHS),
        stack={k: _tolist(v) for k, v in st.items()},
        group_graph=list(GROUP_GRAPH),
        graphs={k: (g.n_u, g.n_v, _tolist(g.edges_u), _tolist(g.edges_v))
                for k, g in _e2e_graphs().items()},
        backends=list(REF_BACKEND.values()),
        fields=list(E2E_FIELDS))
    res = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT], input=json.dumps(inp),
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _eq(got, want):
    """Exact equality of a port tensor/array and a reference list."""
    got = np.asarray(got.cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want, dtype=got.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# the mesh
# --------------------------------------------------------------------- #
def test_make_mesh_layout_and_axes():
    """Row-major devices over the named axes; repeated devices allowed
    when listed; dp axes and axis sizes as the reference's helpers."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=[CPU] * 8)
    assert isinstance(mesh, DeviceMesh) and mesh.size == 8
    assert mesh.axis_names == ("pod", "data", "model")
    assert dp_axes(mesh) == ("pod", "data")
    assert axis_size(mesh, ("pod", "data")) == 4
    assert axis_size(mesh, "model") == 2 and axis_size(mesh, "x") == 1
    assert axis_size(mesh, None) == 1
    assert mesh.shards_per_device() == {CPU: 8}
    assert dp_axes(_mesh((8,), ("model",))) == ()
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("data",), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), devices=[CPU] * 3)


def test_make_mesh_without_enough_cards_raises():
    """``devices=None`` takes the CUDA cards and never falls back to the
    CPU: a mesh larger than the visible cards raises."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh((n + 1, 1), ("data", "model"))


def test_a_jax_mesh_is_refused():
    """The port shards over its own ``DeviceMesh``; a JAX ``Mesh`` (or
    anything else) raises ``TypeError`` at every entry point."""
    import jax
    from repro.launch.mesh import make_mesh as j_make_mesh

    jmesh = j_make_mesh((1,), ("data",))
    assert isinstance(jmesh, jax.sharding.Mesh)
    g = graph_from_arrays(*_small_graph())
    cd = _cd_inputs()
    for call in (
            lambda: Executor(EngineConfig(), device=CPU, mesh=jmesh),
            lambda: Planner(EngineConfig(), device=CPU).plan(g, mesh=jmesh),
            lambda: t_engine_tip_decompose(g, ReceiptConfig(), device=CPU,
                                           mesh=jmesh),
            lambda: treceipt.tip_decompose(g, device=CPU, mesh=jmesh),
            lambda: tdist.distributed_butterfly_support(jmesh, cd["a"],
                                                        cd["s"])):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()


def _small_graph():
    g = GRAPH_CASES["powerlaw"]()
    return g.n_u, g.n_v, g.edges_u, g.edges_v


# --------------------------------------------------------------------- #
# the sharded CD entry points
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", list(CD_MESHES))
def test_counting_matches_reference(ref, layout):
    """``distributed_butterfly_support`` equals the reference's on its
    (4, 2) mesh, on every layout of eight CPU shards."""
    cd = _cd_inputs()
    got = tdist.distributed_butterfly_support(_mesh(*CD_MESHES[layout]),
                                              cd["a"], cd["s"])
    _eq(got, ref["count"])


@pytest.mark.parametrize("layout", list(CD_MESHES))
@pytest.mark.parametrize("impl", ["gspmd", "shardmap"])
def test_cd_sweep_matches_reference(ref, impl, layout):
    """One sweep (chunk 16: the peel set runs in chunks) equals the
    reference's under both of its schedules."""
    cd = _cd_inputs()
    sup, alive = tdist.distributed_cd_sweep(
        _mesh(*CD_MESHES[layout]), cd["a"], cd["sup0"],
        np.ones(256, bool), cd["rows"], cd["valid"], 0.0, impl=impl,
        chunk=16)
    _eq(sup, ref["sweep_" + impl]["sup"])
    _eq(alive, ref["sweep_" + impl]["alive"])


def test_cd_sweep_names_its_impls():
    cd = _cd_inputs()
    with pytest.raises(ValueError, match="impl"):
        tdist.distributed_cd_sweep(_mesh(), cd["a"], cd["sup0"],
                                   np.ones(256, bool), cd["rows"],
                                   cd["valid"], 0.0, impl="xla")


@pytest.mark.parametrize("layout", ["4x2", "8x1", "pod2x2x2"])
@pytest.mark.parametrize("width", FUSED_WIDTHS)
def test_fused_loop_matches_reference(ref, width, layout):
    """The range loop: supports, alive, rho and the overflow flag equal
    the reference's (width 8 overflows at the first sweep and stops
    without sweeping); one counted read per sweep."""
    cd = _cd_inputs()
    stats = RunStats()
    sup, alive, rho, ovf = tdist.distributed_cd_fused_loop(
        _mesh(*CD_MESHES[layout]), cd["a"], cd["sup0"], np.ones(256, bool),
        cd["hi"], 0.0, peel_width=width, chunk=16, stats=stats)
    want = ref["fused_%d" % width]
    _eq(sup, want["sup"])
    _eq(alive, want["alive"])
    assert (rho, ovf) == (want["rho"], want["overflow"])
    assert ovf == (width == 8)
    assert stats.host_round_trips == rho + 1


def test_cd_layout_needs_even_shards():
    cd = _cd_inputs()
    with pytest.raises(ValueError, match="split evenly"):
        tdist.distributed_butterfly_support(_mesh((1, 8)), cd["a"][:, :100],
                                            cd["s"])
    with pytest.raises(ValueError, match="CD layout"):
        tdist.distributed_butterfly_support(_mesh((8,), ("expert",)),
                                            cd["a"], cd["s"])


# --------------------------------------------------------------------- #
# the sharded FD
# --------------------------------------------------------------------- #
def test_lpt_shard_plan_layout():
    """Contiguous equal-size shards, padding slots -1, every task once;
    loads carried across calls."""
    w = [9.0, 7.0, 5.0, 4.0, 3.0, 1.0]
    slots, per = lpt_shard_plan(w, 4)
    assert per == 2 and len(slots) == 8
    assert sorted(t for t in slots if t >= 0) == list(range(6))
    assert slots == [0, -1, 1, -1, 2, 5, 3, 4]
    slots2, _ = lpt_shard_plan([2.0], 4, init_loads=[9, 7, 6, 5])
    assert slots2.index(0) == 3


def test_shard_fd_stack_matches_reference(ref):
    st = _fd_stack_inputs()
    got = tdist.shard_fd_stack(st["a"], st["sup0"], st["nmem"], st["lo"],
                               st["weights"], 8)
    want = ref["shard_fd_stack"]
    for name, x in zip(("a", "sup", "alive", "dv", "lo", "slots"), got):
        _eq(x, want[name])


@pytest.mark.parametrize("mode", ["b2", "kernel"])
@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
def test_fd_level_peel_matches_reference(ref, backend, mode):
    """Per stack slot: theta, rho and wedges, and the full carried state
    at an 8-row gather buffer, equal the reference's."""
    st = _fd_stack_inputs()
    a, sup, alive, dv, lo, _slots = tdist.shard_fd_stack(
        st["a"], st["sup0"], st["nmem"], st["lo"], st["weights"], 8)
    mesh = _mesh()
    want = ref["fd_level_peel"][mode]
    th, rho, wedges = tdist.distributed_fd_level_peel(
        mesh, a, sup, alive, dv, lo, update_mode=mode, backend=backend,
        blocks=BLOCKS)
    for x, name in ((th, "theta"), (rho, "rho"), (wedges, "wedges")):
        _eq(x, want[name])
    full = tdist.distributed_fd_level_peel(
        mesh, a, sup, alive, dv, lo, update_mode=mode, peel_width=8,
        full_state=True, backend=backend, blocks=BLOCKS)
    for x, w in zip(full, want["full"]):
        _eq(x, w)


def _port_groups():
    """The port's side of the reference script's group pipeline: CD,
    tasks, the host pre-peel and the shape groups of ``GROUP_GRAPH``."""
    n_u, n_v, m, seed = GROUP_GRAPH
    jg = powerlaw_bipartite(n_u, n_v, m, seed=seed)
    g = graph_from_arrays(jg.n_u, jg.n_v, jg.edges_u, jg.edges_v)
    cfg = ReceiptConfig(num_partitions=8, kernel_blocks=BLOCKS,
                        backend="torch")
    stats = RunStats()
    sid, isup, bounds, _ = receipt_cd(g, cfg, stats, device=CPU)
    tasks = pre_peel_tasks(build_fd_tasks(g, sid, bounds, stats), isup,
                           np.zeros(g.n_u), stats,
                           levels=cfg.fd_prepeel_levels)
    ra, ca, _ = _aligns(cfg)
    groups = pack_by_shape(
        tasks, size_of=lambda t: (len(t["surv"]), max(t["sub"].n_v, 1)),
        weight_of=lambda t: t["wedges"], bucket=lambda n: _level_pad(n, ra),
        bucket_cols=lambda n: _level_pad(n, ca))
    return cfg, groups


@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
def test_shard_level_group_and_peel_match_reference(ref, backend):
    """Each shape group's LPT layout (loads carried across groups: slots,
    every array, ``per_shard``, ``shard_load``) and its sharded peel with
    the first-level delta (the full carried state) equal the
    reference's."""
    cfg, groups = _port_groups()
    assert len(groups) == len(ref["groups"]) > 1
    mesh = _mesh()
    loads = np.zeros(mesh.size)
    for group, want in zip(groups, ref["groups"]):
        built = build_level_stack(group, cfg)
        arr, slots = tdist.shard_level_group(built, mesh.size,
                                             init_loads=loads)
        loads = loads + arr["shard_load"]
        _eq(slots, want["slots"])
        assert set(arr) == set(want["arrays"])
        for k, v in arr.items():
            _eq(v, want["arrays"][k])
        full = tdist.distributed_fd_level_peel(
            mesh, arr["a"], arr["sup"], arr["alive"], arr["dv"], arr["lo"],
            a_l1=arr["a_l1"], n_l1=arr["n_l1"], cap1=arr["cap1"],
            update_mode=built["update_mode"],
            peel_width=built["peel_width"], full_state=True,
            backend=backend, blocks=BLOCKS)
        for x, w in zip(full, want["peeled"]):
            _eq(x, w)


def test_fd_stack_step_matches_reference(ref):
    """The legacy sequential peel over a stack (B2 from kernel 3's plain
    version) equals the reference's ``fd_stack_step``."""
    st = _fd_stack_inputs()
    th = tdist.fd_stack_step(torch.as_tensor(st["a"]),
                             torch.as_tensor(st["sup0"]),
                             torch.as_tensor(st["nmem"]),
                             torch.as_tensor(st["lo"]), blocks=BLOCKS)
    _eq(th, ref["fd_stack_step"])


# --------------------------------------------------------------------- #
# the mesh decompose end to end
# --------------------------------------------------------------------- #
def _port_e2e(entry, g, backend, mesh):
    """One mesh decompose through the named entry point: (theta, stats,
    plan or None)."""
    jcfg = JEngineConfig(num_partitions=8, kernel_blocks=BLOCKS,
                         backend=REF_BACKEND[backend])
    cfg = engine_config_from_fields(jcfg.to_dict())
    tg = graph_from_arrays(g.n_u, g.n_v, g.edges_u, g.edges_v)
    if entry == "executor":
        td = Executor(cfg, device=CPU, mesh=mesh).decompose(tg)
        return td.theta, td.stats, td.plan
    if entry == "facade":
        th, st = treceipt.tip_decompose(tg, cfg, device=CPU, mesh=mesh)
        return th, st, None
    th, st = t_engine_tip_decompose(tg, cfg.to_receipt_config(), device=CPU,
                                    mesh=mesh)
    return th, st, None


@pytest.mark.parametrize("entry", ["executor", "facade", "engine"])
@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("case", list(GRAPH_CASES) + ["pl240"])
def test_mesh_decompose_matches_reference(ref, case, backend, entry):
    """``Executor(mesh=...).decompose``, the facade's and the engine's
    ``tip_decompose(mesh=...)``: theta, the FD counters the reference
    reports for a mesh, and the plan's shard count and representation,
    equal the reference's mesh decompose; theta also equals the port's
    single-device run."""
    g = _e2e_graphs()[case]
    theta, st, plan = _port_e2e(entry, g, backend, _mesh())
    want = ref["e2e"][f"{case}/{REF_BACKEND[backend]}"]
    _eq(theta, want["theta"])
    for k in E2E_FIELDS:
        assert getattr(st, k) == want[k], k
    if plan is not None:
        assert plan.mesh_shards == want["mesh_shards"] == 8
        assert plan.representation == want["representation"]
    if case == "pl240":
        assert sum(1 for r in st.fd_shard_rho if r > 0) > 1
        assert sum(st.fd_shard_wedges) <= st.wedges_fd


# --------------------------------------------------------------------- #
# what a mesh refuses, and how it plans
# --------------------------------------------------------------------- #
def test_mesh_refusals():
    """The reference's refusals: the legacy FD engines, ``map`` and the
    wing workload do not run on a mesh."""
    mesh = _mesh()
    g = graph_from_arrays(*_small_graph())
    for mode in ("b2", "matvec"):
        with pytest.raises(ValueError, match="fd_mode='level'"):
            t_engine_tip_decompose(g, ReceiptConfig(fd_mode=mode),
                                   device=CPU, mesh=mesh)
    with pytest.raises(ValueError, match="Executor.map runs single-device"):
        Executor(EngineConfig(), device=CPU, mesh=mesh).map([g])
    with pytest.raises(ValueError, match="workload='wing'"):
        Executor(EngineConfig(workload="wing"), device=CPU,
                 mesh=mesh).decompose(g)


def test_mesh_plans_dense_and_counts_its_shards():
    """A sharded plan never routes tiled on its own: where the fixed CD
    bytes overflow the budget, ``auto`` takes the tiled route without a
    mesh and is infeasible with one; an explicit ``tiled`` stays tiled.
    The FD estimate counts the slots of the shards on the fullest
    device."""
    g = graph_from_arrays(*_small_graph())
    mesh = _mesh()
    probe = Planner(EngineConfig(kernel_blocks=BLOCKS),
                    device=CPU).plan(g).cost_model
    budget = probe["dense_fixed_bytes"] - 1
    assert probe["tiled_bytes"] <= budget
    cfg = EngineConfig(kernel_blocks=BLOCKS, memory_budget_bytes=budget)
    assert Planner(cfg, device=CPU).plan(g).representation == "tiled"
    with pytest.raises(PlanInfeasibleError):
        Planner(cfg, device=CPU).plan(g, mesh=mesh)
    tiled = EngineConfig(kernel_blocks=BLOCKS, representation="tiled")
    assert Planner(tiled, device=CPU).plan(
        g, mesh=mesh).representation == "tiled"
    plan = Planner(EngineConfig(kernel_blocks=BLOCKS), device=CPU).plan(
        g, mesh=mesh)
    assert plan.mesh_shards == 8 and plan.representation == "dense"
    assert plan.signature[4] == 8
    planner = Planner(EngineConfig(kernel_blocks=BLOCKS), device=CPU)
    rcfg = planner.rcfg
    one = planner._estimate_fd_bytes(g, rcfg)
    on_one_card = planner._estimate_fd_bytes(g, rcfg, mesh=mesh)
    spread = planner._estimate_fd_bytes(
        g, rcfg, mesh=make_mesh((8,), ("data",),
                                devices=[torch.device("cpu", i)
                                         for i in range(8)]))
    assert 0 < spread < on_one_card and one > 0


@pytest.mark.parametrize("groups", [
    [[100.0, 1, 1, 1, 1, 1, 1, 1]],     # one heavy task: 3 slots, not 2
    [[100.0], [1, 1, 1, 1]],            # loads [100, 0, 0, 0] carried in
])
def test_mesh_plan_counts_the_engines_lpt_slots(groups):
    """The mesh plan's FD slots per shard are the engine's LPT layout
    (``lpt_shard_plan``, loads carried across groups as
    ``fd._run_level_groups_mesh`` carries them), not
    ``ceil(n_g / shards)``, which is smaller on these uneven layouts."""
    from repro_torch.api.plan import _mesh_fd_slots

    n_shards = 4
    got = _mesh_fd_slots(groups, n_shards)
    loads = [0.0] * n_shards
    for weights, slots in zip(groups, got):
        lay, per_shard = lpt_shard_plan(weights, n_shards, loads)
        assert slots >= per_shard
        for s in range(n_shards):
            loads[s] += sum(weights[t] for t in
                            lay[s * per_shard:(s + 1) * per_shard] if t >= 0)
    old = -(-len(groups[-1]) // n_shards)
    assert old < got[-1] == lpt_shard_plan(
        groups[-1], n_shards,
        [100.0, 0, 0, 0] if len(groups) > 1 else None)[1]

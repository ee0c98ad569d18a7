"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.roofline``,
``utils.op_cost``, ``core.distributed.lower_cd_sweep`` /
``lower_fd_stack``) against the reference's, on the CPU.

The port costs a step on meta tensors over a mesh of meta positions; the
reference lowers and compiles it on forced host devices.  The
reference's cells run in ONE subprocess on 8 host devices, mesh (2, 2, 2)
(module fixture ``ref``), and the port's cells on a (2, 2, 2) mesh of
meta positions.  Tolerances: arguments exactly (the port's CD piece of A
is f32 where the reference's is int8: 3 more bytes per entry);
``flops_per_dev`` within 1% for the RECEIPT cells; the collectives of
``cd_sweep_1m`` exactly against the port's own schedule in closed form;
the two-depth extrapolation of an LM exactly (FLOPs, bytes, wire bytes)
and its peak within 1%.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_bundle as j_get_bundle
from repro.configs import receipt_tip as j_receipt_tip
from repro.launch import roofline as jrl
from repro_torch.configs import get_bundle, receipt_tip
from repro_torch.configs.families import make_lm_bundle
from repro_torch.configs.shapes import RECEIPT_SHAPES, LMShape
from repro_torch.core import distributed as tdist
from repro_torch.launch import dryrun, roofline as rl
from repro_torch.launch.mesh import make_mesh
from repro_torch.utils.op_cost import OpCost

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
LM_ARCHS = ALL_ARCHS[:5]
REF_CELLS = [("two-tower-retrieval", "retrieval_cand"),
             ("receipt-tip", "cd_sweep_1m"), ("receipt-tip", "fd_stack")]
# the reference's test_dryrun cells
DRYRUN_CELLS = [
    ("minitron-8b", "train_4k"),
    ("minitron-8b", "decode_32k"),
    ("deepseek-v2-236b", "train_4k"),
    ("graphsage-reddit", "full_graph_sm"),
    ("two-tower-retrieval", "retrieval_cand"),
    ("receipt-tip", "cd_sweep_1m"),
    ("receipt-tip", "fd_stack"),
]

REF_SCRIPT = r"""
import os, sys, json
sys.path.insert(0, "src")
from repro.launch.dryrun import dryrun_cell
from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for arch, shape in json.loads(sys.stdin.read()):
    rec = dryrun_cell(arch, shape, multi_pod=True, mesh=mesh, verbose=False)
    r = rec["roofline"]
    out[shape] = {"args": rec["memory_analysis"]["argument_size_in_bytes"],
                  "flops": r["flops_per_dev"],
                  "wire": r["wire_bytes_per_dev"]}
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (meta tensors; the test workers'
    pools would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return make_mesh((2, 2, 2), ("pod", "data", "model"), devices=[META] * 8)


@functools.lru_cache(maxsize=None)
def _cell(arch, shape):
    return dryrun.dryrun_cell(arch, shape, multi_pod=True, mesh=_mesh(),
                              verbose=False)


@pytest.fixture(scope="module")
def ref():
    """The reference's dry run of ``REF_CELLS`` on 8 forced host
    devices, from one subprocess."""
    res = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT], input=json.dumps(REF_CELLS),
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu", REPRO_DRYRUN_DEVICES="8",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------------- #
# roofline: collectives and parameter counts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("g", [1, 2, 4, 16])
@pytest.mark.parametrize("op", rl.COLLECTIVE_OPS)
def test_collective_wire_bytes_equal_reference(op, g):
    for out_bytes in (1, 4096, 3 * 2 ** 31 + 7):
        assert (rl.Collective(op, out_bytes, g).wire_bytes
                == jrl.Collective(op, out_bytes, g).wire_bytes)


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    return j_get_bundle(arch).abstract_params()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_count_params_equals_reference(arch):
    assert (rl.count_params(get_bundle(arch).abstract_params())
            == jrl.count_params(_ref_abstract(arch)))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_active_params_and_model_flops_equal_reference(arch):
    b, jb = get_bundle(arch), j_get_bundle(arch)
    ab, jab = b.abstract_params(), _ref_abstract(arch)
    n, jn = rl.count_params(ab), jrl.count_params(jab)
    act = rl.lm_active_params(ab, b.cfg)
    assert act == jrl.lm_active_params(jab, jb.cfg)
    if b.cfg.moe:
        assert act < n
    for name, s in b.shapes.items():
        tokens = s.global_batch * (1 if s.kind == "decode" else s.seq_len)
        kind = "train" if s.kind == "train" else "serve"
        assert (rl.lm_model_flops(n, act, tokens, kind)
                == jrl.lm_model_flops(jn, act, tokens, kind)), name


def test_roofline_units_and_times():
    r = rl.Roofline(flops=10.0, hbm_bytes=3.35e12, wire_bytes=1e9,
                    n_collectives=2, coll_by_op={"all-gather": 1e9},
                    flops_by_unit={"bf16": 989e12, "int8": 1979e12},
                    pod_wire_bytes=0.5e9)
    assert r.t_compute == pytest.approx(2.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(0.5e9 / 450e9 + 0.5e9 / 50e9)
    assert r.bottleneck == "compute"
    d = r.to_dict()
    # the reference's keys, then the port's additions
    assert set(jrl.Roofline(1.0, 1.0, 1.0, 0, {}).to_dict()) <= set(d)
    assert {"flops_by_unit", "even_split_share", "depths"} <= set(d)


# --------------------------------------------------------------------- #
# the RECEIPT cells and retrieval against the reference
# --------------------------------------------------------------------- #
def test_receipt_and_retrieval_arguments_equal_reference(ref):
    s = RECEIPT_SHAPES["cd_sweep_1m"]
    a_piece = (s.n_u // 4) * (s.n_v // 2)       # dp = pod x data, model
    assert (_cell("receipt-tip", "cd_sweep_1m")["memory_analysis"]
            ["argument_size_in_bytes"] == ref["cd_sweep_1m"]["args"]
            + 3 * a_piece)
    for arch, shape in (("receipt-tip", "fd_stack"),
                        ("two-tower-retrieval", "retrieval_cand")):
        assert (_cell(arch, shape)["memory_analysis"]
                ["argument_size_in_bytes"] == ref[shape]["args"]), shape


@pytest.mark.parametrize("shape", ["cd_sweep_1m", "fd_stack"])
def test_receipt_flops_within_one_percent_of_reference(shape, ref):
    got = _cell("receipt-tip", shape)["roofline"]["flops_per_dev"]
    assert got == pytest.approx(ref[shape]["flops"], rel=1e-2)


def test_fd_stack_has_no_wire_bytes():
    r = _cell("receipt-tip", "fd_stack")["roofline"]
    assert r["wire_bytes_per_dev"] == 0.0
    assert r["n_collectives"] == 0
    # kernel 3's pairs body on the int8 unit, the sequential peel none
    assert set(r["flops_by_unit"]) == {"int8"}


def test_cd_sweep_collectives_equal_the_schedule_in_closed_form():
    """Per chunk of the peel set: the row gather (an all-reduce of the
    f32 rows over the 4 dp positions), the reduce-scatter of the partial
    products over ``model``, the sum of the (n_loc,) partials over
    ``model``; every position takes part in each."""
    s = RECEIPT_SHAPES["cd_sweep_1m"]
    n_dp, n_tp, chunk = 4, 2, 16384
    n_chunks, n_loc = s.peel_rows // chunk, s.n_u // n_dp
    gather = 2 * (chunk * s.n_v // n_tp * 4) * (n_dp - 1) / n_dp
    scatter = n_loc * (chunk // n_tp) * 4 * (n_tp - 1)
    psum = 2 * n_loc * 4 * (n_tp - 1) / n_tp
    r = _cell("receipt-tip", "cd_sweep_1m")["roofline"]
    assert r["n_collectives"] == 3 * n_chunks
    assert r["coll_by_op"] == {"all-reduce": n_chunks * (gather + psum),
                               "reduce-scatter": n_chunks * scatter}
    assert r["wire_bytes_per_dev"] == n_chunks * (gather + scatter + psum)
    assert r["pod_wire_bytes_per_dev"] == n_chunks * gather
    # the f32 row gather moves 4x the reference's int8 all-reduce
    assert n_chunks * gather == 4 * n_chunks * 2 * (
        chunk * s.n_v // n_tp) * (n_dp - 1) / n_dp
    assert r["depths"] == {"chunks": {"traced": [1, 2],
                                      "config": n_chunks}}


def test_cd_chunk_extrapolation_is_exact():
    mesh = _mesh()
    kw = dict(n_u=65536, n_v=1024, peel_rows=4 * 16384)
    whole = tdist._cost_cd_sweep(mesh, kw["n_u"], kw["n_v"],
                                 kw["peel_rows"], "shardmap", 16384)
    ext = tdist.lower_cd_sweep(mesh, **kw)
    for key in ("flops", "hbm", "wire", "n_coll", "unit/fp32"):
        assert ext.per_device(key) == whole.per_device(key), key
    assert ext.args == whole.args
    assert float(ext.peak) == pytest.approx(float(whole.peak), rel=1e-2)


def test_cd_sweep_at_one_position_books_kernel_one():
    """At ``model`` = 1 the product and its epilogue are kernel 1's peel
    body: its int8 work (2 per row pair per column) in place of the plain
    version's, its arithmetic in ``flops``."""
    mesh = make_mesh((1, 1), ("data", "model"), devices=[META])
    n_u, n_v, rows = 512, 256, 64
    c = tdist.lower_cd_sweep(mesh, n_u=n_u, n_v=n_v, peel_rows=rows)
    assert c.per_device("unit/int8") == 2 * n_u * rows * n_v
    assert c.per_device("flops") == 2 * n_u * rows * n_v + 2 * n_u * rows
    assert "unit/fp32" not in c.keys()


def test_fused_impl_costs_one_body_sweep():
    mesh = _mesh()
    kw = dict(n_u=4096, n_v=1024, peel_rows=256)
    one = tdist.lower_cd_sweep(mesh, **kw)
    fused = tdist.lower_cd_sweep(mesh, **kw, impl="fused")
    assert fused.per_device("flops") == one.per_device("flops")
    # the peel set's join over the dp shards
    assert fused.per_device("op/all-gather") > 0
    for impl in ("gspmd", "shardmap"):
        assert (tdist.lower_cd_sweep(mesh, **kw, impl=impl).per_device(
            "wire") == one.per_device("wire"))


# --------------------------------------------------------------------- #
# the reference's test_dryrun cells through the port
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,shape", DRYRUN_CELLS)
def test_dryrun_cell_costs_with_collectives(arch, shape):
    out = _cell(arch, shape)
    r = out["roofline"]
    assert out["ok"]
    assert r["flops_per_dev"] > 0
    assert r["t_compute_s"] > 0 and r["t_memory_s"] > 0
    if shape == "fd_stack":
        assert r["wire_bytes_per_dev"] < 32e6
    elif shape == "retrieval_cand":
        # no collective by the port's rule: its tables are split over
        # `model` only (nothing to gather over dp) and it does not train
        # (no gradient), and activation collectives over `model` are not
        # invented
        assert r["n_collectives"] == 0
    else:
        assert r["n_collectives"] > 0


def test_sharded_moe_books_positions_and_its_exchange():
    r = _cell("deepseek-v2-236b", "train_4k")["roofline"]
    assert r["coll_by_op"]["all-to-all"] > 0
    assert 0 < r["even_split_share"] < 1
    assert r["depths"]["layers"] == {"traced": [1, 2, 3], "config": 59}
    assert r["depths"]["dense_layers"] == {"traced": [1], "config": 1}


# --------------------------------------------------------------------- #
# the two-depth extrapolation, exact at the reduced depths
# --------------------------------------------------------------------- #
# the reduced configs' 16-token attention blocks at 4,096 tokens would
# trace 32k block steps a layer: short sequences of the same kinds
SMALL_SHAPES = {"train": LMShape("train", 64, 8),
                "decode": LMShape("decode", 64, 8)}


@pytest.mark.parametrize("shape", list(SMALL_SHAPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_depth_extrapolation_equals_full_depth(arch, shape):
    """The reduced widths at 4 layers (the MoE archs: 3 dense + 4 MoE),
    past every traced depth: the extrapolation (affine for serving,
    quadratic for training) equals the whole trace."""
    red = get_bundle(arch, reduced=True)
    nd = 3 if red.cfg.moe else 0
    cfg = dataclasses.replace(red.cfg, n_layers=nd + 4, n_dense_layers=nd)
    b = make_lm_bundle(arch, cfg, red.opt_cfg, shapes=SMALL_SHAPES)
    mesh = _mesh()
    whole = dryrun.trace_step(b, shape, mesh)
    ext = dryrun._lm_cost(b, shape, mesh)
    for key in ("flops", "hbm", "wire"):
        assert ext.per_device(key) == whole.per_device(key), key
    assert ext.args == whole.args and ext.outputs == whole.outputs
    assert float(ext.peak) == pytest.approx(float(whole.peak), rel=1e-2)


def test_training_bytes_are_quadratic_in_depth():
    """Why training takes a third depth: the stacked leaves' backward
    moves bytes quadratic in the depth (an affine fit misses them)."""
    red = get_bundle("minitron-8b", reduced=True)
    hbm = []
    for n in (1, 2, 3, 4):
        b = make_lm_bundle("minitron-8b",
                           dataclasses.replace(red.cfg, n_layers=n),
                           red.opt_cfg, shapes=SMALL_SHAPES)
        hbm.append(dryrun.trace_step(b, "train", _mesh()).per_device("hbm"))
    second = [hbm[i + 2] - 2 * hbm[i + 1] + hbm[i] for i in range(2)]
    assert second[0] == second[1] > 0


# --------------------------------------------------------------------- #
# the cost mode
# --------------------------------------------------------------------- #
def test_op_cost_counts_products_bytes_and_the_peak():
    x = torch.empty((64, 32), device=META)
    w = torch.empty((32, 16), dtype=torch.bfloat16, device=META)
    with OpCost(1) as oc:
        oc.add_arguments([(x, x.numel() * 4)])
        y = (x.to(torch.bfloat16) @ w)                 # (64, 16)
        rows = x[torch.zeros(8, dtype=torch.long, device=META)]
        del y, rows
    c = oc.cost
    assert c.per_device("flops") == 2 * 64 * 32 * 16
    assert c.per_device("unit/bf16") == 2 * 64 * 32 * 16
    # _to_copy 8192 + 4096, the product 4096 + 1024 + 2048, the arange-free
    # zeros 64, the gather 2 * 8 rows of 128 bytes + 64 of indices
    assert c.per_device("hbm") == (8192 + 4096) + (4096 + 1024 + 2048) + \
        64 + (2 * 8 * 128 + 64)
    assert c.peak == 8192 + 4096 + 2048


def test_op_cost_raises_on_an_op_it_cannot_cost():
    a = torch.empty((4, 4), device=META)
    with pytest.raises(NotImplementedError, match="no cost rule"):
        with OpCost(1):
            torch.linalg.cholesky(a)


# --------------------------------------------------------------------- #
# the config and the CLI
# --------------------------------------------------------------------- #
def test_receipt_tip_configs_equal_reference_but_blocks_and_backend():
    """The port's full config runs the card's blocks (128, 128, 512), not
    the reference's v5e ridge blocks; its reduced config the plain
    versions (``"torch"``), where the reference says ``"xla"``."""
    for name, differ in (("full_config", {"kernel_blocks"}),
                         ("reduced_config", {"backend"})):
        mine = dataclasses.asdict(getattr(receipt_tip, name)())
        theirs = dataclasses.asdict(getattr(j_receipt_tip, name)())
        shared = set(mine) & set(theirs) - {"dtype"}
        assert {k for k in shared if mine[k] != theirs[k]} == differ, name
    assert receipt_tip.full_config().kernel_blocks == (128, 128, 512)
    assert receipt_tip.reduced_config().backend == "torch"
    assert receipt_tip.ARCH_ID == j_receipt_tip.ARCH_ID


def test_cli_writes_one_ok_record(tmp_path):
    out = tmp_path / "dryrun.json"
    rc = dryrun.main(["--arch", "receipt-tip", "--shape", "fd_stack",
                      "--out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 1 and recs[0]["ok"]
    assert recs[0]["mesh"] == "16x16" and recs[0]["chips"] == 256
    r = recs[0]["roofline"]
    # two of the 512 subsets per position
    assert r["flops_per_dev"] == 2 * 2 * 2048 * 2048 * 8192
    assert np.isfinite(r["t_compute_s"]) and r["bottleneck"] in (
        "compute", "memory", "collective")

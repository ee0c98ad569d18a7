"""``DeviceGraph`` built on the device from its edge ids, held against a
plain host build of the same residual graph: ``induced_on_u`` (with its
sorts), then a dense ``np.zeros`` and a fill of the ones.  Port only, on
the CPU with the kernels' plain versions."""
import numpy as np
import pytest
import torch

from repro_torch.core.engine.peel_loop import (DeviceGraph, ReceiptConfig,
                                               RunStats, bucket)
from repro_torch.core.graph import powerlaw_bipartite
from repro_torch.kernels import butterfly_sparse as ksparse

BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (small tensors)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _members(n_u, kind, seed):
    """Ascending member sets, as DGM keeps them, or every row."""
    rng = np.random.default_rng(seed)
    if kind == "all":
        return np.arange(n_u)
    if kind == "one":
        return np.array([int(rng.integers(n_u))])
    share = {"most": 0.8, "few": 0.3}[kind]
    return np.sort(rng.choice(n_u, max(1, int(n_u * share)), replace=False))


def _plain(g, members, cfg):
    """The residual graph built on the host: the reference's numbers."""
    bi, bj, bk = cfg.kernel_blocks
    sub, _ = g.induced_on_u(members, min_degree_v=2)
    dvk = sub.degrees_v()
    eu, ev = sub.edges_u, sub.edges_v
    n_cols = max(int(sub.n_v), 1)
    rows_pad = bucket(len(members), max(bi, bj))
    cols_pad = bucket(n_cols, bk)
    a = np.zeros((rows_pad, cols_pad), np.float32)
    a[eu, ev] = 1.0
    dv0 = np.zeros(cols_pad, np.float32)
    dv0[: len(dvk)] = dvk
    w = np.zeros(rows_pad, np.float64)
    np.add.at(w, eu, (dvk[ev] - 1).astype(np.float64))
    du = np.bincount(eu, minlength=rows_pad)
    return dict(a=torch.from_numpy(a), m=len(eu), dv0=dv0, w_np=w,
                total_wedges=float(w.sum()),
                c_rcnt=float(np.minimum(du[eu], dvk[ev]).sum()),
                n_cols=n_cols, rows_pad=rows_pad, cols_pad=cols_pad)


@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("kind", ["all", "most", "few", "one"])
@pytest.mark.parametrize("shape", [(60, 80, 500, 3), (97, 53, 700, 11),
                                   (150, 210, 1200, 29)])
def test_device_graph_equals_a_plain_host_build(shape, kind, backend):
    n_u, n_v, m, seed = shape
    g = powerlaw_bipartite(n_u, n_v, m, seed=seed).relabel_by_degree()
    members = _members(g.n_u, kind, seed)
    cfg = ReceiptConfig(kernel_blocks=BLOCKS, backend=backend)
    want = _plain(g, members, cfg)
    stats = RunStats()
    dg = DeviceGraph(g, members, cfg, device=CPU, stats=stats)
    assert torch.equal(dg.a, want["a"])
    np.testing.assert_array_equal(dg.dv0.numpy(), want["dv0"])
    np.testing.assert_array_equal(dg.w_np, want["w_np"])
    for key in ("total_wedges", "c_rcnt", "n_cols", "rows_pad",
                "cols_pad"):
        assert getattr(dg, key) == want[key], key
    if backend == "torch_sparse":
        row_ext = ksparse.row_extents_device(want["a"], BLOCKS[2])
        assert torch.equal(dg.row_ext, row_ext)
        assert torch.equal(dg.kmax, ksparse.tile_extents(row_ext, BLOCKS[0]))
    else:
        assert dg.row_ext is None and dg.kmax is None
    # the matrix is built on the device, never uploaded
    assert stats.trace.built_bytes == want["rows_pad"] * want["cols_pad"] * 4
    assert stats.trace.upload_bytes == want["m"] * 8 + want["cols_pad"] * 4

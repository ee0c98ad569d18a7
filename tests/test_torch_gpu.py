"""The port on the card: each CUDA kernel against its plain version, and
the main path against the exact oracle.

Every test here is marked ``gpu`` and skips without a card (the kernels
have no CPU mode).  The file imports nothing of JAX, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from conftest import make_vhub_graph
from repro_torch.convert import graph_from_arrays
from repro_torch.core import peeling
from repro_torch.core.engine import ReceiptConfig
from repro_torch.core.graph import paper_fig1_graph, powerlaw_bipartite
from repro_torch.core.receipt import tip_decompose
from repro_torch.kernels import butterfly as bfly
from repro_torch.kernels import butterfly_sparse as bsp
from repro_torch.kernels import ops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _adj(gen, *shape, density=0.3):
    return (torch.rand(*shape, generator=gen) < density).float()


@pytest.mark.gpu
@pytest.mark.parametrize("n_a,n_b,n_v", [(8, 8, 8), (70, 33, 129),
                                         (300, 257, 1000)])
def test_kernels_equal_plain(card, n_a, n_b, n_v):
    """Ragged shapes (no tile multiple) on purpose: the kernels mask the
    edge themselves.  torch.equal: the f32 integer regime is exact."""
    gen = torch.Generator().manual_seed(n_a)
    a = _adj(gen, n_a, n_v).to(card)
    rows = torch.randint(0, n_a, (n_b,), generator=gen).to(card)
    valid = (torch.arange(n_b) < n_b // 2).float().to(card)
    b = a[rows] * valid[:, None]
    ids = torch.arange(n_a, dtype=torch.int32, device=card)
    rows = rows.to(torch.int32)
    assert torch.equal(bfly.butterfly_update(a, b, valid, ids, rows),
                       bfly.butterfly_update_plain(a, b, valid, ids, rows))
    a3 = _adj(gen, 3, n_a, n_v).to(card)
    ids3 = ids.expand(3, n_a).contiguous()
    s3 = (torch.rand(3, n_a, generator=gen) < 0.7).float().to(card)
    assert torch.equal(
        bfly.butterfly_update_batched(a3, a3, s3, ids3, ids3),
        bfly.butterfly_update_batched_plain(a3, a3, s3, ids3, ids3))
    cut = torch.randint(0, n_v + 1, (2, n_a, 1), generator=gen)
    st = (_adj(gen, 2, n_a, n_v) * (torch.arange(n_v) < cut)).to(card)
    for blocks in [(8, 8, 8), (16, 8, 32), (128, 128, 512)]:
        assert torch.equal(ops.b2_stack(st, blocks=blocks),
                           bsp.b2_stack_plain(st, None, None, blocks=blocks))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["b2", "kernel"])
def test_main_path_on_card_matches_oracle(card, mode):
    ops.reset_launch_counts()
    vhub = make_vhub_graph(seed=6)
    for g in (paper_fig1_graph(), powerlaw_bipartite(200, 120, 1500, seed=5),
              graph_from_arrays(vhub.n_u, vhub.n_v, vhub.edges_u,
                                vhub.edges_v)):
        theta, _ = tip_decompose(g, ReceiptConfig(fd_update_mode=mode))
        np.testing.assert_array_equal(theta, peeling.bup_oracle(g)[0])
    counts = ops.launch_counts()
    assert counts["butterfly_update"] > 0
    assert counts["butterfly_update_batched"] > 0
    assert (counts["b2_stack"] > 0) == (mode == "b2")

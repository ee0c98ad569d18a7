"""The port's ParB baseline, legacy FD engines and counting module against
the reference.

Each case is built once with numpy and handed to both packages.  The
reference runs its ``xla`` backend, the port ``torch`` (and
``torch_sparse``) with kernel blocks (8, 8, 8).  Theta and the paper's
counters are compared bit for bit (the f32 integer regime, DESIGN.md
section 8, makes the arithmetic exact).  ``host_round_trips``,
``device_loop_calls`` and ``overflow_fallbacks`` are the port's own and
are not compared: the port sizes every gather to its peel set, so its
ParB never overflows.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import GRAPH_CASES
from repro.core import counting as jcount
from repro.core.engine import ReceiptConfig as JConfig
from repro.core.engine import parb_tip_decompose as j_parb
from repro.core.engine import tip_decompose as j_tip_decompose
from repro.core.engine.fd import _fd_peel_b2_vm, _fd_peel_matvec_vm
from repro.core.graph import powerlaw_bipartite
from repro.core.peeling import bup_oracle
from repro_torch.convert import config_from_fields, graph_from_arrays
from repro_torch.core import counting as tcount
from repro_torch.core import receipt as treceipt
from repro_torch.core.engine import fd as tfd
from repro_torch.kernels import ops as tops

BLOCKS = (8, 8, 8)
CPU = torch.device("cpu")
FD_COUNTERS = ("rho_cd", "rho_fd", "wedges_cd", "wedges_fd", "num_subsets",
               "bounds", "subset_sizes", "subset_wedges_fd", "fd_groups",
               "fd_padding_waste")
PARB_COUNTERS = ("rho_cd", "wedges_cd", "elided_sweeps", "huc_recounts",
                 "wedges_pvbcnt", "rho_fd", "wedges_fd")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: its CPU tensors are small, and
    the test workers' thread pools would otherwise oversubscribe the
    cores (each pool spins while it waits)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_graph(g):
    return graph_from_arrays(g.n_u, g.n_v, g.edges_u, g.edges_v)


def _configs(backend="torch", **kw):
    """The reference's config (backend ``xla``) and the port's, with the
    port's ``backend`` (``torch`` or ``torch_sparse``)."""
    jcfg = JConfig(backend="xla", kernel_blocks=BLOCKS, **kw)
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    fields["backend"] = {"torch": "xla", "torch_sparse": "interpret_sparse"}[
        backend]
    return jcfg, config_from_fields(fields)


# ---------------------------------------------------------------------- #
# legacy FD engines
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _reference_fd(case, side, mode):
    jcfg, _ = _configs(fd_mode=mode)
    return j_tip_decompose(GRAPH_CASES[case](), jcfg, side=side)


@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("mode", ["b2", "matvec"])
@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_legacy_fd_modes_match_reference(case, side, mode, backend):
    """``fd_mode="b2"`` (B2 rows from the kernel-3 stack) and
    ``"matvec"`` (one B2 row recomputed per step): theta equal to the
    reference and ``bup_oracle``, and the CD + FD counters equal."""
    g = GRAPH_CASES[case]()
    j_theta, j_stats = _reference_fd(case, side, mode)
    _, tcfg = _configs(backend, fd_mode=mode)
    t_theta, t_stats = treceipt.tip_decompose(_port_graph(g), tcfg,
                                              side=side, device=CPU)
    np.testing.assert_array_equal(t_theta, j_theta)
    np.testing.assert_array_equal(
        t_theta, bup_oracle(g if side == "U" else g.transposed())[0])
    for key in FD_COUNTERS:
        assert getattr(t_stats, key) == getattr(j_stats, key), key


@pytest.mark.parametrize("mode", ["b2", "matvec"])
def test_sequential_peels_match_reference(mode):
    """``_fd_peel_b2`` / ``_fd_peel_matvec`` on one (G, M) stack with
    ragged member counts, ties in the supports and positive floors,
    against the reference's ``vmap``-ed loops."""
    rng = np.random.default_rng(31)
    g_n, mm, cc = 3, 16, 12
    a = (rng.random((g_n, mm, cc)) < 0.4).astype(np.float32)
    nmem = np.array([16, 9, 0])
    alive = np.arange(mm)[None, :] < nmem[:, None]
    a *= alive[:, :, None]
    w = np.einsum("gic,gjc->gij", a, a)
    b2 = (w * (w - 1) / 2).astype(np.float32)
    for k in range(g_n):
        np.fill_diagonal(b2[k], 0)
    sup = np.where(alive, b2.sum(axis=2), np.inf).astype(np.float32)
    lo = np.array([0.0, 4.0, 1.0], np.float32)
    if mode == "b2":
        want = _fd_peel_b2_vm(jnp.asarray(b2), jnp.asarray(sup),
                              jnp.asarray(nmem), jnp.asarray(lo))
        got = tfd._fd_peel_b2(torch.from_numpy(b2), torch.from_numpy(sup),
                              torch.from_numpy(nmem), torch.from_numpy(lo))
    else:
        want = _fd_peel_matvec_vm(jnp.asarray(a), jnp.asarray(sup),
                                  jnp.asarray(nmem), jnp.asarray(lo))
        got = tfd._fd_peel_matvec(torch.from_numpy(a), torch.from_numpy(sup),
                                  torch.from_numpy(nmem),
                                  torch.from_numpy(lo))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------- #
# ParB
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _reference_parb(case, kw):
    jcfg, _ = _configs(**dict(kw))
    return j_parb(GRAPH_CASES[case](), jcfg)


@pytest.mark.parametrize("backend", ["torch", "torch_sparse"])
@pytest.mark.parametrize("device_loop", [True, False])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_parb_matches_reference(case, device_loop, backend):
    """``parb_tip_decompose`` over ``device_peel_loop(minmode=True)``, and
    with ``device_loop=False`` the blocking host schedule over
    ``host_sweep``: theta and the counters equal the reference's."""
    g = GRAPH_CASES[case]()
    kw = (("device_loop", device_loop),)
    j_theta, j_stats = _reference_parb(case, kw)
    _, tcfg = _configs(backend, **dict(kw))
    t_theta, t_stats = treceipt.parb_tip_decompose(_port_graph(g), tcfg,
                                                   device=CPU)
    np.testing.assert_array_equal(t_theta, j_theta)
    np.testing.assert_array_equal(t_theta, bup_oracle(g)[0])
    for key in PARB_COUNTERS:
        assert getattr(t_stats, key) == getattr(j_stats, key), key
    assert t_stats.overflow_fallbacks == 0


def test_parb_reenters_after_cap_exits():
    """``max_sweeps=1``: every loop invocation stops after one sweep and
    the driver re-enters until no row is alive."""
    g = GRAPH_CASES["powerlaw"]()
    j_theta, j_stats = _reference_parb("powerlaw", (("max_sweeps", 1),))
    _, tcfg = _configs(max_sweeps=1)
    t_theta, t_stats = treceipt.parb_tip_decompose(_port_graph(g), tcfg,
                                                   device=CPU)
    np.testing.assert_array_equal(t_theta, j_theta)
    assert t_stats.rho_cd == j_stats.rho_cd
    assert t_stats.device_loop_calls == t_stats.rho_cd


@pytest.mark.parametrize("seed,rho", [(5, 106), (7, 117), (23, 115)])
def test_tiled_sweeps_equal_parb_rounds(seed, rho):
    """The tiled engine runs the ParB schedule (whole-graph min-level peel
    with lo = 0), so its ``rho_fd`` equals ParB's ``rho_cd`` — the
    reference's counts on these graphs — and the theta agree."""
    g = _port_graph(powerlaw_bipartite(200, 120, 1500, seed=seed))
    _, tcfg = _configs()
    p_theta, p_stats = treceipt.parb_tip_decompose(g, tcfg, device=CPU)
    t_theta, t_stats = treceipt.tip_decompose(
        g, dataclasses.replace(tcfg, representation="tiled"), device=CPU)
    assert p_stats.rho_cd == t_stats.rho_fd == rho
    np.testing.assert_array_equal(t_theta, p_theta)


# ---------------------------------------------------------------------- #
# counting
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_counting_matches_reference(case):
    """The dense kernel path (all rows, and an alive mask), the wedge-pair
    table, the sort + segment-sum path and the int64 oracle."""
    g = GRAPH_CASES[case]()
    tg = _port_graph(g)
    a = g.dense()[: g.n_u, : g.n_v]
    alive = (np.random.default_rng(4).random(g.n_u) < 0.6).astype(np.float32)
    for mask in (None, alive):
        want = jcount.butterfly_counts_dense(
            jnp.asarray(a), None if mask is None else jnp.asarray(mask),
            backend="xla")
        got = tcount.butterfly_counts_dense(
            torch.from_numpy(a), None if mask is None
            else torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    j_us, j_ups = jcount.wedge_pair_table(g)
    t_us, t_ups = tcount.wedge_pair_table(tg)
    np.testing.assert_array_equal(t_us, j_us)
    np.testing.assert_array_equal(t_ups, j_ups)
    want = jcount.butterfly_counts_segment(jnp.asarray(j_us),
                                           jnp.asarray(j_ups), g.n_u)
    got = tcount.butterfly_counts_segment(torch.from_numpy(t_us),
                                          torch.from_numpy(t_ups), g.n_u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tcount.butterfly_counts_numpy(tg),
                                  jcount.butterfly_counts_numpy(g))
    np.testing.assert_array_equal(got.numpy(),
                                  jcount.butterfly_counts_numpy(g))
    tops.reset_launch_counts()
    tcount.butterfly_counts_dense(torch.from_numpy(a))
    assert sum(tops.launch_counts().values()) == 0     # the plain version

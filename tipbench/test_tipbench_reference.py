"""CPU tests of the benchmark's yardstick: the plain reference against a
brute-force peel and against the dense form of the level peel, the
generator copy against Marvel's seed-0 figures, and the run's import
boundary (no JAX, no JAX package)."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tipbench import generator, harness, reference

ROOT = Path(__file__).resolve().parents[1]


def _brute_theta(n_u, n_v, eu, ev):
    """Alg. 2 one vertex at a time, in Python integers: peel a vertex of
    least support, set its tip number, and lower each alive vertex's
    support by the butterflies it shares with it, not below that level."""
    nbr = [set() for _ in range(n_u)]
    for u, v in zip(eu, ev):
        nbr[int(u)].add(int(v))

    def shared(x, y):
        w = len(nbr[x] & nbr[y])
        return w * (w - 1) // 2

    sup = [sum(shared(x, y) for y in range(n_u) if y != x)
           for x in range(n_u)]
    alive = set(range(n_u))
    theta = [0] * n_u
    while alive:
        x = min(alive, key=lambda u: (sup[u], u))
        t = sup[x]
        theta[x] = t
        alive.remove(x)
        for y in alive:
            b = shared(x, y)
            if b:
                sup[y] = max(t, sup[y] - b)
    return np.array(theta, np.int64)


def _dense_tip_numbers(n_u, n_v, eu, ev):
    """The level peel over the whole dense B2 in float64 (the reference's
    form before its memory followed the wedge pairs): (theta, levels,
    largest support)."""
    b2 = reference.pair_butterflies(n_u, n_v, eu, ev)
    sup = b2.sum(dim=1)
    top = float(sup.max().item()) if n_u else 0.0
    theta = torch.zeros(n_u, dtype=torch.float64)
    alive = torch.ones(n_u, dtype=torch.bool)
    levels = 0
    left = n_u
    while left:
        t = torch.where(alive, sup, torch.tensor(float("inf"),
                                                 dtype=torch.float64)).min()
        rows = torch.nonzero(alive & (sup <= t)).squeeze(1)
        theta[rows] = t
        alive[rows] = False
        left -= rows.numel()
        drop = b2.index_select(0, rows).sum(dim=0)
        sup = torch.where(alive, torch.maximum(sup - drop, t), sup)
        levels += 1
    return theta.round().to(torch.int64).numpy(), levels, top


def _fig1():
    """The paper's Fig. 1 graph: u1: v1 v2 | u2: v1 v2 v3 | u3: v1..v5 |
    u4: v4 v5 (butterfly counts 2, 4, 5, 1; tip numbers 2, 3, 3, 1)."""
    eu = [0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3]
    ev = [0, 1, 0, 1, 2, 0, 1, 2, 3, 4, 3, 4]
    return 4, 5, np.array(eu), np.array(ev)


def test_reference_on_the_paper_fig1_graph():
    n_u, n_v, eu, ev = _fig1()
    theta, levels, top = reference.tip_numbers(n_u, n_v, eu, ev)
    b2 = reference.pair_butterflies(n_u, n_v, eu, ev)
    assert b2.sum(dim=1).tolist() == [2, 4, 5, 1]
    assert theta.tolist() == [2, 3, 3, 1]
    assert top == 5 and levels >= 1
    assert theta.tolist() == _brute_theta(n_u, n_v, eu, ev).tolist()


@pytest.mark.parametrize("seed", range(6))
def test_reference_matches_a_brute_force_peel(seed):
    """Seeded Chung-Lu graphs (hubs, ties, isolated rows) and uniform
    ones: the level peel gives the one-at-a-time peel's numbers."""
    if seed % 2:
        n_u, n_v = 40, 30
        eu, ev = generator.powerlaw_edges(n_u, n_v, 160, seed=(seed, 0))
    else:
        rng = np.random.default_rng(seed)
        n_u, n_v = 35, 25
        a = rng.random((n_u, n_v)) < 0.2
        eu, ev = np.nonzero(a)
    theta, _, _ = reference.tip_numbers(n_u, n_v, eu, ev)
    assert theta.tolist() == _brute_theta(n_u, n_v, eu, ev).tolist()


def _seeded_graph(kind, seed):
    """The graphs the tests above and the loops' tests draw: Chung-Lu
    (hubs, ties, isolated rows) and uniform ones."""
    if kind == "fig1":
        return _fig1()
    if kind == "uniform":
        rng = np.random.default_rng(seed)
        a = rng.random((35, 25)) < 0.2
        return (35, 25) + np.nonzero(a)
    n_u, n_v, m = {"powerlaw": (40, 30, 160), "bf16": (60, 80, 500),
                   "loop": (45, 35, 260)}[kind]
    if kind == "loop":
        return (n_u, n_v) + generator.powerlaw_edges_exact(
            n_u, n_v, m, seed=((2 ** 31 + 3, seed), 0))
    return (n_u, n_v) + generator.powerlaw_edges(n_u, n_v, m,
                                                 seed=(seed, 0))


@pytest.mark.parametrize("block_cells", [None, 96])
@pytest.mark.parametrize("kind,seed", [
    ("fig1", 0), ("uniform", 0), ("uniform", 2), ("uniform", 4),
    ("powerlaw", 1), ("powerlaw", 3), ("powerlaw", 5), ("bf16", 3),
    ("loop", 0), ("loop", 1)])
def test_reference_equals_the_dense_form(monkeypatch, kind, seed,
                                         block_cells):
    """Tip numbers, levels and largest support as the level peel over the
    whole dense B2 gives them, with W in one block and in many."""
    if block_cells:
        monkeypatch.setattr(reference, "_BLOCK_CELLS", block_cells)
    n_u, n_v, eu, ev = _seeded_graph(kind, seed)
    theta, levels, top = reference.tip_numbers(n_u, n_v, eu, ev)
    want, want_levels, want_top = _dense_tip_numbers(n_u, n_v, eu, ev)
    assert theta.tolist() == want.tolist()
    assert (levels, top) == (want_levels, want_top)


@pytest.mark.parametrize("block_cells", [None, 4096])
def test_reference_memory_follows_the_wedge_pairs(monkeypatch,
                                                  block_cells):
    """100,000 peeled vertices x 50 others, 2,000 edges: the dense B2
    would take 80 GB.  Vertices of degree below 2 have tip number 0, and
    the others the dense form's numbers on the graph of them alone."""
    if block_cells:
        monkeypatch.setattr(reference, "_BLOCK_CELLS", block_cells)
    n_u, n_v = 100_000, 50
    eu, ev = generator.powerlaw_edges_exact(n_u, n_v, 2000, seed=(17, 0))
    theta, levels, top = reference.tip_numbers(n_u, n_v, eu, ev)
    deg = np.bincount(eu, minlength=n_u)
    keep = np.flatnonzero(deg >= 2)
    on = deg[eu] >= 2
    pos = np.searchsorted(keep, eu[on])
    want, want_levels, want_top = _dense_tip_numbers(keep.size, n_v, pos,
                                                     ev[on])
    assert 100 < keep.size < 2000 and want_top > 100
    assert np.all(theta[deg < 2] == 0)
    assert theta[keep].tolist() == want.tolist() and top == want_top
    assert levels == want_levels + (0 if 0 in want else 1)


def test_reference_handles_an_edgeless_graph():
    theta, levels, top = reference.tip_numbers(5, 4, [], [])
    assert theta.tolist() == [0] * 5 and levels == 1 and top == 0


def test_bfloat16_reference_departs_from_the_exact_one():
    """The control's arithmetic: supports in bfloat16 round above 256, so
    the numbers differ from the float64 reference on a graph whose
    supports reach the thousands."""
    eu, ev = generator.powerlaw_edges(60, 80, 500, seed=(3, 0))
    exact, _, top = reference.tip_numbers(60, 80, eu, ev)
    low, _, _ = reference.tip_numbers(60, 80, eu, ev, dtype=torch.bfloat16)
    assert top > 1000
    assert np.count_nonzero(low != exact) > 0


def test_generator_copy_gives_marvel_seed_0():
    """82,255 distinct edges and a largest side-U support of 3,938,492,
    counted here by a sparse product independent of the reference."""
    import scipy.sparse as sp

    eu, ev = generator.powerlaw_edges(6486, 12942, 96662, 2.0, 2.0, seed=0)
    assert eu.size == 82255
    keys = eu.astype(np.int64) * 12942 + ev
    assert np.all(np.diff(keys) > 0)
    a = sp.csr_matrix((np.ones(eu.size), (eu, ev)), shape=(6486, 12942))
    w = (a @ a.T).tocsr()
    w.setdiag(0)
    w.data = w.data * (w.data - 1) / 2
    assert int(np.asarray(w.sum(axis=1)).max()) == 3938492


def test_mutation_batches_delete_present_and_insert_absent_edges():
    n_u, n_v = 50, 70
    eu, ev = generator.powerlaw_edges(n_u, n_v, 400, seed=(9, 0))
    cur = generator.edge_keys(eu, ev, n_v)
    batches = generator.mutation_batches(cur, n_u, n_v, 400, 2.0, 2.0, 0.05,
                                         0.5, 6, seed=(9, 1))
    again = generator.mutation_batches(cur, n_u, n_v, 400, 2.0, 2.0, 0.05,
                                       0.5, 6, seed=(9, 1))
    for (d, i), (d2, i2) in zip(batches, again):
        assert np.array_equal(d, d2) and np.array_equal(i, i2)
    for dels, ins in batches:
        size = max(2, int(round(0.05 * cur.size)))
        assert dels.size == int(round(0.5 * size))
        assert dels.size + ins.size == size
        assert np.isin(dels, cur).all() and not np.isin(ins, cur).any()
        assert np.unique(ins).size == ins.size
        assert (ins // n_v < n_u).all() and (ins % n_v < n_v).all()
        cur = np.union1d(np.setdiff1d(cur, dels), ins)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch", "repro_torch.api", "jaxtyping", "tipbench",
             "reprox.y"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["repro.core.graph", "jax",
                                              "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter: import every module of the harness and the
    entry point, drive a small cell on the CPU through the whole run, and
    list the modules whose top-level name is forbidden."""
    code = textwrap.dedent(f"""
        import json, runpy, sys, time
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        runpy.run_path({str(ROOT / 'tipbench' / 'run.py')!r},
                       run_name="tipbench_run")
        from tipbench import control, harness
        spec = harness.load_cell("chunglu_marvel.refresh")
        spec["config"] = dict(spec["config"], n_u=40, n_v=50, m=200)
        spec["traffic"] = dict(spec["traffic"], cycles=8)
        r = harness.run_cell(spec, 5, 0.01, False, "cpu",
                             time.perf_counter(), log=lambda *a, **k: None)
        print(json.dumps([r["correct"], harness.forbidden_modules()]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True
    assert bad == []


@pytest.mark.parametrize("shape", [(6486, 12942, 96662),
                                   (16726, 22015, 58595), (40, 50, 220)])
def test_exact_generator_realises_the_published_edge_count(shape):
    """Exactly m distinct edges, sorted, in range, the same from the same
    seed and another from another."""
    n_u, n_v, m = shape
    eu, ev = generator.powerlaw_edges_exact(n_u, n_v, m, seed=(2 ** 31 + 9,
                                                                0))
    keys = eu.astype(np.int64) * n_v + ev
    assert keys.size == m and np.all(np.diff(keys) > 0)
    assert eu.min() >= 0 and eu.max() < n_u and ev.max() < n_v
    again = generator.powerlaw_edges_exact(n_u, n_v, m,
                                           seed=(2 ** 31 + 9, 0))
    other = generator.powerlaw_edges_exact(n_u, n_v, m,
                                           seed=(2 ** 31 + 9, 1))
    assert np.array_equal(again[0], eu) and np.array_equal(again[1], ev)
    assert not (np.array_equal(other[0], eu)
                and np.array_equal(other[1], ev))


def test_decompose_requests_are_distinct_graphs_checked_each_by_its_own():
    """Each request of the decompose loop is a graph of its own, drawn
    from ``(seed, i)``, and the reference's answer to it is that graph's."""
    from tipbench import loops

    cfg = json.loads((ROOT / "tipbench/configs/chunglu_marvel.json")
                     .read_text())
    cfg.update(n_u=45, n_v=35, m=260)
    loop = loops.DecomposeLoop(cfg, {"pool": 3}, 2 ** 31 + 3, "cpu")
    loop.prepare()
    graphs = [loop.answer_graph(k) for k in range(4)]
    assert all(g[2].size == 260 for g in graphs)
    assert graphs[0][2].tolist() != graphs[1][2].tolist()
    assert graphs[3][2].tolist() == graphs[0][2].tolist()     # cycled
    for k in range(3):
        want, _, _ = reference.tip_numbers(*graphs[k])
        got, _ = loop.expected(k)
        assert got.tolist() == want.tolist()

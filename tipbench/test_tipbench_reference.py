"""CPU tests of the benchmark's yardstick: the plain reference against a
brute-force peel, the generator copy against Marvel's seed-0 figures, and
the run's import boundary (no JAX, no JAX package)."""
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

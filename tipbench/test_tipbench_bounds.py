"""CPU tests of ``tipbench.bounds``: each count held against a brute-force
count over every row pair or (row, column), and ``launch_bound`` against
the counts it should pick for each entry point and backend."""
import numpy as np
import pytest
import torch

from tipbench import bounds


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _adj(rng, *shape, density=0.25):
    return (rng.random(shape) < density).astype(np.float32)


def test_bound_takes_the_larger_of_operations_and_bytes():
    t, what = bounds.bound(1979e9, 0.0)
    assert t == pytest.approx(1.0) and what == "operations"
    t, what = bounds.bound(0.0, 3.35e9)
    assert t == pytest.approx(1.0) and what == "bytes"


def _peel_brute(a, b, s, ka, kb, blocks):
    n_a, n_v = a.shape
    n_b = b.shape[0]
    valid = np.nonzero(s)[0]
    live = (b[valid] != 0).any(axis=0) if valid.size else np.zeros(n_v, bool)

    def lim(i, j):
        if ka is None:
            return n_v
        return min(ka[i // blocks[0]], kb[j // blocks[1]]) * blocks[2]

    ops = a_bytes = 0
    for i in range(n_a):
        reach = 0
        for j in valid:
            ops += 2 * int(live[:min(lim(i, j), n_v)].sum())
            reach = max(reach, lim(i, j))
        a_bytes += 4 * int(live[:min(reach, n_v)].sum())
    nbytes = a_bytes + 4.0 * (valid.size * n_v + n_b + valid.size + 2 * n_a)
    if ka is not None:
        nbytes += 4.0 * (ka.size + kb.size)
    return ops, nbytes, int(live.sum())


@pytest.mark.parametrize("extents", [False, True])
@pytest.mark.parametrize("n_valid", [0, 1, 5])
def test_peel_live_work_matches_brute_force(n_valid, extents):
    rng = np.random.default_rng(40 + n_valid)
    n_a, n_b, n_v = 21, 9, 37
    blocks = (4, 2, 8)
    a, b = _adj(rng, n_a, n_v), _adj(rng, n_b, n_v, density=0.15)
    s = np.zeros(n_b, np.float32)
    s[rng.choice(n_b, n_valid, replace=False)] = 1.0
    ka = kb = None
    if extents:
        ka = rng.integers(0, 6, -(-n_a // blocks[0])).astype(np.int32)
        kb = rng.integers(0, 6, -(-n_b // blocks[1])).astype(np.int32)
    want = _peel_brute(a, b, s, ka, kb, blocks)
    ext = (_t(ka), _t(kb), blocks) if extents else ()
    got = bounds.peel_live_work(_t(a), _t(b), _t(s), *ext)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]


@pytest.mark.parametrize("extents", [False, True])
def test_stack_peel_live_work_sums_the_groups(extents):
    rng = np.random.default_rng(50)
    g_n, n_a, n_b, n_v = 3, 21, 9, 37
    blocks = (4, 2, 8)
    a, b = _adj(rng, g_n, n_a, n_v), _adj(rng, g_n, n_b, n_v)
    s = np.zeros((g_n, n_b), np.float32)
    for g, n in enumerate((0, 1, 5)):
        s[g, rng.choice(n_b, n, replace=False)] = 1.0
    ka = rng.integers(0, 6, (g_n, -(-n_a // 4))).astype(np.int32)
    kb = rng.integers(0, 6, (g_n, -(-n_b // 2))).astype(np.int32)
    ops = nbytes = 0.0
    for g in range(g_n):
        o, n, _ = _peel_brute(a[g], b[g], s[g], ka[g] if extents else None,
                              kb[g] if extents else None, blocks)
        ops += o
        nbytes += n
    ext = (_t(ka), _t(kb), blocks) if extents else ()
    assert bounds.stack_peel_live_work(_t(a), _t(b), _t(s), *ext) == (
        ops, nbytes)


@pytest.mark.parametrize("extents", [None, (4, 4, 8), (5, 5, 3)])
@pytest.mark.parametrize("dead", [0, 7, 23])
def test_count_pair_ops_matches_brute_force(dead, extents):
    rng = np.random.default_rng(60 + dead)
    n, n_v = 23, 37
    a = _adj(rng, n, n_v, density=0.3)
    a[rng.choice(n, 6, replace=False)] = 0.0
    a[:, 9:13] = 0.0
    s = np.ones(n, np.float32)
    s[rng.choice(n, dead, replace=False)] = 0.0
    full = (a != 0).any(axis=1)
    live = (a[full & (s != 0)] != 0).any(axis=0)
    kmax = None
    if extents is not None:
        bi, _, bk = extents
        kmax = rng.integers(0, 7, -(-n // bi)).astype(np.int32)

    def cols(i, j):
        lim = n_v if kmax is None else min(
            min(kmax[i // bi], kmax[j // bi]) * bk, n_v)
        return int(live[:lim].sum())

    want = sum(cols(i, j) for i in range(n) for j in range(n)
               if i != j and full[i] and full[j] and (s[i] or s[j]))
    got = bounds.count_pair_ops(_t(a), _t(s),
                                None if kmax is None else _t(kmax), extents)
    assert got == want


@pytest.mark.parametrize("extents", [None, (4, 4, 8), (4, 8, 8), (5, 3, 3)])
def test_b2_pair_ops_matches_brute_force(extents):
    rng = np.random.default_rng(70)
    g_n, m, n_v = 3, 23, 37
    a = _adj(rng, g_n, m, n_v, density=0.3)
    a[0, rng.choice(m, 6, replace=False)] = 0.0
    a[:, m - 3:] = 0.0
    a[2] = 0.0
    ka = kb = None
    if extents is not None:
        bi, bj, bk = extents
        ka = rng.integers(0, 7, (g_n, -(-m // bi))).astype(np.int32)
        kb = rng.integers(0, 7, (g_n, -(-m // bj))).astype(np.int32)
    want = 0
    for g in range(g_n):
        full = (a[g] != 0).any(axis=1)
        live = (a[g] != 0).any(axis=0)

        def lim(x):
            if ka is None:
                return n_v
            return min(min(ka[g, x // bi], kb[g, x // bj]) * bk, n_v)

        for x in range(m):
            for y in range(x + 1, m):
                if full[x] and full[y]:
                    want += 2 * int(live[:min(lim(x), lim(y))].sum())
    ext = () if ka is None else (_t(ka), _t(kb), extents)
    assert bounds.b2_pair_ops(_t(a), *ext) == want


def test_tiled_peel_live_work_matches_brute_force():
    """Kernel 6's mask form over a slot list: every nonzero tile of a
    (3 x 4)-tile matrix a slot, one slot dead; per row with mass and
    column band, 2 bi operations for each column the row holds in its own
    live tile times the live slots of that band; bytes of those columns
    of each band's live slots, s and out, and the index arrays."""
    rng = np.random.default_rng(80)
    bi, bk, n_rt, n_ct = 4, 8, 3, 4
    dense = _adj(rng, n_rt * bi, n_ct * bk, density=0.3)
    dense[:bi, bk:2 * bk] = 0.0                       # an empty tile
    pos = -np.ones((n_rt, n_ct), np.int32)
    tiles, srow, scol = [], [], []
    for r in range(n_rt):
        for c in range(n_ct):
            t = dense[r * bi:(r + 1) * bi, c * bk:(c + 1) * bk]
            if t.any():
                pos[r, c] = len(tiles)
                tiles.append(t)
                srow.append(r)
                scol.append(c)
    td = np.stack(tiles)
    live = np.ones(len(tiles), np.int32)
    live[1] = 0
    s = np.zeros(n_rt * bi, np.float32)
    s[[0, 5, 6, 11]] = 1.0
    col_live = np.zeros(n_ct)
    for k, c in enumerate(scol):
        col_live[c] += live[k]
    ops, cols = 0.0, np.zeros((n_ct, bk), bool)
    for y in np.nonzero(s)[0]:
        for c in range(n_ct):
            p = pos[y // bi, c]
            if p < 0 or not live[p]:
                continue
            nz = td[p, y % bi] != 0
            ops += 2 * bi * nz.sum() * col_live[c]
            cols[c] |= nz
    nbytes = (4.0 * bi * float((cols.sum(axis=1) * col_live).sum())
              + 4.0 * 2 * n_rt * bi
              + 4.0 * (3 * len(tiles) + n_rt + 1 + n_rt * n_ct))
    got = bounds.tiled_peel_live_work(_t(td), _t(np.array(scol, np.int32)),
                                      _t(pos), _t(live), _t(s))
    assert got == (ops, nbytes)


@pytest.mark.parametrize("shape,blocks", [((2, 23, 37), (4, 8)),
                                          ((16, 40), (16, 8)),
                                          ((9, 9), (4, 3))])
def test_tile_extents_of_is_the_last_nonzero_stripe_of_each_tile(shape,
                                                                  blocks):
    rng = np.random.default_rng(90)
    a = _adj(rng, *shape, density=0.1)
    a[..., :blocks[0], :] = 0.0                       # an all-zero tile
    br, bk = blocks
    *lead, rows, n_v = a.shape
    flat = a.reshape(-1, rows, n_v)
    want = np.zeros((flat.shape[0], -(-rows // br)), np.int64)
    for g in range(flat.shape[0]):
        for t in range(want.shape[1]):
            cols = np.nonzero(flat[g, t * br:(t + 1) * br].any(axis=0))[0]
            want[g, t] = cols.max() // bk + 1 if cols.size else 0
    got = bounds.tile_extents_of(_t(a), br, bk)
    assert got.tolist() == want.reshape(*lead, -1).tolist()


def test_launch_bound_picks_each_entry_points_count():
    """Dense and sparse counting and peel forms of ``butterfly_update``,
    the stack form, kernel 3 with the data's own extents, and no bound for
    an entry point without a hand kernel."""
    rng = np.random.default_rng(100)
    blocks = (4, 4, 8)
    a = _t(_adj(rng, 13, 30))
    s = torch.ones(13)
    ids = torch.arange(13, dtype=torch.int32)
    kmax = bounds.tile_extents_of(a, 4, 8)
    kw = {"blocks": blocks, "body": "count"}
    assert bounds.launch_bound("butterfly_update", (a, a, s, ids, ids),
                               dict(kw, backend="cuda")) == bounds.bound(
        bounds.count_pair_ops(a, s), 4.0 * (13 * 30 + 3 * 13))
    sparse = bounds.launch_bound(
        "butterfly_update", (a, a, s, ids, ids),
        dict(kw, backend="cuda_sparse", kmax_a=kmax, kmax_b=kmax))
    assert sparse == bounds.bound(
        bounds.count_pair_ops(a, s, kmax, blocks),
        bounds._live_stripe_bytes(kmax, kmax, 13, 13, 30, blocks, same=True)
        + 4.0 * (3 * 13 + kmax.numel()))
    b = a[:5].contiguous()
    sb = torch.tensor([1.0, 0, 1, 0, 0])
    o, n, _ = bounds.peel_live_work(a, b, sb)
    assert bounds.launch_bound("butterfly_update", (a, b, sb, ids, ids[:5]),
                               {"backend": None}) == bounds.bound(o, n)
    a3 = a.reshape(1, 13, 30).expand(2, 13, 30).contiguous()
    b3 = b.reshape(1, 5, 30).expand(2, 5, 30).contiguous()
    s3 = sb.expand(2, 5).contiguous()
    assert bounds.launch_bound(
        "butterfly_update_batched", (a3, b3, s3, ids, ids), {}) == \
        bounds.bound(*bounds.stack_peel_live_work(a3, b3, s3))
    k3 = bounds.tile_extents_of(a3, 4, 8)
    assert bounds.launch_bound("b2_stack", (a3,), {"blocks": blocks}) == \
        bounds.bound(bounds.b2_pair_ops(a3, k3, k3, blocks),
                     4.0 * (a3.numel() + 2 * 13 * 13 + 2 * k3.numel()))
    assert bounds.launch_bound("find_hi_device", (), {}) is None

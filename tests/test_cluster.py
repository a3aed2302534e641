"""Clustering engine tests: both engines must recover planted clusters and
agree with each other; merge algebra must match the reference's weighted
mean; runs must be deterministic under a fixed seed."""

import numpy as np
import pytest

from kmerlsh_tpu.cluster import engine, greedy


def planted(rng, n_clusters=12, members=25, S=16, noise=0.01):
    """Well-separated random centroids with tight noise — every engine must
    recover the exact partition."""
    centers = rng.normal(size=(n_clusters, S)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows, labels = [], []
    for c in range(n_clusters):
        pts = centers[c][None, :] + noise * rng.normal(size=(members, S))
        rows.append(pts.astype(np.float32))
        labels += [c] * members
    rows = np.concatenate(rows)
    perm = rng.permutation(len(rows))
    return rows[perm], np.asarray(labels)[perm]


def partition_of(members, n):
    lab = np.full(n, -1)
    for c, ids in enumerate(members):
        lab[np.asarray(ids, int)] = c
    assert (lab >= 0).all()
    return lab


def same_partition(a, b):
    # bijection between label sets
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("eng", ["greedy", "tpu"])
def test_planted_recovery(eng):
    rng = np.random.default_rng(0)
    X, labels = planted(rng)
    fn = greedy.cluster if eng == "greedy" else engine.cluster
    cents, sizes, members = fn(X, min_similarity=0.90, iterations=30, seed=1)
    assert len(members) == 12
    assert sorted(sizes.tolist()) == [25] * 12
    assert same_partition(partition_of(members, len(X)), labels)
    # centroid of a pure cluster ≈ member mean (tolerance covers the
    # f16-packed sort payloads of PERMUTE=payload_sort_f16: ~5e-4 rounding)
    for c, ids in enumerate(members):
        np.testing.assert_allclose(cents[c], X[np.asarray(ids, int)].mean(0),
                                   atol=2e-3)


def test_tpu_engine_deterministic():
    rng = np.random.default_rng(3)
    X, _ = planted(rng, n_clusters=8, members=10)
    r1 = engine.cluster(X, min_similarity=0.85, iterations=15, seed=7)
    r2 = engine.cluster(X, min_similarity=0.85, iterations=15, seed=7)
    assert np.array_equal(r1[0], r2[0])
    assert all(np.array_equal(a, b) for a, b in zip(r1[2], r2[2]))


def test_engines_agree_on_separated_data():
    rng = np.random.default_rng(5)
    X, labels = planted(rng, n_clusters=6, members=40, S=12, noise=0.005)
    _, s1, m1 = greedy.cluster(X, min_similarity=0.92, iterations=25, seed=2)
    _, s2, m2 = engine.cluster(X, min_similarity=0.92, iterations=25, seed=2)
    assert sorted(s1.tolist()) == sorted(s2.tolist()) == [40] * 6
    assert same_partition(partition_of(m1, len(X)), partition_of(m2, len(X)))


def test_weighted_sizes_as_input():
    # rows pre-weighted (as in the out-of-core merge rounds): merged centroid
    # must be the size-weighted mean (funcAB.cc:62-67)
    X = np.array([[1.0, 0.0], [0.999, 0.01]], np.float32)
    w = np.array([3, 1], np.int32)
    for fn in (greedy.cluster, engine.cluster):
        cents, sizes, members = fn(X, sizes=w, min_similarity=0.9,
                                   iterations=5, seed=0)
        assert len(members) == 1 and sizes[0] == 4
        want = (3 * X[0] + 1 * X[1]) / 4
        # f16-packed payloads round inputs once (~5e-4); the weighted-mean
        # WEIGHTS stay exact — asserted bit-exact under PERMUTE=payload_sort
        # in test_weighted_mean_exact_under_f32_payloads
        np.testing.assert_allclose(cents[0], want, atol=2e-3)


def test_dissimilar_rows_never_merge():
    X = np.eye(8, dtype=np.float32)  # orthogonal rows, cosine 0
    for fn in (greedy.cluster, engine.cluster):
        _, sizes, members = fn(X, min_similarity=0.8, iterations=20, seed=0)
        assert len(members) == 8
        assert sizes.tolist() == [1] * 8


def test_anneal_threshold_progression():
    # two groups at cosine ~0.93: must merge only once threshold anneals
    # below 0.93 — i.e. with min_sim=0.95-ish high nothing merges
    a = np.array([1.0, 0.0], np.float32)
    th = 0.90
    b = np.array([np.cos(np.arccos(th)), np.sin(np.arccos(th))], np.float32)
    X = np.stack([a, a, b, b])
    # min_similarity=0.94 → threshold never reaches 0.90: expect 2 clusters
    _, _, m_hi = engine.cluster(X, min_similarity=0.94, iterations=10, seed=0)
    assert len(m_hi) == 2
    # min_similarity=0.80 → threshold passes 0.90: expect 1 cluster
    _, _, m_lo = engine.cluster(X, min_similarity=0.80, iterations=10, seed=0)
    assert len(m_lo) == 1


def test_single_row_and_empty():
    one = np.ones((1, 4), np.float32)
    for fn in (greedy.cluster, engine.cluster):
        cents, sizes, members = fn(one, min_similarity=0.8, iterations=3, seed=0)
        assert len(members) == 1 and sizes[0] == 1
    cents, sizes, members = engine.cluster(np.zeros((0, 4), np.float32))
    assert len(members) == 0


def test_large_duplicate_bucket_collapses_fast():
    # 2000 identical rows: pairing-merge must collapse them within few
    # iterations (log-depth), the device answer to nestedCluster
    X = np.tile(np.array([[0.3, -1.2, 0.5, 2.0]], np.float32), (2000, 1))
    X += 1e-4 * np.random.default_rng(0).normal(size=X.shape).astype(np.float32)
    _, sizes, members = engine.cluster(X, min_similarity=0.9, iterations=25,
                                       seed=0)
    assert len(members) == 1
    assert sizes[0] == 2000


def _poisson_counts(seed=11, S=8, n_prof=40, reps=30):
    rng = np.random.default_rng(seed)
    prof = rng.gamma(2.0, 20.0, size=(n_prof, S))
    rows = rng.integers(0, n_prof, size=n_prof * reps)
    counts = np.minimum(rng.poisson(prof[rows]), 65535).astype(np.uint16).T
    v = (np.log(np.maximum(counts, 1)).sum(axis=1) / counts.shape[1]).astype(
        np.float32)
    return counts, v


def test_fused_session_matches_chunked_path_exactly_pre_compaction():
    """Up to the first capacity compaction the fused session and the
    transform + engine.cluster composition are bit-identical (same rng
    stream, same merge dynamics, same layout)."""
    import jax.numpy as jnp

    from kmerlsh_tpu.ops import transform

    counts, v = _poisson_counts()
    schedule = (0.95 - 0.01 * np.arange(engine.HEAD_ITERS)).astype(np.float32)

    c_f, s_f, m_f = engine.cluster_counts(counts, v, schedule, seed=3)
    jvalues, keep = transform.abundance_transform(counts, v)
    c_c, s_c, m_c = engine.cluster(
        jvalues, keep.astype(jnp.int32), thresholds=schedule, seed=3,
        init_rounds=16)

    assert s_f.tolist() == s_c.tolist()
    assert all(np.array_equal(a, b) for a, b in zip(m_f, m_c))
    np.testing.assert_allclose(c_f, c_c, atol=1e-5)


def test_fused_session_statistically_matches_chunked_path():
    """Across capacity compactions the paths stay statistically identical
    (same cluster count, same size multiset); exact member routing may
    differ because chain centroids are f32 prefix-sum differences whose low
    bits depend on array layout — both paths are individually seeded-
    deterministic, which is strictly stronger than the reference (its runs
    don't even match themselves, hash/lshash.cc:6-7)."""
    import jax.numpy as jnp

    from kmerlsh_tpu.ops import transform

    counts, v = _poisson_counts()
    iters = 12
    sim_step = (0.95 - 0.8) / iters
    schedule = np.concatenate(
        [[0.95], 0.95 - sim_step * np.arange(iters)]).astype(np.float32)

    c_f, s_f, m_f = engine.cluster_counts(counts, v, schedule, seed=3)
    jvalues, keep = transform.abundance_transform(counts, v)
    c_c, s_c, m_c = engine.cluster(
        jvalues, keep.astype(jnp.int32), thresholds=schedule, seed=3,
        init_rounds=16)

    assert len(m_f) == len(m_c)
    assert sorted(s_f.tolist()) == sorted(s_c.tolist())
    # all rows covered exactly once by each
    assert sorted(np.concatenate(m_f).tolist()) == \
        sorted(np.concatenate(m_c).tolist())


def test_cluster_counts_deterministic():
    counts, v = _poisson_counts(seed=5)
    schedule = (0.95 - 0.012 * np.arange(10)).astype(np.float32)
    r1 = engine.cluster_counts(counts, v, schedule, seed=7)
    r2 = engine.cluster_counts(counts, v, schedule, seed=7)
    assert np.array_equal(r1[0], r2[0])
    assert r1[1].tolist() == r2[1].tolist()
    assert all(np.array_equal(a, b) for a, b in zip(r1[2], r2[2]))


def test_fused_session_filters_low_count_rows():
    """Rows failing the Σcount > 0.1·S filter (ioMatrix.cc:381) never
    appear in any cluster."""
    S = 10
    counts = np.zeros((S, 6), np.uint16)
    counts[:, 0] = 50
    counts[:, 1] = 50
    counts[0, 2] = 1   # total 1 ≤ 0.1*10 → dropped
    counts[:, 3] = 30
    v = np.zeros(S, np.float32)
    schedule = np.full(4, 0.5, np.float32)
    _, sizes, members = engine.cluster_counts(counts, v, schedule, seed=0)
    covered = np.concatenate(members) if members else np.empty(0)
    assert 2 not in covered
    assert 4 not in covered and 5 not in covered
    assert int(sizes.sum()) == 3  # rows 0,1,3 survive


def hierarchy(rng, n_base, levels, S, step=0.025):
    """Anneal-sensitive rows: a binary hierarchy of unit vectors where level
    l children sit at cos ≈ 0.95 − l·step from their parent, so merges
    happen across MANY different anneal iterations and the merge forest
    deepens level by level — the adversarial case for root resolution."""
    base = rng.normal(size=(n_base, S)).astype(np.float64)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    all_vecs = [base]
    all_labels = [np.arange(n_base)]
    cur, cur_lab = base, np.arange(n_base)
    for lev in range(levels):
        cos = 0.95 - (lev + 1) * step
        sin = np.sqrt(1 - cos * cos)
        kids, kid_lab = [], []
        for sgn in (1.0, -1.0):
            orth = rng.normal(size=cur.shape)
            orth -= (orth * cur).sum(1, keepdims=True) * cur
            orth /= np.linalg.norm(orth, axis=1, keepdims=True)
            kids.append(cos * cur + sgn * sin * orth)
            kid_lab.append(cur_lab)
        cur = np.concatenate(kids)
        cur_lab = np.concatenate(kid_lab)
        all_vecs.append(cur)
        all_labels.append(cur_lab)
    vecs = np.concatenate(all_vecs)     # ALL hierarchy nodes, not just leaves
    labels = np.concatenate(all_labels)
    perm = rng.permutation(len(vecs))
    return vecs[perm].astype(np.float32), labels[perm]


def test_adversarial_chain_depth_resolves():
    """Deep merge forests (hierarchy levels merging in different anneal
    windows over 60 iterations) must still resolve to a correct partition —
    pins the pointer-jumping bound in the finalize program."""
    rng = np.random.default_rng(0)
    X, labels = hierarchy(rng, n_base=4, levels=5, S=16)
    _, sizes, members = engine.cluster(
        X, min_similarity=0.70, iterations=60, seed=1)
    assert sum(len(g) for g in members) == len(X)
    assert int(sizes.sum()) == len(X)
    got = partition_of(members, len(X))
    # clusters never mix base groups, and multi-level merging actually
    # happened (node count collapses well below the input count)
    assert len(set(zip(got.tolist(), labels.tolist()))) == len(set(got))
    assert len(members) < len(X) // 3
    assert max(len(g) for g in members) >= 8   # chains span ≥3 levels


def test_finalize_pointer_jump_bound():
    """The finalize program's 2^jumps bound must cover the worst legal
    forest depth (one deepening per iteration): resolve a pure chain of
    depth = iterations with the engine's own jumps formula."""
    import math

    import jax.numpy as jnp

    total = 60                          # iterations in the adversarial run
    jumps = max(6, math.ceil(math.log2(total * 1 + 2)) + 1)
    cap = 128
    parent = np.arange(cap, dtype=np.int32)
    parent[1 : total + 1] = np.arange(total)   # chain: i+1 -> i -> ... -> 0
    vt = np.zeros((4, cap), np.float32)
    sizes = np.zeros(cap, np.int32)
    sizes[0] = total + 1
    slots = np.arange(cap, dtype=np.int32)
    buf = np.asarray(engine._finalize_program(
        jnp.asarray(vt), jnp.asarray(sizes), jnp.asarray(slots),
        jnp.asarray(parent), cap, jumps))
    roots = buf[2 * cap : 3 * cap]
    assert (roots[: total + 1] == 0).all()


LIMIT = 16 << 30   # a synthetic 16 GiB device


def test_hbm_rows_budget():
    from kmerlsh_tpu.utils import hbm

    b = hbm.rows_budget(20, 1)
    assert b & (b - 1) == 0 and b >= 1 << 16
    # more devices, more rows; more samples, fewer rows
    assert hbm.rows_budget(20, 8) >= b
    assert hbm.rows_budget(100, 1) <= b
    # the static model on a 16 GiB device rejects 2^26 x 20 and accepts 2^25
    per = hbm._per_row_bytes(20)
    assert (1 << 26) * per > LIMIT * 0.6
    assert (1 << 25) * per < LIMIT
    assert hbm.rows_budget(20, 1, mem=LIMIT) == 1 << 24


def test_hbm_budget_uses_measurement_at_the_boundary(monkeypatch):
    """When the matrix exceeds the static estimate (the budget actually
    decides single-batch vs out-of-core), the measured bytes/row takes
    over: at 268 B/row on a 16 GiB device the budget admits 2^25 x 20 in
    one batch and refuses 2^26 x 20."""
    from kmerlsh_tpu.utils import hbm

    calls = []

    def fake_measured(num_samples):
        calls.append(num_samples)
        return 268

    monkeypatch.setattr(hbm, "_cached_per_row_bytes", fake_measured)
    # small matrix: static estimate suffices, no measurement triggered
    hbm.rows_budget(20, 1, mem=LIMIT, kmap_size=1 << 20)
    assert calls == []
    # boundary-deciding matrix: measurement kicks in
    b = hbm.rows_budget(20, 1, mem=LIMIT, kmap_size=1 << 26)
    assert calls == [20]
    assert b == 1 << 25  # fits 2^25, refuses 2^26


class _FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_bytes_refuses_an_accelerator_without_a_limit(
        monkeypatch):
    """No silent default: an accelerator that reports no bytes_limit is an
    error, one that does is sized from it."""
    import jax

    from kmerlsh_tpu.utils import hbm

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(None)])
    with pytest.raises(RuntimeError, match="no memory limit"):
        hbm.device_memory_bytes()
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice({"bytes_limit": LIMIT})])
    assert hbm.device_memory_bytes() == LIMIT


def test_device_memory_bytes_on_cpu_is_host_ram():
    import os

    import jax

    from kmerlsh_tpu.utils import hbm

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert hbm.device_memory_bytes() == ram // len(jax.local_devices())


def test_calibration_key_carries_device_kind(monkeypatch):
    import jax

    from kmerlsh_tpu.utils import hbm

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice({})])
    assert hbm.calibration_key(20) == "gpu_NVIDIA H100 80GB HBM3_S20"


def test_half_pull_matches_full_precision():
    """engine.cluster_counts(half_pull=True) packs f16 centroid pairs into
    the finalize buffer (halves the out-of-core pull); memberships/sizes
    must be EXACT (ids never touch the value path) and centroids within
    f16 rounding of the f32 pull."""
    from kmerlsh_tpu.cluster import engine

    rng = np.random.default_rng(5)
    S, n = 12, 3000
    prof = rng.gamma(2.0, 20.0, size=(64, S))
    rows = rng.integers(0, 64, size=n)
    counts = np.ascontiguousarray(
        np.minimum(rng.poisson(prof[rows]), 65535).astype(np.uint16).T)
    v = (np.log(np.maximum(counts, 1)).sum(axis=1) / n).astype(np.float32)
    thr = (0.95 - 0.0075 * np.arange(8)).astype(np.float32)

    c0, s0, g0 = engine.cluster_counts(counts, v, thr, seed=1)
    finish, stats = engine.cluster_counts(counts, v, thr, seed=1,
                                          half_pull=True, defer_pull=True)
    c1, s1, g1 = finish()
    assert np.array_equal(s0, s1)
    assert len(g0) == len(g1)
    assert all(np.array_equal(a, b) for a, b in zip(g0, g1))
    denom = np.maximum(np.abs(c0), 1e-3)
    assert np.max(np.abs(c0 - c1) / denom) < 2e-3
    assert stats["pull_seconds"] > 0 and stats["pull_bytes"] > 0


def test_weighted_mean_exact_under_f32_payloads(monkeypatch):
    """With the bit-exact PERMUTE=payload_sort the merged centroid equals
    the size-weighted mean to f32 rounding (funcAB.cc:62-67), guarding the
    exact-math path the f16-packed payloads trade away."""
    monkeypatch.setattr(engine, "PERMUTE", "payload_sort")
    X = np.array([[1.0, 0.0], [0.999, 0.01]], np.float32)
    w = np.array([3, 1], np.int32)
    cents, sizes, members = engine.cluster(X, sizes=w, min_similarity=0.9,
                                           iterations=5, seed=0)
    assert len(members) == 1 and sizes[0] == 4
    want = (3 * X[0] + 1 * X[1]) / 4
    np.testing.assert_allclose(cents[0], want, atol=1e-6)

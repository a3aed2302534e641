"""Device ops tests: transform, LSH signatures, segmented scans, t-test."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kmerlsh_tpu.ops import lsh, segment, transform, ttest


def test_abundance_transform_matches_reference_formula():
    rng = np.random.default_rng(0)
    S, B = 6, 500
    counts = rng.integers(0, 100, size=(S, B)).astype(np.uint16)
    counts[:, 0] = 0  # all-zero row must be dropped
    v_kmers = rng.uniform(0.1, 2.0, size=S).astype(np.float32)
    values, keep = transform.abundance_transform(jnp.asarray(counts),
                                                 jnp.asarray(v_kmers))
    values, keep = np.asarray(values), np.asarray(keep)
    want = np.log(counts.T.astype(np.float64) + 1.0) - v_kmers[None, :]
    np.testing.assert_allclose(values, want, rtol=1e-5, atol=1e-5)
    want_keep = counts.sum(axis=0, dtype=np.int64) > 0.1 * S
    assert np.array_equal(keep, want_keep)
    assert not keep[0]


def test_lsh_signatures_match_numpy_bigendian_packing():
    rng = np.random.default_rng(1)
    M, S, h = 300, 10, 7
    X = rng.normal(size=(M, S)).astype(np.float32)
    H = np.asarray(lsh.draw_hyperplanes(jax.random.PRNGKey(0), S))
    keys, proj = lsh.signatures(jnp.asarray(X), jnp.asarray(H), jnp.int32(h))
    keys = np.asarray(keys)
    # numpy oracle replicating lshash.cc:44-59: key = key*2 + (dot >= 0)
    P = X @ H
    want = np.zeros(M, dtype=np.int64)
    for i in range(h):
        want = want * 2 + (P[:, i] >= 0)
    assert np.array_equal(keys, want)
    assert keys.max() < 2**h
    np.testing.assert_allclose(np.asarray(proj), P[:, lsh.H_MAX], rtol=1e-5)


def test_segmented_cumsum_and_rank():
    keys = jnp.asarray([0, 0, 0, 2, 2, 5, 7, 7, 7, 7])
    starts = segment.segment_starts(keys)
    assert list(np.asarray(starts)) == [1, 0, 0, 1, 0, 1, 1, 0, 0, 0]
    vals = jnp.ones(10, jnp.int32)
    cs = segment.segmented_cumsum(vals, starts)
    assert list(np.asarray(cs)) == [1, 2, 3, 1, 2, 1, 1, 2, 3, 4]
    alive = jnp.asarray([1, 0, 1, 1, 1, 1, 0, 1, 1, 0], bool)
    rank = segment.alive_rank_in_segment(alive, starts)
    got = list(np.asarray(rank)[np.asarray(alive)])
    assert got == [0, 1, 0, 1, 0, 0, 1]


def scipy_ttest(x, y):
    from scipy import stats

    r = stats.ttest_ind(x, y, equal_var=True)
    left = stats.t.cdf(r.statistic, len(x) + len(y) - 2)
    return r.pvalue, left, 1 - left


def test_studentttest2_matches_scipy():
    rng = np.random.default_rng(2)
    n1, n2 = 5, 7
    vals = rng.normal(size=(50, n1 + n2)).astype(np.float32)
    vals[10, :n1] += 3.0   # strongly right
    vals[11, n1:] += 3.0   # strongly left
    both, left, right = ttest.studentttest2(jnp.asarray(vals), n1, n2)
    both, left, right = map(np.asarray, (both, left, right))
    for i in range(50):
        b, l, r = scipy_ttest(vals[i, :n1].astype(np.float64),
                              vals[i, n1:].astype(np.float64))
        assert both[i] == pytest.approx(b, abs=2e-4)
        assert left[i] == pytest.approx(l, abs=2e-4)
        assert right[i] == pytest.approx(r, abs=2e-4)


def test_studentttest2_degenerate_zero_variance():
    # alglib statistics.cpp:12589-12612: s==0 → indicator p-values
    n1 = n2 = 3
    rows = np.array([
        [1, 1, 1, 1, 1, 1],   # equal means → both=1, left=1, right=1
        [2, 2, 2, 1, 1, 1],   # x > y       → both=0, left=1, right=0
        [1, 1, 1, 2, 2, 2],   # x < y       → both=0, left=0, right=1
    ], dtype=np.float32)
    both, left, right = map(np.asarray, ttest.studentttest2(jnp.asarray(rows), n1, n2))
    assert list(both) == [1, 0, 0]
    assert list(left) == [1, 1, 0]
    assert list(right) == [1, 0, 1]


def test_wrs_verdicts_tail_mapping():
    n1 = n2 = 4
    rows = np.zeros((3, 8), np.float32)
    rows[0, :n1] = 5.0   # A >> B: righttail small → group 1
    rows[1, n1:] = 5.0   # B >> A: lefttail small → group 2
    rows[2] = np.random.default_rng(3).normal(size=8)  # not significant
    sizes = np.array([100, 100, 100])
    v = np.asarray(ttest.wrs_verdicts(rows, sizes, n1, n2, 0.01, size_thresh=10))
    assert list(v) == [1, 2, 0]
    # size_thresh is strict '>' (funcAB.cc:86)
    v2 = np.asarray(ttest.wrs_verdicts(rows, sizes, n1, n2, 0.01, size_thresh=100))
    assert list(v2) == [0, 0, 0]


@pytest.mark.parametrize("S", [20, 100])
def test_signatures_t_match_f64_sign_pack(S):
    """signatures_t keys equal the big-endian sign pack of an f64 NumPy
    projection through the same hyperplanes, except for bits whose
    projection lies within f32 rounding of zero."""
    M, h = 4096, 16
    rng = np.random.default_rng(S)
    x = rng.standard_normal((S, M)).astype(np.float32)
    hyper = np.asarray(lsh.draw_hyperplanes(jax.random.PRNGKey(S), S))
    keys, proj = lsh.signatures_t(jnp.asarray(x), jnp.asarray(hyper),
                                  jnp.int32(h))
    p = hyper.astype(np.float64).T @ x.astype(np.float64)
    near = np.abs(p) <= 1e-5 * (np.abs(hyper.astype(np.float64)).T
                                @ np.abs(x.astype(np.float64)))
    keys = np.asarray(keys).astype(np.int64)
    for i in range(h):
        bit = (keys >> (h - 1 - i)) & 1
        assert np.all((bit == (p[i] >= 0)) | near[i])
    assert near[:h].sum() < M * h // 1000
    np.testing.assert_allclose(np.asarray(proj), p[lsh.H_MAX], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fn", ["signatures", "signatures_t"])
def test_signature_matmul_is_highest_precision(fn):
    """The lowered product names HIGHEST precision, so no backend may run
    it in TF32 or bf16 passes."""
    S, M = 20, 256
    x = jnp.zeros((M, S) if fn == "signatures" else (S, M), jnp.float32)
    hyper = lsh.draw_hyperplanes(jax.random.PRNGKey(0), S)
    text = jax.jit(getattr(lsh, fn)).lower(x, hyper, jnp.int32(4)).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots and all("HIGHEST" in ln for ln in dots), dots

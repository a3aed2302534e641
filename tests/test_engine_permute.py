"""The PERMUTE strategies of the engine's state permutation must agree:
bit-exact for the f32 strategies, within f16 rounding for the packed one."""

import jax.numpy as jnp
import numpy as np
import pytest

from kmerlsh_tpu.cluster import engine


def _state(m=4096, s=20, seed=0):
    rng = np.random.default_rng(seed)
    # few distinct keys: long runs of ties exercise sort stability
    key = rng.integers(0, 64, size=m).astype(np.int32)
    key[rng.random(m) < 0.1] = engine.BIG_KEY
    sizes = rng.integers(0, 4, size=m).astype(np.int32)
    slots = rng.permutation(m).astype(np.int32)
    mi = np.where(rng.random(m) < 0.3, rng.integers(0, m, size=m),
                  -1).astype(np.int32)
    vt = rng.standard_normal((s, m)).astype(np.float32)
    return tuple(jnp.asarray(a) for a in (key, sizes, slots, mi, vt))


def _check(got, want, permute):
    *got_lanes, got_vt = map(np.asarray, got)
    *want_lanes, want_vt = map(np.asarray, want)
    for g, w in zip(got_lanes, want_lanes):
        assert np.array_equal(g, w)
    if permute == "payload_sort_f16":
        # one f16 rounding: |err| ≤ 2^-11·|x|
        assert np.all(np.abs(got_vt - want_vt)
                      <= 2.0 ** -11 * np.abs(want_vt) + 1e-7)
    else:
        assert np.array_equal(got_vt, want_vt)


@pytest.mark.parametrize("permute",
                         ["gather_lane", "gather_rows", "payload_sort_f16"])
def test_sort_state_matches_payload_sort(permute):
    key, sizes, slots, mi, vt = _state()
    want = engine._sort_state(key, sizes, slots, mi, vt, "payload_sort")
    got = engine._sort_state(key, sizes, slots, mi, vt, permute)
    _check(got[:4] + (got[4],), want, permute)


@pytest.mark.parametrize("permute",
                         ["gather_lane", "gather_rows", "payload_sort_f16"])
def test_compact_sort_matches_payload_sort(permute):
    _, sizes, slots, _, vt = _state(seed=1)
    want = engine.compact_sort(vt, sizes, slots, "payload_sort")
    got = engine.compact_sort(vt, sizes, slots, permute)
    # compare lanes (sizes, slots) first, values last
    _check((got[1], got[2], got[0]), (want[1], want[2], want[0]), permute)
    # alive-first and stable: alive slots keep their input order
    alive = np.asarray(sizes) > 0
    assert np.array_equal(np.asarray(got[2])[:alive.sum()],
                          np.asarray(slots)[alive])

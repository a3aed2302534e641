"""Hash-layer parity (golden values from the compiled reference), p-stable
LSH, matrix text IO, memory probes."""

import numpy as np
import jax.numpy as jnp
import pytest

from kmerlsh_tpu.io import clusterio
from kmerlsh_tpu.kmer import hashing
from kmerlsh_tpu.ops import lsh
from kmerlsh_tpu.utils import timing

# golden values produced by /root/reference/hash/hash.cc MurmurHash3_x64_64
# (seed 0) over the first `len` little-endian bytes of each word
GOLDEN = [
    (1, 0x0123456789ABCDEF, 0x0461F9B79EB5057E),
    (1, 0x0000000000000000, 0xAD0047D6CD405C0D),
    (1, 0xFFFFFFFFFFFFFFFF, 0x0BA7A1BF030A2E4B),
    (2, 0x0123456789ABCDEF, 0xAFC3018BA1573E95),
    (2, 0x0000000000000000, 0x2F33544D5B60E02B),
    (8, 0x0123456789ABCDEF, 0xDE5D38DAE9DCAA90),
    (8, 0x0000000000000000, 0xAA3ADFE9AECD325F),
    (8, 0xFFFFFFFFFFFFFFFF, 0xDE44E6237A502815),
    (8, 0x00000000DEADBEEF, 0xE0C384291CB39569),
]


def test_murmur3_matches_reference_golden():
    for length, val, want in GOLDEN:
        got = hashing.murmur3_x64_64_u64(
            np.array([val], np.uint64), length)[0]
        assert int(got) == want, (length, hex(val))


def test_kmer_hash_uses_k_bytes():
    # k=23 → 6 bytes hashed; differing byte 7 must not change the hash
    a = np.uint64(0x00AA0000DEADBEEF)
    b = np.uint64(0x00BB0000DEADBEEF)
    assert hashing.kmer_hash(a, 23) == hashing.kmer_hash(b, 23)
    assert hashing.kmer_hash(a, 31) != hashing.kmer_hash(b, 31)


def test_splitmix64_nonzero_and_vectorized():
    x = np.arange(100, dtype=np.uint64)
    h = hashing.splitmix64(x)
    assert len(np.unique(h)) == 100


def test_p_stable_signatures():
    import jax

    X = np.array([[1.0, 0.0], [0.0, 2.0]], np.float32)
    H = np.asarray(lsh.draw_hyperplanes(jax.random.PRNGKey(0), 2))
    q = np.asarray(lsh.p_stable_signatures(jnp.asarray(X), jnp.asarray(H),
                                           jnp.int32(3), b=0.5, r=2.0))
    P = X @ H[:, :3]
    want = np.floor((P + 0.5) / 2.0).astype(np.int32)
    assert np.array_equal(q[:, :3], want)
    assert not q[:, 3:].any()


def test_matrix_text_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(5, 3)).astype(np.float32)
    ids = [np.arange(i + 1, dtype=np.uint64) for i in range(5)]
    p = str(tmp_path / "m.txt")
    clusterio.save_matrix(vals, ids, p, ignore_small=1)
    back, back_ids = clusterio.read_matrix(p)
    keep = [i for i in range(5) if len(ids[i]) > 1]
    np.testing.assert_allclose(back, vals[keep], rtol=1e-6)
    assert len(back_ids) == len(keep)


def test_memory_probes():
    kb = timing.host_memory_kb()
    assert kb > 1000  # a Python process is at least a few MB
    assert isinstance(timing.device_memory_stats(), dict)


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_location(monkeypatch, env_set):
    """With JAX_COMPILATION_CACHE_DIR set nothing is configured here (JAX
    reads it itself); unset, the cache is one fixed directory inside the
    checkout."""
    import os

    from kmerlsh_tpu.utils import jaxcache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        assert jaxcache.cache_dir() is None
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert jaxcache.cache_dir() == os.path.join(repo, ".cache", "jax")

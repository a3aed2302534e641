"""Tests that only mean something on an NVIDIA GPU (marker ``gpu``; they
skip unless pytest runs with ``--on-gpu`` on a machine with the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmerlsh_tpu.ops import lsh
from kmerlsh_tpu.utils import hbm

pytestmark = pytest.mark.gpu


def test_pair_sort_lowers_to_radix_sort():
    """The (key, iota) sort of PERMUTE=gather_lane compiles to a library
    radix-sort custom call, not to XLA's comparison sort."""
    m = 1 << 20
    key = jnp.zeros((m,), jnp.int32)
    iota = jnp.arange(m, dtype=jnp.int32)
    text = jax.jit(lambda k, i: jax.lax.sort(
        (k, i), num_keys=1, is_stable=True)).lower(key, iota).compile(
    ).as_text()
    assert any("custom-call" in ln and "radixsort" in ln.lower()
               for ln in text.splitlines()), text[:4000]


def test_memory_stats_present():
    """The card reports its memory limit and peak, which batch sizing and
    the benchmark's peak-memory figure read."""
    stats = jax.devices()[0].memory_stats()
    assert stats["bytes_limit"] > 0
    assert "peak_bytes_in_use" in stats
    assert hbm.device_memory_bytes() == stats["bytes_limit"]


def test_signatures_t_full_precision_on_gpu():
    """At HIGHEST precision the GPU projection matches an f64 one to f32
    rounding (TF32 would be off by ~1e-3 relative)."""
    s, m = 20, 1 << 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((s, m)).astype(np.float32)
    hyper = lsh.draw_hyperplanes(jax.random.PRNGKey(0), s)
    _, proj = jax.jit(lsh.signatures_t)(jnp.asarray(x), hyper, jnp.int32(8))
    h64 = np.asarray(hyper, np.float64)
    want = h64[:, lsh.H_MAX] @ x.astype(np.float64)
    scale = np.abs(h64[:, lsh.H_MAX]) @ np.abs(x.astype(np.float64))
    assert (np.abs(np.asarray(proj) - want) <= 1e-5 * scale).all()

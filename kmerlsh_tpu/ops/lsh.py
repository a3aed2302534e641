"""Random-hyperplane LSH signatures as one matmul.

Replaces the reference's per-row scalar loop (``LSH::random_projection``,
hash/lshash.cc:44-59 — hot loop #1, O(n·h·d) scalar FLOPs) with one batched
matmul ``X @ H`` followed by sign-bit packing. Key packing matches the
reference: hyperplane 0 is the most significant bit (``key = key*2 + bit``,
lshash.cc:55-57), and a projection of exactly 0 hashes to bit 1
(``sum >= 0 ? 1 : 0``, lshash.cc:51).

Hyperplanes are drawn N(0,1) from a seeded ``jax.random`` key — the
deterministic replacement for the reference's unseeded ``std::random_device``
(lshash.cc:6-7).

``h`` (the number of active hyperplanes, = ⌊log2 n⌋) changes every
iteration, so kernels take a *static maximum* ``H_MAX`` columns and mask by
the dynamic scalar ``h`` — shapes stay static for XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

H_MAX = 30  # keys fit int32; reference packs into `int` the same way


def draw_hyperplanes(rng: jax.Array, num_samples: int) -> jax.Array:
    """[num_samples, H_MAX + 1] N(0,1); the extra last column is the
    secondary-ordering projection used by the pairing merge."""
    return jax.random.normal(rng, (num_samples, H_MAX + 1), dtype=jnp.float32)


def p_stable_signatures(
    values: jax.Array, hyperplanes: jax.Array, h: jax.Array,
    b: float = 0.0, r: float = 1.0,
):
    """p-stable LSH buckets ⌊(x·a + b)/r⌋ per hyperplane (int32 [M, H_MAX]).

    Completeness port of ``LSH::p_stable`` (hash/lshash.cc:62-75) — present
    but never called in the reference; provided for Euclidean-bucket use
    cases. Columns ≥ h are zeroed.
    """
    p = jnp.dot(values, hyperplanes[:, :H_MAX],
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
    q = jnp.floor((p + b) / r).astype(jnp.int32)
    i = jnp.arange(H_MAX, dtype=jnp.int32)
    return jnp.where(i[None, :] < h, q, 0)


def signatures(values: jax.Array, hyperplanes: jax.Array, h: jax.Array):
    """values f32 [M, S]; hyperplanes [S, H_MAX+1]; h dynamic scalar ≤ H_MAX.

    Returns (keys int32 [M] using the first h sign bits big-endian,
    proj f32 [M] the secondary projection).

    Row-major convenience twin kept for unit tests and external callers;
    the engine's hot path uses :func:`signatures_t` (sample-major layout).
    """
    p = jnp.dot(values, hyperplanes, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
    bits = (p[:, :H_MAX] >= 0).astype(jnp.int32)
    i = jnp.arange(H_MAX, dtype=jnp.int32)
    weights = jnp.where(i < h, jnp.left_shift(1, jnp.maximum(h - 1 - i, 0)), 0)
    keys = jnp.sum(bits * weights[None, :], axis=1, dtype=jnp.int32)
    return keys, p[:, H_MAX]


def signatures_t(values_t: jax.Array, hyperplanes: jax.Array, h: jax.Array):
    """Transposed-layout twin of :func:`signatures`: values_t f32 [S, M].

    The engine keeps cluster profiles sample-major ([S, M]) so the k-mer
    axis is the contiguous minor dimension of every wide op. Same key
    packing as :func:`signatures`.

    The product runs at HIGHEST precision (full f32, never TF32 or bf16
    passes): a key bit is the sign of a projection, so a reduced-precision
    product flips bits of near-zero projections against the host oracle,
    and the [31, S] × [S, M] product is tiny next to the sort that
    follows it.
    """
    p = jnp.dot(hyperplanes.T, values_t, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
    bits = (p[:H_MAX] >= 0).astype(jnp.int32)
    i = jnp.arange(H_MAX, dtype=jnp.int32)
    weights = jnp.where(i < h, jnp.left_shift(1, jnp.maximum(h - 1 - i, 0)), 0)
    keys = jnp.sum(bits * weights[:, None], axis=0, dtype=jnp.int32)
    return keys, p[H_MAX]

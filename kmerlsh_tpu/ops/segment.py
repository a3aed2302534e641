"""Segmented-scan primitives for bucket-local operations.

Buckets (LSH key segments) are contiguous runs after sorting; all per-bucket
logic (ranks, pair assignment) is expressed as segmented cumulative sums so
it vectorizes across every bucket at once — the data-parallel replacement for
the reference's OpenMP loop over buckets (function/cluster.cc:281-293).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_starts(sorted_keys: jax.Array) -> jax.Array:
    """Bool mask of segment starts in a sorted key array."""
    prev = jnp.concatenate([sorted_keys[:1] - 1, sorted_keys[:-1]])
    return sorted_keys != prev


def segmented_cumsum(values: jax.Array, starts: jax.Array) -> jax.Array:
    """Inclusive cumulative sum that resets at each segment start."""

    def op(a, b):
        a_flag, a_sum = a
        b_flag, b_sum = b
        return a_flag | b_flag, jnp.where(b_flag, b_sum, a_sum + b_sum)

    _, out = jax.lax.associative_scan(op, (starts, values))
    return out


def alive_rank_in_segment(alive: jax.Array, starts: jax.Array) -> jax.Array:
    """0-based rank of each alive element among alive elements of its
    segment (undefined for dead elements)."""
    a = alive.astype(jnp.int32)
    return segmented_cumsum(a, starts) - a

"""Device LSH clustering engine.

The reference's hot loop (function/cluster.cc:181-340) is re-designed for
XLA rather than translated:

  * **layout** — cluster profiles live **sample-major** (``values_t``
    f32 [S, M]): the k-mer/cluster axis is the minor (contiguous) dimension,
    so every elementwise op, shift and scan over the matrix reads whole
    contiguous rows of M elements instead of strided S≈20-wide records;
  * **signatures** — one [31, S] × [S, M] matmul replaces the
    per-row scalar projection loop (hot loop #1, hash/lshash.cc:44-59);
  * **bucketing** — ONE fused int32 sort key (bucket key, quantized
    secondary projection) + ``argsort`` replaces the scatter into 2^h
    vectors (cluster.cc:15-30); buckets become contiguous segments;
  * **within-bucket merging** — the inherently sequential greedy
    ``p_cluster`` (cluster.cc:56-87) is replaced by a *single-pass chain
    collapse*: consecutive sorted elements whose neighbor cosine ≥ threshold
    chain together and each chain collapses to one cluster whose centroid is
    the exact size-weighted mean (funcAB.cc:49-71 semantics), computed as
    prefix-sum differences. A *pairing-merge* fallback (R adjacent rank-pair
    rounds) is kept for comparison and the sharded path;
  * **oversized buckets** — need no special case (the reference re-partitions
    buckets > 1e6 once, cluster.cc:286-288): chain/pairing cost is
    independent of bucket size;
  * **dynamic cluster count** — static-shape state with validity masks; the
    active hyperplane count h = ⌊log2 n_alive⌋ is computed *in-graph* so
    whole chunks of iterations run as one ``lax.scan`` without host
    round-trips; the host compacts on device and halves capacity when
    occupancy drops.

Host↔device traffic per chunk is two scalars (alive count and position
bound); the merge forest, centroids and sizes never leave the device until
the final packed result.

Cluster membership is tracked on host via a parent forest over input rows —
id lists never exist on device.

Determinism: hyperplanes come from ``jax.random`` keys derived from a seed
(the reference draws from an unseeded ``std::random_device``).
"""

from __future__ import annotations

import math
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from kmerlsh_tpu.ops import lsh, segment

BIG_KEY = 2**31 - 1  # sentinel: dead slots sort to the end

# wall-clock split of the most recent cluster_counts/cluster session:
#   device_seconds — device program execution (dispatch → block_until_ready)
#   pull_seconds   — device→host transfers (per-chunk alive-count scalars +
#                    the one packed finalize buffer)
# Reset at session start; read by pipeline/bench for the headline split.
LAST_SESSION: dict = {}

DEFAULT_CHUNK = 8   # iterations fused per program at large capacities
SMALL_CAP = 1 << 16
SMALL_CHUNK = 32    # at small capacities, fuse more: dispatch latency
                    # dominates over the (tiny) per-iteration compute

# How the per-iteration permutation is applied to the [S, M] value matrix
# (the single hottest choice in the engine; tools/iter_profile.py times
# each variant, PERF.md records the numbers and the sort lowering XLA
# picks for each — on the H100 "gather_lane" is the fastest by far, since
# only a single-key pair sort gets XLA:GPU's library radix sort):
#   "payload_sort_f16" — the value rows ride ONE variadic sort as ⌈S/2⌉
#     i32 rows of packed f16 pairs: values are rounded to f16 AT SORT
#     TIME, merge means stay f32. Unmerged centroids re-round to the
#     identical f16 each iteration (idempotent), so the error stays a
#     ~5e-4 relative rounding per merge level — invisible to the 0.8-0.95
#     cosine thresholds of the anneal;
#   "payload_sort"     — the same with full f32 payloads (bit-exact);
#   "gather_lane" (DEFAULT) — sort only (key, iota), a pair sort XLA:GPU
#     lowers to a library radix sort, then gather the lane arrays and the
#     [S, M] matrix by the order (bit-exact);
#   "gather_rows"      — sort (key, i32 payloads, iota), then gather the
#     matrix through its [M, S] transpose.
# Overridable via KMERLSH_PERMUTE.
import os as _os  # noqa: E402

PERMUTE = _os.environ.get("KMERLSH_PERMUTE", "gather_lane")


def _pack_f16(values_t):
    """[S, M] f32 → [⌈S/2⌉, M] i32 of packed f16 pairs (row 2i in the low
    half-word, row 2i+1 in the high half-word). Slices before widening so
    no full-[S, M] u32 temp materializes."""
    s, m = values_t.shape
    u = jax.lax.bitcast_convert_type(
        values_t.astype(jnp.float16), jnp.uint16)
    if s % 2:
        u = jnp.concatenate([u, jnp.zeros((1, m), jnp.uint16)])
    packed = u[0::2].astype(jnp.uint32) | (u[1::2].astype(jnp.uint32) << 16)
    return jax.lax.bitcast_convert_type(packed, jnp.int32)


def _unpack_f16(packed, s: int):
    """Inverse of :func:`_pack_f16`, upcast to f32 [S, M]."""
    u = jax.lax.bitcast_convert_type(packed, jnp.uint32)
    lo = (u & jnp.uint32(0xFFFF)).astype(jnp.uint16)
    hi = (u >> 16).astype(jnp.uint16)
    inter = jnp.stack([lo, hi], axis=1).reshape(-1, packed.shape[1])
    return jax.lax.bitcast_convert_type(
        inter[:s], jnp.float16).astype(jnp.float32)


def _sort_state(key, sizes, cur_slot, merged_into, values_t,
                permute: str = "payload_sort"):
    """Stable-sort the iteration state by ``key`` using the strategy
    ``permute`` (see :data:`PERMUTE`). Returns
    (skey, ssizes, scs, smi, svt[S, M])."""
    s, m = values_t.shape
    if permute == "payload_sort":
        ops = jax.lax.sort(
            (key, sizes, cur_slot, merged_into)
            + tuple(values_t[i] for i in range(s)),
            num_keys=1, is_stable=True)
        return ops[0], ops[1], ops[2], ops[3], jnp.stack(ops[4:])
    if permute == "payload_sort_f16":
        packed = _pack_f16(values_t)
        ops = jax.lax.sort(
            (key, sizes, cur_slot, merged_into)
            + tuple(packed[i] for i in range(packed.shape[0])),
            num_keys=1, is_stable=True)
        svt = _unpack_f16(jnp.stack(ops[4:]), s)
        return ops[0], ops[1], ops[2], ops[3], svt
    iota = jnp.arange(m, dtype=jnp.int32)
    if permute == "gather_lane":
        skey, order = jax.lax.sort((key, iota), num_keys=1, is_stable=True)
        return (skey, sizes[order], cur_slot[order], merged_into[order],
                values_t[:, order])
    skey, ssize, scs, smi, order = jax.lax.sort(
        (key, sizes, cur_slot, merged_into, iota),
        num_keys=1, is_stable=True)
    return skey, ssize, scs, smi, values_t.T[order, :].T


def _combined_sort_key(keys, proj, sizes, h):
    """Fuse (bucket key, quantized secondary projection) into ONE int32 sort
    key — a single-key sort moves fewer bytes than a two-key sort, and only
    a single-key sort can take XLA's radix-sort path. The quantization
    range is computed over ALIVE projections only, so the ordering is
    invariant to how many dead/padded slots ride along — host
    compaction can never change merge decisions."""
    big = jnp.int32(BIG_KEY)
    alive = sizes > 0
    free = jnp.clip(30 - h, 0, 29)
    levels = jnp.left_shift(jnp.int32(1), free)
    pmin = jnp.min(jnp.where(alive, proj, jnp.inf))
    pmax = jnp.max(jnp.where(alive, proj, -jnp.inf))
    span = jnp.maximum(pmax - pmin, 1e-20)
    q = jnp.clip(
        ((proj - pmin) / span * levels.astype(jnp.float32)).astype(jnp.int32),
        0, levels - 1)
    return jnp.where(keys == big, jnp.int32(2**31 - 1),
                     jnp.left_shift(keys, free) | q)


def pairing_merge(
    values_t: jax.Array,   # f32 [S, M]
    sizes: jax.Array,      # i32 [M]  (0 = dead slot)
    keys: jax.Array,       # i32 [M] bucket keys (BIG_KEY for dead slots)
    proj: jax.Array,       # f32 [M] secondary ordering projection
    threshold: jax.Array,  # f32 scalar: cosine-similarity threshold
    rounds: int,
    merged_into: jax.Array | None = None,  # i32 [M] accumulator (-1 = alive)
    h: jax.Array | None = None,  # i32 scalar: bits used by ``keys``
    cur_slot: jax.Array | None = None,  # i32 [M] position → stable slot id
    unsort: bool = True,
):
    """R vectorized pairing-merge rounds over key segments (traceable core,
    shared by the single-chip and shard_map paths).

    With ``unsort=True`` (default) arrays come back in input slot order and
    ``merged_into[slot]`` names the slot that absorbed ``slot`` (-1 while
    alive). With ``unsort=False`` arrays stay in sorted position order and
    a 4th output ``cur_slot`` (position → stable slot id) is returned
    instead of paying an inverse-permutation sort — the chunked scan
    threads it through and the host unpermutes once per chunk.

    Cost profile (deliberate): ONE argsort per call; per round only
    cumsum/cummax/cummin scans, gathers, and elementwise math. No scatters,
    no per-round sorts, no associative_scan pairs.
    """
    m = values_t.shape[1]
    big = jnp.int32(BIG_KEY)
    if merged_into is None:
        merged_into = jnp.full((m,), -1, jnp.int32)
    if cur_slot is None:
        cur_slot = jnp.arange(m, dtype=jnp.int32)

    if h is None:
        order = jnp.lexsort((proj, keys))
    else:
        combined = _combined_sort_key(keys, proj, sizes, h)
        order = jnp.argsort(combined, stable=True).astype(jnp.int32)
    skey = keys[order]
    svt = values_t[:, order]
    ssize = sizes[order]
    scs = cur_slot[order]
    smi = merged_into[order]

    starts = segment.segment_starts(skey)
    valid_seg = skey != big
    seg_id = jnp.cumsum(starts.astype(jnp.int32))
    pos = jnp.arange(m, dtype=jnp.int32)
    # position of each element's segment start (cummax; starts[0] is True)
    seg_pos = jax.lax.cummax(jnp.where(starts, pos, jnp.int32(0)))

    for r in range(rounds):
        alive = (ssize > 0) & valid_seg
        a = alive.astype(jnp.int32)
        alive_before = jnp.cumsum(a) - a  # alive strictly before position
        # rank among alive within segment (valid where alive)
        rank = alive_before - alive_before[seg_pos]

        # nearest alive neighbors by position: within a segment, position
        # order among alive IS rank order, so these are the rank±1 partners
        nxt = jax.lax.cummin(jnp.where(alive, pos, jnp.int32(m)),
                             reverse=True)
        next_after = jnp.concatenate(
            [nxt[1:], jnp.full((1,), m, jnp.int32)])
        prv = jax.lax.cummax(jnp.where(alive, pos, jnp.int32(-1)))
        prev_before = jnp.concatenate(
            [jnp.full((1,), -1, jnp.int32), prv[:-1]])

        ph = r % 2
        role_left = alive & (rank >= ph) & ((rank - ph) % 2 == 0)
        role_right = alive & (rank >= ph + 1) & ((rank - ph) % 2 == 1)

        partner = jnp.where(role_left, next_after, prev_before)
        pc = jnp.clip(partner, 0, m - 1)
        partner_ok = (
            (role_left | role_right)
            & (partner >= 0) & (partner < m)
            & (seg_id[pc] == seg_id)
        )
        partner = jnp.where(partner_ok, pc, pos)

        # each element gathers its own partner; sims are computed on both
        # sides with identical reduction order, so left/right agree bitwise
        pv = svt[:, partner]
        ps = ssize[partner]
        dot = jnp.sum(svt * pv, axis=0)
        nn = jnp.sqrt(jnp.sum(svt * svt, axis=0) * jnp.sum(pv * pv, axis=0))
        sim = dot / jnp.where(nn > 0, nn, 1.0)
        merge = partner_ok & (sim >= threshold)

        win = merge & role_left    # absorbs its partner
        lose = merge & role_right  # dies into its partner

        tot = (ssize + ps).astype(jnp.float32)
        svt = jnp.where(
            win[None, :],
            (svt * ssize[None, :].astype(jnp.float32)
             + pv * ps[None, :].astype(jnp.float32))
            / jnp.where(win, tot, 1.0)[None, :],
            svt,
        )
        ssize = jnp.where(win, ssize + ps, ssize)
        ssize = jnp.where(lose, 0, ssize)
        smi = jnp.where(lose, scs[partner], smi)

    if not unsort:
        return svt, ssize, smi, scs
    inv = jnp.argsort(order).astype(jnp.int32)
    return svt[:, inv], ssize[inv], smi[inv]


def _shift(x, d: int, fill=0):
    """out[i] = x[i-d] for a static d ≥ 1 (contiguous pad+slice — no
    gathers; the primitive of the log-step scans)."""
    return jnp.pad(x[:-d], (d, 0), constant_values=fill)


def _shift2(x, d: int):
    """Minor-axis twin of :func:`_shift` for [S, M] stacks."""
    return jnp.pad(x[:, :-d], ((0, 0), (d, 0)))


# chains longer than 2**MAX_CHAIN_LOG are cut at fixed position strides:
# each piece collapses exactly (exact sizes/means) and the pieces merge on
# the next iteration. This bounds the scan to MAX_CHAIN_LOG levels for ANY
# capacity — both the op count the compiler must chew (the unrolled level
# graph grows with log2 of the capacity otherwise) and the runtime passes.
MAX_CHAIN_LOG = 15


def _seg_scan(head, w, wv, scs, m: int):
    """Hillis-Steele segmented scan over positions: inclusive within-chain
    sums of ``w`` (i32 [M]) and the stacked weighted values ``wv``
    (f32 [S, M]), plus a forward fill of the chain head's ``scs``.
    Boundaries = ``head``; chains are pre-cut to ≤ 2**MAX_CHAIN_LOG.
    Contiguous static shifts only — no gathers. Returns (W, WV, head_fill).
    """
    f = head
    W = w
    fill = scs
    d = 1
    for _ in range(min(MAX_CHAIN_LOG, max(m - 1, 1).bit_length())):
        keep = ~f
        W = W + jnp.where(keep, _shift(W, d), 0)
        wv = wv + jnp.where(keep[None, :], _shift2(wv, d), 0.0)
        fill = jnp.where(f, fill, _shift(fill, d))
        f = f | _shift(f, d, fill=True)
        d *= 2
    return W, wv, fill


def _rev_fill(last, scs, m: int):
    """Backward fill: every position gets the ``scs`` of its chain's LAST
    element (boundaries = ``last``), via the same log-shift scan on
    reversed arrays."""
    f = last[::-1]
    fill = scs[::-1]
    d = 1
    for _ in range(min(MAX_CHAIN_LOG, max(m - 1, 1).bit_length())):
        fill = jnp.where(f, fill, _shift(fill, d))
        f = f | _shift(f, d, fill=True)
        d *= 2
    return fill[::-1]


def chain_collapse(
    values_t: jax.Array,   # f32 [S, M]
    sizes: jax.Array,      # i32 [M]  (0 = dead slot)
    keys: jax.Array,       # i32 [M] bucket keys (BIG_KEY for dead slots)
    proj: jax.Array,       # f32 [M] secondary ordering projection
    threshold: jax.Array,
    merged_into: jax.Array | None = None,
    cur_slot: jax.Array | None = None,
    h: jax.Array | None = None,
    permute: str = "payload_sort",
):
    """Single-pass full bucket collapse: consecutive sorted elements whose
    neighbor cosine ≥ threshold chain together; each chain collapses to a
    single cluster with the exact size-weighted mean. This is the data-
    parallel analog of the reference's one greedy sweep over a bucket
    (p_cluster, cluster.cc:56-87): O(1) passes instead of O(b) rounds.

    ALL permutation of the state happens in :func:`_sort_state` (one
    strategy per :data:`PERMUTE`); the within-chain reductions
    (size-weighted sums, head-slot fill) run as log-step segmented scans of
    contiguous static shifts, with no gathers of the value matrix.

    The surviving centroid is written at the chain's LAST position: the
    inclusive segmented sums are complete there. The head's stable slot id
    is what survives — the last position's ``cur_slot`` is swapped with the
    head's, so the merge forest still records "everyone merged into the
    chain head" exactly as the reference's greedy sweep does.

    Same output contract as ``pairing_merge(unsort=False)``.
    """
    s, m = values_t.shape
    big = jnp.int32(BIG_KEY)
    if merged_into is None:
        merged_into = jnp.full((m,), -1, jnp.int32)
    if cur_slot is None:
        cur_slot = jnp.arange(m, dtype=jnp.int32)

    combined = _combined_sort_key(keys, proj, sizes, h)
    scomb, ssize, scs, smi, svt = _sort_state(
        combined, sizes, cur_slot, merged_into, values_t, permute)

    # recover the bucket id from the combined key (dead slots map above any
    # real bucket — see _combined_sort_key)
    free = jnp.clip(30 - h, 0, 29)
    bucket = jnp.right_shift(scomb, free)
    starts = segment.segment_starts(bucket)
    alive = (ssize > 0) & (scomb != big)

    # neighbor similarity with the previous position (all alive elements of
    # a segment are contiguous: dead slots all carry BIG keys)
    prev_vt = _shift2(svt, 1)
    dot = jnp.sum(svt * prev_vt, axis=0)
    nn = jnp.sqrt(jnp.sum(svt * svt, axis=0)
                  * jnp.sum(prev_vt * prev_vt, axis=0))
    sim = dot / jnp.where(nn > 0, nn, 1.0)
    prev_alive = _shift(alive, 1, fill=False)
    pos = jnp.arange(m, dtype=jnp.int32)
    # stride cut: bound chain length so the segmented scan needs only
    # MAX_CHAIN_LOG levels; cut pieces re-merge next iteration
    uncut = (pos & ((1 << MAX_CHAIN_LOG) - 1)) != 0
    link = alive & prev_alive & (~starts) & uncut & (sim >= threshold)
    head = alive & ~link
    next_link = jnp.concatenate([link[1:], jnp.zeros(1, bool)])
    is_last = alive & ~next_link            # last member of each chain

    # within-chain inclusive sums + head-slot forward fill, one fused scan
    w = ssize
    W, WV, head_scs = _seg_scan(
        head, w, svt * w[None, :].astype(jnp.float32), scs, m)
    denom = jnp.maximum(W, 1).astype(jnp.float32)
    new_vt = jnp.where(is_last[None, :], WV / denom[None, :], svt)
    new_size = jnp.where(is_last, W, jnp.where(alive, 0, ssize))

    # slot bookkeeping: the chain-head SLOT survives (stored at the last
    # position); the last position's original slot moves to the head
    # position and dies there with everyone else
    last_scs = _rev_fill(is_last, scs, m)
    new_scs = jnp.where(is_last, head_scs,
                        jnp.where(head, last_scs, scs))
    new_mi = jnp.where(alive & ~is_last, head_scs, smi)
    return new_vt, new_size, new_mi, new_scs


def _active_h(sizes):
    n_alive = jnp.maximum(jnp.sum((sizes > 0).astype(jnp.int32)), 2)
    return jnp.clip(
        jnp.floor(jnp.log2(n_alive.astype(jnp.float32))).astype(jnp.int32),
        1, lsh.H_MAX,
    )


def _one_iteration(values_t, sizes, rng, threshold, rounds, merged_into,
                   cur_slot, merge: str = "pairing",
                   permute: str = "payload_sort"):
    """One LSH iteration with h = ⌊log2 n_alive⌋ computed in-graph; state
    stays in sorted position order (cur_slot tracks stable slot ids).

    ``merge`` picks the within-bucket primitive: ``"pairing"`` (R adjacent
    rank-pair rounds) or ``"chain"`` (single-pass neighbor-chain collapse —
    ~4-5× cheaper per iteration and merges whole duplicate runs at once;
    both implement the reference's greedy bucket sweep semantics,
    cluster.cc:56-87)."""
    h = _active_h(sizes)
    hyper = lsh.draw_hyperplanes(rng, values_t.shape[0])
    keys, proj = lsh.signatures_t(values_t, hyper, h)
    keys = jnp.where(sizes > 0, keys, jnp.int32(BIG_KEY))
    if merge == "chain":
        return chain_collapse(values_t, sizes, keys, proj, threshold,
                              merged_into, cur_slot, h=h, permute=permute)
    return pairing_merge(values_t, sizes, keys, proj, threshold, rounds,
                         merged_into, h=h, cur_slot=cur_slot, unsort=False)


def compact_sort(values_t, sizes, slots, permute: str = "payload_sort"):
    """Alive-first stable compaction, using the ``permute`` strategy for
    the [S, M] value movement (see :data:`PERMUTE`)."""
    s, m = values_t.shape
    dead = (sizes == 0).astype(jnp.int32)
    if permute == "payload_sort":
        ops = jax.lax.sort(
            (dead, sizes, slots) + tuple(values_t[i] for i in range(s)),
            num_keys=1, is_stable=True)
        return jnp.stack(ops[3:]), ops[1], ops[2]
    if permute == "payload_sort_f16":
        packed = _pack_f16(values_t)
        ops = jax.lax.sort(
            (dead, sizes, slots)
            + tuple(packed[i] for i in range(packed.shape[0])),
            num_keys=1, is_stable=True)
        return _unpack_f16(jnp.stack(ops[3:]), s), ops[1], ops[2]
    iota = jnp.arange(m, dtype=jnp.int32)
    if permute == "gather_lane":
        _, order = jax.lax.sort((dead, iota), num_keys=1, is_stable=True)
        return values_t[:, order], sizes[order], slots[order]
    _, ssize, sslots, order = jax.lax.sort(
        (dead, sizes, slots, iota), num_keys=1, is_stable=True)
    return values_t.T[order, :].T, ssize, sslots


def _iterate_update(values_t, sizes, slots, parent, base_rng, thresholds,
                    iter_offset, rounds, merge, deep_init, compact=True,
                    permute: str = "payload_sort"):
    """Traced core shared by the head/chunk session programs: run
    ``len(thresholds)`` iterations (threshold > 1 ⇒ padding no-op), fold the
    merges into the on-device parent forest.

    State contract: ``slots[p]`` is the stable original-slot id at position
    ``p``; ``parent`` (original capacity, never shrinks) maps slot → absorber
    slot, identity while alive. Merge decisions are capacity-invariant (see
    ``_combined_sort_key``), so compacting between programs never changes
    results — only the work per iteration.

    Returns ``(values_t, sizes, slots, parent, n_alive, bound)`` where
    ``bound`` is a capacity bound covering every ALIVE position: with
    ``compact=True`` the state is compacted alive-first (one extra payload
    sort — the head program pays it once so the first capacity slice can
    shrink to the post-deep-init survivor count) and ``bound = n_alive``;
    with ``compact=False`` (chunk programs) the extra sort is skipped —
    every iteration's own sort already moves dead slots to the tail, so
    all alive positions sit below the alive count at the LAST executed
    sort, which is what ``bound`` reports (later deaths only punch holes
    below it). Hole-slicing to ``bound`` is bit-identical to compacted
    slicing for every downstream computation (dead slots are masked by
    ``sizes == 0`` everywhere)."""
    mi = jnp.full((values_t.shape[1],), -1, jnp.int32)
    cs = slots
    off = 0
    bound = jnp.sum((sizes > 0).astype(jnp.int32))
    if deep_init:
        # the deep pass: single-pass full chain collapse on raw rows (the
        # analog of the reference's first greedy sweep, kmerLSH.cc:487)
        h = _active_h(sizes)
        hyper = lsh.draw_hyperplanes(jax.random.fold_in(base_rng, 0),
                                     values_t.shape[0])
        keys, proj = lsh.signatures_t(values_t, hyper, h)
        keys = jnp.where(sizes > 0, keys, jnp.int32(BIG_KEY))
        values_t, sizes, mi, cs = chain_collapse(
            values_t, sizes, keys, proj, thresholds[0], mi, cs, h=h,
            permute=permute)
        off = 1

    rest = thresholds[off:]
    if rest.shape[0] == 1:
        # single-iteration programs skip the lax.scan/cond wrapper: the
        # scan double-buffers the [S, M] f32 carry, which can push a
        # session sized to fill device memory over the budget where the
        # same iteration unscanned fits (see BIG_SCAN_CAP)
        na_in = jnp.sum((sizes > 0).astype(jnp.int32))
        values_t, sizes, mi, cs = _one_iteration(
            values_t, sizes, jax.random.fold_in(base_rng, iter_offset + off),
            rest[0], rounds, mi, cs, merge, permute)
        bound = na_in
    elif rest.shape[0]:
        def body(carry, x):
            thr, it = x

            def run(c):
                values_t, sizes, mi, cs, _ = c
                na_in = jnp.sum((sizes > 0).astype(jnp.int32))
                rng = jax.random.fold_in(base_rng, it)
                return _one_iteration(values_t, sizes, rng, thr, rounds, mi,
                                      cs, merge, permute) + (na_in,)

            # padding thresholds (> 1) are TRUE no-ops (see _lsh_cluster_chunk)
            return jax.lax.cond(thr <= 1.0, run, lambda c: c, carry), ()

        its = iter_offset + off + jnp.arange(rest.shape[0], dtype=jnp.int32)
        (values_t, sizes, mi, cs, bound), _ = jax.lax.scan(
            body, (values_t, sizes, mi, cs, bound), (rest, its))

    # each slot dies at most once per program, so one scatter folds all of
    # this program's merges into the global forest; slots that did not merge
    # keep their existing parent (they may have died in an earlier program)
    parent = parent.at[cs].set(jnp.where(mi >= 0, mi, parent[cs]))
    n_alive = jnp.sum((sizes > 0).astype(jnp.int32))
    if compact:
        values_t, sizes, cs = compact_sort(values_t, sizes, cs, permute)
        bound = n_alive
    return values_t, sizes, cs, parent, n_alive, bound


@partial(jax.jit,
         static_argnames=("rounds", "merge", "deep_init", "permute"))
def _head_program(counts, v_kmers, base_rng, thresholds,
                  rounds: int, merge: str, deep_init: bool,
                  permute: str = "payload_sort"):
    """Session head: abundance transform (ioMatrix.cc:353-408 semantics)
    fused with the first iterations. counts uint16 [S, cap] — sample-major,
    exactly the engine's layout: no relayout anywhere."""
    cap = counts.shape[1]
    c = counts.astype(jnp.float32)                      # [S, cap]
    values_t = jnp.log1p(c) - v_kmers[:, None].astype(jnp.float32)
    total = jnp.sum(counts.astype(jnp.int32), axis=0)
    keep = total.astype(jnp.float32) > 0.1 * counts.shape[0]
    sizes = keep.astype(jnp.int32)
    slots = jnp.arange(cap, dtype=jnp.int32)
    parent = jnp.arange(cap, dtype=jnp.int32)
    return _iterate_update(values_t, sizes, slots, parent, base_rng,
                           thresholds, jnp.int32(0), rounds, merge, deep_init,
                           permute=permute)


@partial(jax.jit, static_argnames=("rounds", "merge", "permute"),
         donate_argnums=(0, 1, 2, 3))
def _chunk_program(values_t, sizes, slots, parent, base_rng, thresholds,
                   iter_offset, rounds: int, merge: str,
                   permute: str = "payload_sort"):
    """Session middle: a chunk of iterations at the (possibly shrunken)
    current capacity; the parent forest stays at original capacity. No
    compaction sort — the host slices on the returned position bound.

    The state arguments are DONATED: XLA aliases the input buffers to the
    outputs, halving the resident state (the f32 [S, cap] values would
    otherwise exist twice). Callers must rebind — _drive_session does."""
    return _iterate_update(values_t, sizes, slots, parent, base_rng,
                           thresholds, iter_offset, rounds, merge,
                           deep_init=False, compact=False, permute=permute)


@partial(jax.jit, static_argnames=("new_cap",))
def _slice_state(values_t, sizes, slots, new_cap: int):
    """Shrink alive-first-compacted state to a smaller capacity (the
    session analog of the reference's shrinking cluster vector): later
    iterations sort/scan/gather proportionally less."""
    return values_t[:, :new_cap], sizes[:new_cap], slots[:new_cap]


@partial(jax.jit, static_argnames=("new_cap", "permute"))
def _compact_slice_state(values_t, sizes, slots, new_cap: int, permute: str):
    """Alive-first compaction + slice in one program: used when the alive
    COUNT fits a smaller capacity than the alive-position BOUND does (the
    hole-sliced state can carry holes worth a full power of two — e.g. a
    deep-init pass that kills 30% of a session; running chunks or the
    finalize at double width then needs twice the device memory)."""
    values_t, sizes, slots = compact_sort(values_t, sizes, slots, permute)
    return values_t[:, :new_cap], sizes[:new_cap], slots[:new_cap]


@partial(jax.jit, static_argnames=("fc", "jumps"))
def _finalize_program(values_t, sizes, slots, parent, fc: int, jumps: int):
    """Resolve merge-forest roots (log-depth pointer jumping; ``2**jumps``
    bounds the chain depth — each merge round deepens chains by ≤ 1) and
    pack everything the host needs into ONE i32 buffer = one device→host
    transfer."""
    roots = parent
    for _ in range(jumps):
        roots = roots[roots]
    vbits = jax.lax.bitcast_convert_type(
        values_t[:, :fc], jnp.int32).reshape(-1)
    return jnp.concatenate([sizes[:fc], slots[:fc], roots, vbits])


def _fwd_fill(starts, vals):
    """Forward-fill ``vals`` from each segment start over the whole array
    (full log-depth — segments here are cluster memberships and can span
    the entire capacity)."""
    f = starts
    fill = vals
    d = 1
    m = vals.shape[0]
    for _ in range(max(m - 1, 1).bit_length()):
        fill = jnp.where(f, fill, _shift(fill, d))
        f = f | _shift(f, d, fill=True)
        d *= 2
    return fill


@partial(jax.jit, static_argnames=("fc", "jumps", "half"))
def _finalize_grouped(values_t, sizes, slots, parent, fc: int, jumps: int,
                      half: bool = False):
    """Root resolution + FULL membership grouping on device, packed into
    ONE i32 buffer: ``[flat_members(cap0) | seg_lens(fc) | seg_sizes(fc) |
    centroid bits(S·fc)]``.

    The host equivalent (:func:`_group_by_roots`) is a stable argsort +
    fancy-indexed reorder of the full row set on the host; here the same
    grouping is two stable payload sorts + log-shift fills on device and
    the pull stays the same size as a roots-based buffer.

    Ordering contract (same as :func:`_group_by_roots`): clusters by
    smallest member id, member ids ascending within each cluster; rows
    whose root is dead (filtered rows) sort to the tail and are excluded
    by the lengths."""
    s = values_t.shape[0]
    cap0 = parent.shape[0]
    # state is alive-first compacted with n_alive ≤ fc: slice to fc (the
    # session may end at a larger capacity than the final cluster count
    # needs — slicing drops only dead tail slots)
    values_t = values_t[:, :fc]
    sizes = sizes[:fc]
    slots = slots[:fc]
    roots = parent
    for _ in range(jumps):
        roots = roots[roots]
    big = jnp.int32(cap0)
    alive_of_slot = jnp.zeros((cap0,), jnp.bool_).at[slots].set(
        sizes > 0, mode="drop")
    pos_of_slot = jnp.zeros((cap0,), jnp.int32).at[slots].set(
        jnp.arange(fc, dtype=jnp.int32), mode="drop")
    rows = jnp.arange(cap0, dtype=jnp.int32)
    key = jnp.where(alive_of_slot[roots], roots, big)

    # sort 1: by root; stable ⇒ member ids ascend within each segment
    key_s, rows_s = jax.lax.sort((key, rows), num_keys=1, is_stable=True)
    starts = jnp.concatenate(
        [jnp.ones(1, bool), key_s[1:] != key_s[:-1]])
    first = _fwd_fill(starts, rows_s)        # segment's smallest member id
    first = jnp.where(key_s == big, big, first)

    # sort 2: by first member; stable ⇒ segments stay contiguous, members
    # stay ascending, dead rows (first = big) sink to the tail
    first_s, flat, key_s2 = jax.lax.sort(
        (first, rows_s, key_s), num_keys=1, is_stable=True)
    starts2 = jnp.concatenate(
        [jnp.ones(1, bool), first_s[1:] != first_s[:-1]])
    valid = first_s != big
    live_start = starts2 & valid
    seg_id = jnp.cumsum(live_start.astype(jnp.int32)) - 1
    seg_idc = jnp.clip(seg_id, 0, fc - 1)
    lens = jnp.zeros((fc,), jnp.int32).at[seg_idc].add(
        valid.astype(jnp.int32), mode="drop")
    seg_root = jnp.zeros((fc,), jnp.int32).at[
        jnp.where(live_start, seg_idc, fc)].set(key_s2, mode="drop")

    p = pos_of_slot[jnp.clip(seg_root, 0, cap0 - 1)]
    cents = values_t[:, p]                   # [S, fc] in final cluster order
    csizes = sizes[p]
    if half:
        # pack f16 centroid pairs into i32 — halves the dominant term of
        # the pull (the out-of-core batch passes move every survivor
        # centroid to the host; f16's ~1e-3 relative error is invisible to
        # 0.8-0.95 cosine thresholds).
        # Pairs are adjacent along the fc axis, matching the host unpack.
        c16 = jax.lax.bitcast_convert_type(
            cents.astype(jnp.float16), jnp.uint16).reshape(s, fc // 2, 2)
        packed = (c16[..., 0].astype(jnp.uint32)
                  | (c16[..., 1].astype(jnp.uint32) << 16))
        vbits = jax.lax.bitcast_convert_type(
            packed, jnp.int32).reshape(-1)
    else:
        vbits = jax.lax.bitcast_convert_type(cents, jnp.int32).reshape(-1)
    return jnp.concatenate([flat, lens, csizes, vbits])


def upload_counts(counts: np.ndarray) -> tuple[jax.Array, int]:
    """Pad a uint16 [S, N] count batch to capacity and place it on device.

    Returns (device array [S, cap], N). Callers that run several sessions
    over the same matrix (threshold sweeps, bench warm runs) should hold on
    to the device array — re-using it skips the host→device transfer.
    """
    S, n = counts.shape
    cap = _pad_capacity(n)
    padded = np.zeros((S, cap), np.uint16)
    padded[:, :n] = counts
    return jnp.asarray(padded), n


# Above this capacity, chunk iterations run as single-iteration programs
# WITHOUT the lax.scan wrapper: the scan double-buffers the [S, M] f32
# carry, so at a capacity sized to fill device memory the scanned chunk can
# run out of memory where the identical unscanned iteration fits. One extra
# dispatch per iteration at those capacities — sessions leave them within
# a few iterations as the anneal collapses.
BIG_SCAN_CAP = 1 << 24

# Iterations fused into the head program (full capacity). ONE: the deep
# init pass collapses duplicate-profile rows on the bench workload, so
# every iteration after the first can run at a fraction of the capacity —
# fusing more into the head runs them at FULL capacity. Costs one extra
# dispatch per session.
HEAD_ITERS = 1
MID_CHUNK = 3    # iterations per mid-session chunk while capacity is large


@partial(jax.jit,
         static_argnames=("rounds", "merge", "deep_init", "permute"))
def _head_values_program(values_t, sizes, base_rng, thresholds,
                         rounds: int, merge: str, deep_init: bool,
                         permute: str = "payload_sort"):
    """Session head for pre-transformed values (the `cluster()` entry):
    identical dynamics to `_head_program` minus the abundance transform."""
    cap = values_t.shape[1]
    slots = jnp.arange(cap, dtype=jnp.int32)
    parent = jnp.arange(cap, dtype=jnp.int32)
    return _iterate_update(values_t, sizes, slots, parent, base_rng,
                           thresholds, jnp.int32(0), rounds, merge, deep_init,
                           permute=permute)


def _drive_session(values_t, sizes, slots, parent, na, it, thr, base_rng,
                   rounds, merge, verbose, cap0, s, n,
                   half_pull: bool = False, defer_pull: bool = False,
                   bound: int | None = None):
    """Shared host loop after the head program: chunked iterations with
    capacity compaction, then root resolution + ONE packed pull + host
    membership grouping. Returns (centroids [K, S], sizes [K], members).

    ``half_pull`` packs the pulled centroids as f16 pairs (halves the
    dominant pull term; out-of-core batch passes use it — tmp artifacts
    are internal). ``defer_pull`` returns ``(finish, stats)`` instead: the
    finalize program is dispatched but the device→host pull happens only
    when ``finish()`` is called — the out-of-core driver calls it from a
    worker thread so batch i's pull overlaps batch i+1's device pass;
    ``stats`` carries this session's device/pull split (``finish`` adds
    its own pull time to it)."""
    total = len(thr)
    cap = values_t.shape[1]
    if bound is None:
        bound = na
    while it < total:
        # slice on the alive-POSITION bound, not the alive count: chunk
        # programs skip the compaction sort, so alive slots sit below the
        # last sort's alive count with holes (see _iterate_update) — but
        # when the alive COUNT fits a strictly smaller capacity, pay one
        # compaction sort to claim it (halving every later sort/scan)
        new_cap = min(cap, _pad_capacity(max(bound, 1)))
        cap_na = min(cap, _pad_capacity(max(na, 1)))
        if cap_na < new_cap:
            values_t, sizes, slots = _compact_slice_state(
                values_t, sizes, slots, cap_na, PERMUTE)
            cap = cap_na
            bound = na
        elif new_cap < cap:
            values_t, sizes, slots = _slice_state(
                values_t, sizes, slots, new_cap)
            cap = new_cap
        if cap > BIG_SCAN_CAP:
            c = 1          # un-scanned single-iteration program (see
            c_prog = 1     # _iterate_update: scan carries OOM at full HBM)
        elif cap <= SMALL_CAP:
            c = total - it                    # run everything that remains
            c_prog = max(MID_CHUNK,
                         1 << max(0, math.ceil(math.log2(max(c, 1)))))
        else:
            c = min(MID_CHUNK, total - it)
            c_prog = max(MID_CHUNK,
                         1 << max(0, math.ceil(math.log2(max(c, 1)))))
        tpad = np.full(c_prog, 9.0, np.float32)
        tpad[:c] = thr[it:it + c]
        t0 = time.perf_counter()
        values_t, sizes, slots, parent, na_dev, bound_dev = _chunk_program(
            values_t, sizes, slots, parent, base_rng, jnp.asarray(tpad),
            jnp.int32(it), rounds, merge, PERMUTE)
        jax.block_until_ready(na_dev)
        t1 = time.perf_counter()
        na, bound = int(na_dev), int(bound_dev)   # 1 RT per chunk
        t2 = time.perf_counter()
        LAST_SESSION["device_seconds"] += t1 - t0
        LAST_SESSION["pull_seconds"] += t2 - t1
        LAST_SESSION.setdefault("programs", []).append(
            (f"chunk[{c}]@{cap}", round(t1 - t0, 3)))
        it += c
        if verbose:
            print(f"[tpu] iter {it}: {na} clusters")

    # forest depth ≤ executed iterations + 1 (a death records its chain
    # HEAD, which survives that iteration — chains deepen ≤ 1 per merge
    # round); 2**jumps must cover it. Each jump is a cap0-wide 1-D gather,
    # so no slack is added.
    rpi = 1 if merge == "chain" else max(rounds, 1)
    jumps = max(3, math.ceil(math.log2(total * rpi + 2)))
    fc = min(cap, _pad_capacity(max(na, 1)))
    if fc < min(cap, _pad_capacity(max(bound, 1))):
        # the alive count fits a smaller width than the position bound:
        # one compaction sort halves the finalize (and its pull)
        values_t, sizes, slots = _compact_slice_state(
            values_t, sizes, slots, fc, PERMUTE)
    elif fc < cap:
        # slice in a separate program so the over-capacity state frees
        # BEFORE the finalize allocates: a single-deep-pass batch session
        # otherwise enters finalize with the full-capacity f32 state alive
        values_t, sizes, slots = _slice_state(values_t, sizes, slots, fc)
    t0 = time.perf_counter()
    dev_buf = _finalize_grouped(values_t, sizes, slots, parent, fc, jumps,
                                half_pull)
    jax.block_until_ready(dev_buf)
    t1 = time.perf_counter()
    LAST_SESSION["device_seconds"] += t1 - t0
    LAST_SESSION.setdefault("programs", []).append(
        (f"finalize@{fc}", round(t1 - t0, 3)))
    stats = {"device_seconds": LAST_SESSION["device_seconds"],
             "pull_seconds": LAST_SESSION["pull_seconds"],
             "pull_bytes": LAST_SESSION.get("pull_bytes", 0),
             "programs": list(LAST_SESSION.get("programs", []))}

    def finish():
        t2 = time.perf_counter()
        buf = np.asarray(dev_buf)             # one pull (1 RT)
        dt = time.perf_counter() - t2
        stats["pull_seconds"] += dt
        stats["pull_bytes"] += buf.nbytes
        if not defer_pull:
            LAST_SESSION["pull_seconds"] += dt
            LAST_SESSION["pull_bytes"] = (
                LAST_SESSION.get("pull_bytes", 0) + buf.nbytes)

        # unpack: grouping happened on device (filtered rows — their own
        # dead roots, ioMatrix.cc:381 — sorted to the tail and excluded by
        # lens); the host only builds offsets and views
        from kmerlsh_tpu.cluster.groups import Groups

        flat_all = buf[:cap0]
        lens = buf[cap0:cap0 + fc][:na].astype(np.int64)
        csizes = buf[cap0 + fc:cap0 + 2 * fc][:na].astype(np.int64)
        vtail = buf[cap0 + 2 * fc:]
        if half_pull:
            vals = vtail.view(np.float16).reshape(s, fc)[:, :na].astype(
                np.float32)
        else:
            vals = vtail.view(np.float32).reshape(s, fc)[:, :na]
        offs = np.concatenate([[0], np.cumsum(lens)])
        members = Groups(flat_all[:offs[-1]].astype(np.int64), offs)
        return np.ascontiguousarray(vals.T), csizes, members

    if defer_pull:
        return finish, stats
    return finish()


def _group_by_roots(roots, alive_slots, alive_sizes, alive_vals_t):
    """Assemble (centroids [K, S], sizes [K], members: Groups) from a row →
    root map plus the alive clusters' (slot, size, centroid) columns.
    Clusters come back ordered by smallest member id; member ids ascend
    within each group (a stable argsort of ``roots`` yields both for free).
    """
    from kmerlsh_tpu.cluster.groups import Groups

    s = alive_vals_t.shape[0]
    na = len(alive_slots)
    if na == 0:
        return (np.zeros((0, s), np.float32), np.zeros(0, np.int64),
                Groups(np.empty(0, np.int64), np.zeros(1, np.int64)))
    order = np.argsort(roots, kind="stable")
    sr = roots[order]
    starts = np.flatnonzero(np.r_[True, sr[1:] != sr[:-1]])
    uniq = sr[starts]
    glens = np.diff(np.r_[starts, len(sr)])

    gidx = np.searchsorted(uniq, alive_slots)   # every alive slot is a root
    first_member = order[starts[gidx]]
    cl_order = np.argsort(first_member, kind="stable")
    gsel = gidx[cl_order]

    centroids = np.ascontiguousarray(alive_vals_t[:, cl_order].T,
                                     dtype=np.float32)
    out_sizes = alive_sizes[cl_order].astype(np.int64)
    lens = glens[gsel]
    offs = np.r_[0, np.cumsum(lens)]
    pos = np.repeat(starts[gsel] - offs[:-1], lens) + np.arange(offs[-1])
    members = Groups(order[pos].astype(np.int64), offs)
    return centroids, out_sizes, members


def cluster_counts(
    counts,                      # uint16 [S, N] batch (np) or device [S, cap]
    v_kmers: np.ndarray,         # f32 [S] per-sample coverage offsets
    thresholds: np.ndarray,      # f32 [I] anneal schedule (incl. init pass)
    seed: int = 0,
    rounds: int = 4,
    deep_init: bool = True,
    verbose: bool = False,
    n: int | None = None,        # real column count when counts is on device
    merge: str = "chain",
    half_pull: bool = False,
    defer_pull: bool = False,
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Single-batch mode C as a handful of fused device programs.

    Structure: head (transform + first iterations at full capacity) → mid
    chunks with capacity compaction between them (cluster count collapses
    geometrically, so later iterations run at a fraction of the capacity)
    → finalize (root resolution + one packed pull). The count matrix is
    the only upload; membership comes back as one i32 root map. ``counts``
    may be a capacity-padded device array from :func:`upload_counts` (with
    ``n``) to amortize the upload across sessions. Returns
    (centroids [K, S], sizes [K], members) like :func:`cluster`.
    """
    if isinstance(counts, jax.Array):
        assert n is not None, "pass n (real column count) with device counts"
        jcounts = counts
    else:
        S0, n0 = counts.shape
        if n0 == 0:
            return np.zeros((0, S0), np.float32), np.zeros(0, np.int64), []
        jcounts, n = upload_counts(counts)
    S, cap0 = jcounts.shape
    thr = np.asarray(thresholds, np.float32)
    total = len(thr)
    base_rng = jax.random.PRNGKey(seed)
    jv = jnp.asarray(np.asarray(v_kmers, np.float32))

    head_k = min(total, HEAD_ITERS)
    head_thr = np.full(HEAD_ITERS, 9.0, np.float32)
    head_thr[:head_k] = thr[:head_k]
    LAST_SESSION.clear()
    LAST_SESSION.update(device_seconds=0.0, pull_seconds=0.0)
    t0 = time.perf_counter()
    values_t, sizes, slots, parent, na_dev, _ = _head_program(
        jcounts, jv, base_rng, jnp.asarray(head_thr), rounds, merge,
        deep_init, PERMUTE)
    jax.block_until_ready(na_dev)
    # drop the local ref to the uint16 count matrix: an init-batch session
    # never revisits it, and at the 2^25-batch design point its 1.3 GB
    # otherwise stays allocated through the finalize peak (callers that
    # cache the device array keep their own reference)
    del jcounts
    t1 = time.perf_counter()
    na = int(na_dev)                          # 1 RT
    LAST_SESSION["device_seconds"] += t1 - t0
    LAST_SESSION["pull_seconds"] += time.perf_counter() - t1
    LAST_SESSION.setdefault("programs", []).append(
        (f"head[{head_k}]@{cap0}", round(t1 - t0, 3)))
    if verbose:
        print(f"[tpu] head ({head_k} iters): {na} clusters")
    return _drive_session(values_t, sizes, slots, parent, na, head_k, thr,
                          base_rng, rounds, merge, verbose, cap0, S, n,
                          half_pull=half_pull, defer_pull=defer_pull)


def _pad_capacity(n: int) -> int:
    """Round up to a power of two (min 4096) so only log-many distinct
    programs ever compile — each distinct shape costs a full XLA
    compile."""
    return max(4096, 1 << math.ceil(math.log2(max(n, 1))))


def cluster(
    values,
    sizes=None,
    min_similarity: float = 0.8,
    iterations: int = 100,
    seed: int = 0,
    rounds: int = 4,
    chunk: int = DEFAULT_CHUNK,
    compact_below: float = 0.5,
    verbose: bool = False,
    thresholds: np.ndarray | None = None,
    init_rounds: int | None = None,
    merge: str = "chain",
    transposed: bool = False,
    half_pull: bool = False,
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Cluster rows of ``values`` [N, S] with the annealed-threshold LSH loop
    (0.95 → min_similarity over ``iterations``, cluster.cc:190-192,330).

    ``values``/``sizes`` may be NumPy or device arrays (device arrays avoid
    any host transfer of the matrix; rows with size 0 are pre-filtered
    slots). With ``transposed=True``, ``values`` is [S, N] sample-major —
    the engine's native layout, skipping the input relayout entirely.
    ``init_rounds`` (any non-None value) marks the first threshold as the
    deep init pass (kmerLSH.cc:487 analog); with the default chain merge
    every iteration is already a full collapse, so it only matters for
    ``merge="pairing"``. ``chunk``/``compact_below`` are accepted for
    back-compat; chunking is governed by the session constants.
    Returns (centroids [K, S], sizes [K], members: per-cluster sorted
    arrays of input row indices), ordered by smallest member index.
    """
    del chunk, compact_below
    on_device = isinstance(values, jax.Array)
    if not on_device:
        values = np.asarray(values, dtype=np.float32)
    if transposed:
        s, n = values.shape
    else:
        n, s = values.shape
    if n == 0:
        return np.zeros((0, s), np.float32), np.zeros(0, np.int64), []

    cap = _pad_capacity(n)
    if on_device:
        vt = values if transposed else values.T
        jvals = jnp.pad(vt.astype(jnp.float32), ((0, 0), (0, cap - n)))
        if sizes is None:
            jsizes = jnp.pad(jnp.ones(n, jnp.int32), (0, cap - n))
        else:
            jsizes = jnp.pad(jnp.asarray(sizes, jnp.int32), (0, cap - n))
    else:
        host_vals = np.zeros((s, cap), np.float32)
        host_vals[:, :n] = values if transposed else values.T
        host_sizes = np.zeros(cap, np.int32)
        host_sizes[:n] = (np.asarray(sizes, np.int32) if sizes is not None
                          else np.ones(n, np.int32))
        jvals = jnp.asarray(host_vals)
        jsizes = jnp.asarray(host_sizes)

    base_rng = jax.random.PRNGKey(seed)
    if thresholds is None:
        sim_step = (0.95 - min_similarity) / iterations
        thr = (0.95 - sim_step * np.arange(iterations)).astype(np.float32)
    else:
        thr = np.asarray(thresholds, np.float32)
    total = len(thr)

    head_k = min(total, HEAD_ITERS)
    head_thr = np.full(HEAD_ITERS, 9.0, np.float32)
    head_thr[:head_k] = thr[:head_k]
    LAST_SESSION.clear()
    LAST_SESSION.update(device_seconds=0.0, pull_seconds=0.0)
    t0 = time.perf_counter()
    values_t, jsizes, slots, parent, na_dev, _ = _head_values_program(
        jvals, jsizes, base_rng, jnp.asarray(head_thr), rounds, merge,
        init_rounds is not None, PERMUTE)
    jax.block_until_ready(na_dev)
    t1 = time.perf_counter()
    na = int(na_dev)
    LAST_SESSION["device_seconds"] += t1 - t0
    LAST_SESSION["pull_seconds"] += time.perf_counter() - t1
    if verbose:
        print(f"[tpu] head ({head_k} iters): {na} clusters")
    return _drive_session(values_t, jsizes, slots, parent, na, head_k, thr,
                          base_rng, rounds, merge, verbose, cap, s, n,
                          half_pull=half_pull)

"""Multi-chip sharded clustering (shard_map over the k-mer row axis).

Device-mesh generalization of the reference's out-of-core batch rounds
(app/kmerLSH.cc:278-430): instead of tmp files, shards. One iteration, all
inside a single SPMD program:

  1. **local phase** — each device hashes its row shard against *replicated*
     hyperplanes (same global key space everywhere) and runs the single-pass
     chain collapse locally (cluster/engine.py);
  2. **exchange** — each device selects a FIXED-capacity window of its first
     ``exchange_cap`` alive survivors (positions via one cumsum +
     searchsorted, no extra sort) and ``all_gather``s only (centroid, size,
     slot-id) summaries between devices: per-device gathered bytes are
     O(devices · exchange_cap · samples), **independent of the total row
     count** — the raw matrix never moves;
  3. **global phase** — a replicated chain collapse joins gathered clusters
     that share a global LSH bucket across shards; every device computes the
     identical result, takes back its own slots, and scatters them over its
     window positions;
  4. the merge forest is row-sharded on device: each device owns
     ``parent[gid]`` for its original slot range and folds both local and
     global merge events into it with one small scatter each.

Clusters beyond the exchange window simply stay local that iteration and
get their cross-shard chance on a later one — exactly the reference's
tmp-file rounds semantics (a batch's clusters only meet other batches'
in later merge rounds, kmerLSH.cc:354-411), but with summaries over the
device interconnect instead of files.

Slot ids never migrate between devices, so the parent shard layout is
static; the host pulls the forest ONCE at the end and resolves roots with
vectorized pointer jumping.

The final mode-E t-test is a cluster-sharded mean/variance pass
(``sharded_wrs``).
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from kmerlsh_tpu.cluster.engine import BIG_KEY, chain_collapse
from kmerlsh_tpu.ops import lsh
from kmerlsh_tpu.parallel.mesh import ROWS, make_mesh

EXCHANGE_CAP = 4096   # survivor summaries exchanged per device per iteration

# wall-clock split of the most recent sharded session (same contract as
# engine.LAST_SESSION): device program walls, device→host pulls, and the
# single-device anneal-tail's own split folded in (ADVICE r4: the tail used
# to overwrite the engine dict, so multi-device bench splits described only
# the tail). Reset by _drive; read by pipeline/bench.
LAST_SESSION: dict = {}

HEAD_ITERS = 3        # iterations fused into the head program
MID_CHUNK = 4         # iterations per chunk program thereafter
SMALL_LOCAL_CAP = 1 << 13  # below this per-device capacity, fuse everything


def _window_positions(alive: jax.Array, e: int, rot: jax.Array):
    """Positions of ``e`` alive slots (one cumsum + binary search — no
    sort). When more than ``e`` slots are alive the window ROTATES with
    ``rot`` (the iteration index), so every survivor gets a cross-shard
    exchange within ⌈alive/e⌉ iterations — the coverage guarantee behind
    the fixed-capacity exchange. Exhausted entries return ``len(alive)``
    (dropped on scatter)."""
    c = alive.shape[0]
    ar = jnp.cumsum(alive.astype(jnp.int32))
    n_local = ar[-1]
    j = jnp.arange(e, dtype=jnp.int32)
    # ranks are e consecutive values mod n_local → distinct while e ≤ alive
    rank = jnp.where(n_local > e,
                     (j + rot * e) % jnp.maximum(n_local, 1), j)
    pos = jnp.searchsorted(ar, rank + 1).astype(jnp.int32)
    valid = j < n_local
    return jnp.where(valid, pos, jnp.int32(c)), valid


def _realign_to(slot_ref: jax.Array, slot_cur: jax.Array):
    """Permutation ``sel`` with ``slot_cur[sel[p]] == slot_ref[p]`` (both are
    the same multiset; stable double argsort aligns duplicates in order)."""
    ord1 = jnp.argsort(slot_cur, stable=True)
    ord2 = jnp.argsort(slot_ref, stable=True)
    return ord1[jnp.argsort(ord2, stable=True)]


def _one_dist_iteration(values_t, sizes, slots, parent, n_alive, rng,
                        threshold, it, e: int, c0_loc: int,
                        permute: str = "payload_sort"):
    """One sharded LSH iteration (runs per device inside shard_map)."""
    s, c = values_t.shape
    my = jax.lax.axis_index(ROWS).astype(jnp.int32)
    base = my * jnp.int32(c0_loc)

    h = jnp.clip(
        jnp.floor(jnp.log2(jnp.maximum(n_alive, 2).astype(jnp.float32)))
        .astype(jnp.int32), 1, lsh.H_MAX)
    hyper = lsh.draw_hyperplanes(rng, s)                     # replicated

    # ---- local phase: hash + single-pass chain collapse on my shard ----
    keys, proj = lsh.signatures_t(values_t, hyper, h)
    keys = jnp.where(sizes > 0, keys, jnp.int32(BIG_KEY))
    values_t, sizes, mi, slots = chain_collapse(
        values_t, sizes, keys, proj, threshold, None, slots, h=h,
        permute=permute)
    li = slots - base                                        # all local gids
    parent = parent.at[li].set(jnp.where(mi >= 0, mi, parent[li]))

    # ---- exchange: a rotating window of `e` alive survivors ----
    alive = sizes > 0
    pos, valid = _window_positions(alive, e, it)
    posc = jnp.minimum(pos, c - 1)
    w_vals = values_t[:, posc]
    w_sizes = jnp.where(valid, sizes[posc], 0)
    w_slots = jnp.where(valid, slots[posc], jnp.int32(-1))

    g_vals = jax.lax.all_gather(w_vals, ROWS, axis=1, tiled=True)  # [S, D*e]
    g_sizes = jax.lax.all_gather(w_sizes, ROWS, tiled=True).reshape(-1)
    g_slots = jax.lax.all_gather(w_slots, ROWS, tiled=True).reshape(-1)

    # ---- global phase: replicated merge of the gathered summaries ----
    gk, gp = lsh.signatures_t(g_vals, hyper, h)
    gk = jnp.where(g_sizes > 0, gk, jnp.int32(BIG_KEY))
    m_vals, m_sizes, m_mi, m_scs = chain_collapse(
        g_vals, g_sizes, gk, gp, threshold, None, g_slots, h=h,
        permute=permute)

    # chain_collapse leaves state sorted AND swaps head/last slot ids;
    # realign by slot identity so position p again holds slot g_slots[p]
    sel = _realign_to(g_slots, m_scs)
    r_vals = m_vals[:, sel]
    r_sizes = m_sizes[sel]
    r_mi = m_mi[sel]

    # fold global merge events for MY gids into my parent shard. Invalid
    # entries (other devices' slots, window padding) are routed to the
    # out-of-range index c0_loc and DROPPED — masking them to index 0
    # instead would alias many identity writes onto local slot 0, and
    # XLA's duplicate-index scatter order is unspecified, so a real death
    # record for gid == base could be clobbered (observed: stranded rows
    # rooted at dead shard-base slots whenever the chunk loop ran long)
    gi = g_slots - base
    ok = (r_mi >= 0) & (gi >= 0) & (gi < c0_loc)
    parent = parent.at[jnp.where(ok, gi, c0_loc)].set(
        jnp.where(ok, r_mi, 0), mode="drop")

    # write my post-merge window back over my window positions
    mv = jax.lax.dynamic_slice_in_dim(r_vals, my * e, e, axis=1)
    ms = jax.lax.dynamic_slice_in_dim(r_sizes, my * e, e, axis=0)
    values_t = values_t.at[:, pos].set(mv, mode="drop")
    sizes = sizes.at[pos].set(ms, mode="drop")

    n_alive = jax.lax.psum(jnp.sum((sizes > 0).astype(jnp.int32)), ROWS)
    return values_t, sizes, slots, parent, n_alive


def _scan_iters(values_t, sizes, slots, parent, rng, thresholds, it_offset,
                e: int, c0_loc: int, permute: str = "payload_sort"):
    """Run ``len(thresholds)`` sharded iterations as one lax.scan; padding
    thresholds (> 1) are true no-ops (cond-skipped — the predicate is
    replicated, so all devices branch identically)."""
    na0 = jax.lax.psum(jnp.sum((sizes > 0).astype(jnp.int32)), ROWS)

    def body(carry, x):
        thr, it = x

        def run(c):
            vt, sz, sl, par, na = c
            return _one_dist_iteration(
                vt, sz, sl, par, na, jax.random.fold_in(rng, it), thr, it,
                e, c0_loc, permute)

        return jax.lax.cond(thr <= 1.0, run, lambda c: c, carry), ()

    its = it_offset + jnp.arange(thresholds.shape[0], dtype=jnp.int32)
    (values_t, sizes, slots, parent, na), _ = jax.lax.scan(
        body, (values_t, sizes, slots, parent, na0), (thresholds, its))
    max_alive = jax.lax.pmax(jnp.sum((sizes > 0).astype(jnp.int32)), ROWS)
    return values_t, sizes, slots, parent, na, max_alive


@lru_cache(maxsize=8)
def _dist_programs(mesh, e: int, permute: str = "payload_sort"):
    """Jitted SPMD programs for one (mesh, exchange_cap, permute); cached
    so repeated pipeline calls reuse XLA executables."""

    def head_body(counts, v_kmers, rng, thresholds):
        s, c = counts.shape
        my = jax.lax.axis_index(ROWS).astype(jnp.int32)
        base = my * jnp.int32(c)
        # abundance transform fused in (ioMatrix.cc:353-408 semantics)
        cf = counts.astype(jnp.float32)
        values_t = jnp.log1p(cf) - v_kmers[:, None].astype(jnp.float32)
        total = jnp.sum(counts.astype(jnp.int32), axis=0)
        sizes = (total.astype(jnp.float32) > 0.1 * s).astype(jnp.int32)
        slots = jnp.arange(c, dtype=jnp.int32) + base
        parent = slots
        return _scan_iters(values_t, sizes, slots, parent, rng, thresholds,
                           jnp.int32(0), e, c, permute)

    def head_values_body(values_t, sizes, rng, thresholds):
        c = values_t.shape[1]
        my = jax.lax.axis_index(ROWS).astype(jnp.int32)
        slots = jnp.arange(c, dtype=jnp.int32) + my * jnp.int32(c)
        parent = slots
        return _scan_iters(values_t, sizes, slots, parent, rng, thresholds,
                           jnp.int32(0), e, c, permute)

    def chunk_body(values_t, sizes, slots, parent, rng, thresholds,
                   it_offset):
        return _scan_iters(values_t, sizes, slots, parent, rng, thresholds,
                           it_offset, e, parent.shape[0], permute)

    state_specs = (P(None, ROWS), P(ROWS), P(ROWS), P(ROWS))
    out_state = state_specs + (P(), P())

    head = jax.jit(jax.shard_map(
        head_body, mesh=mesh,
        in_specs=(P(None, ROWS), P(), P(), P()),
        out_specs=out_state, check_vma=False))
    head_values = jax.jit(jax.shard_map(
        head_values_body, mesh=mesh,
        in_specs=(P(None, ROWS), P(ROWS), P(), P()),
        out_specs=out_state, check_vma=False))
    chunk = jax.jit(jax.shard_map(
        chunk_body, mesh=mesh,
        in_specs=state_specs + (P(), P(), P()),
        out_specs=out_state, check_vma=False))

    def slice_body(values_t, sizes, slots, new_c: int):
        from kmerlsh_tpu.cluster.engine import compact_sort

        values_t, sizes, slots = compact_sort(values_t, sizes, slots,
                                              permute)
        return values_t[:, :new_c], sizes[:new_c], slots[:new_c]

    def make_slice(new_c):
        return jax.jit(jax.shard_map(
            partial(slice_body, new_c=new_c), mesh=mesh,
            in_specs=(P(None, ROWS), P(ROWS), P(ROWS)),
            out_specs=(P(None, ROWS), P(ROWS), P(ROWS)), check_vma=False))

    slice_cache: dict[int, object] = {}

    def slice_to(state, new_c):
        if new_c not in slice_cache:
            slice_cache[new_c] = make_slice(new_c)
        return slice_cache[new_c](*state)

    return head, head_values, chunk, slice_to


def _local_cap(n: int, n_dev: int, lo: int = 512) -> int:
    """Per-device capacity: power-of-two per shard (bounds distinct
    compiled programs), total = n_dev · cap ≥ n."""
    per = -(-n // n_dev)
    return max(lo, 1 << math.ceil(math.log2(max(per, 1))))


def _put(mesh, arr: np.ndarray, spec: P) -> jax.Array:
    """Place a host array (identical on every process) with ``spec`` on
    ``mesh``. Single-process this is ``device_put``; multi-process each
    host materializes only its addressable shards."""
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def _my_cols(mesh, s: int, n_cols: int) -> tuple[int, int]:
    """This process's contiguous global-column range under P(None, ROWS)."""
    sharding = NamedSharding(mesh, P(None, ROWS))
    imap = sharding.devices_indices_map((s, n_cols))
    me = jax.process_index()
    spans = sorted((idx[1].start or 0, idx[1].stop or n_cols)
                   for d, idx in imap.items() if d.process_index == me)
    lo, hi = spans[0][0], spans[-1][1]
    assert all(a <= hi and b >= lo for a, b in spans), (
        f"non-contiguous process columns: {spans}")
    return lo, hi


def _handoff_cap(num_samples: int) -> int:
    """Global alive count at which the anneal tail moves to ONE device
    (exact single-device merge semantics): what one device's memory budget
    admits for an S-sample session (utils/hbm.py). A fixed count sized for
    a smaller device keeps the anneal sharded long after the survivors fit
    one card, and the fixed-capacity exchange then leaves cross-shard
    duplicates for the terminal rounds to settle."""
    from kmerlsh_tpu.utils.hbm import rows_budget

    return rows_budget(num_samples, 1)


def _drive(head_fn, head_args, mesh, thresholds, seed, e, verbose,
           progs) -> tuple:
    """Shared host loop: head program → chunk programs with per-device
    capacity shrinking → final compact + pull. Returns
    ((values_t [S, D*Cf] np, sizes, slots, parent, n_alive), rest) where
    ``rest`` is the un-run tail of the threshold schedule: once the global
    alive count fits :func:`_handoff_cap` the loop exits early and the caller
    replays the remaining anneal on a single device — the
    threshold-sensitive tail then has EXACT single-chip merge semantics
    (every survivor pair shares one memory space every iteration), which
    the fixed-capacity exchange cannot guarantee at scale."""
    import time

    _, _, chunk, slice_to = progs
    thr = np.asarray(thresholds, np.float32)
    total = len(thr)
    rng = jax.random.PRNGKey(seed)
    n_dev = mesh.size
    LAST_SESSION.clear()
    LAST_SESSION.update(device_seconds=0.0, pull_seconds=0.0, programs=[])

    def timed(tag, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        LAST_SESSION["device_seconds"] += dt
        LAST_SESSION["programs"].append((tag, round(dt, 3)))
        return out

    head_k = min(total, HEAD_ITERS)
    head_thr = np.full(HEAD_ITERS, 9.0, np.float32)
    head_thr[:head_k] = thr[:head_k]
    values_t, sizes, slots, parent, na_dev, ma_dev = timed(
        f"dist_head[{head_k}]", head_fn, *head_args, rng,
        jnp.asarray(head_thr))
    it = head_k
    t0 = time.perf_counter()
    na, max_alive = int(na_dev), int(ma_dev)      # 1 pull
    LAST_SESSION["pull_seconds"] += time.perf_counter() - t0
    c_loc = sizes.shape[0] // n_dev
    if verbose:
        print(f"[dist] head ({head_k} iters): {na} clusters")

    handoff = _handoff_cap(values_t.shape[0])
    while it < total and (na > handoff or n_dev == 1):
        new_c = min(c_loc, _local_cap(max(max_alive, 1), 1))
        if new_c < c_loc:
            values_t, sizes, slots = slice_to(
                (values_t, sizes, slots), new_c)
            c_loc = new_c
        if c_loc <= SMALL_LOCAL_CAP:
            c = total - it
        else:
            c = min(MID_CHUNK, total - it)
        c_prog = max(MID_CHUNK,
                     1 << max(0, math.ceil(math.log2(max(c, 1)))))
        tpad = np.full(c_prog, 9.0, np.float32)
        tpad[:c] = thr[it:it + c]
        values_t, sizes, slots, parent, na_dev, ma_dev = timed(
            f"dist_chunk[{c}]@{c_loc}", chunk, values_t, sizes, slots,
            parent, rng, jnp.asarray(tpad), jnp.int32(it))
        t0 = time.perf_counter()
        na, max_alive = int(na_dev), int(ma_dev)
        LAST_SESSION["pull_seconds"] += time.perf_counter() - t0
        it += c
        if verbose:
            print(f"[dist] iter {it}: {na} clusters")

    fin_c = min(c_loc, _local_cap(max(max_alive, 1), 1))
    values_t, sizes, slots = slice_to((values_t, sizes, slots), fin_c)
    from kmerlsh_tpu.parallel.multihost import gather_np

    t0 = time.perf_counter()
    pulled = (gather_np(values_t), gather_np(sizes), gather_np(slots),
              gather_np(parent), na)
    LAST_SESSION["pull_seconds"] += time.perf_counter() - t0
    LAST_SESSION["pull_bytes"] = sum(
        a.nbytes for a in pulled[:4] if hasattr(a, "nbytes"))
    return (pulled, thr[it:])


TERMINAL_ITERS = 5   # = the reference's per-merge-round iteration count
                     # (Cluster(..., iters=5), app/kmerLSH.cc:375-387); only
                     # used when survivors never fit the single-device
                     # handoff (alive > _handoff_cap at the end of the anneal)


def _assemble(values_t, sizes, slots, parent, n_rows: int,
              extra_thresholds=None, seed: int = 0,
              verbose: bool = False):
    """Host-side root resolution + membership assembly (same contract as
    cluster.engine.cluster: order by smallest member id).

    ``extra_thresholds`` runs a single-device GLOBAL pass over all
    survivors before assembly. Two uses:

      * **handoff** — the un-run tail of the anneal schedule (from
        ``_drive``): the threshold-sensitive final iterations replay with
        exact single-chip semantics, eliminating cross-shard fragmentation
        (the fixed-capacity exchange only gives each survivor a cross-shard
        chance every ⌈alive/e⌉ iterations — measured +187% cluster-count
        inflation at 2^20×8dev without this);
      * **terminal rounds** — ``TERMINAL_ITERS`` repeats of the final
        threshold when survivors exceeded the handoff budget, the analog of
        the reference's "merge tmp batches until one remains"
        (app/kmerLSH.cc:354-411)."""
    r = parent.astype(np.int64)
    while True:
        nr = r[r]
        if np.array_equal(nr, r):
            break
        r = nr
    roots = r[:len(parent)]

    from kmerlsh_tpu.cluster.engine import _group_by_roots

    alive = np.flatnonzero((sizes > 0) & (slots < n_rows))
    al_slots = slots[alive].astype(np.int64)
    al_sizes = sizes[alive]
    al_vals = values_t[:, alive]

    if extra_thresholds is not None and len(extra_thresholds) and \
            len(alive) > 1:
        from kmerlsh_tpu.cluster import engine

        thr = np.asarray(extra_thresholds, np.float32)
        cents, tsizes, members = engine.cluster(
            al_vals, sizes=al_sizes.astype(np.int32), thresholds=thr,
            seed=seed, transposed=True, verbose=verbose)
        # fold the tail session's split into the sharded session's own
        # counters (engine.cluster cleared engine.LAST_SESSION; without
        # this the reported split covered only the tail — ADVICE r4)
        for k in ("device_seconds", "pull_seconds", "pull_bytes"):
            if k in engine.LAST_SESSION:
                LAST_SESSION[k] = (LAST_SESSION.get(k, 0)
                                   + engine.LAST_SESSION[k])
        LAST_SESSION.setdefault("programs", []).extend(
            ("tail_" + t, d)
            for t, d in engine.LAST_SESSION.get("programs", []))
        if verbose:
            print(f"[dist] single-device tail ({len(thr)} iters): "
                  f"{len(alive)} -> {len(members)} clusters")
        # members groups alive-indices; the group head (first member) slot
        # absorbs the rest: compose row roots through the terminal groups
        flat, offs = members.flat, members.offsets
        heads = flat[offs[:-1]]
        to_head = np.empty(len(alive), np.int64)
        to_head[flat] = np.repeat(heads, members.sizes)
        # root slot → alive index (every alive root is its own slot)
        order = np.argsort(al_slots, kind="stable")
        sorted_slots = al_slots[order]
        ridx = np.searchsorted(sorted_slots, roots[:n_rows])
        ridx_c = np.minimum(ridx, len(alive) - 1)
        is_alive_root = sorted_slots[ridx_c] == roots[:n_rows]
        final_roots = np.where(
            is_alive_root, al_slots[to_head[order[ridx_c]]],
            roots[:n_rows])
        return _group_by_roots(final_roots, al_slots[heads],
                               tsizes.astype(al_sizes.dtype),
                               np.ascontiguousarray(cents.T))

    return _group_by_roots(roots[:n_rows], al_slots, al_sizes, al_vals)


def _tail_schedule(rest: np.ndarray, thresholds, mesh) -> np.ndarray | None:
    """Single-device tail to run after the sharded prefix: the handed-off
    remainder of the anneal when ``_drive`` exited early, terminal rounds
    at the final threshold otherwise (multi-device meshes only)."""
    if mesh.size <= 1:
        return None
    if len(rest):
        return rest
    return np.full(TERMINAL_ITERS,
                   float(np.asarray(thresholds)[-1]), np.float32)


def upload_counts_sharded(counts: np.ndarray, mesh) -> tuple[jax.Array, int]:
    """Pad a uint16 [S, N] count batch to sharded capacity and place it
    row-sharded on ``mesh``. Returns (device array [S, D·c_loc], N)."""
    S, n = counts.shape
    c_loc = _local_cap(n, mesh.size)
    padded = np.zeros((S, mesh.size * c_loc), np.uint16)
    padded[:, :n] = counts
    return _put(mesh, padded, P(None, ROWS)), n


def upload_counts_process_local(
    bin_path: str, num_samples: int, kmap_size: int, mesh,
) -> tuple[jax.Array, int]:
    """Multi-host count upload: each process reads ONLY its own column
    slice of the sample-major ``kmer_count.bin`` (ReadHT layout,
    io/ioHT.cc:65-66) and assembles the global row-sharded array via
    ``jax.make_array_from_process_local_data`` — the full matrix never
    lives on one host."""
    from kmerlsh_tpu.io import counts as countsio

    S = num_samples
    c_loc = _local_cap(kmap_size, mesh.size)
    n_cols = mesh.size * c_loc
    lo, hi = _my_cols(mesh, S, n_cols)
    local = np.zeros((S, hi - lo), np.uint16)
    rlo, rhi = min(lo, kmap_size), min(hi, kmap_size)
    if rhi > rlo:
        local[:, :rhi - rlo] = countsio.read_count_batch(
            bin_path, S, kmap_size, rlo, rhi - rlo)
    sharding = NamedSharding(mesh, P(None, ROWS))
    arr = jax.make_array_from_process_local_data(sharding, local,
                                                 global_shape=(S, n_cols))
    return arr, kmap_size


def cluster_counts_sharded(
    counts,                      # uint16 [S, N] batch (np) or sharded device
    v_kmers: np.ndarray,         # f32 [S] coverage offsets
    thresholds: np.ndarray,      # f32 [I] anneal schedule
    mesh=None,
    seed: int = 0,
    exchange_cap: int = EXCHANGE_CAP,
    verbose: bool = False,
    n: int | None = None,        # real column count when counts is on device
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Sharded twin of ``engine.cluster_counts``: transform fused into the
    head program, row axis sharded over ``mesh``. Same output contract.
    ``counts`` may be a pre-sharded device array from
    :func:`upload_counts_sharded` (with ``n``) to amortize the upload."""
    mesh = mesh or make_mesh()
    if isinstance(counts, jax.Array):
        assert n is not None, "pass n (real column count) with device counts"
        jcounts = counts
        S = counts.shape[0]
    else:
        S, n = counts.shape
        if n == 0:
            return np.zeros((0, S), np.float32), np.zeros(0, np.int64), []
        jcounts, n = upload_counts_sharded(counts, mesh)
    jv = jnp.asarray(np.asarray(v_kmers, np.float32))

    from kmerlsh_tpu.cluster import engine as _eng

    progs = _dist_programs(mesh, exchange_cap, _eng.PERMUTE)
    head = progs[0]
    pulled, rest = _drive(head, (jcounts, jv), mesh, thresholds, seed,
                          exchange_cap, verbose, progs)
    extra = _tail_schedule(rest, thresholds, mesh)
    return _assemble(*pulled[:4], n_rows=n, extra_thresholds=extra,
                     seed=seed + 99_991, verbose=verbose)


def cluster_sharded(
    values,
    sizes=None,
    mesh=None,
    min_similarity: float = 0.8,
    iterations: int = 100,
    seed: int = 0,
    thresholds: np.ndarray | None = None,
    exchange_cap: int = EXCHANGE_CAP,
    verbose: bool = False,
    **_ignored,
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Multi-device version of ``cluster.engine.cluster``: same annealed
    loop (0.95 → min_similarity over ``iterations``, cluster.cc:190-192),
    row axis sharded over ``mesh``. Same output contract."""
    mesh = mesh or make_mesh()
    n_dev = mesh.size
    values = np.asarray(values, dtype=np.float32)
    n, s = values.shape
    if n == 0:
        return np.zeros((0, s), np.float32), np.zeros(0, np.int64), []

    if thresholds is None:
        sim_step = (0.95 - min_similarity) / iterations
        thresholds = (0.95 - sim_step * np.arange(iterations)).astype(
            np.float32)

    c_loc = _local_cap(n, n_dev)
    host_vals = np.zeros((s, n_dev * c_loc), np.float32)
    host_vals[:, :n] = values.T
    host_sizes = np.zeros(n_dev * c_loc, np.int32)
    host_sizes[:n] = (np.asarray(sizes, np.int32) if sizes is not None
                      else np.ones(n, np.int32))
    jvals = _put(mesh, host_vals, P(None, ROWS))
    jsizes = _put(mesh, host_sizes, P(ROWS))

    from kmerlsh_tpu.cluster import engine as _eng

    progs = _dist_programs(mesh, exchange_cap, _eng.PERMUTE)
    head_values = progs[1]
    pulled, rest = _drive(head_values, (jvals, jsizes), mesh, thresholds,
                          seed, exchange_cap, verbose, progs)
    extra = _tail_schedule(rest, thresholds, mesh)
    return _assemble(*pulled[:4], n_rows=n, extra_thresholds=extra,
                     seed=seed + 99_991, verbose=verbose)


def sharded_wrs(mesh, n1: int, n2: int, pval_thresh: float, size_thresh: int):
    """Cluster-sharded WRS verdicts: each device tests its shard of
    clusters; verdict gathering is the only collective."""
    from kmerlsh_tpu.ops import ttest

    def step(values, sizes):
        return ttest.wrs_verdicts(values, sizes, n1, n2, pval_thresh,
                                  size_thresh)

    shmapped = jax.shard_map(
        step, mesh=mesh, in_specs=(P(ROWS, None), P(ROWS)),
        out_specs=P(ROWS), check_vma=False,
    )
    return jax.jit(shmapped)


def shard_rows(mesh, array):
    """Place an [N, ...] array row-sharded on the mesh (N must divide by
    the mesh size; the host pads capacity to a multiple)."""
    spec = P(ROWS, *([None] * (array.ndim - 1)))
    return _put(mesh, np.asarray(array), spec)


def shard_cols(mesh, array):
    """Place an [..., N] array sharded on its LAST axis — the layout of the
    engine's sample-major [S, N] profile matrix (k-mer axis on lanes and
    across devices)."""
    spec = P(*([None] * (array.ndim - 1)), ROWS)
    return _put(mesh, np.asarray(array), spec)

"""Pipeline orchestration: modes K (count) → B (bin) → C (cluster) → E (extract).

Port of ``kmerCluster`` + ``init_clustering`` (app/kmerLSH.cc:278-603) with
the same stage boundaries and on-disk artifacts, so any stage can restart
from files alone (the reference's checkpoint story, SURVEY §5.4):

  K: per-sample KMC database            (external kmc or native counter)
  B: kmer_set.hex + kmer_count.bin + kmer_count.log
  C: tmp/N.bin{,.clust} batch rounds → <clust_file>{,.clust}
  E: <output1>_<basename>, <output2>_<basename> extracted FASTQ

Documented divergences from the reference:
  * global k-mer row order is sorted-canonical-key (deterministic), not
    cuckoo iteration order;
  * cluster output is ordered by smallest member id, ids ascending within a
    line (the reference's order is thread-interleave nondeterministic);
  * ``tmp_dir`` is created if missing (the reference crashes, kmerLSH.cc:326);
  * hyperplanes are seeded (reference: std::random_device).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from kmerlsh_tpu.cluster.groups import Groups, as_groups
from kmerlsh_tpu.config import HyperParams
from kmerlsh_tpu.io import clusterio, counts as countsio, fastq as fastqio, kmc as kmcio
from kmerlsh_tpu.io.samples import get_input
from kmerlsh_tpu.ops import reads as readops, transform, ttest
from kmerlsh_tpu.utils.timing import Stages

# (path, mtime_ns, size, S, kmap_size) → (device counts [S, cap], n);
# bounded to one entry — see _fused_single_batch
_DEVICE_COUNTS_CACHE: dict = {}


def _mesh_or_none():
    """Row-sharding mesh when more than one device is visible (the
    multi-device replacement for the reference's single-process OpenMP:
    the k-mer axis shards over devices, SURVEY §5.7)."""
    import jax

    if jax.device_count() > 1:
        from kmerlsh_tpu.parallel.mesh import make_mesh

        return make_mesh()
    return None


def _cluster_fn(params: HyperParams):
    if params.engine == "greedy":
        from kmerlsh_tpu.cluster import greedy

        def run(values, sizes, iterations, min_similarity, seed,
                half_pull=False):
            del half_pull  # host engine: nothing to pull
            return greedy.cluster(
                values, sizes=sizes, min_similarity=min_similarity,
                iterations=iterations,
                bucket_size_threshold=params.bucket_size_threshold,
                seed=seed, verbose=params.verbose)
    elif _mesh_or_none() is not None:
        from kmerlsh_tpu.parallel import dist

        def run(values, sizes, iterations, min_similarity, seed,
                half_pull=False):
            del half_pull  # sharded pulls are the gathered state, not a buffer
            return dist.cluster_sharded(
                values, sizes=sizes, min_similarity=min_similarity,
                iterations=iterations, seed=seed, verbose=params.verbose)
    else:
        from kmerlsh_tpu.cluster import engine

        def run(values, sizes, iterations, min_similarity, seed,
                transposed=False, half_pull=False):
            # single-iteration batch passes mirror the reference's full
            # greedy bucket collapse (cluster.cc:56-87) with extra pairing
            # rounds: log-depth, no re-sort, so 16 rounds ≈ one greedy pass
            rounds = max(params.merge_rounds, 16) if iterations == 1 \
                else params.merge_rounds
            return engine.cluster(
                values, sizes=sizes, min_similarity=min_similarity,
                iterations=iterations, seed=seed, rounds=rounds,
                verbose=params.verbose, transposed=transposed,
                half_pull=half_pull)

    return run


# on-disk dtype of the INTERNAL tmp-round centroid files (the reference's
# tmp/N.bin, kmerLSH.cc:326-336, which it writes f32). f16 halves the
# dominant out-of-core cost — pulling every batch's survivor centroids to
# the host and re-reading them each merge round — and its ~1e-3 relative
# error is invisible to the 0.8-0.95 cosine thresholds of the merge rounds
# (test_out_of_core_f16_tmp_matches_f32).
# The FINAL <clust_file> binary stays f32 (reference format).
TMP_VALUES_DTYPE = "<f2"

# floor of the merge-round window (rows per merge-round read; the real
# window is half the HBM-sized batch budget — merge rounds run f32 survivor
# sessions at roughly twice the per-row bytes of the uint16 counts session)
MERGE_WINDOW_MIN = 1 << 16


def init_clustering(
    params: HyperParams, kmap_size: int, v_kmers: list[float], stages: Stages,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Out-of-core batched pre-clustering (app/kmerLSH.cc:278-430):
    transform+cluster each 'batch_thresh'-row slice once at threshold 0.95,
    then re-merge tmp files in rounds (similarity − 0.001 per round, 5
    iterations) until ≤ one batch remains. Multi-host: every process
    computes the identical global clustering; tmp artifacts are written by
    process 0 only, with barriers before they are read back.

    Single-chip batch passes pull HALF-precision centroids (engine
    ``half_pull``) and overlap each batch's device→host pull + tmp save
    with the next batch's read + device pass (engine ``defer_pull`` + a
    flush thread). Per-phase device/pull splits accumulate into
    ``stages.times`` (VERDICT r4 #3)."""
    import threading

    from kmerlsh_tpu.parallel import multihost

    cluster = _cluster_fn(params)
    os.makedirs(params.tmp_dir, exist_ok=True)
    bin_path = os.path.join(params.work_dir, countsio.BIN_NAME)
    S = len(v_kmers)
    v = np.asarray(v_kmers, np.float32)

    similarity = params.min_similarity
    batch = params.batch_thresh
    tmp_no = 0
    write_path = os.path.join(params.tmp_dir, f"{tmp_no}.bin")
    seed = params.seed

    def _acc_split(st: dict) -> None:
        for key in ("device_seconds", "pull_seconds"):
            if key in st:
                stages.times[key] = stages.times.get(key, 0.0) + st[key]
        if st.get("pull_bytes"):
            stages.metrics["pull_bytes"] = (
                stages.metrics.get("pull_bytes", 0) + int(st["pull_bytes"]))

    mesh = _mesh_or_none() if params.engine != "greedy" else None
    offset = 0
    state = {"total": 0, "first": True}
    errs: list[BaseException] = []

    def save_batch(cents, groups, ids, stats=None):
        """Translate groups to global ids and append to the tmp round
        files (runs on the flush thread for deferred engine batches)."""
        try:
            if stats is not None:
                _acc_split(stats)
            if isinstance(groups, Groups):
                # engine/dist groups are sorted-within and ``ids`` is
                # monotone, so the translation preserves ascending order
                ids_list = groups.map_ids(ids)
            else:
                ids_list = Groups.from_list(
                    [np.sort(ids[g]) for g in groups], dtype=np.uint64)
            with stages.stage("save_tmp"):
                if multihost.proc0():
                    clusterio.save_result(
                        ids_list, write_path + ".clust",
                        append=not state["first"], ignore_small=0)
                    clusterio.save_binary(
                        cents, ids_list, write_path,
                        append=not state["first"], ignore_small=0,
                        dtype=TMP_VALUES_DTYPE)
            state["total"] += len(ids_list)
            state["first"] = False
        except BaseException as e:  # noqa: BLE001 — re-raised on the driver
            errs.append(e)

    def flush_deferred(finish, stats, ids):
        try:
            cents, _, groups = finish()
        except BaseException as e:  # noqa: BLE001 — re-raised on the driver
            errs.append(e)
            return
        save_batch(cents, groups, ids, stats)

    pending = None        # (finish, stats, ids) of the previous batch
    th = None
    while offset < kmap_size:
        if pending is not None:
            # overlap: the previous batch's pull + tmp save run while this
            # batch reads from disk and executes on device
            th = threading.Thread(target=flush_deferred, args=pending,
                                  daemon=True)
            th.start()
            pending = None
        bs = min(batch, kmap_size - offset)
        with stages.stage("read_batch"):
            cmat = countsio.read_count_batch(bin_path, S, kmap_size, offset, bs)
        if params.verbose:
            print(f"batch @{offset}: {bs} rows")
        if mesh is not None:
            # mesh path: the raw uint16 batch uploads once and the
            # transform+filter run fused inside the sharded head program —
            # no [S, batch] host round trip (filtered rows become dead
            # slots; the batch pass is one iteration at 0.95, kmerLSH.cc:487)
            from kmerlsh_tpu.parallel import dist

            with stages.stage("cluster_batch"):
                cents, _, groups = dist.cluster_counts_sharded(
                    cmat, v, np.asarray([0.95], np.float32), mesh=mesh,
                    seed=seed, verbose=params.verbose)
            ids = (offset + np.arange(bs)).astype(np.uint64)
            if th is not None:
                th.join()
                th = None
            save_batch(cents, groups, ids, dist.LAST_SESSION)
        elif params.engine == "greedy":
            with stages.stage("transform"):
                jvalues_t, keep = transform.abundance_transform_t(cmat, v)
            keep_np = np.asarray(keep)
            values = np.asarray(jvalues_t).T[keep_np]
            ids = (offset + np.nonzero(keep_np)[0]).astype(np.uint64)
            with stages.stage("cluster_batch"):
                cents, _, groups = cluster(values, None, 1, similarity, seed)
            if th is not None:
                th.join()
                th = None
            save_batch(cents, groups, ids)
        else:
            # single chip: the transform fuses into the head program
            # (engine.cluster_counts) exactly like the fused single-batch
            # path — uploading a separate f32 transform output alongside
            # the session working set OOMs at the 2^25 batch budget.
            # iterations=1 ⇒ one deep pass at threshold 0.95 (the
            # reference's init batch semantics, kmerLSH.cc:323,487)
            from kmerlsh_tpu.cluster import engine

            ids = (offset + np.arange(bs)).astype(np.uint64)
            # overlap (defer_pull) only when the batch leaves device-memory
            # headroom for the retained finalize buffer: at a batch sized to
            # the full budget the next session's peak + the deferred buffer
            # would not fit
            from kmerlsh_tpu.utils.hbm import rows_budget

            defer = bs <= rows_budget(S, 1) // 2
            with stages.stage("cluster_batch"):
                out = engine.cluster_counts(
                    cmat, v, np.asarray([0.95], np.float32), seed=seed,
                    rounds=max(params.merge_rounds, 16), deep_init=True,
                    verbose=params.verbose, half_pull=True,
                    defer_pull=defer)
            if th is not None:
                th.join()
                th = None
            if defer:
                finish, stats = out
                pending = (finish, stats, ids)
            else:
                cents, _, groups = out
                save_batch(cents, groups, ids, engine.LAST_SESSION)
        if errs:
            raise errs[0]
        seed += 1
        offset += bs
    if th is not None:
        th.join()
    if pending is not None:
        flush_deferred(*pending)
    if errs:
        raise errs[0]
    total = state["total"]

    # merge rounds operate on survivor VALUES (f32 [n, S] uploads + f32
    # session state — roughly twice the per-row bytes of the uint16 counts
    # sessions the batch budget was sized for), so their window is half the
    # batch budget; observed: a full-budget merge round ResourceExhausts
    # where the same-capacity counts session fits
    vbatch = max(MERGE_WINDOW_MIN, batch // 2)
    while total > vbatch:
        similarity -= 0.001  # kmerLSH.cc:356
        read_path = write_path
        tmp_no += 1
        write_path = os.path.join(params.tmp_dir, f"{tmp_no}.bin")
        remaining, total, start, first = total, 0, 0, True
        multihost.barrier(f"tmp_round_{tmp_no}")   # writes visible before reads
        while start < remaining:
            bs = min(vbatch, remaining - start)
            with stages.stage("read_tmp"):
                values, ids_list = clusterio.read_cluster(
                    read_path, S, start, bs, dtype=TMP_VALUES_DTYPE)
            sizes = ids_list.sizes.astype(np.int32)
            with stages.stage("cluster_merge_round"):
                # merge-round outputs land in f16 tmp files anyway: pull
                # half-precision centroids (engine path only)
                cents, _, groups = cluster(values, sizes, 5, similarity,
                                           seed, half_pull=True)
            if mesh is not None:
                from kmerlsh_tpu.parallel import dist

                _acc_split(dist.LAST_SESSION)
            elif params.engine != "greedy":
                from kmerlsh_tpu.cluster import engine

                _acc_split(engine.LAST_SESSION)
            seed += 1
            out_ids = ids_list.regroup(groups)
            with stages.stage("save_tmp"):
                if multihost.proc0():
                    clusterio.save_result(out_ids, write_path + ".clust",
                                          append=not first, ignore_small=0)
                    clusterio.save_binary(cents, out_ids, write_path,
                                          append=not first, ignore_small=0,
                                          dtype=TMP_VALUES_DTYPE)
            total += len(out_ids)
            start += bs
            first = False
        multihost.barrier(f"tmp_round_{tmp_no}_done")
        if multihost.proc0():
            os.remove(read_path)
            os.remove(read_path + ".clust")

    multihost.barrier("init_clustering_done")
    return clusterio.read_cluster_all(write_path, S, dtype=TMP_VALUES_DTYPE)


def mode_c_schedule(iterations: int, min_similarity: float) -> np.ndarray:
    """Threshold schedule of a single-batch mode-C session: the init pass
    at 0.95 (kmerLSH.cc:487), then the I-step anneal 0.95 → N
    (cluster.cc:190-192)."""
    sim_step = (0.95 - min_similarity) / iterations
    return np.concatenate([
        [0.95], 0.95 - sim_step * np.arange(iterations)]).astype(np.float32)


def _fused_single_batch(
    params: HyperParams, kmap_size: int, v_kmers: list[float], stages: Stages,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Single-batch mode C as ONE device program: transform → one deep init
    iteration at 0.95 → the I-step anneal → root resolution → compaction
    (engine._fused_session). One upload, one dispatch, small pulls."""
    from kmerlsh_tpu.cluster import engine

    bin_path = os.path.join(params.work_dir, countsio.BIN_NAME)
    S = len(v_kmers)
    v = np.asarray(v_kmers, np.float32)
    mesh = _mesh_or_none()
    # device-resident input cache: re-clustering the same count matrix
    # (threshold/iteration sweeps, repeated mode-C restarts) skips the
    # host→device transfer — the dominant cost of a warm session
    st = os.stat(bin_path)
    mesh_id = (tuple(d.id for d in mesh.devices.flat)
               if mesh is not None else None)
    cache_key = (os.path.abspath(bin_path), st.st_mtime_ns, st.st_size,
                 S, kmap_size, mesh_id)
    cached = _DEVICE_COUNTS_CACHE.get(cache_key)
    with stages.stage("read_batch"):
        if cached is None:
            from kmerlsh_tpu.parallel import multihost

            if mesh is not None and multihost.process_count() > 1:
                # multi-host: each process reads only its column slice
                from kmerlsh_tpu.parallel import dist

                jcounts, n = dist.upload_counts_process_local(
                    bin_path, S, kmap_size, mesh)
            elif mesh is not None:
                from kmerlsh_tpu.parallel import dist

                cmat = countsio.read_count_batch(
                    bin_path, S, kmap_size, 0, kmap_size)
                jcounts, n = dist.upload_counts_sharded(cmat, mesh)
            else:
                cmat = countsio.read_count_batch(
                    bin_path, S, kmap_size, 0, kmap_size)
                jcounts, n = engine.upload_counts(cmat)
            _DEVICE_COUNTS_CACHE.clear()   # hold at most one matrix
            _DEVICE_COUNTS_CACHE[cache_key] = (jcounts, n)
        else:
            jcounts, n = cached

    schedule = mode_c_schedule(params.cluster_iteration,
                               params.min_similarity)
    if mesh is not None:
        from kmerlsh_tpu.parallel import dist

        cents, _, groups = dist.cluster_counts_sharded(
            jcounts, v, schedule, mesh=mesh, seed=params.seed,
            verbose=params.verbose, n=n)
        # sharded split covers the whole run incl. the single-device
        # anneal tail (dist.LAST_SESSION folds the tail in — ADVICE r4)
        for key in ("device_seconds", "pull_seconds"):
            if key in dist.LAST_SESSION:
                stages.times[key] = dist.LAST_SESSION[key]
        if "pull_bytes" in dist.LAST_SESSION:
            stages.record("pull_bytes",
                          int(dist.LAST_SESSION["pull_bytes"]))
    else:
        # half_pull: the finalize centroids cross device→host as packed
        # f16 (halves the dominant warm-wall transfer). The saved binary
        # stays f32 BYTES (reference format); its values carry f16
        # precision (one rounding of the final centroids).
        cents, _, groups = engine.cluster_counts(
            jcounts, v, schedule, seed=params.seed,
            rounds=params.merge_rounds, deep_init=True,
            verbose=params.verbose, n=n, half_pull=True)
        # headline split: device program wall vs device→host pulls
        for key in ("device_seconds", "pull_seconds"):
            if key in engine.LAST_SESSION:
                stages.times[key] = engine.LAST_SESSION[key]
        if "pull_bytes" in engine.LAST_SESSION:
            stages.record("pull_bytes", int(engine.LAST_SESSION["pull_bytes"]))
    if isinstance(groups, Groups):
        return cents, groups          # already sorted-within (int64 ids)
    return cents, Groups.from_list([np.sort(g) for g in groups],
                                   dtype=np.uint64)


def kmer_cluster(params: HyperParams) -> Stages:
    """Full pipeline driver (= ``kmerCluster``, app/kmerLSH.cc:432-603)."""
    from kmerlsh_tpu.parallel import multihost
    from kmerlsh_tpu.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    stages = Stages(params.verbose)
    samples1, kmc_names1 = get_input(params.input1)
    samples2, kmc_names2 = get_input(params.input2)
    samples = samples1 + samples2
    kmc_names = kmc_names1 + kmc_names2
    n1, n2 = len(samples1), len(samples2)
    if params.verbose:
        print(f"# samples in group 1: {n1}\n# samples in group 2: {n2}")

    kmap_size: int | None = None
    v_kmers: list[float] | None = None

    if params.kmc:
        with stages.stage("K_kmc"):
            # per-sample counting splits round-robin across processes
            for fq, name in multihost.my_items(list(zip(samples, kmc_names))):
                kmcio.run_kmc(fq, name, params.k, params.count_min,
                              params.threads_to_use, params.max_memory,
                              params.work_dir, params.verbose)
            multihost.barrier("K_kmc")
    if params.bin:
        with stages.stage("B_bin"):
            # shared artifacts (hex/bin/log) are written by process 0 only
            if multihost.proc0():
                kmap_size, v_kmers = countsio.build_count_matrix(
                    kmc_names, params.k, params.work_dir, params.verbose)
            multihost.barrier("B_bin")
            if not multihost.proc0():
                kmap_size, covs = countsio.read_log(
                    os.path.join(params.work_dir, countsio.LOG_NAME))
                v_kmers = [c / kmap_size for c in covs]

    clust_path = params.clust_file_name

    if params.clustering:
        if not params.bin:
            kmap_size, covs = countsio.read_log(
                os.path.join(params.work_dir, countsio.LOG_NAME))
            v_kmers = [c / kmap_size for c in covs]
        # HBM-aware batch size: never let a batch's session exceed device
        # memory (the reference's 1e8 constant assumed host RAM,
        # kmerLSH.cc:285,292-295)
        from kmerlsh_tpu.utils.hbm import rows_budget

        mesh = _mesh_or_none()
        eff_batch = min(params.batch_thresh,
                        rows_budget(len(v_kmers),
                                    mesh.size if mesh is not None else 1,
                                    kmap_size=kmap_size))
        if params.verbose and eff_batch < params.batch_thresh:
            print(f"batch_thresh {params.batch_thresh} -> {eff_batch} "
                  f"(device memory budget)")
        params = dataclasses.replace(params, batch_thresh=eff_batch)
        if params.engine == "tpu" and kmap_size <= params.batch_thresh:
            # fused fast path: the whole matrix fits one batch, so the init
            # pass (1 deep iteration at 0.95) and the final anneal run as a
            # single on-device session — no tmp round trip, no re-upload.
            # (Divergence: tmp/0.bin is not written on this path; mode-C
            # restarts read kmer_count.bin, never tmp files.)
            with stages.stage("C_cluster"):
                cents, final_ids = _fused_single_batch(
                    params, kmap_size, v_kmers, stages)
        else:
            with stages.stage("C_init_clustering"):
                values, ids_list = init_clustering(
                    params, kmap_size, v_kmers, stages)
            ids_list = as_groups(ids_list)
            sizes = ids_list.sizes.astype(np.int32)
            with stages.stage("C_cluster"):
                cents, _, groups = _cluster_fn(params)(
                    values, sizes, params.cluster_iteration,
                    params.min_similarity, params.seed + 10_000)
            final_ids = ids_list.regroup(groups)
        with stages.stage("C_save"):
            if multihost.proc0():
                clusterio.save_result(final_ids, clust_path + ".clust",
                                      ignore_small=params.ignore_small)
                clusterio.save_binary(cents, final_ids, clust_path,
                                      ignore_small=params.ignore_small)
            multihost.barrier("C_save")
        stages.record("clusters", int(np.sum(
            as_groups(final_ids).sizes > params.ignore_small)))

    if params.extracting:
        with stages.stage("E_wrs"):
            values, ids_list = clusterio.read_cluster_all(
                clust_path, len(samples))
            sizes = ids_list.sizes
            mesh = _mesh_or_none()
            if mesh is not None and len(ids_list) >= mesh.size:
                from kmerlsh_tpu.parallel import dist

                pad = -len(ids_list) % mesh.size
                vp = np.pad(values.astype(np.float32), ((0, pad), (0, 0)))
                sp = np.pad(sizes.astype(np.int32), (0, pad))
                fn = dist.sharded_wrs(mesh, n1, n2, params.pval_thresh,
                                      params.size_thresh)
                verdicts = multihost.gather_np(
                    fn(dist.shard_rows(mesh, vp), dist.shard_rows(mesh, sp)))
                verdicts = verdicts[:len(ids_list)]
            else:
                verdicts = np.asarray(ttest.wrs_verdicts(
                    values, sizes, n1, n2, params.pval_thresh,
                    params.size_thresh))
        keys = countsio.read_hex(os.path.join(params.work_dir, countsio.HEX_NAME))
        gids1 = ids_list.select(verdicts == 1).flat.astype(np.int64)
        gids2 = ids_list.select(verdicts == 2).flat.astype(np.int64)
        gk1 = np.sort(keys[gids1]) if len(gids1) else np.empty(0, np.uint64)
        gk2 = np.sort(keys[gids2]) if len(gids2) else np.empty(0, np.uint64)
        if params.verbose:
            print(f"# of differential kmers in group A : {len(gk1)}")
            print(f"# of differential kmers in group B : {len(gk2)}")
        with stages.stage("E_extract"):
            _extract_group(samples1, gk1, params.output1, params)
            _extract_group(samples2, gk2, params.output2, params)
        stages.record("diff_kmers_group1", len(gk1))
        stages.record("diff_kmers_group2", len(gk2))

    return stages


# name of the scorer the most recent _pick_scorer call selected ("native"/
# "device"/"host"); read by bench so the round artifact records what `auto`
# actually chose on the bench host
LAST_SCORER: str | None = None


def _pick_scorer(params: HyperParams):
    """Mode-E read scorer: host NumPy, the native C++ scorer, or the
    on-device kernel (ops/reads.py). All are returned in async form
    (dispatch → zero-arg resolver) so ``_extract_group`` can overlap
    parse/pack with device execution.

    ``auto`` prefers the NATIVE scorer whenever the extension is built
    (see PERF.md for its rate beside the device kernel's on the GPU); the
    device kernel remains an explicit opt-in (``read_scorer="device"``),
    and ``auto`` falls back to it only on an accelerator host without the
    extension (io/ioFastQ.cc:99-103 analog)."""
    global LAST_SCORER

    def sync_async(fn):
        return lambda seqs, dk, k, v: (lambda m=fn(seqs, dk, k, v): m)

    if params.read_scorer == "device":
        LAST_SCORER = "device"
        return readops.score_part_device_async
    if params.read_scorer == "host":
        LAST_SCORER = "host"
        return sync_async(readops.score_part)
    if params.read_scorer == "native":
        LAST_SCORER = "native"
        return sync_async(readops.score_part_native)
    try:
        import _kmerlsh_native  # noqa: F401

        LAST_SCORER = "native"
        return sync_async(readops.score_part_native)
    except ImportError:
        pass
    import jax

    if jax.default_backend() not in ("cpu",):
        LAST_SCORER = "device"
        return readops.score_part_device_async
    LAST_SCORER = "host"
    return sync_async(readops.score_part)


def _extract_group(
    sample_files: list[str], diff_keys: np.ndarray, out_prefix: str,
    params: HyperParams,
) -> None:
    """= ``IOFQ::Extracting`` (io/ioFastQ.cc:161-195): one output file per
    sample named ``{out_prefix}_{basename(sample)}``. Multi-host: samples
    split round-robin across processes (outputs are per-sample files).

    Pipelined three ways: a producer thread parses/decompresses the next
    part while the current one scores, and with the device scorer the
    dispatch for part i+1 is issued before part i's mask is pulled —
    parse, host→device transfer, and device compute all overlap."""
    import queue
    import threading

    from kmerlsh_tpu.parallel import multihost

    score = _pick_scorer(params)
    for path in multihost.my_items(sample_files):
        out = f"{out_prefix}_{os.path.basename(path)}"
        if params.verbose:
            print(f"writing to {out}")
        q: queue.Queue = queue.Queue(maxsize=2)
        prod_err: list[BaseException] = []

        def produce(p=path, q=q):
            # a parse failure (e.g. corrupt FASTQ header) must abort the
            # extraction, not truncate it silently: record the exception
            # and re-raise it on the consumer side after join
            try:
                for part in fastqio.read_parts([p]):
                    q.put(part)
            except BaseException as e:      # noqa: BLE001 — re-raised below
                prod_err.append(e)
            finally:
                q.put(None)

        th = threading.Thread(target=produce, daemon=True)
        th.start()
        with open(out, "wb") as f:
            pending = None                      # (reads, mask resolver)
            while True:
                part = q.get()
                if part is None:
                    break
                resolve = score([r.seq for r in part], diff_keys,
                                params.k, params.kmer_vote)
                if pending is not None:
                    prev_part, prev_resolve = pending
                    mask = prev_resolve()
                    fastqio.write_fastq(
                        f, (r for r, m in zip(prev_part, mask) if m))
                pending = (part, resolve)
            if pending is not None:
                prev_part, prev_resolve = pending
                mask = prev_resolve()
                fastqio.write_fastq(
                    f, (r for r, m in zip(prev_part, mask) if m))
        th.join()
        if prod_err:
            raise prod_err[0]

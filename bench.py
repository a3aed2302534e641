"""Mode-C LSH clustering benchmark on one accelerator, beside the reference.

Every phase runs as a subprocess with its own time box (one process holds
the card at a time; the orchestrator itself never imports JAX). The
orchestrator prints a COMPLETE, cumulative JSON record after every phase,
followed by a compact summary as the last line, so a partial run still
lands its numbers. Every record names the device it ran on: JAX's
``platform``, ``device_kind`` and device count, and the cards' name and
power limit as nvidia-smi reports them. A run that finds no accelerator
fails; it never falls back to the CPU.

Headline workload: 2^24 k-mer rows x 20 samples with an ANNEAL-SENSITIVE
profile hierarchy — row profiles draw from a 3-level similarity tree whose
levels sit at cosine ~ 0.95..0.8, so merging happens throughout the
threshold anneal instead of collapsing in the first greedy pass.  The
reference kmerLSH binary (12 OpenMP threads, built from ``REF_SRC`` into
``REF_BUILD``) runs the identical mode-C workload
(function/cluster.cc:181-340 hot loops) for the baseline; its time is
cached on disk beside the cached binary, and a run killed at its time box
is recorded as a LOWER BOUND.

The headline ``value`` is the WARM device-resident rate (counts already in
device memory); ``cold_seconds`` records the first run including host read,
upload and compilation.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

N_ROWS = int(os.environ.get("KMERLSH_BENCH_ROWS", 1 << 24))
N_SAMPLES = 20
ITERATIONS = 20
MIN_SIM = 0.8
WORK = os.environ.get("KMERLSH_BENCH_WORK", "/tmp/kmerlsh_bench_r3")
REF_BUILD = "/tmp/kmerlsh_refbuild"
REF_SRC = "/root/reference"
TOTAL_BUDGET_S = float(os.environ.get("KMERLSH_BENCH_BUDGET_S", 2700))
_T0 = time.perf_counter()


def remaining() -> float:
    return TOTAL_BUDGET_S - (time.perf_counter() - _T0)


def note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# data generation (cached on disk; identical distribution to the round-2
# bench so numbers stay comparable)
# --------------------------------------------------------------------------

def make_data(n_rows: int, root: str = WORK) -> str:
    """Anneal-sensitive count matrix: profiles from a similarity hierarchy
    (node count ~ n_rows/4 after the first collapse, so every anneal
    iteration still faces live merge work). Written under ``root`` as the
    stage-B artifacts mode C reads (kmer_count.bin/.log + sample lists);
    returns that directory."""
    sub = os.path.join(root, f"c{n_rows >> 20}M" if n_rows >= 1 << 20
                       else f"c{n_rows}")
    os.makedirs(sub, exist_ok=True)
    marker = os.path.join(sub, "kmer_count.bin")
    if os.path.exists(marker):
        return sub
    rng = np.random.default_rng(0)
    S = N_SAMPLES
    # the matrix is written to a temp name and renamed LAST (below), so a
    # kill mid-generation can never leave a half-written dataset that
    # later runs silently benchmark against

    n_base = max(64, n_rows >> 7)
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

    rows = rng.integers(0, len(pool), size=n_rows)
    vals = 4.0 + pool[rows]
    vals += 0.01 * rng.standard_normal((n_rows, S)).astype(np.float32)
    counts = np.clip(np.rint(np.expm1(vals)), 1, 65535).astype(np.uint16)

    cov = np.log(np.maximum(counts, 1).astype(np.float64)).sum(axis=0)
    with open(os.path.join(sub, "kmer_count.log"), "w") as f:
        f.write(str(n_rows))
        for c in cov:
            f.write("\t%f" % c)
    half = S // 2
    for name, rng_ in (("l1", range(half)), ("l2", range(half, S))):
        with open(os.path.join(sub, name), "w") as f:
            for i in rng_:
                f.write(f"s{i}.fastq db{i}\n")
    counts.T.astype("<u2").tofile(marker + ".part")
    os.rename(marker + ".part", marker)   # completeness marker goes last
    return sub


# --------------------------------------------------------------------------
# workers (each runs as `python bench.py --worker NAME` in a subprocess with
# its own timeout; result JSON goes to $KMERLSH_BENCH_OUT)
# --------------------------------------------------------------------------

def _device() -> dict:
    """The device this worker measures on; refuses to measure the CPU."""
    from kmerlsh_tpu.utils.timing import device_record

    dev = device_record()
    if dev["platform"] == "cpu":
        raise SystemExit("bench measures an accelerator; JAX found only "
                         "the CPU")
    return dev


def _worker_mode_c() -> dict:
    """Mode C on the device: one cold run (host read + upload + compile +
    session + save), then warm runs that reuse the device-resident count
    matrix (pipeline._DEVICE_COUNTS_CACHE)."""
    n_rows = int(os.environ["KMERLSH_BENCH_N"])
    sub = os.environ["KMERLSH_BENCH_SUB"]
    dev = _device()
    from kmerlsh_tpu.config import HyperParams
    from kmerlsh_tpu.pipeline import kmer_cluster

    def once(tag: str):
        tmp = os.path.join(sub, f"tmp_{tag}")
        shutil.rmtree(tmp, ignore_errors=True)
        p = HyperParams(
            input1=os.path.join(sub, "l1"), input2=os.path.join(sub, "l2"),
            clust_file_name=os.path.join(sub, f"result_{tag}.txt"),
            tmp_dir=tmp, work_dir=sub,
            cluster_iteration=ITERATIONS, min_similarity=MIN_SIM,
            kmc=False, bin=False, clustering=True, extracting=False, seed=0,
        )
        t0 = time.perf_counter()
        stages = kmer_cluster(p)
        return time.perf_counter() - t0, stages

    cold_s, st = once("cold")
    warm_runs = [once(f"warm{i}") for i in range(2)]
    warm_s, wst = min(warm_runs, key=lambda r: r[0])
    out = {
        "device": dev,
        "rows": n_rows,
        "cold_seconds": round(cold_s, 2),
        "warm_seconds": round(warm_s, 2),
        "read_upload_seconds": round(st.times.get("read_batch", 0.0), 2),
        "save_seconds": round(wst.times.get("C_save", 0.0), 2),
        "clusters": wst.metrics.get("clusters"),
    }
    # engine split: device program wall vs device→host pulls
    for key in ("device_seconds", "pull_seconds"):
        if key in wst.times:
            out[key] = round(wst.times[key], 2)
    if "device_seconds" in out and "pull_seconds" in out:
        out["other_host_seconds"] = round(
            warm_s - out["device_seconds"] - out["pull_seconds"]
            - out["save_seconds"], 2)
    if "pull_bytes" in wst.metrics:
        out["pull_mb"] = round(wst.metrics["pull_bytes"] / 1e6, 1)
    from kmerlsh_tpu.utils.timing import device_memory_stats

    stats = device_memory_stats()
    if "peak_bytes_in_use" in stats:
        out["peak_device_gb"] = round(stats["peak_bytes_in_use"] / 2**30, 2)
    return out


def _worker_reads() -> dict:
    """Mode-E scorer throughput (reads/s): host NumPy, native and
    on-device (io/ioFastQ.cc:31-65 semantics)."""
    dev = _device()
    from kmerlsh_tpu.kmer import codec
    from kmerlsh_tpu.ops import reads as readops

    rng = np.random.default_rng(0)
    k, n_reads, rl = 23, 1 << 16, 150
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = [bases[rng.integers(0, 4, size=rl)].tobytes()
            for _ in range(n_reads)]
    marker = bases[rng.integers(0, 4, size=5000)].tobytes()
    codes, _ = codec.seq_to_codes(marker)
    diff = np.unique(codec.canonical_key(codec.sliding_kmers(codes, k), k))

    out = {"device": dev}
    for name, fn in (("host", readops.score_part),
                     ("native", readops.score_part_native),
                     ("device", readops.score_part_device)):
        fn(seqs[:1024], diff, k, 0.5)      # warm / compile
        t0 = time.perf_counter()
        fn(seqs, diff, k, 0.5)
        out[name] = round(n_reads / (time.perf_counter() - t0), 1)
    return out


def _gen_mode_b_data() -> tuple[str, list[str]]:
    """FASTQ fixture for the K/B benches: 6 samples drawing 150 bp reads
    from a shared 2 Mbp genome, so the canonical union is ~4 M k-mers and
    each sample contributes ~18 M k-mer instances."""
    sub = os.path.join(WORK, "modeB")
    os.makedirs(sub, exist_ok=True)
    n_samples, n_reads, rl = 6, 120_000, 150
    fastqs = [os.path.join(sub, f"s{i}.fastq") for i in range(n_samples)]
    if not os.path.exists(os.path.join(sub, "l2")):
        rng = np.random.default_rng(7)
        bases = np.frombuffer(b"ACGT", np.uint8)
        genome = bases[rng.integers(0, 4, size=1 << 21)]
        for i, fq in enumerate(fastqs):
            starts = rng.integers(0, len(genome) - rl, size=n_reads)
            reads = genome[starts[:, None] + np.arange(rl)]
            qual = np.full(rl, ord("I"), np.uint8).tobytes().decode()
            with open(fq, "w") as f:
                for j in range(n_reads):
                    f.write(f"@s{i}r{j}\n{reads[j].tobytes().decode()}\n"
                            f"+\n{qual}\n")
        half = n_samples // 2
        for name, idxs in (("l1", range(half)), ("l2", range(half, n_samples))):
            with open(os.path.join(sub, name), "w") as f:
                for i in idxs:
                    f.write(f"{fastqs[i]} {os.path.join(sub, f'db{i}')}\n")
    return sub, fastqs


def _worker_mode_kb() -> dict:
    """Mode K (native k-mer counting from FASTQ) and mode B (KMC-db union +
    count-matrix build) throughput; the orchestrator separately times the
    reference binary's ``-M B --only`` on the same databases."""
    from kmerlsh_tpu.io import counts as countsio, kmc as kmcio
    from kmerlsh_tpu.io.samples import get_input
    from kmerlsh_tpu.utils.timing import device_record

    sub, fastqs = _gen_mode_b_data()
    k = 23
    _, dbs1 = get_input(os.path.join(sub, "l1"))
    _, dbs2 = get_input(os.path.join(sub, "l2"))
    dbs = dbs1 + dbs2

    t0 = time.perf_counter()
    for fq, db in zip(fastqs, dbs):
        kmcio.run_kmc(fq, db, k, count_min=1, threads=2, max_memory_gb=8,
                      work_dir=sub, verbose=False)
    t_k = time.perf_counter() - t0
    # k-mer instances processed in mode K = reads * (rl - k + 1) per sample
    instances = sum(1 for _ in fastqs) * 120_000 * (150 - k + 1)

    records = 0
    for db in dbs:
        keys, _, _ = kmcio.read_db(db)
        records += len(keys)

    t0 = time.perf_counter()
    countsio.build_count_matrix(dbs, k, sub, verbose=False)
    t_b = time.perf_counter() - t0
    return {
        "device": device_record(),
        "k_count_seconds": round(t_k, 2),
        "k_count_kmer_instances_per_s": round(instances / t_k, 1),
        "b_seconds": round(t_b, 2),
        "b_db_records": records,
        "b_db_records_per_s": round(records / t_b, 1),
        "workdir": sub,
    }


def _prep_mode_e_artifacts() -> tuple[str, int, int]:
    """Deterministic mode-E workload on the modeB fixture: stage-B artifacts
    plus a synthesized cluster file with two large group-differential
    clusters (one per tail) and a tail of small untested ones. Both
    implementations then run the IDENTICAL `-M E --only` job. Returns
    (workdir, total_reads, kmap)."""
    from kmerlsh_tpu.cluster.groups import Groups
    from kmerlsh_tpu.io import clusterio, counts as countsio

    sub, fastqs = _gen_mode_b_data()
    log_path = os.path.join(sub, "kmer_count.log")
    if not os.path.exists(log_path):
        from kmerlsh_tpu.io.samples import get_input

        _, dbs1 = get_input(os.path.join(sub, "l1"))
        _, dbs2 = get_input(os.path.join(sub, "l2"))
        countsio.build_count_matrix(dbs1 + dbs2, 23, sub, verbose=False)
    kmap, _ = countsio.read_log(log_path)

    clust = os.path.join(sub, "clust_e.txt")
    if not os.path.exists(clust + ".clust"):
        big = 100_000
        n_small, small_sz = 1000, 10
        ids = [np.arange(big, dtype=np.uint64),
               np.arange(big, 2 * big, dtype=np.uint64)]
        base = 2 * big
        for i in range(n_small):
            ids.append(np.arange(base + i * small_sz,
                                 base + (i + 1) * small_sz, dtype=np.uint64))
        groups = Groups.from_list(ids, dtype=np.uint64)
        # centroids: per-sample values; group A = first 3 samples. Cluster 0
        # high in A (righttail → group1), cluster 1 high in B (lefttail).
        cents = np.ones((2 + n_small, 6), np.float32)
        cents[0] = [5.0, 5.1, 4.9, 1.0, 1.1, 0.9]
        cents[1] = [1.0, 1.1, 0.9, 5.0, 5.1, 4.9]
        clusterio.save_result(groups, clust + ".clust")
        clusterio.save_binary(cents, groups, clust)
    return sub, 6 * 120_000, kmap


def _worker_mode_e() -> dict:
    """Mode E end-to-end (WRS + extraction over every FASTQ) with our
    pipeline; the orchestrator times the reference binary on the SAME
    artifacts (io/ioFastQ.cc:78-158 + funcAB.cc:73-108 head-to-head)."""
    dev = _device()
    from kmerlsh_tpu.config import HyperParams
    from kmerlsh_tpu.pipeline import kmer_cluster

    sub, total_reads, _ = _prep_mode_e_artifacts()
    out = {"device": dev}
    for scorer in ("native", "host"):
        p = HyperParams(
            input1=os.path.join(sub, "l1"), input2=os.path.join(sub, "l2"),
            output1=os.path.join(sub, f"e_{scorer}_A"),
            output2=os.path.join(sub, f"e_{scorer}_B"),
            clust_file_name=os.path.join(sub, "clust_e.txt"),
            tmp_dir=os.path.join(sub, "tmp"), work_dir=sub, k=23,
            size_thresh=50_000, read_scorer=scorer,
            kmc=False, bin=False, clustering=False, extracting=True,
        )
        t0 = time.perf_counter()
        kmer_cluster(p)
        dt = time.perf_counter() - t0
        out[f"{scorer}_seconds"] = round(dt, 2)
        out[f"{scorer}_reads_per_s"] = round(total_reads / dt, 1)
    # what would `auto` have picked on this host? (VERDICT r4 #4)
    import dataclasses

    from kmerlsh_tpu import pipeline

    pipeline._pick_scorer(dataclasses.replace(p, read_scorer="auto"))
    out["auto_scorer"] = pipeline.LAST_SCORER
    out["total_reads"] = total_reads
    out["workdir"] = sub
    return out


def reference_mode_e(workdir: str, total_reads: int,
                     box_s: float) -> dict | None:
    """Time the reference binary's ``-M E --only`` on the same artifacts."""
    cache = os.path.join(REF_BUILD, "baseline_modeE.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    binary = _build_reference()
    if binary is None:
        return None
    refdir = os.path.join(workdir, "ref_e")
    os.makedirs(refdir, exist_ok=True)
    for f in ("kmer_set.hex", "kmer_count.bin", "kmer_count.log",
              "clust_e.txt", "clust_e.txt.clust"):
        shutil.copy(os.path.join(workdir, f), os.path.join(refdir, f))
    try:
        t0 = time.perf_counter()
        subprocess.run(
            [binary, "-a", os.path.join(workdir, "l1"),
             "-b", os.path.join(workdir, "l2"),
             "-o", os.path.join(refdir, "eA"),
             "-p", os.path.join(refdir, "eB"),
             "-M", "E", "--only", "-F", "clust_e.txt", "-K", "23",
             "-S", "50000", "-T", "12"],
            cwd=refdir, check=True, capture_output=True, timeout=box_s)
        dt = time.perf_counter() - t0
        result = {"seconds": round(dt, 2),
                  "reads_per_s": round(total_reads / dt, 1), "threads": 12}
        with open(cache, "w") as f:
            json.dump(result, f)
        return result
    except Exception as e:
        note(f"reference mode E unavailable: {e}")
        return None


WORKERS = {
    "mode_c": _worker_mode_c,
    "reads": _worker_reads,
    "mode_kb": _worker_mode_kb,
    "mode_e": _worker_mode_e,
}


def run_worker(name: str, timeout_s: float, **env_vals) -> dict | None:
    """Run one phase in a subprocess with its own timeout; None on any
    failure (logged, never fatal)."""
    out_path = os.path.join(WORK, f"out_{name}.json")
    try:
        os.remove(out_path)
    except OSError:
        pass
    env = dict(os.environ)
    env["KMERLSH_BENCH_OUT"] = out_path
    env.update({f"KMERLSH_BENCH_{k.upper()}": str(v)
                for k, v in env_vals.items()})
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", name],
            timeout=timeout_s, env=env, capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if r.returncode != 0:
            note(f"{name} worker rc={r.returncode}: {r.stderr[-400:]}")
        with open(out_path) as f:
            return json.load(f)
    except subprocess.TimeoutExpired:
        note(f"{name} worker exceeded its {timeout_s:.0f}s box; skipped")
    except Exception as e:
        note(f"{name} worker unavailable: {e}")
    return None


# --------------------------------------------------------------------------
# reference baseline (built + measured at most once ever; time-boxed with a
# lower-bound model on overrun)
# --------------------------------------------------------------------------

def _build_reference() -> str | None:
    binary = os.path.join(REF_BUILD, "kmerLSH")
    if os.path.exists(binary):
        return binary
    try:
        shutil.copytree(REF_SRC, REF_BUILD, dirs_exist_ok=True)
        subprocess.run(["make", "-j4"], cwd=REF_BUILD, check=True,
                       capture_output=True, timeout=1200)
        return binary
    except Exception as e:
        note(f"reference build failed: {e}")
        return None


def reference_mode_c(sub: str, box_s: float, n_rows: int = N_ROWS,
                     threads: int = 12) -> dict | None:
    """Time the reference binary's mode C on the same matrix.  On overrun:
    kill it, parse ``Iteration:`` progress from --verbose stdout, and
    record the elapsed time as a LOWER BOUND (the remaining iterations are
    treated as free), so speedups computed against it are conservative.

    A completed measurement caches forever; a lower-bound (killed) one
    caches PROVISIONALLY and is re-attempted whenever a later run brings a
    bigger time box than the recorded elapsed time."""
    tag = f"c{n_rows >> 20}M" + (f"_t{threads}" if threads != 12 else "")
    cache = os.path.join(REF_BUILD, f"baseline_{tag}.json")
    cache_lb = os.path.join(REF_BUILD, f"baseline_{tag}_lower.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    prov = None
    if os.path.exists(cache_lb):
        with open(cache_lb) as f:
            prov = json.load(f)
        if box_s <= prov["seconds"] + 60:
            return prov          # no chance of beating the recorded bound
    binary = _build_reference()
    if binary is None:
        return prov
    os.makedirs(os.path.join(sub, "tmp"), exist_ok=True)
    lines: list[str] = []
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [binary, "-a", "l1", "-b", "l2", "-o", "oA", "-p", "oB",
         "-M", "C", "--only", "-I", str(ITERATIONS), "-N", str(MIN_SIM),
         "-T", str(threads), "-F", "ref_result.txt", "--verbose"],
        cwd=sub, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def pump():
        for line in proc.stdout:
            lines.append(line)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        proc.wait(timeout=box_s)
        elapsed = time.perf_counter() - t0
        th.join(timeout=5)
        if proc.returncode != 0:
            # a crashed reference must never be cached as a baseline
            note(f"reference mode C rc={proc.returncode}: "
                 f"{''.join(lines)[-400:]}")
            return prov
        result = {"seconds": round(elapsed, 2), "lower_bound": False,
                  "threads": threads, "host_cores": os.cpu_count()}
        with open(cache, "w") as f:
            json.dump(result, f)
        return result
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        elapsed = time.perf_counter() - t0
        th.join(timeout=5)
        iters = sum(1 for ln in lines if ln.startswith("Iteration:"))
        result = {
            "seconds": round(elapsed, 2), "lower_bound": True,
            "iterations_done": iters, "iterations_total": ITERATIONS,
            "threads": threads, "host_cores": os.cpu_count(),
            "model": (f"killed at the {box_s:.0f}s box after {iters}/"
                      f"{ITERATIONS} anneal iterations; 'seconds' is the "
                      "elapsed lower bound (remaining iterations treated "
                      "as free), so vs_baseline UNDERSTATES the speedup"),
        }
        if prov is None or result["seconds"] > prov["seconds"]:
            with open(cache_lb, "w") as f:
                json.dump(result, f)
        return result


def reference_mode_b(workdir: str, records: int, box_s: float) -> dict | None:
    """Time the reference binary's ``-M B --only`` over the same KMC
    databases the mode_kb worker built (kmer/kmc_reader.cc:11,96 path)."""
    cache = os.path.join(REF_BUILD, "baseline_modeB.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    binary = _build_reference()
    if binary is None:
        return None
    refdir = os.path.join(workdir, "ref_run")
    os.makedirs(refdir, exist_ok=True)
    try:
        t0 = time.perf_counter()
        subprocess.run(
            [binary, "-a", os.path.join(workdir, "l1"),
             "-b", os.path.join(workdir, "l2"), "-o", "oA", "-p", "oB",
             "-M", "B", "--only", "-T", "12", "-K", "23"],
            cwd=refdir, check=True, capture_output=True, timeout=box_s)
        dt = time.perf_counter() - t0
        result = {"seconds": round(dt, 2),
                  "db_records_per_s": round(records / dt, 1)}
        with open(cache, "w") as f:
            json.dump(result, f)
        return result
    except Exception as e:
        note(f"reference mode B unavailable: {e}")
        return None


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------

def _compact(results: dict) -> dict:
    """Distill the cumulative record into a ≤1 kB headline summary (the
    last printed line must parse even when only a 2 kB tail is kept)."""
    c: dict = {"metric": results.get("metric"),
               "value": results.get("value"),
               "unit": results.get("unit"),
               "vs_baseline": results.get("vs_baseline")}
    for k in ("vs_baseline_cold", "reference_seconds",
              "reference_12core_model_seconds", "vs_12core_model",
              "vs_12core_model_device", "device_rows_per_s"):
        if k in results:
            c[k] = results[k]
    mc = results.get("mode_c") or {}
    dev = results.get("device") or {}
    for k in ("platform", "kind", "count", "name_power_limit"):
        if k in dev:
            c[f"device_{k}"] = dev[k]
    for k in ("warm_seconds", "cold_seconds", "device_seconds",
              "pull_seconds", "save_seconds", "clusters", "pull_mb"):
        if k in mc:
            c[k] = mc[k]
    kb = results.get("mode_kb") or {}
    if "b_vs_reference" in kb:
        c["mode_b_vs_ref"] = kb["b_vs_reference"]
    me = results.get("mode_e") or {}
    for src, dst in (("e_vs_reference", "mode_e_vs_ref"),
                     ("native_reads_per_s", "mode_e_native_reads_per_s"),
                     ("auto_scorer", "mode_e_auto_scorer")):
        if src in me:
            c[dst] = me[src]
    blob = json.dumps(c)
    while len(blob) > 1000 and len(c) > 4:     # hard cap, drop extras
        c.popitem()
        blob = json.dumps(c)
    return c


def main() -> None:
    os.makedirs(WORK, exist_ok=True)
    results: dict = {
        "metric": f"mode_C_cluster_{N_ROWS >> 20}Mx{N_SAMPLES}_I{ITERATIONS}",
        "value": None,
        "unit": "kmer_rows/s",
        "vs_baseline": None,
    }

    def emit():
        # full cumulative record first, then a compact (≤1 kB) summary as
        # the LAST line, so a reader that keeps only the tail of the output
        # still gets the headline fields
        print(json.dumps(results), flush=True)
        print(json.dumps(_compact(results)), flush=True)

    note(f"budget {TOTAL_BUDGET_S:.0f}s; generating data ({N_ROWS} rows)")
    sub = make_data(N_ROWS)
    note(f"data ready at {sub} ({remaining():.0f}s left)")

    # ---- phase 1: mode-C headline on the device ---------------------------
    mode_c = run_worker("mode_c", max(300.0, min(remaining() - 480, 1500)),
                        n=N_ROWS, sub=sub)
    if mode_c is None:
        note("mode-C worker failed; no headline")
        emit()
        sys.exit(1)
    results["device"] = mode_c["device"]
    results["value"] = round(N_ROWS / mode_c["warm_seconds"], 1)
    results["mode_c"] = mode_c
    if mode_c.get("device_seconds"):
        results["device_rows_per_s"] = round(
            N_ROWS / mode_c["device_seconds"], 1)
    results["note"] = (
        "value = warm device-resident rate (counts already in device "
        "memory); cold_seconds includes host read, upload and compilation; "
        "device_seconds/pull_seconds split device programs from "
        "device-to-host transfers")
    emit()

    # ---- phase 2: reference baseline (same row count as the headline) -----
    if remaining() > 240:
        ref = reference_mode_c(sub, box_s=max(120.0, min(remaining() - 420,
                                                         1500)),
                               n_rows=N_ROWS)
        if ref:
            results["reference"] = ref
            results["reference_seconds"] = ref["seconds"]
            results["vs_baseline"] = round(
                ref["seconds"] / mode_c["warm_seconds"], 3)
            results["vs_baseline_cold"] = round(
                ref["seconds"] / mode_c["cold_seconds"], 3)
            # fair-hardware model: the reference on 12 real cores by
            # perfect-linear per-core scaling of the measured run (the
            # most conservative assumption FOR US)
            cores = ref.get("host_cores") or os.cpu_count()
            model_12c = ref["seconds"] * cores / max(ref["threads"], 1)
            results["reference_12core_model_seconds"] = round(model_12c, 1)
            results["vs_12core_model"] = round(
                model_12c / mode_c["warm_seconds"], 3)
            if mode_c.get("device_seconds"):
                results["vs_12core_model_device"] = round(
                    model_12c / mode_c["device_seconds"], 3)
            results["vs_baseline_context"] = (
                f"reference ran {ref['threads']} threads on {cores} physical "
                "cores; *_12core_model assumes perfect linear scaling to 12 "
                "cores")
            if ref.get("lower_bound"):
                results["vs_baseline_note"] = ref["model"]
        emit()
    else:
        note("skipping reference baseline: out of budget")

    # ---- phase 3: extras ---------------------------------------------------
    if remaining() > 360:
        kb = run_worker("mode_kb", min(remaining() - 240, 900))
        if kb:
            results["mode_kb"] = kb
            refb = reference_mode_b(kb["workdir"], kb["b_db_records"],
                                    box_s=min(remaining() - 120, 600))
            if refb:
                results["mode_kb"]["reference_b_seconds"] = refb["seconds"]
                results["mode_kb"]["b_vs_reference"] = round(
                    refb["seconds"] / kb["b_seconds"], 3)
        emit()
    else:
        note("skipping mode K/B bench: out of budget")

    # ---- phase 4: mode E head-to-head --------------------------------------
    if remaining() > 300:
        mode_e = run_worker("mode_e", min(remaining() - 180, 600))
        if mode_e:
            results["mode_e"] = mode_e
            refe = reference_mode_e(mode_e["workdir"],
                                    mode_e["total_reads"],
                                    box_s=min(remaining() - 90, 600))
            if refe:
                results["mode_e"]["reference_seconds"] = refe["seconds"]
                results["mode_e"]["reference_reads_per_s"] = \
                    refe["reads_per_s"]
                results["mode_e"]["e_vs_reference"] = round(
                    refe["seconds"] / mode_e["native_seconds"], 3)
        emit()
    else:
        note("skipping mode E bench: out of budget")

    if remaining() > 240:
        reads = run_worker("reads", min(remaining() - 120, 420))
        if reads:
            results["mode_e_scorer_reads_per_s"] = reads
        emit()
    else:
        note("skipping read-scoring bench: out of budget")


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        result = WORKERS[sys.argv[2]]()
        with open(os.environ["KMERLSH_BENCH_OUT"], "w") as f:
            json.dump(result, f)
    else:
        main()

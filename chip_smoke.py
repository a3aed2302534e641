#!/usr/bin/env python3
"""Smoke test of kmerlsh on an NVIDIA GPU: the main path, end to end,
checked against plain references.

    python chip_smoke.py               # one card
    python chip_smoke.py --devices 4   # the sharded mode-C path on four cards

With one card it runs, each phase in its own child process:

  env       JAX's default backend must be ``gpu``; prints ``jax.devices()``.
            Then the native extension is rebuilt from native/_native.cc and
            must import.
  pipeline  modes K → B → C → E through the ``kmerlsh`` CLI on the
            kmerlsh_tpu.testdata fixture; planted-marker recall ≥ 0.8 per
            group.
  mode_c    mode C through ``pipeline.kmer_cluster`` at 2^24 rows × 20
            samples (bench.make_data), one cold and one warm run; the saved
            output must partition the kept rows, carry correct centroids,
            and be identical cold and warm.
  parity    device results against plain references: LSH keys vs an f64
            NumPy projection, the engine on the GPU vs the same engine on
            the CPU, the t-test vs scipy, the device read scorer vs the
            native one.
  pytest    the tests marked ``gpu`` and the engine tests that compare with
            the greedy oracle, on the card (``pytest --on-gpu``).

With ``--devices 4`` it runs only the sharded path and what it is compared
with: mode C at 2^24 × 20 through ``kmer_cluster`` on a 4-card mesh, the
same data on card 0 alone, and ``__graft_entry__.dryrun_multichip(4)``.

The parent never imports JAX, so only one process holds a card at a time.
Any failed check exits non-zero and prints no result line; on success the
last line is ``{"ok": true, "device": {...}}`` as JAX reports the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import sysconfig
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TIME_LIMIT_S = 1150          # whole run, compilation included

MODE_C_ROWS = 1 << 24        # bench.make_data sizes (bench.py)
MODE_C_SAMPLES = 20
MODE_C_ITERS = 20
MODE_C_MIN_SIM = 0.80
CENTROID_CHECKS = 1000
LSH_ROWS = 1 << 20
ENGINE_PARITY_ROWS = 1 << 18
ENGINE_PARITY_SHARE = 0.02   # GPU vs CPU cluster count
MULTICHIP_SHARE = 0.02       # 4-card vs 1-card cluster count
TTEST_CLUSTERS = 100_000
SCORER_READS = 1 << 16

# f16 unit roundoff: one rounding moves a value by at most F16_U·|x|
F16_U = 2.0 ** -11
# f32 product at HIGHEST precision: error ≤ S·2^-24·Σ|h_i·x_i| ≤ 6e-6·Σ for
# S ≤ 100; a key bit may differ from the f64 sign only below this bound
LSH_NEAR_ZERO = 1e-5
# t-test p-values vs scipy: the device computes the statistic and the
# regularized incomplete beta in f32 (continued fraction), good to ~1e-4
TTEST_ATOL = 1e-3

CHILD_BOX_S = {"env": 240, "pipeline": 420, "mode_c": 600, "parity": 420,
               "pytest": 600, "multichip": 1000}


class SmokeError(Exception):
    """A failed check."""


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of a passing run. Refuses any platform but the GPU:
    a CPU run proves nothing about the card."""
    if platform != "gpu":
        raise SmokeError(f"platform {platform!r} is not a GPU")
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": int(count)}})


# --------------------------------------------------------------------------
# checks (pure: NumPy in, stats out, SmokeError on failure)
# --------------------------------------------------------------------------

def check_partition(groups, kept: np.ndarray) -> dict:
    """Every kept row in exactly one cluster, no other row anywhere, and
    the cluster sizes summing to the kept rows."""
    flat = np.asarray(groups.flat, np.int64)
    n_kept = int(kept.sum())
    if int(groups.sizes.sum()) != n_kept or len(flat) != n_kept:
        raise SmokeError(f"cluster sizes sum to {int(groups.sizes.sum())}, "
                         f"{len(flat)} ids listed, {n_kept} rows kept")
    if flat.min(initial=0) < 0 or flat.max(initial=-1) >= len(kept):
        raise SmokeError("cluster ids outside the row range")
    if not kept[flat].all():
        raise SmokeError("a filtered row is in a cluster")
    if len(np.unique(flat)) != n_kept:
        raise SmokeError("a row is in more than one cluster")
    return {"clusters": len(groups), "rows": n_kept}


def centroid_roundings(permute: str, iterations: int) -> int:
    """How many f16 roundings a saved centroid can carry: the final pull
    always packs f16 pairs; under ``payload_sort_f16`` every iteration's
    sort rounds the merged means again (≤ one merge level per iteration
    plus the init pass)."""
    return iterations + 2 if permute == "payload_sort_f16" else 1


def check_centroids(centroids: np.ndarray, groups, counts_sm, v: np.ndarray,
                    idx: np.ndarray, roundings: int) -> dict:
    """Saved centroid vs the f64 host mean of its members' log1p(c) − v
    rows, for the clusters ``idx``. Tolerance, relative to the members'
    largest |value| (every mean stays within it): ``roundings`` f16
    roundings, plus the f32 error of summing the cluster's n members
    (4·n·2^-24), plus 1e-6."""
    worst = 0.0
    for i in idx:
        ids = np.asarray(groups[int(i)], np.int64)
        rows = np.log1p(counts_sm[:, ids].astype(np.float64)) - v[:, None]
        want = rows.mean(axis=1)
        tol = ((roundings * F16_U + 4 * len(ids) * 2.0 ** -24)
               * np.abs(rows).max() + 1e-6)
        err = np.abs(centroids[int(i)].astype(np.float64) - want).max()
        if err > tol:
            raise SmokeError(f"cluster {int(i)} ({len(ids)} rows): centroid "
                             f"off by {err:.3g} > tolerance {tol:.3g}")
        worst = max(worst, err / tol)
    return {"checked": len(idx), "worst_err_over_tol": worst}


def check_mode_c_output(work_dir: str, clust_path: str, num_samples: int,
                        iterations: int, permute: str,
                        n_check: int = CENTROID_CHECKS, seed: int = 0) -> dict:
    """Check one mode-C result (``<clust_path>`` + ``.clust``, saved with
    ignore_small = 0) against the stage-B artifacts in ``work_dir``."""
    from kmerlsh_tpu.io import clusterio, counts as countsio

    kmap, covs = countsio.read_log(os.path.join(work_dir, countsio.LOG_NAME))
    counts = np.fromfile(os.path.join(work_dir, countsio.BIN_NAME),
                         dtype="<u2").reshape(num_samples, kmap)
    v = np.asarray([c / kmap for c in covs], np.float64)
    kept = counts.sum(axis=0, dtype=np.int64) > 0.1 * num_samples
    centroids, groups = clusterio.read_cluster_all(clust_path, num_samples)
    out = check_partition(groups, kept)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(groups), size=min(n_check, len(groups)),
                     replace=False)
    out.update(check_centroids(centroids, groups, counts, v, idx,
                               centroid_roundings(permute, iterations)))
    return out


def check_keys_against_f64(keys: np.ndarray, proj: np.ndarray,
                           hyper: np.ndarray, values_t: np.ndarray,
                           h: int) -> dict:
    """Device LSH keys vs the sign of an f64 projection through the SAME
    (f32) hyperplanes: a bit may differ only where |p| ≤ LSH_NEAR_ZERO ·
    Σ|h_i·x_i|; the secondary projection within that bound."""
    h64, x64 = hyper.astype(np.float64), values_t.astype(np.float64)
    p = h64.T @ x64                                   # [H_MAX + 1, M]
    scale = np.abs(h64).T @ np.abs(x64)
    near = np.abs(p) <= LSH_NEAR_ZERO * scale
    keys = keys.astype(np.int64)
    bad_bits = near_bits = 0
    for i in range(h):
        dev_bit = (keys >> (h - 1 - i)) & 1
        ref_bit = (p[i] >= 0).astype(np.int64)
        diff = dev_bit != ref_bit
        if (diff & ~near[i]).any():
            bad_bits += int((diff & ~near[i]).sum())
        near_bits += int(diff.sum())
    if bad_bits:
        raise SmokeError(f"{bad_bits} LSH key bits differ from the f64 "
                         "sign away from zero")
    perr = np.abs(proj.astype(np.float64) - p[-1])
    if (perr > LSH_NEAR_ZERO * scale[-1] + 1e-30).any():
        raise SmokeError("secondary projection off beyond the f32 bound")
    return {"rows": keys.shape[0], "bits": h,
            "bits_differing_near_zero": near_bits,
            "max_proj_err_over_bound": float(
                (perr / (LSH_NEAR_ZERO * scale[-1] + 1e-30)).max())}


def membership_agreement(groups_a, groups_b, n: int) -> float:
    """Share of the clustered rows whose cluster has exactly the same
    members in both results."""
    lab_b = np.full(n, -1, np.int64)
    lab_b[np.asarray(groups_b.flat, np.int64)] = np.repeat(
        np.arange(len(groups_b)), groups_b.sizes)
    flat_a = np.asarray(groups_a.flat, np.int64)
    gid_a = np.repeat(np.arange(len(groups_a)), groups_a.sizes)
    lb = lab_b[flat_a]
    lo = np.full(len(groups_a), np.iinfo(np.int64).max)
    hi = np.full(len(groups_a), -2)
    np.minimum.at(lo, gid_a, lb)
    np.maximum.at(hi, gid_a, lb)
    size_b = np.append(groups_b.sizes, 0)
    same = (lo == hi) & (lo >= 0) & (size_b[np.clip(lo, -1, None)]
                                     == groups_a.sizes)
    return float(groups_a.sizes[same].sum() / max(len(flat_a), 1))


# --------------------------------------------------------------------------
# phases (run in a child process that holds the card)
# --------------------------------------------------------------------------

def _say(msg: str) -> None:
    print(msg, flush=True)


def phase_env(devices: int) -> dict:
    import jax

    from kmerlsh_tpu.utils.timing import device_record

    _say(f"jax {jax.__version__} devices: {jax.devices()}")
    dev = device_record()
    if dev["platform"] != "gpu":
        raise SmokeError(f"JAX found no GPU (platform {dev['platform']!r})")
    if dev["count"] != devices:
        raise SmokeError(f"{dev['count']} GPUs visible, expected {devices}")
    return dev


def _marker_keys(markers, k: int) -> np.ndarray:
    from kmerlsh_tpu.kmer import codec

    keys = []
    for seq in markers:
        codes, _ = codec.seq_to_codes(seq.encode())
        keys.append(codec.canonical_key(codec.sliding_kmers(codes, k), k))
    return np.unique(np.concatenate(keys))


def phase_pipeline() -> dict:
    """K → B → C → E through the CLI on the testdata fixture (the
    parameters of tests/test_pipeline.py; the reference's default
    S = 500 000 would leave this small fixture with no tested cluster)."""
    from kmerlsh_tpu import cli, testdata
    from kmerlsh_tpu.io import clusterio, counts as countsio
    from kmerlsh_tpu.io.samples import get_input
    from kmerlsh_tpu.ops import ttest

    k, size_thresh, pval = 15, 20, 0.01
    with tempfile.TemporaryDirectory(prefix="kmerlsh_smoke_") as tmp:
        m = testdata.generate(os.path.join(tmp, "data"), seed=99)
        clust = os.path.join(tmp, "clustering_result.txt")
        argv = ["-a", m["lists"]["A"], "-b", m["lists"]["B"],
                "-o", os.path.join(tmp, "outA"),
                "-p", os.path.join(tmp, "outB"),
                "-K", str(k), "-I", "15", "-N", "0.85",
                "-S", str(size_thresh), "-P", str(pval), "-V", "0.5",
                "-C", "2", "--seed", "5", "--work-dir", tmp,
                "-F", clust, "-D", os.path.join(tmp, "tmp")]
        t0 = time.perf_counter()
        cli.main(argv)
        wall = time.perf_counter() - t0

        keys = countsio.read_hex(os.path.join(tmp, countsio.HEX_NAME))
        s1, _ = get_input(m["lists"]["A"])
        s2, _ = get_input(m["lists"]["B"])
        values, ids = clusterio.read_cluster_all(clust, len(s1) + len(s2))
        verdicts = np.asarray(ttest.wrs_verdicts(
            values, ids.sizes, len(s1), len(s2), pval, size_thresh))
        recall = {}
        for g, group in (("A", 1), ("B", 2)):
            got = keys[ids.select(verdicts == group).flat.astype(np.int64)]
            mk = _marker_keys(m["markers"][g], k)
            mk = mk[np.isin(mk, keys)]
            recall[g] = float(np.isin(mk, got).mean()) if len(mk) else 0.0
            for fq in m["samples"][g]:
                out = os.path.join(tmp, f"out{g}_{os.path.basename(fq)}")
                if not os.path.getsize(out):
                    raise SmokeError(f"mode E wrote no reads to {out}")
    _say(f"pipeline K->B->C->E: {wall:.3f} s, {len(ids)} clusters, "
         f"marker recall A {recall['A']:.3f} B {recall['B']:.3f} "
         "(must be >= 0.8)")
    if min(recall.values()) < 0.8:
        raise SmokeError(f"marker recall {recall} below 0.8")
    return {"wall_s": wall, "recall": recall}


def _mode_c_params(sub: str, tag: str):
    from kmerlsh_tpu.config import HyperParams

    return HyperParams(
        input1=os.path.join(sub, "l1"), input2=os.path.join(sub, "l2"),
        clust_file_name=os.path.join(sub, f"result_{tag}.txt"),
        tmp_dir=os.path.join(sub, f"tmp_{tag}"), work_dir=sub,
        cluster_iteration=MODE_C_ITERS, min_similarity=MODE_C_MIN_SIM,
        kmc=False, bin=False, clustering=True, extracting=False, seed=0,
        ignore_small=0)


def _run_mode_c(sub: str, tag: str) -> dict:
    from kmerlsh_tpu.pipeline import kmer_cluster

    t0 = time.perf_counter()
    stages = kmer_cluster(_mode_c_params(sub, tag))
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "clusters": stages.metrics.get("clusters"),
            "device_s": stages.times.get("device_seconds"),
            "pull_s": stages.times.get("pull_seconds"),
            "save_s": stages.times.get("C_save")}


def phase_mode_c(rows: int = MODE_C_ROWS) -> dict:
    import filecmp

    import bench
    from kmerlsh_tpu.cluster import engine
    from kmerlsh_tpu.utils.timing import (device_memory_stats,
                                          nvidia_smi_name_power)

    with tempfile.TemporaryDirectory(prefix="kmerlsh_smoke_") as root:
        t0 = time.perf_counter()
        sub = bench.make_data(rows, root=root)
        _say(f"mode C data: {rows} rows x {MODE_C_SAMPLES} samples in "
             f"{time.perf_counter() - t0:.3f} s")
        cold = _run_mode_c(sub, "cold")
        warm = _run_mode_c(sub, "warm")
        peak = device_memory_stats().get("peak_bytes_in_use")
        for tag, r in (("cold", cold), ("warm", warm)):
            _say(f"mode C {tag}: wall {r['wall_s']:.3f} s, device "
                 f"{r['device_s']} s, pull {r['pull_s']} s, save "
                 f"{r['save_s']} s, clusters {r['clusters']}")
        _say(f"mode C: PERMUTE={engine.PERMUTE}, peak device bytes {peak}, "
             f"card {nvidia_smi_name_power()}")
        res = os.path.join(sub, "result_warm.txt")
        chk = check_mode_c_output(sub, res, MODE_C_SAMPLES, MODE_C_ITERS,
                                  engine.PERMUTE)
        rounds = centroid_roundings(engine.PERMUTE, MODE_C_ITERS)
        _say(f"mode C output: {chk['rows']} kept rows in {chk['clusters']} "
             f"clusters, each in exactly one; {chk['checked']} centroids "
             f"vs f64 host means within {rounds} f16 roundings (worst "
             f"err/tol {chk['worst_err_over_tol']:.3f})")
        if chk["clusters"] != warm["clusters"]:
            raise SmokeError("saved cluster count differs from the run's")
        same = all(filecmp.cmp(os.path.join(sub, f"result_cold.txt{ext}"),
                               os.path.join(sub, f"result_warm.txt{ext}"),
                               shallow=False) for ext in (".clust", ""))
        _say(f"mode C cold and warm outputs identical: {same}")
        if not same:
            raise SmokeError("cold and warm mode-C outputs differ")
    return {"cold": cold, "warm": warm, "peak_device_bytes": peak,
            "permute": engine.PERMUTE, **chk}


def _parity_lsh(rows: int) -> dict:
    import jax
    import jax.numpy as jnp

    from kmerlsh_tpu.ops import lsh

    s, h = MODE_C_SAMPLES, MODE_C_SAMPLES
    rng = np.random.default_rng(1)
    values_t = rng.standard_normal((s, rows)).astype(np.float32)
    hyper = lsh.draw_hyperplanes(jax.random.PRNGKey(3), s)
    keys, proj = jax.jit(lsh.signatures_t)(jnp.asarray(values_t), hyper,
                                           jnp.int32(h))
    out = check_keys_against_f64(np.asarray(keys), np.asarray(proj),
                                 np.asarray(hyper), values_t, h)
    _say(f"parity lsh.signatures_t [{s} x {rows}], f32 HIGHEST vs f64 "
         f"NumPy: {out['bits_differing_near_zero']} bits differ, all with "
         f"|p| <= {LSH_NEAR_ZERO:g}*sum|h*x|; projection max err/bound "
         f"{out['max_proj_err_over_bound']:.3g}")
    return out


def _parity_engine(rows: int) -> dict:
    import jax

    import bench
    from kmerlsh_tpu.cluster import engine
    from kmerlsh_tpu.io import counts as countsio
    from kmerlsh_tpu.pipeline import mode_c_schedule

    with tempfile.TemporaryDirectory(prefix="kmerlsh_smoke_") as root:
        sub = bench.make_data(rows, root=root)
        kmap, covs = countsio.read_log(os.path.join(sub, countsio.LOG_NAME))
        counts = countsio.read_count_batch(
            os.path.join(sub, countsio.BIN_NAME), MODE_C_SAMPLES, kmap, 0,
            kmap)
    v = np.asarray([c / kmap for c in covs], np.float32)
    sched = mode_c_schedule(MODE_C_ITERS, MODE_C_MIN_SIM)
    out = {}
    for name, dev in (("gpu", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            t0 = time.perf_counter()
            _, sizes, groups = engine.cluster_counts(
                counts, v, sched, seed=0, half_pull=True)
            out[name] = {"clusters": len(groups),
                         "wall_s": time.perf_counter() - t0,
                         "groups": groups}
    g, c = out["gpu"]["clusters"], out["cpu"]["clusters"]
    share = abs(g - c) / max(c, 1)
    agree = membership_agreement(out["gpu"]["groups"], out["cpu"]["groups"],
                                 kmap)
    _say(f"parity engine {rows} x {MODE_C_SAMPLES}, PERMUTE="
         f"{engine.PERMUTE}: GPU {g} clusters vs CPU {c} ({share:.4%}, must "
         f"be <= {ENGINE_PARITY_SHARE:.0%}); rows in identical clusters "
         f"{agree:.4f}")
    if share > ENGINE_PARITY_SHARE:
        raise SmokeError(f"GPU/CPU cluster counts differ by {share:.2%}")
    return {"gpu_clusters": g, "cpu_clusters": c, "share": share,
            "identical_cluster_rows": agree}


def _parity_ttest(n: int) -> dict:
    from scipy import stats

    from kmerlsh_tpu.ops import ttest

    n1 = n2 = MODE_C_SAMPLES // 2
    pval, size_thresh = 0.01, 10
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((n, n1 + n2)).astype(np.float32)
    shift = rng.integers(0, 3, size=n)                  # 0 none, 1 A, 2 B
    vals[shift == 1, :n1] += 1.5
    vals[shift == 2, n1:] += 1.5
    sizes = rng.integers(1, 40, size=n)
    _, left, right = map(np.asarray, ttest.studentttest2(vals, n1, n2))
    verdict = np.asarray(ttest.wrs_verdicts(vals, sizes, n1, n2, pval,
                                            size_thresh))
    x, y = vals[:, :n1].astype(np.float64), vals[:, n1:].astype(np.float64)
    t = stats.ttest_ind(x, y, axis=1, equal_var=True).statistic
    ref_left = stats.t.cdf(t, n1 + n2 - 2)
    ref_right = stats.t.sf(t, n1 + n2 - 2)
    perr = np.maximum(np.abs(left - ref_left), np.abs(right - ref_right))
    worst = int(np.argmax(perr))
    err = float(perr[worst])
    ref_v = np.where(sizes > size_thresh, np.where(
        ref_left <= pval, 2, np.where(ref_right <= pval, 1, 0)), 0)
    edge = ((np.abs(ref_left - pval) <= TTEST_ATOL)
            | (np.abs(ref_right - pval) <= TTEST_ATOL))
    bad = (verdict != ref_v) & ~edge
    _say(f"parity ttest {n} clusters (f32 on device vs scipy f64): max p "
         f"err {err:.3g} at left-tail p {ref_left[worst]:.4f} (tolerance "
         f"{TTEST_ATOL:g}); verdicts differ on "
         f"{int((verdict != ref_v).sum())} rows, {int(bad.sum())} of them "
         f"with p farther than {TTEST_ATOL:g} from the threshold; verdict "
         f"counts {np.bincount(verdict, minlength=3).tolist()}")
    if err > TTEST_ATOL or bad.any():
        raise SmokeError("t-test disagrees with scipy")
    return {"max_p_err": float(err), "verdict_diffs": int(
        (verdict != ref_v).sum())}


def _parity_reads(n: int) -> dict:
    from kmerlsh_tpu.kmer import codec
    from kmerlsh_tpu.ops import reads as readops

    k, rl, vote = 23, 150, 0.5
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    marker = bases[rng.integers(0, 4, size=5000)].tobytes()
    codes, _ = codec.seq_to_codes(marker)
    diff = np.unique(codec.canonical_key(codec.sliding_kmers(codes, k), k))
    seqs = []
    for _ in range(n):
        ln = int(rng.integers(0, rl + 1))
        if rng.random() < 0.4:
            st = int(rng.integers(0, len(marker) - ln))
            seqs.append(marker[st:st + ln])
        else:
            seqs.append(bases[rng.integers(0, 5, size=ln)].tobytes())
    times = {}
    masks = {}
    for name, fn in (("device", readops.score_part_device),
                     ("native", readops.score_part_native)):
        fn(seqs[:1024], diff, k, vote)                  # warm / compile
        t0 = time.perf_counter()
        masks[name] = fn(seqs, diff, k, vote)
        times[name] = time.perf_counter() - t0
    same = np.array_equal(masks["device"], masks["native"])
    _say(f"parity reads {n} reads, k={k}: device mask == native mask: "
         f"{same} ({int(masks['native'].sum())} selected); device "
         f"{n / times['device']:.1f} reads/s, native "
         f"{n / times['native']:.1f} reads/s")
    if not same:
        raise SmokeError("device read scorer disagrees with native")
    return {"selected": int(masks["native"].sum()),
            "device_reads_per_s": n / times["device"],
            "native_reads_per_s": n / times["native"]}


def phase_parity(lsh_rows: int = LSH_ROWS,
                 engine_rows: int = ENGINE_PARITY_ROWS,
                 ttest_n: int = TTEST_CLUSTERS,
                 reads_n: int = SCORER_READS) -> dict:
    return {"lsh": _parity_lsh(lsh_rows),
            "engine": _parity_engine(engine_rows),
            "ttest": _parity_ttest(ttest_n),
            "reads": _parity_reads(reads_n)}


PYTEST_TARGETS = [
    "tests/test_gpu.py",
    "tests/test_chain_collapse.py",
    "tests/test_engine_permute.py",
    "tests/test_ops.py",
    "tests/test_cluster.py::test_planted_recovery",
    "tests/test_cluster.py::test_tpu_engine_deterministic",
    "tests/test_cluster.py::test_engines_agree_on_separated_data",
]


def run_pytest(env: dict, deadline: float) -> None:
    """The pytest phase: pytest is itself the one process on the card."""
    box = min(CHILD_BOX_S["pytest"], deadline - time.monotonic())
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "--on-gpu", *PYTEST_TARGETS],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=box)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    print(r.stdout[-3000:], flush=True)
    print(f"[pytest] {time.monotonic() - t0:.1f} s, rc={r.returncode}",
          flush=True)
    if r.returncode != 0 or "skipped" in tail:
        raise SmokeError(f"pytest on the card: rc={r.returncode} "
                         f"({tail}) {r.stderr[-1500:]}")


def phase_multichip(rows: int = MODE_C_ROWS, devices: int = 4) -> dict:
    import jax

    import __graft_entry__
    import bench
    from kmerlsh_tpu.cluster import engine
    from kmerlsh_tpu.io import counts as countsio
    from kmerlsh_tpu.pipeline import mode_c_schedule

    with tempfile.TemporaryDirectory(prefix="kmerlsh_smoke_") as root:
        sub = bench.make_data(rows, root=root)
        mesh_run = _run_mode_c(sub, "mesh")
        chk = check_mode_c_output(sub, os.path.join(sub, "result_mesh.txt"),
                                  MODE_C_SAMPLES, MODE_C_ITERS,
                                  engine.PERMUTE)
        _say(f"mode C on {devices} cards: wall {mesh_run['wall_s']:.3f} s, "
             f"device {mesh_run['device_s']} s, {chk['clusters']} clusters; "
             f"{chk['rows']} kept rows each in exactly one cluster; "
             f"{chk['checked']} centroids vs f64 host means (worst err/tol "
             f"{chk['worst_err_over_tol']:.3f})")
        kmap, covs = countsio.read_log(os.path.join(sub, countsio.LOG_NAME))
        counts = countsio.read_count_batch(
            os.path.join(sub, countsio.BIN_NAME), MODE_C_SAMPLES, kmap, 0,
            kmap)
    v = np.asarray([c / kmap for c in covs], np.float32)
    with jax.default_device(jax.devices()[0]):
        t0 = time.perf_counter()
        _, _, groups = engine.cluster_counts(
            counts, v, mode_c_schedule(MODE_C_ITERS, MODE_C_MIN_SIM),
            seed=0, half_pull=True)
        one_wall = time.perf_counter() - t0
    one = len(groups)
    share = abs(chk["clusters"] - one) / max(one, 1)
    _say(f"mode C on card 0 alone: {one} clusters in {one_wall:.3f} s; "
         f"{devices}-card count differs by {share:.4%} (must be <= "
         f"{MULTICHIP_SHARE:.0%})")
    if share > MULTICHIP_SHARE:
        raise SmokeError(f"{devices}-card cluster count off by {share:.2%}")
    __graft_entry__.dryrun_multichip(devices)
    return {"mesh": mesh_run, "one_card_clusters": one, "share": share}


PHASES = {"pipeline": phase_pipeline, "mode_c": phase_mode_c,
          "parity": phase_parity, "multichip": phase_multichip}


def _child(phase: str, devices: int) -> int:
    """Run one phase in this process; its last stdout line is JSON."""
    try:
        env = phase_env(devices)
        out = env if phase == "env" else PHASES[phase]()
    except SmokeError as e:
        print(f"FAILED {phase}: {e}", flush=True)
        return 1
    print(json.dumps(out, default=str), flush=True)
    return 0


# --------------------------------------------------------------------------
# parent: no JAX here
# --------------------------------------------------------------------------

def _run_child(phase: str, devices: int, env: dict, deadline: float) -> dict:
    box = min(CHILD_BOX_S[phase], deadline - time.monotonic())
    if box <= 10:
        raise SmokeError(f"no time left for phase {phase}")
    t0 = time.monotonic()
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--phase", phase,
             "--devices", str(devices)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=box)
    except subprocess.TimeoutExpired as e:
        out = e.stdout or b""
        print((out.decode(errors="replace") if isinstance(out, bytes)
               else out)[-4000:], flush=True)
        raise SmokeError(f"phase {phase} exceeded {box:.0f} s") from e
    lines = r.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(ln, flush=True)
    print(f"[{phase}] {time.monotonic() - t0:.1f} s, rc={r.returncode}",
          flush=True)
    if r.returncode != 0 or not lines:
        print(lines[-1] if lines else "", flush=True)
        print(r.stderr[-4000:], file=sys.stderr, flush=True)
        raise SmokeError(f"phase {phase} failed")
    return json.loads(lines[-1])


def build_native(env: dict) -> None:
    """Rebuild the native extension in place and require that it imports
    (setup.py tolerates build failures, and an old build may exist)."""
    so = os.path.join(REPO, "_kmerlsh_native"
                      + sysconfig.get_config_var("EXT_SUFFIX"))
    before = os.path.getmtime(so) if os.path.exists(so) else -1.0
    r = subprocess.run(
        [sys.executable, "setup.py", "build_ext", "--inplace", "--force"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if not os.path.exists(so) or os.path.getmtime(so) <= before:
        raise SmokeError(f"native extension did not build: rc={r.returncode}"
                         f" {r.stdout[-1500:]} {r.stderr[-1500:]}")
    r = subprocess.run([sys.executable, "-c", "import _kmerlsh_native"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        raise SmokeError(f"_kmerlsh_native does not import: {r.stderr}")
    print(f"native extension built: {os.path.basename(so)}", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded mode-C path on four cards")
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase:
        return _child(args.phase, args.devices)

    deadline = time.monotonic() + TIME_LIMIT_S
    if not os.path.isdir(os.path.join(REPO, "kmerlsh_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    from kmerlsh_tpu.utils.timing import nvidia_smi_name_power

    cards = nvidia_smi_name_power()
    print(f"card (name, power limit): {cards or 'nvidia-smi not available'}",
          flush=True)
    env = dict(os.environ)
    if args.devices == 1 and "CUDA_VISIBLE_DEVICES" not in env:
        env["CUDA_VISIBLE_DEVICES"] = "0"   # else kmer_cluster shards
    phases = (["pipeline", "mode_c", "parity", "pytest"]
              if args.devices == 1 else ["multichip"])
    try:
        device = _run_child("env", args.devices, env, deadline)
        build_native(env)
        for ph in phases:
            if ph == "pytest":
                run_pytest(env, deadline)
            else:
                _run_child(ph, args.devices, env, deadline)
        line = result_line(device["platform"], device["kind"],
                           device["count"])
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    for c in nvidia_smi_name_power():
        print(c, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

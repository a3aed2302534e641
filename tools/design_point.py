"""Design-point runner: one cold mode-C run at a row count chosen via
KMERLSH_DP_N (default 2^26 — beyond one session's device-memory budget it
takes the out-of-core init_clustering path), recording the per-phase
wall/device/pull splits that init_clustering accumulates, incl. pulled
bytes and the device it ran on.

Usage:  KMERLSH_DP_N=$((1<<26)) python tools/design_point.py
Prints one JSON line.
"""

import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (reuses the dataset generator)


def main():
    n = int(os.environ.get("KMERLSH_DP_N", 1 << 26))
    sub = bench.make_data(n)
    from kmerlsh_tpu.config import HyperParams
    from kmerlsh_tpu.pipeline import kmer_cluster

    tmp = os.path.join(sub, "tmp_dp")
    shutil.rmtree(tmp, ignore_errors=True)
    p = HyperParams(
        input1=os.path.join(sub, "l1"), input2=os.path.join(sub, "l2"),
        clust_file_name=os.path.join(sub, "result_dp.txt"),
        tmp_dir=tmp, work_dir=sub,
        cluster_iteration=bench.ITERATIONS, min_similarity=bench.MIN_SIM,
        kmc=False, bin=False, clustering=True, extracting=False, seed=0,
        verbose=True,
    )
    from kmerlsh_tpu.utils.timing import device_record

    t0 = time.perf_counter()
    st = kmer_cluster(p)
    wall = time.perf_counter() - t0
    out = {
        "device": device_record(),
        "rows": n,
        "cold_seconds": round(wall, 2),
        "path": ("init_clustering (out-of-core)" if "C_init_clustering"
                 in st.times else "single fused"),
        "clusters": st.metrics.get("clusters"),
        "note": ("single cold run; device/pull split accumulated across "
                 "all batch passes, merge rounds and the final anneal; "
                 "tmp centroids f16; batch pulls overlap the next "
                 "batch's device pass"),
    }
    for k in ("read_batch", "cluster_batch", "save_tmp", "read_tmp",
              "cluster_merge_round", "C_init_clustering", "C_cluster",
              "C_save", "device_seconds", "pull_seconds"):
        if k in st.times:
            out[k.lower() + "_seconds" if not k.endswith("seconds") else k] \
                = round(st.times[k], 2)
    if "pull_bytes" in st.metrics:
        out["pull_mb"] = round(st.metrics["pull_bytes"] / 1e6, 1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

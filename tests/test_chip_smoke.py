"""The pure helpers of chip_smoke.py, on the CPU: the result line, the
partition / centroid checks of a mode-C output, the LSH key check and
membership agreement. (The smoke itself needs the card.)"""

import json

import numpy as np
import pytest

import bench
import chip_smoke as cs
from kmerlsh_tpu.cluster.groups import Groups


def test_result_line_is_exact_for_gpu():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_result_line_refuses_other_platforms(platform):
    with pytest.raises(cs.SmokeError):
        cs.result_line(platform, "x", 1)


@pytest.fixture(scope="module")
def mode_c_run(tmp_path_factory):
    """A small mode-C run through the pipeline on bench.make_data."""
    from kmerlsh_tpu.pipeline import kmer_cluster

    root = str(tmp_path_factory.mktemp("smoke"))
    sub = bench.make_data(1 << 13, root=root)
    p = cs._mode_c_params(sub, "t")
    p.cluster_iteration = 6
    kmer_cluster(p)
    return sub, p.clust_file_name


def test_mode_c_output_check_passes_on_a_real_run(mode_c_run):
    from kmerlsh_tpu.cluster import engine

    sub, res = mode_c_run
    out = cs.check_mode_c_output(sub, res, cs.MODE_C_SAMPLES, 6,
                                 engine.PERMUTE, n_check=200)
    assert out["rows"] == 1 << 13 and out["checked"] == min(200,
                                                            out["clusters"])


def test_mode_c_output_check_catches_a_wrong_centroid(mode_c_run, tmp_path):
    from kmerlsh_tpu.io import clusterio

    sub, res = mode_c_run
    vals, ids = clusterio.read_cluster_all(res, cs.MODE_C_SAMPLES)
    vals = vals.copy()
    vals[:, 0] += 0.05
    bad = str(tmp_path / "bad.txt")
    clusterio.save_result(ids, bad + ".clust")
    clusterio.save_binary(vals, ids, bad)
    with pytest.raises(cs.SmokeError, match="centroid"):
        cs.check_mode_c_output(sub, bad, cs.MODE_C_SAMPLES, 6,
                               "payload_sort", n_check=50)


def test_partition_check_catches_a_duplicate_and_a_missing_row():
    kept = np.ones(6, bool)
    cs.check_partition(Groups.from_list([[0, 1], [2, 3, 4, 5]]), kept)
    with pytest.raises(cs.SmokeError, match="more than one"):
        cs.check_partition(Groups.from_list([[0, 1, 2], [2, 3, 4]]), kept)
    with pytest.raises(cs.SmokeError, match="sum to"):
        cs.check_partition(Groups.from_list([[0, 1], [2, 3, 4]]), kept)
    kept[5] = False
    with pytest.raises(cs.SmokeError, match="filtered"):
        cs.check_partition(Groups.from_list([[0, 1], [2, 3, 5]]), kept)


def test_key_check_accepts_exact_keys_and_rejects_a_flipped_bit():
    rng = np.random.default_rng(0)
    s, m, h = 20, 512, 10
    x = rng.standard_normal((s, m)).astype(np.float32)
    hyper = rng.standard_normal((s, 31)).astype(np.float32)
    p = hyper.astype(np.float64).T @ x.astype(np.float64)
    keys = np.zeros(m, np.int64)
    for i in range(h):
        keys = keys * 2 + (p[i] >= 0)
    cs.check_keys_against_f64(keys, p[-1], hyper, x, h)
    far = int(np.argmax(np.abs(p[0])))
    keys[far] ^= 1 << (h - 1)
    with pytest.raises(cs.SmokeError, match="key bits"):
        cs.check_keys_against_f64(keys, p[-1], hyper, x, h)


def test_membership_agreement():
    a = Groups.from_list([[0, 1], [2, 3], [4]])
    assert cs.membership_agreement(a, a, 5) == 1.0
    b = Groups.from_list([[0, 1], [2], [3, 4]])
    assert cs.membership_agreement(a, b, 5) == pytest.approx(2 / 5)


def test_smoke_refuses_to_run_outside_a_checkout(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout

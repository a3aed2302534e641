"""Multi-host pipeline entry: 2 OS processes × 4 virtual CPU devices run
the FULL mode-C pipeline through the shipped CLI (--coordinator /
--num-processes / --process-id → jax.distributed.initialize), with
process-local count loading; the resulting .clust must be byte-identical
to a single-process run over the same 8-device global mesh.

This is the launchable equivalent of the reference's single-binary UX
(app/kmerLSH.cc:605-616) for a multi-host run."""

import os
import subprocess
import sys

import numpy as np
import pytest

S, N = 8, 2048

WORKER = r"""
import os, sys
proc_id, nproc, port, work, extra = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4], sys.argv[5:])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
from kmerlsh_tpu import cli
cli.main(["-a", os.path.join(work, "l1"), "-b", os.path.join(work, "l2"),
          "-M", "C", "--only", "-I", "6", "-N", "0.8", "--seed", "0",
          "--work-dir", work, "-D", os.path.join(work, "tmp"),
          "-F", os.path.join(work, "mp_result.txt"),
          "--coordinator", f"localhost:{port}",
          "--num-processes", str(nproc), "--process-id", str(proc_id)]
         + extra)
print(f"WORKER_DONE proc={proc_id}", flush=True)
"""

SINGLE = r"""
import os, sys
work, extra = sys.argv[1], sys.argv[2:]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
from kmerlsh_tpu import cli
cli.main(["-a", os.path.join(work, "l1"), "-b", os.path.join(work, "l2"),
          "-M", "C", "--only", "-I", "6", "-N", "0.8", "--seed", "0",
          "--work-dir", work, "-D", os.path.join(work, "tmp_sp"),
          "-F", os.path.join(work, "sp_result.txt")] + extra)
print("SINGLE_DONE", flush=True)
"""


def _write_inputs(work: str) -> None:
    rng = np.random.default_rng(3)
    prof = rng.integers(1, 200, size=(16, S)).astype(np.float64)
    rows = rng.integers(0, 16, size=N)
    counts = (prof[rows] + rng.integers(0, 3, size=(N, S))).astype(np.uint16)
    counts.T.astype("<u2").tofile(os.path.join(work, "kmer_count.bin"))
    cov = np.log(np.maximum(counts, 1).astype(np.float64)).sum(axis=0)
    with open(os.path.join(work, "kmer_count.log"), "w") as f:
        f.write(str(N))
        for c in cov:
            f.write("\t%f" % c)
    half = S // 2
    for name, idx in (("l1", range(half)), ("l2", range(half, S))):
        with open(os.path.join(work, name), "w") as f:
            for i in idx:
                f.write(f"s{i}.fastq db{i}\n")


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.skipif(os.environ.get("KMERLSH_SKIP_MULTIPROC") == "1",
                    reason="explicitly disabled")
@pytest.mark.parametrize("extra", [[], ["--batch-thresh", "512"]],
                         ids=["fused", "multibatch"])
def test_two_process_cli_mode_c(tmp_path, extra):
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        port = str(s.getsockname()[1])

    work = str(tmp_path)
    _write_inputs(work)
    wscript = tmp_path / "worker.py"
    wscript.write_text(WORKER)
    sscript = tmp_path / "single.py"
    sscript.write_text(SINGLE)

    procs = [
        subprocess.Popen(
            [sys.executable, str(wscript), str(i), "2", port, work] + extra,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env())
        for i in range(2)
    ]
    single = subprocess.Popen(
        [sys.executable, str(sscript), work] + extra,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())
    outs = [p.communicate(timeout=600)[0] for p in procs]
    sout = single.communicate(timeout=600)[0]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"WORKER_DONE proc={i}" in out
    assert single.returncode == 0, f"single failed:\n{sout[-3000:]}"

    mp = open(os.path.join(work, "mp_result.txt.clust"), "rb").read()
    sp = open(os.path.join(work, "sp_result.txt.clust"), "rb").read()
    assert mp and mp == sp, (
        "2-process result differs from the single-process 8-device run")
    mpb = open(os.path.join(work, "mp_result.txt"), "rb").read()
    spb = open(os.path.join(work, "sp_result.txt"), "rb").read()
    assert mpb == spb

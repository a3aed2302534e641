"""Stage timers and structured metrics.

Replaces the reference's scattered ``chrono`` spans + ``/proc/self/status``
probes (io/ioMatrix.cc:15-29, function/cluster.cc:259-308) with a context
manager that records wall-clock per named stage and an optional device-memory
snapshot; ``jax.profiler`` traces can wrap any stage via ``trace_dir``.
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("kmerlsh_tpu")


class Stages:
    def __init__(self, verbose: bool = False):
        self.times: dict[str, float] = {}
        self.metrics: dict[str, float] = {}
        self.verbose = verbose

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if self.verbose:
                print(f"[stage] {name}: {dt:.3f}s")

    def record(self, name: str, value: float) -> None:
        self.metrics[name] = value
        if self.verbose:
            print(f"[metric] {name}: {value}")


def host_memory_kb() -> int:
    """VmSize of this process in KB (= ``IOMat::getValue``,
    io/ioMatrix.cc:15-29)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def nvidia_smi_name_power() -> list[str]:
    """One ``name, power.limit`` line per visible NVIDIA card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them; empty when nvidia-smi is absent. Every measured number is
    reported beside these: a card set below its maximum power runs slower
    under load."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return []
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_record() -> dict:
    """The device a measurement ran on, as JAX reports it, plus the
    cards' name and power limit."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
            "name_power_limit": nvidia_smi_name_power()}


def device_memory_stats() -> dict:
    """Best-effort live device memory, the analog of the VmSize probe."""
    try:
        import jax

        d = jax.devices()[0]
        stats = d.memory_stats() or {}
        return {k: v for k, v in stats.items() if "bytes" in k}
    except Exception:
        return {}

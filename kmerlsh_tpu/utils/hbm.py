"""Device-memory-aware batch sizing.

The reference hard-codes a 100 M-row out-of-core batch (app/kmerLSH.cc:285)
because its unit of memory is host RAM (2 B × samples × rows,
kmerLSH.cc:292-295). Here the unit is device memory: one mode-C session
holds the uint16 count batch, the f32 [S, cap] profile state, its sort
copy, the segmented-scan accumulators, and a handful of i32 lane arrays.

Two sizing sources:

  * **measured** — :func:`measure_per_row_bytes` runs the real head program
    at two small capacities and differences the device's
    ``peak_bytes_in_use``; the result is disk-cached per (platform, device
    kind, S). Used automatically when the decision matters (the matrix
    exceeds the static estimate) so a wrong constant can no longer silently
    OOM or halve a run.
  * **static** — the hand-derived per-row model below, used when the
    static estimate already admits the whole matrix or the backend keeps
    no peak statistics (the CPU backend).

The memory limit itself comes from the device (``bytes_limit``); an
accelerator that reports none is an error, and the CPU backend sizes from
host RAM.
"""

from __future__ import annotations

import json
import math
import os

from kmerlsh_tpu.utils.jaxcache import CACHE_ROOT

# static model: bytes per k-mer row as a function of sample count S:
#   counts uint16 (2S) + f32 state ×3 live copies (12S) + ~13 i32/f32 lane
#   arrays (keys, proj, slots, parent, scan flags/sums, sort temps)
_PER_ROW_LANES = 64

_CAL_PATH = os.path.join(CACHE_ROOT, "hbm_calibration.json")


def _per_row_bytes(num_samples: int) -> int:
    return 14 * num_samples + _PER_ROW_LANES


def device_memory_bytes() -> int:
    """Memory available to ONE device of the default backend: the
    device's ``bytes_limit`` on an accelerator; host RAM split evenly over
    the local devices on the CPU backend. Raises when an accelerator
    reports no limit — a guessed size would silently OOM or under-fill."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return ram // len(jax.local_devices())
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
    if not limit:
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no memory "
            "limit (memory_stats()['bytes_limit']); cannot size batches")
    return int(limit)


def measure_per_row_bytes(num_samples: int,
                          cap_small: int = 1 << 16) -> int | None:
    """Empirical bytes/row: run the head program (the session's peak-memory
    phase — transform + deep init + sort temps all live) at ``cap_small``
    and ``2·cap_small`` and difference the device peak. Returns None when
    the backend reports no memory stats (CPU) or the measurement is invalid
    (an earlier larger program already owns the peak)."""
    import jax
    import numpy as np

    from kmerlsh_tpu.cluster import engine

    dev = jax.devices()[0]
    if not (dev.memory_stats() or {}).get("bytes_limit"):
        return None

    rng = np.random.default_rng(0)
    peaks = []
    for cap in (cap_small, 2 * cap_small):
        counts = rng.integers(1, 100, size=(num_samples, cap)).astype(
            np.uint16)
        v = np.zeros(num_samples, np.float32)
        thr = np.asarray([0.95, 0.9, 0.85], np.float32)
        out = engine._head_program(
            engine.upload_counts(counts)[0], v,
            jax.random.PRNGKey(0), thr, 4, "chain", True, engine.PERMUTE)
        jax.block_until_ready(out)
        peaks.append((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))
    if peaks[1] <= peaks[0]:
        return None
    return int(math.ceil((peaks[1] - peaks[0]) / cap_small))


def calibration_key(num_samples: int) -> str:
    """Calibration cache key: the per-row cost depends on the backend's
    compiler and the device model, not only on the platform."""
    import jax

    dev = jax.devices()[0]
    return f"{dev.platform}_{dev.device_kind}_S{num_samples}"


def _cached_per_row_bytes(num_samples: int) -> int | None:
    """Disk-cached measured bytes/row for :func:`calibration_key`."""
    key = calibration_key(num_samples)
    cal = {}
    try:
        with open(_CAL_PATH) as f:
            cal = json.load(f)
    except OSError:
        pass
    if key in cal:
        return cal[key]
    measured = measure_per_row_bytes(num_samples)
    if measured is None:
        return None
    cal[key] = measured
    os.makedirs(os.path.dirname(_CAL_PATH), exist_ok=True)
    with open(_CAL_PATH, "w") as f:
        json.dump(cal, f)
    return measured


def rows_budget(num_samples: int, n_devices: int = 1, fill: float = 0.6,
                per_row: int | None = None, mem: int | None = None,
                kmap_size: int | None = None) -> int:
    """Largest power-of-two row count whose mode-C session fits in
    ``fill`` × device memory across ``n_devices`` (capacities pad to powers
    of two, so the budget is returned as one).

    When ``kmap_size`` is given and exceeds the static estimate — i.e. the
    budget actually decides between single-batch and out-of-core — the
    session measures bytes/row empirically (disk-cached, one-time) and
    sizes from that with a higher fill (the measurement already includes
    sort transients)."""
    if mem is None:
        mem = device_memory_bytes()
    if per_row is None:
        per_row = _per_row_bytes(num_samples)
        static_rows = int(mem * fill * n_devices / per_row)
        if kmap_size is not None and kmap_size > static_rows:
            measured = _cached_per_row_bytes(num_samples)
            if measured:
                per_row, fill = measured, 0.8
    rows = int(mem * fill * n_devices / per_row)
    return max(1 << 16, 1 << int(math.floor(math.log2(max(rows, 1)))))

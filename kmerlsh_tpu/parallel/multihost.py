"""Multi-host runtime: ``jax.distributed`` lifecycle + process-local helpers.

The reference is a single OpenMP binary (SURVEY §5.8 — no distributed
backend of any kind); this framework's multi-host story is the standard
JAX one: every host runs the SAME ``kmerlsh`` command with three extra
flags (``--coordinator host:port --num-processes N --process-id i``, or the
matching ``KMERLSH_*`` env vars), ``jax.distributed.initialize`` forms the
global runtime, and the pipeline then:

  * loads each process's own column slice of ``kmer_count.bin``
    (``dist.upload_counts_process_local``) — the full matrix never lives on
    one host;
  * runs the identical SPMD programs everywhere (global-mesh ``shard_map``);
  * writes shared artifacts from process 0 only, with barriers before any
    stage that reads them back;
  * splits per-sample work (mode K counting, mode E extraction) round-robin
    across processes.
"""

from __future__ import annotations

import os

import numpy as np


def maybe_initialize(params) -> None:
    """Form the jax.distributed runtime when multi-process flags/env are
    set. Must run before any other JAX call."""
    coord = params.coordinator or os.environ.get("KMERLSH_COORDINATOR", "")
    if not coord:
        return
    nproc = params.num_processes or int(
        os.environ.get("KMERLSH_NUM_PROCESSES", "0"))
    pid = params.process_id if params.process_id >= 0 else int(
        os.environ.get("KMERLSH_PROCESS_ID", "-1"))
    if nproc <= 0 or pid < 0:
        raise ValueError(
            "--coordinator requires --num-processes and --process-id "
            "(or KMERLSH_NUM_PROCESSES / KMERLSH_PROCESS_ID)")
    import jax

    jax.distributed.initialize(coord, num_processes=nproc, process_id=pid)


def process_count() -> int:
    import jax

    return jax.process_count()


def proc0() -> bool:
    import jax

    return jax.process_index() == 0


def barrier(name: str) -> None:
    """Block until every process reaches ``name`` (no-op single-process)."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def gather_np(x) -> np.ndarray:
    """Globally-sharded jax.Array → full NumPy array on every process
    (plain ``np.asarray`` single-process)."""
    import jax

    if jax.process_count() > 1 and isinstance(x, jax.Array) \
            and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def my_items(items: list) -> list:
    """This process's round-robin share of per-sample work."""
    import jax

    p, n = jax.process_index(), jax.process_count()
    return [x for i, x in enumerate(items) if i % n == p]

"""Device-mesh construction.

The framework's scale axis is the k-mer row dimension — the analog of
sequence/context parallelism (SURVEY §5.7): the abundance matrix is sharded
over devices on the row axis ("rows"), hyperplanes and thresholds are
replicated, and cross-shard merging moves only (key, centroid, size)
summaries between devices. The mesh is flat and 1-D: every device
exchanges with every other one each iteration, which suits an all-to-all
interconnect such as NVLink.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

ROWS = "rows"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (ROWS,))

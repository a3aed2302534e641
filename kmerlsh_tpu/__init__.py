"""kmerlsh_tpu — an accelerator-native metagenomic k-mer LSH clustering framework.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``kmerLSH`` C++/OpenMP tool (disease-associated sub-metagenome discovery via
LSH clustering of k-mer abundance profiles):

  * mode K — k-mer counting per sample (external KMC3, or the built-in native
    counter when ``kmc`` is not on PATH),
  * mode B — union of canonical k-mers across samples + sample-major uint16
    count-matrix artifacts (``kmer_set.hex`` / ``kmer_count.bin`` /
    ``kmer_count.log``, byte-compatible with the reference formats),
  * mode C — iterative random-hyperplane LSH clustering of the
    log-transformed, coverage-centered abundance matrix on the device,
  * mode E — per-cluster two-sample Student's t-test and differential-read
    extraction from FASTQ.

The compute path is pure JAX (signatures as one matmul, sort/segment merges on
device, batched t-tests); the host side handles streaming I/O and artifact
codecs. Multi-chip scaling shards the k-mer row axis over a
``jax.sharding.Mesh`` (see ``kmerlsh_tpu.parallel``).
"""

__version__ = "0.1.0"

from kmerlsh_tpu.config import HyperParams  # noqa: F401

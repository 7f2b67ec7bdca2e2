"""hisat2_tpu — a JAX graph-genome spliced read aligner.

A JAX/XLA framework with the capabilities of HISAT2 (hisat2 v2.1.0):
FM-index based alignment of DNA/RNA sequencing reads against a reference
genome (+ variants), re-designed as batched array programs for an
accelerator (an NVIDIA H100 GPU):

  - the FM index is laid out as dense integer arrays in device memory
    (packed 2-bit BWT words + rank checkpoints + sampled suffix array),
  - search runs as *batched wavefronts*: thousands of reads advance one
    LF-mapping step per fused device loop iteration (lax.scan; no
    hand-written kernel — XLA compiles the plain jax.numpy/lax code),
  - coordinate resolution, extension and scoring are batched gathers/compares
    over the packed reference,
  - multi-device scaling shards the read stream over a jax.sharding.Mesh and
    merges summaries/splice tables with collectives (no mutexes, no threads).

Package layout:
  index/    index build + on-disk formats (.ht2 reader, native .npz format)
  ops/      device kernels: rank/LF, batched FM search, SA resolve, extension
  align/    alignment pipeline: policies, scoring, pairing, MAPQ, selection
  io/       host I/O: FASTA/FASTQ parsing, SAM formatting
  parallel/ mesh/sharding utilities, collective merge of summaries
  cli/      command-line front-ends (align / build / inspect)
"""

__version__ = "0.1.0"

"""sctagger — a JAX single-cell barcode matching engine.

A from-scratch JAX/XLA/Pallas framework with the capabilities of vpc-ccg/scTagger
(reference: its scTagger.py): matching cellular barcodes between short-read and
long-read single-cell RNA-seq data. The device paths run on an NVIDIA GPU; the
CPU runs the plain jnp path (tests).

Subcommands (CLI-compatible with the reference, `scTagger.py:20-145`):
  extract_lr_bc         locate the SR adapter on long reads (edit-distance scan)
  extract_sr_bc         build an SR barcode whitelist from a Cell Ranger BAM
  extract_sr_bc_from_lr build the whitelist from LR segments + 10x whitelist
  match_trie            match LR segments against the whitelist within max-error

Architecture (not a port):
  core/      2-bit packed sequence arrays, host-side parity-critical algorithms
  ops/       Myers bit-vector edit distance (a Pallas kernel for stage 3, plain
             JAX for stage 1), exact k-mer lookup, top-k counting
  models/    composed jittable compute graphs per pipeline stage
  parallel/  jax.sharding mesh, pjit/shard_map wrappers, collectives
  io/        FASTQ/TSV/BAM ingestion (C++ BGZF+BAM reader in native/)
  stages/    the four stage drivers (host orchestration, byte-exact TSV output)
  pipeline/  Snakemake-equivalent DAG runner with file-based resume
"""

__version__ = "0.1.0"

"""CAMMiQ-TPU: a JAX/XLA metagenomic identification and quantification engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of CAMMiQ
(reference: algo-cancer/CAMMiQ, bioRxiv 10.1101/2020.06.12.149245):

- Build phase: generalized suffix array + LCP over the concatenation of all
  genomes (plus reverse complements), shortest unique / doubly-unique
  substring extraction via segmented scans, sparsified covering selection,
  and a flat, vectorizable hash index (no pointer tries).
- Query phase: batched 2-bit packed reads, vectorized rolling-hash probes of
  the flat index, the reference's exact read-classification case analysis as
  masked vector reductions, per-genome / per-substring count accumulation via
  scatter-adds, collective-reduced across a device mesh.
- Quantification: the reference's MIQP objective solved with a JAX-native
  projected-gradient QP + EXIST rounding; identification ILP via exact
  branch-and-bound over the (small) undetermined set.

Layer map (mirrors SURVEY.md section 7):
  ops/       low-level device kernels (packing, segmented scans, SA, LCP, hash)
  io/        FASTA/FASTQ/map-file data plane
  index/     build pipeline: GSA -> LCP0/MU/OCC -> sparsify -> flat table
  query/     probe + classify + pipeline (the hot loop)
  models/    quantification QP and identification ILP models/solvers
  parallel/  mesh setup, sharded/distributed query
  tools/     simulator / downloader / map-file toolbox
"""

from .version import __version__

__all__ = ["__version__"]

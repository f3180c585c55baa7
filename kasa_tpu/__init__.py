"""kasa_tpu: a JAX taxonomic k-mer classifier for GPUs.

A from-scratch re-design of the capabilities of SilvioWeging/kASA
(k-mer Analysis of Sequences based on Amino acid-like encoding,
NAR gkab200) in JAX/XLA, run on an NVIDIA GPU.

The reference is a single-node C++ binary built around a sorted
external-memory (k-mer, taxid) array (reference: source/kASA.hpp,
source/modes/*.hpp).  This framework keeps the same *capability
surface* — index build / identify / update / shrink / merge / content
file tooling, with byte-compatible on-disk artifact formats — but the
compute path is re-architected for an accelerator:

  * k-mers are held as 2 (or 5, for k<=25) 30-bit limbs in int32
    arrays, so every hot compare and sort is a 32-bit integer op,
  * the classifier's stateful CPU merge-join (reference:
    Compare.hpp:679-1069) is re-cast as sort + vectorized
    lexicographic binary-search + segment-sum scoring,
  * scaling is via jax.sharding over a device mesh (prefix-sharded
    index, data-parallel read batches) instead of threads over
    disjoint stxxl ranges.
"""

__version__ = "0.1.0"

HIGHEST_K_64 = 12     # k <= 12 fits 60 bits  (reference: kASA.hpp:48)
HIGHEST_K_128 = 25    # k <= 25 fits 125 bits (reference: MetaHeader.h HIGHESTPOSSIBLEK)
LOWEST_K = 1

"""Classic device engine for identify: one jit-compiled classify per
(batch-bucket, index) shape, driven directly from the CLI pipeline.

This is the per-batch fallback of ``--engine tpu`` for workloads the
turbo fast path does not cover (pipeline default stays "exact" for
bit parity with the reference binary).  It wraps the flagship kernel (match/device.py classify_batch)
behind the same per-batch interface as the parity engines:

  ingest -> encode -> [here] classify -> rank -> write

Counts are integer/float-exact per batch (the kernel's tail loop makes
taxa expansion exact at any group size); scores differ from the
reference only by float accumulation order and by NOT reproducing the
reference's scoreMatchAVX drop quirk (Compare.hpp:559-575).

Batch shapes are bucketed to powers of two so a steady stream of
equal-sized batches compiles exactly once.
"""

from __future__ import annotations

import numpy as np

from ..core import kmer


class TpuMatchResult:
    def __init__(self, num_k: int, num_species: int, num_reads: int):
        self.scores = np.zeros((num_reads, num_species), dtype=np.float32)
        self.counts_all = np.zeros((num_k, num_species), dtype=np.float64)
        self.counts_unique = np.zeros((num_k, num_species), dtype=np.uint64)
        self.counts_total = np.zeros((num_k, num_species), dtype=np.uint64)
        self.tail_pairs = 0


def _bucket(n: int, minimum: int) -> int:
    size = minimum
    while size < n:
        size <<= 1
    return size


def dedup_unique(q_limbs: np.ndarray, read_ids: np.ndarray):
    """-e: drop duplicate (kmer, readID) pairs (Compare.hpp:3167)."""
    L = q_limbs.shape[1]
    order = np.lexsort((read_ids,) + tuple(
        q_limbs[:, i] for i in range(L - 1, -1, -1)))
    ql, rl = q_limbs[order], read_ids[order]
    keep = np.empty(len(rl), dtype=bool)
    keep[0] = True
    keep[1:] = np.any(ql[1:] != ql[:-1], axis=1) | (rl[1:] != rl[:-1])
    return ql[keep], rl[keep]


class TpuEngine:
    """Device-resident index + jitted classify for the CLI pipeline.

    `dense_max_s` selects the scoring lowering: up to that many species
    rows the base tile uses dense one-hot reductions (elementwise work,
    fastest at small S); above it, flat scatter-adds whose cost is
    independent of S (the shape that survives S >= 10k).  Both are
    exact (match/device.py tail loop)."""

    def __init__(self, limbs: np.ndarray, taxids: np.ndarray,
                 tax_to_row: dict, highest_k: int, min_k: int, max_k: int,
                 num_species: int, cap: int = 8, dense_max_s: int = 512,
                 read_bucket: int = 256, kmer_bucket: int = 1 << 13):
        from .join import DeviceIndex
        from .device import StackedTables

        self.min_k, self.max_k = min_k, max_k
        self.highest_k = highest_k
        self.num_species = num_species
        self.cap = cap
        self.dense_max_s = dense_max_s
        self.read_bucket = read_bucket
        self.kmer_bucket = kmer_bucket
        dev = DeviceIndex(limbs, taxids, tax_to_row, highest_k,
                          min_k, max_k, num_species)
        self.tables = StackedTables.build(dev)

    def classify(self, q_limbs: np.ndarray, read_ids: np.ndarray,
                 num_reads: int, unique: bool = False,
                 want_scores: bool = True) -> TpuMatchResult:
        import jax.numpy as jnp
        from .device import classify_batch

        t = self.tables
        num_k = self.max_k - self.min_k + 1
        res = TpuMatchResult(num_k, self.num_species, num_reads)
        if len(read_ids) == 0 or t.idx_limbs.shape[0] == 0:
            return res

        if unique:
            q_limbs, read_ids = dedup_unique(q_limbs, read_ids)

        m = len(read_ids)
        r_pad = _bucket(num_reads, self.read_bucket)
        L = q_limbs.shape[1]
        dense = self.num_species <= self.dense_max_s

        if dense:
            # dense lowering needs the uniform layout (row m -> read
            # m // kpr): place each read's queries at its block start,
            # padding to the batch's max-windows-per-read rounded to 16
            # (buckets the compile key; equal-length reads compile once)
            counts = np.bincount(read_ids, minlength=num_reads)
            kpr = max((int(counts.max()) + 15) // 16 * 16, 16)
            M = r_pad * kpr
            order = np.argsort(read_ids, kind="stable")
            ql, rl = q_limbs[order], read_ids[order]
            offs = np.zeros(num_reads, dtype=np.int64)
            np.cumsum(counts[:-1], out=offs[1:])
            pos = np.arange(m) - offs[rl]
            dst = rl.astype(np.int64) * kpr + pos
            q = np.zeros((M, L), np.int32)
            v = np.zeros((M,), bool)
            q[dst] = ql
            v[dst] = True
            r = np.zeros((M,), np.int32)   # rows derive from the layout
        else:
            kpr = 0
            m_pad = _bucket(m, self.kmer_bucket)
            q = np.zeros((m_pad, L), np.int32)
            q[:m] = q_limbs
            r = np.zeros((m_pad,), np.int32)
            r[:m] = read_ids
            v = np.zeros((m_pad,), bool)
            v[:m] = True

        scores, counts_all, counts_unique, tail = classify_batch(
            t.idx_limbs, t.grp_id, t.grp_start, t.d_tax, t.masks, t.weights,
            t.run_start, t.run_end, t.prefix_tbl, t.idx_tax,
            jnp.asarray(q), jnp.asarray(r), jnp.asarray(v),
            t.num_steps, t.sub_steps, self.min_k, self.max_k,
            self.highest_k, self.num_species, r_pad, self.cap,
            kmers_per_read=kpr, run_scan_w=0, dense_scores=dense)

        res.scores = np.asarray(scores)[:num_reads]
        res.counts_all = np.asarray(counts_all, dtype=np.float64)
        res.counts_unique = np.asarray(counts_unique).astype(np.uint64)
        res.tail_pairs = int(tail)
        return res

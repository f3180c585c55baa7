"""Out-of-core identify: classify against indices larger than device
(or host) memory by streaming limb0-run-aligned index chunks through
the device, the accelerator counterpart of the reference's disk-backed
stxxl index handles (Compare.hpp:182-318; one stxxl vector per thread,
trie-range-aligned work splits at Compare.hpp:3263-3283).

Design:

  * The index file is memory-mapped (never fully loaded); chunk
    boundaries are cut at limb0-run boundaries, so every k >= 6 prefix
    group lives entirely inside one chunk (k >= 6 masks cover all of
    limb0; groups nest inside limb0 runs).  Scores/counts therefore
    accumulate exactly across chunks: each (query, k) group is scored
    by exactly one chunk.
  * Per-chunk search/score tables (match/device.py StackedTables) are
    built once per run and spilled to a disk cache next to the index
    (``<idx>_oocache/``); classify streams them chunk by chunk into
    device memory.  Host RAM holds one chunk's tables at a time.
  * All chunks are padded to identical shapes (entries to the chunk
    budget; per-level group tables to their per-chunk upper bounds:
    sum_g |taxa(g)| <= entries per level), so the jitted kernel
    compiles once.  Index padding rows are INT32_MAX keys -- larger
    than any real key, so no query ever lands on them.

The -m semantics (main.cpp:590, Compare.hpp:186-276): identify honors
the memory budget by switching to this tiered path when the resident
table footprint would exceed it; -r (cfg.ram) forces full residency
like the reference's RAM mode.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import kmer
from ..index import artifacts
from ..utils import timers

INT32_MAX = np.int32(0x7FFFFFFF)

ARRAY_FIELDS = ("idx_limbs", "grp_id", "grp_start", "d_tax", "masks",
                "weights", "run_start", "run_end", "prefix_tbl", "idx_tax")


def bytes_per_entry(num_limbs: int, num_k: int) -> int:
    """Resident bytes per index entry for the device tables, sized for
    the larger (turbo) layout: keys2 + (N,8) rowdat + per-k grp2 +
    padded d_tax4 (match/turbo.py); the classic layout (limbs + per-k
    grp_id/d_tax + run bounds) is strictly smaller."""
    return 4 * num_limbs + num_k * 8 + 48


def plan_chunks(path: str, chunk_entries: int) -> list[tuple[int, int]]:
    """Cut [0, N) into limb0-run-aligned chunks of <= chunk_entries
    (a single run larger than the budget becomes its own oversized
    chunk).  Run lengths come from the trie RLE file -- the trie
    prefix IS the limb0 value's letters (Trie.hpp:366-394)."""
    _prefixes, counts = artifacts.read_trie(path)
    cuts = [0]
    acc = 0
    for c in counts:
        c = int(c)
        if acc and acc + c > chunk_entries:
            cuts.append(cuts[-1] + acc)
            acc = 0
        acc += c
    n = cuts[-1] + acc
    if acc or not cuts[1:]:
        cuts.append(n)
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]


class TieredIndex:
    """Chunked device-table view of an on-disk 64-bit index."""

    def __init__(self, path: str, tax_to_row: dict, min_k: int, max_k: int,
                 num_species: int, chunk_entries: int,
                 cache_dir: str | None = None):
        n, itype = artifacts.read_info(path)
        if itype != artifacts.INDEX_TYPE_64:
            raise ValueError("tiered identify supports 64-bit indices")
        if min_k < 6:
            raise ValueError("tiered identify needs k >= 6 (prefix-aligned "
                             "chunks)")
        self.path = path
        self.n = n
        self.min_k, self.max_k = min_k, max_k
        self.num_k = max_k - min_k + 1
        self.num_species = num_species
        self.tax_to_row = tax_to_row
        self.rec = np.memmap(path, dtype=artifacts.REC_64, mode="r",
                             shape=(n,))
        self.chunks = plan_chunks(path, chunk_entries)
        self.chunk_pad = max(b - a for a, b in self.chunks)
        self.cache_dir = cache_dir or (path + "_oocache")
        self._scalar = None
        self._max_run = 1
        self._build_cache()

    # -------------------------------------------------------- build
    def _chunk_file(self, ci: int) -> str:
        return os.path.join(self.cache_dir, f"chunk_{ci:05d}.npz")

    def _stamp_file(self) -> str:
        return os.path.join(self.cache_dir, "stamp.txt")

    def _stamp(self) -> str:
        st = os.stat(self.path)
        return (f"{st.st_size},{st.st_mtime_ns},{self.min_k},{self.max_k},"
                f"{self.num_species},{self.chunk_pad},{len(self.chunks)}")

    def _build_cache(self):
        from .join import DeviceIndex
        from .device import StackedTables

        os.makedirs(self.cache_dir, exist_ok=True)
        stamp = self._stamp()
        have = False
        try:
            have = open(self._stamp_file()).read() == stamp
        except OSError:
            pass
        if have:
            z = np.load(self._chunk_file(0))
            self._max_run = int(z["max_run"])
            self._scalar = {k: int(z[k]) for k in
                            ("num_steps", "sub_steps")}
            return
        num_steps = 1
        sub_steps = 1
        max_run = 1
        for ci, (a, b) in enumerate(self.chunks):
            with timers.stage("oocore/build_chunk"):
                rec = self.rec[a:b]
                limbs = kmer.u64_to_limbs(np.ascontiguousarray(rec["kmer"]))
                taxids = np.ascontiguousarray(rec["taxid"])
                dev = DeviceIndex(limbs, taxids, self.tax_to_row,
                                  self.max_k if self.max_k > 12 else 12,
                                  self.min_k, self.max_k, self.num_species)
                t = StackedTables.build(dev)
                arrs = {f: np.asarray(getattr(t, f)) for f in ARRAY_FIELDS}
                arrs = self._pad_chunk(arrs, b - a)
                np.savez(self._chunk_file(ci), max_run=t.max_run,
                         num_steps=t.num_steps, sub_steps=t.sub_steps,
                         **arrs)
                num_steps = max(num_steps, t.num_steps)
                sub_steps = max(sub_steps, t.sub_steps)
                max_run = max(max_run, t.max_run)
        # uniform probe counts across chunks (shapes must not depend on
        # the chunk): store the maxima in every chunk's stamp
        self._scalar = {"num_steps": num_steps, "sub_steps": sub_steps}
        self._max_run = max_run
        with open(self._stamp_file(), "w") as fh:
            fh.write(stamp)

    def _pad_chunk(self, arrs: dict, n_chunk: int) -> dict:
        pad = self.chunk_pad
        num_k = self.num_k
        L = arrs["idx_limbs"].shape[1]
        out = {}
        il = np.full((pad, L), INT32_MAX, np.int32)
        il[:n_chunk] = arrs["idx_limbs"]
        out["idx_limbs"] = il
        gi = np.zeros((num_k, pad), np.int32)
        gi[:, :n_chunk] = arrs["grp_id"]
        out["grp_id"] = gi
        gs = np.zeros((num_k, pad + 2), np.int32)
        g_in = arrs["grp_start"]
        gs[:, :g_in.shape[1]] = g_in
        gs[:, g_in.shape[1]:] = g_in[:, -1:]
        out["grp_start"] = gs
        dt = np.zeros((num_k, pad), np.int32)
        dt[:, :arrs["d_tax"].shape[1]] = arrs["d_tax"][:, :pad]
        out["d_tax"] = dt
        rs = np.full((pad,), pad - 1, np.int32)
        rs[:n_chunk] = arrs["run_start"]
        out["run_start"] = rs
        re = np.full((pad,), pad, np.int32)
        re[:n_chunk] = arrs["run_end"]
        out["run_end"] = re
        it = np.zeros((pad,), np.int32)
        it[:n_chunk] = arrs["idx_tax"]
        out["idx_tax"] = it
        # prefix table indexes into the chunk; clamp to n_chunk
        out["prefix_tbl"] = np.minimum(arrs["prefix_tbl"],
                                       np.int32(n_chunk)).astype(np.int32)
        out["masks"] = arrs["masks"]
        out["weights"] = arrs["weights"]
        return out

    # ------------------------------------------------------ classify
    def device_tables(self):
        """Yield per-chunk table tuples (device arrays, uniform shapes)."""
        import jax.numpy as jnp

        for ci in range(len(self.chunks)):
            with timers.stage("oocore/load_chunk"):
                z = np.load(self._chunk_file(ci))
                yield tuple(jnp.asarray(z[f]) for f in ARRAY_FIELDS)

    def classify(self, q_limbs: np.ndarray, read_ids: np.ndarray,
                 num_reads: int, unique: bool = False,
                 want_scores: bool = True, cap: int = 8):
        """Stream all chunks; accumulate scores/counts.  Interface
        mirrors TpuEngine.classify (match/engine.py)."""
        import jax.numpy as jnp
        from .device import classify_batch
        from .engine import TpuMatchResult, _bucket, dedup_unique

        res = TpuMatchResult(self.num_k, self.num_species, num_reads)
        if len(read_ids) == 0 or self.n == 0:
            return res
        if unique:
            q_limbs, read_ids = dedup_unique(q_limbs, read_ids)
        m = len(read_ids)
        m_pad = _bucket(m, 1 << 13)
        L = q_limbs.shape[1]
        q = np.zeros((m_pad, L), np.int32)
        q[:m] = q_limbs
        r = np.zeros((m_pad,), np.int32)
        r[:m] = read_ids
        v = np.zeros((m_pad,), bool)
        v[:m] = True
        qd, rd, vd = jnp.asarray(q), jnp.asarray(r), jnp.asarray(v)
        dense = self.num_species <= 512

        for tabs in self.device_tables():
            scores, c_all, c_uni, tail = classify_batch(
                *tabs, qd, rd, vd,
                self._scalar["num_steps"], self._scalar["sub_steps"],
                self.min_k, self.max_k,
                25 if self.max_k > 12 else 12, self.num_species,
                num_reads, cap, kmers_per_read=0, run_scan_w=0,
                dense_scores=False)
            res.scores += np.asarray(scores)[:num_reads]
            res.counts_all += np.asarray(c_all, dtype=np.float64)
            res.counts_unique += np.asarray(c_uni).astype(np.uint64)
            res.tail_pairs += int(tail)
        return res

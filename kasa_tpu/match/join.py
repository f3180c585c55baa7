"""The classifier's device-side core: multi-k exact matching + scoring.

The reference's hot loop is a stateful dual-iterator merge-join over
(sorted query k-mers x sorted index) per trie range, with per-k "open
group" registers (compareWithDatabase, Compare.hpp:679-1069).  That
walk reduces to a clean data-parallel formulation:

    For each k and each distinct k-prefix p present in BOTH the query
    batch and the index:
        T_p = distinct taxa of index entries whose k-prefix == p
        H_p = query occurrences whose k-prefix == p
        for each t in T_p:
            counts_all[k][t]  += |H_p| / |T_p|          (double)
            counts_unique[k][t] += |H_p|   if |T_p|==1
            counts_total[k][t] += 1        (with --coverage)
            for each occurrence o in H_p:
                score[read(o)][t] += w(k) * (1f/|T_p|)  (float)

    with w(k) = (k/25)^2 (Compare.hpp:392) and an occurrence invalid at
    k if any query letter in positions [minK-1, k-1] is '^' (the
    reference's early-skip at minK, Compare.hpp:836, and the
    equal-case break, Compare.hpp:897, which also blocks larger k).

Groups are formed per exact k-prefix for every k in [minK, maxK]
(the trie at depth min(minK, 6) only gates which queries can match at
all, Trie.hpp:494-520; a k-prefix with k >= minK existing in the index
implies its trie prefix exists, so no extra gating is needed).

Device kernels: one vectorized lexicographic binary search per
(query, keff) finds the group; per-group taxa live in a compacted
``d_tax`` array with ``grp_start`` offsets (built once at load);
scoring is a bounded slot-expansion + scatter-add.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core import kmer
from ..ops.search import searchsorted_limbs, num_steps_for

HIGHEST_POSSIBLE_K = 25  # arrWeightingFactors size (Compare.hpp:392)


def weight(k: int) -> np.float32:
    """w(k) = k^2/625 as float32 (the reference's tabulated literals)."""
    return np.float32(np.float32(k * k) / np.float32(625.0))


def map_tax_rows(taxids: np.ndarray, tax_to_row: dict) -> np.ndarray:
    """Vectorized taxid -> dense content row mapping: one searchsorted
    against the content file's sorted taxids (S entries), O(n log S).

    (np.unique(return_inverse=True) here cost ~13 s per identify call
    at 33M entries -- measured round 3; the dict itself is tiny.)"""
    if len(taxids) == 0:
        return np.zeros(0, np.int32)
    keys = np.fromiter(tax_to_row.keys(), dtype=np.int64,
                       count=len(tax_to_row))
    vals = np.fromiter(tax_to_row.values(), dtype=np.int32,
                       count=len(tax_to_row))
    kmax = int(keys.max(initial=0))
    kmin = int(keys.min(initial=0))
    if 0 <= kmin and kmax < (1 << 26):
        # dense LUT: one gather instead of searchsorted (which runs at
        # only ~6M queries/s on 33M-element int64 inputs)
        lut = np.full(kmax + 2, -1, np.int32)
        lut[keys] = vals
        rows = lut[np.minimum(taxids, kmax + 1).astype(np.int64)]
        if (rows < 0).any():
            missing = int(taxids[np.nonzero(rows < 0)[0][0]])
            raise KeyError(missing)
        return rows
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    q = taxids.astype(np.int64)
    idx = np.searchsorted(keys, q)
    idx = np.minimum(idx, len(keys) - 1)
    rows = vals[idx]
    bad = keys[idx] != q
    if bad.any():
        missing = int(taxids[np.nonzero(bad)[0][0]])
        raise KeyError(missing)   # same failure mode as the dict path
    return rows


@dataclass
class GroupTable:
    """Per-keff group structures over the sorted index.

    Held as HOST numpy arrays: tables are built on host and uploaded
    once (by StackedTables / the jit wrappers), never read back."""
    keff: int
    grp_id: np.ndarray     # (N,) int32 group id per index entry
    grp_start: np.ndarray  # (G+1,) int32 offsets into d_tax
    d_tax: np.ndarray      # (T,) int32 distinct taxon rows per group
    mask: np.ndarray       # (L,) int32 prefix mask


def build_group_table(limbs: np.ndarray, tax_rows: np.ndarray,
                      highest_k: int, keff: int) -> GroupTable:
    mask = kmer.prefix_masks(highest_k, keff)
    masked = limbs & mask
    n = len(tax_rows)
    if n == 0:
        return GroupTable(keff, np.zeros(0, np.int32), np.zeros(1, np.int32),
                          np.zeros(0, np.int32), mask)
    new = np.empty(n, dtype=bool)
    new[0] = True
    new[1:] = np.any(masked[1:] != masked[:-1], axis=1)
    grp_id = np.cumsum(new, dtype=np.int32) - 1
    num_groups = int(grp_id[-1]) + 1
    # distinct (group, tax) pairs.  grp_id is already non-decreasing,
    # so sorting (grp_id << 24 | tax) ranks pairs lexicographically;
    # the native record sort replaces np.lexsort's stable argsorts
    # (~0.35 us/elem -- 6 levels x 197M entries cost ~13 min of the
    # r3 turbo-table build, VERDICT r3 weak #5)
    pair_grp = d_tax = None
    if n and grp_id[-1] < (1 << 28) and 0 <= int(tax_rows.min()) \
            and int(tax_rows.max()) < (1 << 24):
        from ..native import sort_kmer_tax
        packed = (grp_id.astype(np.uint64) << np.uint64(24)) \
            | tax_rows.astype(np.uint64)
        dummy = np.zeros(n, np.uint32)
        if sort_kmer_tax(packed, dummy, 52, os.cpu_count() or 1):
            first = np.empty(n, dtype=bool)
            first[0] = True
            first[1:] = packed[1:] != packed[:-1]
            pp = packed[first]
            d_tax = (pp & np.uint64((1 << 24) - 1)).astype(np.int32)
            pair_grp = (pp >> np.uint64(24)).astype(np.int32)
    if pair_grp is None:
        order = np.lexsort((tax_rows, grp_id))
        g_s, t_s = grp_id[order], tax_rows[order]
        first = np.empty(n, dtype=bool)
        first[0] = True
        first[1:] = (g_s[1:] != g_s[:-1]) | (t_s[1:] != t_s[:-1])
        d_tax = t_s[first].astype(np.int32)
        pair_grp = g_s[first]
    grp_start = np.searchsorted(pair_grp, np.arange(num_groups + 1)).astype(np.int32)
    return GroupTable(keff, grp_id, grp_start, d_tax, mask)


class DeviceIndex:
    """Sorted index + per-keff group tables resident on device."""

    def __init__(self, limbs: np.ndarray, taxids: np.ndarray,
                 tax_to_row: dict[int, int], highest_k: int,
                 min_k: int, max_k: int, num_species: int):
        self.highest_k = highest_k
        self.min_k = min_k
        self.max_k = max_k
        self.num_species = num_species  # rows 0..num_species-1 (0 = non_unique)
        self.n = len(taxids)
        self.num_limbs = limbs.shape[1] if self.n else kmer.num_limbs(highest_k)
        self.idx_limbs_np = limbs          # host copy (D2H readback is slow)
        self.idx_limbs = jnp.asarray(limbs)
        rows = map_tax_rows(taxids, tax_to_row)
        self.tax_rows = rows
        self.keffs = list(range(min_k, max_k + 1))
        self.tables = {
            keff: build_group_table(limbs, rows, highest_k, keff)
            for keff in self.keffs
        }
        self.num_steps = num_steps_for(self.n)


@functools.partial(jax.jit, static_argnames=("num_steps",))
def _match_one_keff(idx_limbs, grp_id, grp_start, mask, queries, num_steps):
    """-> (matched (M,), g (M,), T (M,), tax_ofs (M,)) for one keff."""
    q = queries & mask
    lo = searchsorted_limbs(idx_limbs, q, num_steps)
    n = idx_limbs.shape[0]
    lo_c = jnp.minimum(lo, n - 1)
    hit_limbs = idx_limbs[lo_c] & mask
    matched = (lo < n) & jnp.all(hit_limbs == q, axis=1)
    g = jnp.where(matched, grp_id[lo_c], 0)
    T = jnp.where(matched, grp_start[g + 1] - grp_start[g], 0)
    return matched, g, T, grp_start[g]


@jax.jit
def _letters_block(queries: jax.Array, positions: tuple) -> jax.Array:
    """(M, P) letter codes at the given positions (static tuple)."""
    cols = []
    for pos in positions:
        i, j = divmod(pos, kmer.LETTERS_PER_LIMB)
        shift = kmer.BITS_PER_LETTER * (kmer.LETTERS_PER_LIMB - 1 - j)
        cols.append((queries[:, i] >> shift) & 31)
    return jnp.stack(cols, axis=1)


@functools.partial(jax.jit, static_argnames=("p_hat", "num_species"))
def _score_scatter(cum: jax.Array, starts: jax.Array, values: jax.Array,
                   rows: jax.Array, d_tax: jax.Array, table_sel: jax.Array,
                   scores: jax.Array, p_hat: int, num_species: int):
    """Expand (slot -> (occurrence, taxon)) pairs and scatter-add.

    cum: (Q+1,) exclusive cumsum of per-occurrence taxa counts
    starts: (Q,) start offset of the occurrence's group in its d_tax
    values: (Q,) float32 per-pair score value (w_k / T)
    rows: (Q,) int32 score-matrix row (read id)
    d_tax: concatenated taxa arrays of all tables;
    table_sel: (Q,) int32 base offset of the occurrence's table in d_tax
    """
    s = jnp.arange(p_hat, dtype=jnp.int32)
    o = jnp.searchsorted(cum, s, side="right").astype(jnp.int32) - 1
    o = jnp.clip(o, 0, starts.shape[0] - 1)
    j = s - cum[o]
    tax = d_tax[table_sel[o] + starts[o] + j]
    valid = s < cum[-1]
    tax = jnp.where(valid, tax, 0)
    row = jnp.where(valid, rows[o], 0)
    val = jnp.where(valid, values[o], jnp.float32(0))
    return scores.at[row, tax].add(val)


def sort_queries(limbs: np.ndarray, read_ids: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Device sort of the query batch by k-mer (payload: read id)."""
    L = limbs.shape[1]
    ops = [jnp.asarray(limbs[:, i]) for i in range(L)] + [jnp.asarray(read_ids)]
    out = jax.lax.sort(ops, num_keys=L)
    cols = [np.asarray(c) for c in out]
    return np.stack(cols[:L], axis=1), cols[L]


class MatchResult:
    def __init__(self, num_k: int, num_species: int, num_reads: int):
        self.scores = np.zeros((num_reads, num_species), dtype=np.float32)
        self.counts_all = np.zeros((num_k, num_species), dtype=np.float64)
        self.counts_unique = np.zeros((num_k, num_species), dtype=np.uint64)
        self.counts_total = np.zeros((num_k, num_species), dtype=np.uint64)


def match_and_score(
    dev: DeviceIndex,
    q_limbs: np.ndarray,
    read_ids: np.ndarray,
    num_reads: int,
    unique: bool = False,
    coverage: bool = False,
    want_scores: bool = True,
) -> MatchResult:
    """Run the full multi-k match for one (already encoded) batch.

    q_limbs need not be pre-sorted; sorting happens on device here.
    """
    min_k, max_k = dev.min_k, dev.max_k
    ks = list(range(max_k, min_k - 1, -1))
    num_k = len(ks)
    res = MatchResult(num_k, dev.num_species, num_reads)
    if len(read_ids) == 0 or dev.n == 0:
        return res

    q_limbs, read_ids = sort_queries(q_limbs, read_ids)
    if unique:
        # -e: drop duplicate (kmer, readID) pairs (Compare.hpp:3167-3178).
        # after sorting by kmer, equal (kmer, read) pairs need not be
        # adjacent; use lexsort on host for exactness.
        order = np.lexsort((read_ids,) + tuple(q_limbs[:, i] for i in range(q_limbs.shape[1] - 1, -1, -1)))
        ql, rl = q_limbs[order], read_ids[order]
        keep = np.empty(len(rl), dtype=bool)
        keep[0] = True
        keep[1:] = np.any(ql[1:] != ql[:-1], axis=1) | (rl[1:] != rl[:-1])
        # restore kmer-sorted order (it already is: lexsort's primary keys
        # are the limbs)
        q_limbs, read_ids = ql[keep], rl[keep]

    m = len(read_ids)
    qj = jnp.asarray(q_limbs)

    # letters needed for validity: positions minK-1 .. maxK-1
    positions = tuple(range(min_k - 1, max_k))
    letters = np.asarray(_letters_block(qj, positions))
    ok = letters != 30
    # valid at k requires all positions minK-1..k-1 clean (cumulative AND)
    cum_ok = np.cumprod(ok, axis=1).astype(bool)  # column j -> k = minK+j

    per_keff = {}
    for keff in dev.keffs:
        t = dev.tables[keff]
        matched, g, T, start = _match_one_keff(
            dev.idx_limbs, t.grp_id, t.grp_start, t.mask, qj, dev.num_steps)
        per_keff[keff] = (np.asarray(matched), np.asarray(g), np.asarray(T),
                          np.asarray(start))

    # ---- per-k segment (group) statistics for the profile counts
    d_tax_np = {keff: np.asarray(dev.tables[keff].d_tax) for keff in dev.keffs}
    for ki, k in enumerate(ks):
        keff = k
        matched, g, T, start = per_keff[keff]
        valid = matched & cum_ok[:, k - min_k]
        if not valid.any():
            continue
        vg = g[valid]
        seg_first = np.empty(len(vg), dtype=bool)
        seg_first[0] = True
        seg_first[1:] = vg[1:] != vg[:-1]
        seg_ids = np.cumsum(seg_first) - 1
        h = np.bincount(seg_ids)  # occurrences per matched group
        seg_g = vg[seg_first]
        seg_T = T[valid][seg_first]
        seg_start = start[valid][seg_first]
        dt = d_tax_np[keff]
        # expand group x taxa on host (exact double accumulation)
        reps = seg_T
        tax_flat = np.concatenate([
            dt[s:s + c] for s, c in zip(seg_start, reps)
        ]) if len(seg_start) else np.zeros(0, np.int32)
        h_flat = np.repeat(h, reps)
        T_flat = np.repeat(seg_T, reps)
        np.add.at(res.counts_all[ki], tax_flat, h_flat.astype(np.float64) / T_flat)
        uniq_mask = T_flat == 1
        np.add.at(res.counts_unique[ki], tax_flat[uniq_mask],
                  h_flat[uniq_mask].astype(np.uint64))
        if coverage:
            np.add.at(res.counts_total[ki], tax_flat, 1)

        # ---- score matrix scatter (device)
        if want_scores:
            inv_T = np.float32(1.0) / seg_T.astype(np.float32)
            w = weight(k)
            # per-occurrence expansion: occurrence o in segment s gets
            # value w * inv_T[s] over the segment's taxa
            occ_T = np.repeat(seg_T, h).astype(np.int64)
            occ_start = np.repeat(seg_start, h)
            occ_val = np.repeat(np.float32(w) * inv_T, h)
            occ_rows = read_ids[valid].astype(np.int32)
            cum = np.zeros(len(occ_T) + 1, dtype=np.int64)
            np.cumsum(occ_T, out=cum[1:])
            total = int(cum[-1])
            if total == 0:
                continue
            p_hat = 1 << (total - 1).bit_length()
            scores_dev = jnp.asarray(res.scores)
            scores_dev = _score_scatter(
                jnp.asarray(cum.astype(np.int32)),
                jnp.asarray(occ_start.astype(np.int32)),
                jnp.asarray(occ_val),
                jnp.asarray(occ_rows),
                dev.tables[keff].d_tax,
                jnp.zeros(len(occ_T), dtype=jnp.int32),
                scores_dev, p_hat, dev.num_species)
            res.scores = np.asarray(scores_dev)

    return res

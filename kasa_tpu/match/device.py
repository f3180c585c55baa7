"""Fully-jitted device classify kernel -- the classic throughput path.

One compiled XLA program per (batch shape, index shape): run the
fixed-iteration lexicographic binary search for every k in
[minK, maxK], then accumulate split-credit scores into the
(reads x species) matrix.  Replaces the reference's per-thread stateful
merge-join (Compare.hpp:679-1069) with branchless vector ops:

  * dense prefix-table gather + a few residual binary-search probes
    per level k (log2(max bucket) rounds of gather/compare/select),
  * EXACT taxa expansion in two stages: a static base tile of `cap`
    taxa slots per matched query (vectorized, covers nearly all
    groups on real indices), plus a `lax.while_loop` over further
    cap-wide tiles that runs only while some matched group still has
    unprocessed taxa -- no group is ever truncated, at any taxa
    count (the reference caps nothing either, Compare.hpp:516-597).

Two scoring lowerings, chosen by the static `dense_scores` flag:

  * dense (small species axis): base-tile hits become (M, S) one-hot
    masks reduced per read block -- elementwise work, no scatter.
    Requires the uniform read layout (row m -> read m//kmers_per_read).
  * scatter (large species axis): (read, taxon) cells are scatter-
    added into a flat (R*S,) vector; work is O(M*cap) independent of
    S, which is what survives S >= 10k species.

Semantics (validity via '^' letters, per-k prefix groups, w(k)/|T|
split credit) match match/join.py; bit-exact reference parity lives in
match/exact.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core import kmer
from .join import DeviceIndex, weight

# The first phase of every lookup resolves the leading letters of the
# query against a DENSE prefix-offset table -- the device analogue of the
# reference's trie (Trie.hpp:323 direct-lookup mode, which is exactly
# offset[prefix] over the first 6 letters).  20 bits = 4 letters keeps
# the table at 4 MB while cutting the global binary search down to a
# few residual probes within one prefix bucket.
PREFIX_BITS = 20
_PREFIX_SHIFT = 30 - PREFIX_BITS   # limb0 holds 6 letters x 5 bits


@dataclass
class StackedTables:
    """Per-k group tables padded & stacked for a single jit signature.

    The search is hierarchical: one limb0 (first-6-letter) lower_bound
    over the whole index, then per-k short searches over limb1 within
    the limb0 run -- `run_start`/`run_end` give the run bounds per
    index position and `sub_steps` is log2(longest run)."""
    idx_limbs: jax.Array    # (N, L) int32 sorted index
    grp_id: jax.Array       # (numK, N) int32
    grp_start: jax.Array    # (numK, Gmax+1) int32 offsets into d_tax rows
    d_tax: jax.Array        # (numK, Tmax) int32
    masks: jax.Array        # (numK, L) int32 prefix masks
    weights: jax.Array      # (numK,) float32 w(k)
    run_start: jax.Array    # (N,) int32 start of this entry's limb0 run
    run_end: jax.Array      # (N,) int32 end (exclusive)
    prefix_tbl: jax.Array   # (2^PREFIX_BITS + 1,) int32 bucket offsets
    idx_tax: jax.Array      # (N,) int32 dense taxon row per entry
    max_run: int            # longest limb0 run (static index property)
    min_k: int
    max_k: int
    highest_k: int
    num_steps: int
    sub_steps: int
    num_species: int

    @classmethod
    def build(cls, dev: DeviceIndex) -> "StackedTables":
        from ..ops.search import num_steps_for
        # row ki <-> k = max_k - ki (profile row convention, _aOfK order)
        ks = list(range(dev.max_k, dev.min_k - 1, -1))
        n = dev.n
        num_k = len(ks)
        g_max = max(int(dev.tables[k].grp_start.shape[0]) for k in ks)
        t_max = max(int(dev.tables[k].d_tax.shape[0]) for k in ks)
        L = dev.num_limbs
        grp_id = np.zeros((num_k, n), np.int32)
        grp_start = np.zeros((num_k, g_max), np.int32)
        d_tax = np.zeros((num_k, t_max), np.int32)
        masks = np.zeros((num_k, L), np.int32)
        w = np.zeros((num_k,), np.float32)
        for i, k in enumerate(ks):
            t = dev.tables[k]
            grp_id[i, :] = t.grp_id
            gs = t.grp_start
            grp_start[i, :len(gs)] = gs
            grp_start[i, len(gs):] = gs[-1] if len(gs) else 0
            d_tax[i, :len(t.d_tax)] = t.d_tax
            masks[i, :] = t.mask
            w[i] = weight(k)

        # limb0 run bounds
        limb0 = dev.idx_limbs_np[:, 0] if n else np.zeros(0, np.int32)
        if n:
            new = np.r_[True, limb0[1:] != limb0[:-1]]
            run_ids = np.cumsum(new) - 1
            starts = np.nonzero(new)[0].astype(np.int32)
            ends = np.r_[starts[1:], np.int32(n)].astype(np.int32)
            run_start = starts[run_ids]
            run_end = ends[run_ids]
            max_run = int((ends - starts).max())
        else:
            run_start = np.zeros(0, np.int32)
            run_end = np.zeros(0, np.int32)
            max_run = 1

        # dense prefix bucket offsets + residual probe count
        if n:
            prefix_tbl = np.searchsorted(
                limb0.astype(np.int64),
                np.arange((1 << PREFIX_BITS) + 1, dtype=np.int64)
                << _PREFIX_SHIFT).astype(np.int32)
            p0_steps = num_steps_for(int(np.diff(prefix_tbl).max()))
        else:
            prefix_tbl = np.zeros((1 << PREFIX_BITS) + 1, np.int32)
            p0_steps = 1
        idx_tax = (np.asarray(dev.tax_rows, np.int32) if n
                   else np.zeros(0, np.int32))
        return cls(jnp.asarray(dev.idx_limbs), jnp.asarray(grp_id),
                   jnp.asarray(grp_start), jnp.asarray(d_tax),
                   jnp.asarray(masks), jnp.asarray(w),
                   jnp.asarray(run_start), jnp.asarray(run_end),
                   jnp.asarray(prefix_tbl), jnp.asarray(idx_tax), max_run,
                   dev.min_k, dev.max_k, dev.highest_k, p0_steps,
                   num_steps_for(max_run), dev.num_species)


def _lex_less_cols(a_cols, b_cols):
    result = jnp.zeros(jnp.broadcast_shapes(a_cols[0].shape, b_cols[0].shape), bool)
    decided = jnp.zeros_like(result)
    for a, b in zip(a_cols, b_cols):
        lt, gt = a < b, a > b
        result = jnp.where(~decided & lt, True, result)
        decided = decided | lt | gt
    return result


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "sub_steps", "min_k", "max_k", "highest_k",
                     "num_species", "num_reads", "cap", "kmers_per_read",
                     "run_scan_w", "dense_scores"))
def classify_batch(
    idx_limbs: jax.Array,      # (N, L)
    grp_id: jax.Array,         # (numK, N)
    grp_start: jax.Array,      # (numK, Gmax)
    d_tax: jax.Array,          # (numK, Tmax)
    masks: jax.Array,          # (numK, L)
    weights: jax.Array,        # (numK,)
    run_start: jax.Array,      # (N,)
    run_end: jax.Array,        # (N,)
    prefix_tbl: jax.Array,     # (2^PREFIX_BITS + 1,)
    idx_tax: jax.Array,        # (N,) dense taxon rows (run-scan path)
    q_limbs: jax.Array,        # (M, L) int32, any order
    read_ids: jax.Array,       # (M,) int32
    q_valid: jax.Array,        # (M,) bool (padding slots False)
    num_steps: int, sub_steps: int, min_k: int, max_k: int, highest_k: int,
    num_species: int, num_reads: int, cap: int = 16,
    kmers_per_read: int = 0, run_scan_w: int = 0,
    dense_scores: bool | None = None,
):
    """-> (scores (R,S) f32, counts_all (numK,S) f32,
           counts_unique (numK,S) i32, tail_pairs scalar i32).

    Hierarchical search (hot path, k >= 6): a dense prefix-table gather
    narrows limb0 to one bucket, a short lower_bound (num_steps
    residual probes) resolves it, then per-k short masked-limb1
    searches bounded by the limb0 run (sub_steps probes).  For k < 6 a
    full masked search per level is used instead.

    Scoring is EXACT for every group size: a static base tile covers
    the first `cap` taxa of each matched group, and a while_loop walks
    further cap-wide tiles while any matched group still has taxa left
    (`tail_pairs` reports how many (query, taxon) pairs that tail
    processed -- nothing is dropped, matching Compare.hpp:516-597).

    `dense_scores=True` (uniform layout required: query row m belongs
    to read m // kmers_per_read) lowers the base tile to one-hot
    reductions + reshape segment-sums -- no scatter, which is fastest
    while S is small.  `dense_scores=False` scatter-adds flat
    (read*S + taxon) cells instead: O(M*cap) work independent of the
    species-axis size, the only shape that survives S >= 10k.  Queries
    are never sorted: each probe sequence is independent, so batch
    order is irrelevant (the reference sorts only to enable its linear
    merge walk, Compare.hpp:1074)."""
    n = idx_limbs.shape[0]
    L = idx_limbs.shape[1]
    M = q_limbs.shape[0]
    num_k = max_k - min_k + 1
    uniform = kmers_per_read > 0
    if uniform:
        assert M % kmers_per_read == 0 and M // kmers_per_read <= num_reads
    if dense_scores is None:
        dense_scores = uniform
    if dense_scores:
        assert uniform, "dense_scores needs the uniform read layout"

    q_cols = [q_limbs[:, i] for i in range(L)]
    rid = read_ids
    alive = q_valid

    # ---- '^' validity: cum over letter positions minK-1..maxK-1
    def letter(pos):
        i, j = divmod(pos, kmer.LETTERS_PER_LIMB)
        shift = kmer.BITS_PER_LETTER * (kmer.LETTERS_PER_LIMB - 1 - j)
        return (q_cols[i] >> shift) & 31
    ok = jnp.ones((M,), bool)
    cum_ok_by_k = []      # index j -> k = min_k + j
    for pos in range(min_k - 1, max_k):
        ok = ok & (letter(pos) != 30)
        cum_ok_by_k.append(ok)
    # row ki <-> k = max_k - ki
    cum_ok = [cum_ok_by_k[max_k - min_k - ki] for ki in range(num_k)]

    # flat (R*S,) score cells: 1-D scatters lower much better than 2-D
    scores_flat = jnp.zeros((num_reads * num_species + 1,), jnp.float32)
    scores_dense = jnp.zeros((num_reads, num_species), jnp.float32)
    counts_all = jnp.zeros((num_k, num_species), jnp.float32)
    counts_unique = jnp.zeros((num_k, num_species), jnp.int32)
    overflow = jnp.zeros((), jnp.int32)

    idx_cols = [idx_limbs[:, i] for i in range(L)]
    cap_iota = jnp.arange(cap, dtype=jnp.int32)
    species_iota = jnp.arange(num_species, dtype=jnp.int32)

    # ---- shared limb0 phase: prefix bucket gather + residual search
    idx0 = idx_cols[0]
    q0 = q_cols[0]
    bucket = q0 >> _PREFIX_SHIFT
    lo = prefix_tbl[bucket]
    hi = prefix_tbl[bucket + 1]
    def body0(_, carry):
        lo, hi = carry
        mid = (lo + hi) >> 1
        less = idx0[mid] < q0
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)
    lo, hi = jax.lax.fori_loop(0, num_steps, body0, (lo, hi))
    lo0c = jnp.minimum(lo, n - 1)
    matched0 = (lo < n) & (idx0[lo0c] == q0) & alive
    ra = jnp.where(matched0, run_start[lo0c], 0)
    rb = jnp.where(matched0, run_end[lo0c], 0)

    # ---- run-scan path: when the longest limb0 run fits W entries
    # (a static index property, StackedTables.max_run), every k >= 6
    # level is resolved by ONE W-wide scan of the shared limb0 run:
    # no per-k searches, no group-table gathers, and taxa dedup (T) and
    # uniqueness fall out of the one-hot any/sum.  Exact (no cap).
    if run_scan_w:
        assert uniform and L == 2 and min_k >= 6, \
            "run-scan path needs uniform layout, 2 limbs, min_k >= 6"
        W = run_scan_w
        w_iota = jnp.arange(W, dtype=jnp.int32)
        pos_w = jnp.minimum(ra[:, None] + w_iota[None, :], n - 1)
        valid_w = (ra[:, None] + w_iota[None, :]) < rb[:, None]
        limb1_w = idx_cols[1][pos_w]                      # (M, W)
        tax_w = idx_tax[pos_w]                            # (M, W)
        onehot_w = tax_w[:, :, None] == species_iota      # (M, W, S)
        rblocks = M // kmers_per_read
        for ki in range(num_k):
            m1 = masks[ki][1]
            q1m = q_cols[1] & m1
            match_w = valid_w & ((limb1_w & m1) == q1m[:, None])
            hit = (jnp.any(onehot_w & match_w[:, :, None], axis=1)
                   & cum_ok[ki][:, None])                 # (M, S)
            T = jnp.sum(hit, axis=1, dtype=jnp.int32)
            w_over_t = jnp.where(T > 0, weights[ki] / T.astype(jnp.float32), 0.0)
            inv_t = jnp.where(T > 0, 1.0 / T.astype(jnp.float32), 0.0)
            per_q = jnp.where(hit, w_over_t[:, None], 0.0)
            scores_dense = scores_dense.at[:rblocks].add(
                per_q.reshape(rblocks, kmers_per_read, num_species).sum(axis=1))
            counts_all = counts_all.at[ki].add(
                jnp.sum(jnp.where(hit, inv_t[:, None], 0.0), axis=0))
            counts_unique = counts_unique.at[ki].add(jnp.sum(
                hit & (T == 1)[:, None], axis=0, dtype=jnp.int32))
        return scores_dense, counts_all, counts_unique, overflow

    # row id per query (dense path ignores rid and derives rows from
    # the uniform layout; scatter + tail need explicit rows)
    rows = (jnp.arange(M, dtype=jnp.int32) // kmers_per_read) if uniform \
        else rid
    sentinel = num_reads * num_species

    # ---- ONE full-key lower_bound decides EVERY k >= 6 level.
    # k-prefix groups nest inside the sorted order, so for the level-k
    # group [a, b) of a query q: every entry before a has a smaller
    # masked prefix (hence a smaller full key than q) and every entry
    # from b on a larger one, which pins lower_bound(full q) into
    # [a, b].  A nonempty group therefore shows q's k-prefix at pos or
    # pos-1; an empty one at neither.  This replaces the reference's
    # per-k binary searches (Compare.hpp:865-993) with two gathered
    # index rows reused across all k levels -- per-k work is elementwise.
    fullkey = (L == 2 and min_k >= 6)
    if fullkey:
        q1f = q_cols[1]
        slo, shi = ra, rb
        def bodyfk(_, carry):
            slo, shi = carry
            mid = (slo + shi) >> 1
            less = idx_cols[1][jnp.minimum(mid, n - 1)] < q1f
            return jnp.where(less, mid + 1, slo), jnp.where(less, shi, mid)
        slo, _ = jax.lax.fori_loop(0, sub_steps, bodyfk, (slo, shi))
        # the fixed-iteration search may overshoot by one past rb after
        # converging (post-convergence probes read outside the run);
        # the true lower bound is always in [ra, rb]
        pos = jnp.minimum(slo, rb)
        pos_c = jnp.minimum(pos, n - 1)
        prev_c = jnp.maximum(pos - 1, 0)
        at_pos1 = idx_cols[1][pos_c]
        at_prev1 = idx_cols[1][prev_c]
        # both positions stay inside the limb0 run, so limb0 equality
        # is implied by matched0
        pos_ok = matched0 & (pos < rb)
        prev_ok = matched0 & (pos > ra)

    T_levels = []       # (M,) taxa count per query per level
    ts_levels = []      # (M,) d_tax offset per query per level

    for ki in range(num_k):          # unrolled: one fused region per k
        k = max_k - ki
        mask = masks[ki]
        if fullkey and 6 <= k <= 2 * kmer.LETTERS_PER_LIMB:
            m1 = mask[1]
            q1m = q_cols[1] & m1
            hit_at = pos_ok & ((at_pos1 & m1) == q1m)
            hit_prev = prev_ok & ((at_prev1 & m1) == q1m)
            matched = (hit_at | hit_prev) & cum_ok[ki]
            lo_c = jnp.where(hit_at, pos_c, prev_c)
        elif 6 <= k <= 2 * kmer.LETTERS_PER_LIMB and L == 2:
            # limb1 search within the limb0 run [ra, rb)
            m1 = mask[1]
            q1 = q_cols[1] & m1
            slo, shi = ra, rb
            def body1(_, carry):
                slo, shi = carry
                mid = (slo + shi) >> 1
                less = (idx_cols[1][jnp.minimum(mid, n - 1)] & m1) < q1
                return jnp.where(less, mid + 1, slo), jnp.where(less, shi, mid)
            slo, shi = jax.lax.fori_loop(0, sub_steps, body1, (slo, shi))
            lo_c = jnp.minimum(slo, n - 1)
            hit_eq = matched0 & (slo < rb) & ((idx_cols[1][lo_c] & m1) == q1)
            if L > 2:
                for i in range(2, L):
                    hit_eq = hit_eq & ((idx_cols[i][lo_c] & mask[i])
                                       == (q_cols[i] & mask[i]))
            matched = hit_eq & cum_ok[ki]
        else:
            # k < 6: full masked search per level (cannot use the prefix
            # bucket: the mask covers fewer letters than the prefix)
            from ..ops.search import num_steps_for
            qk = [c & mask[i] for i, c in enumerate(q_cols)]
            flo = jnp.zeros((M,), jnp.int32)
            fhi = jnp.full((M,), n, jnp.int32)
            def bodyf(_, carry):
                flo, fhi = carry
                mid = (flo + fhi) >> 1
                mid_cols = [(idx_cols[i][mid] & mask[i]) for i in range(L)]
                less = _lex_less_cols(mid_cols, qk)
                return jnp.where(less, mid + 1, flo), jnp.where(less, fhi, mid)
            flo, fhi = jax.lax.fori_loop(0, num_steps_for(n), bodyf, (flo, fhi))
            lo_c = jnp.minimum(flo, n - 1)
            hit_eq = jnp.ones((M,), bool)
            for i in range(L):
                hit_eq = hit_eq & ((idx_cols[i][lo_c] & mask[i]) == qk[i])
            matched = (flo < n) & hit_eq & cum_ok[ki] & alive

        g = jnp.where(matched, grp_id[ki][lo_c], 0)
        t_start = grp_start[ki][g]
        T = jnp.where(matched, grp_start[ki][g + 1] - t_start, 0)
        T_levels.append(T)
        ts_levels.append(t_start)

        # ---- base tile: first `cap` taxa of each matched group
        w_over_t = jnp.where(T > 0, weights[ki] / T.astype(jnp.float32), 0.0)
        inv_t = jnp.where(T > 0, 1.0 / T.astype(jnp.float32), 0.0)
        slot_tax = d_tax[ki][jnp.minimum(t_start[:, None] + cap_iota[None, :],
                                         d_tax.shape[1] - 1)]
        slot_ok = (cap_iota[None, :] < jnp.minimum(T, cap)[:, None]) & matched[:, None]
        uniq = matched & (T == 1)
        tax_first = d_tax[ki][t_start]

        if dense_scores:
            # one-hot reduction: hit[m, s] = taxon s is in query m's slot
            # list (a taxon appears at most once per group, so 'any'
            # over the cap axis is exact).  All-dense elementwise work; the
            # reshape turns the per-query matrix into per-read rows.
            hit = jnp.any((slot_tax[:, :, None] == species_iota) &
                          slot_ok[:, :, None], axis=1)           # (M, S)
            per_q = jnp.where(hit, w_over_t[:, None], 0.0)
            scores_dense = scores_dense.at[:M // kmers_per_read].add(
                per_q.reshape(M // kmers_per_read, kmers_per_read,
                              num_species).sum(axis=1))
            counts_all = counts_all.at[ki].add(
                jnp.sum(jnp.where(hit, inv_t[:, None], 0.0), axis=0))
            counts_unique = counts_unique.at[ki].add(jnp.sum(
                (tax_first[:, None] == species_iota) & uniq[:, None],
                axis=0, dtype=jnp.int32))
        else:
            cell = jnp.where(slot_ok,
                             rows[:, None] * num_species + slot_tax,
                             sentinel)
            slot_val = jnp.where(slot_ok, w_over_t[:, None], 0.0)
            scores_flat = scores_flat.at[cell.reshape(-1)].add(
                slot_val.reshape(-1))
            # counts_all[k][t] += H_g/T_g per group == each of the H_g
            # occurrences contributing 1/T_g to each taxon
            cslot_val = jnp.where(slot_ok, inv_t[:, None], 0.0)
            counts_all = counts_all.at[
                jnp.full(M * cap, ki),
                jnp.where(slot_ok, slot_tax, 0).reshape(-1)].add(
                cslot_val.reshape(-1), mode="drop")
            counts_unique = counts_unique.at[
                jnp.full(M, ki), jnp.where(uniq, tax_first, 0)].add(
                uniq.astype(jnp.int32), mode="drop")

    # ---- exact tail: while any matched group still has taxa beyond
    # the base tile, scatter further cap-wide tiles (rare on real
    # indices -- the redundancy histogram's tail -- so the loop body
    # usually never runs; scores and counts stay exact regardless of
    # the group's taxa count)
    T_stack = jnp.stack(T_levels)        # (numK, M)
    ts_stack = jnp.stack(ts_levels)      # (numK, M)
    overflow = jnp.sum(jnp.maximum(T_stack - cap, 0))

    def tail_cond(state):
        j = state[0]
        return jnp.any(T_stack > j * cap)

    def tail_body(state):
        j, sf, ca = state
        for ki in range(num_k):
            T = T_stack[ki]
            base = ts_stack[ki] + j * cap
            slot = base[:, None] + cap_iota[None, :]
            ok = slot < (ts_stack[ki] + T)[:, None]
            tax = d_tax[ki][jnp.minimum(slot, d_tax.shape[1] - 1)]
            w_over_t = jnp.where(T > 0, weights[ki] / T.astype(jnp.float32), 0.0)
            inv_t = jnp.where(T > 0, 1.0 / T.astype(jnp.float32), 0.0)
            cell = jnp.where(ok, rows[:, None] * num_species + tax, sentinel)
            sf = sf.at[cell.reshape(-1)].add(
                jnp.where(ok, w_over_t[:, None], 0.0).reshape(-1))
            ca = ca.at[jnp.full(M * cap, ki),
                       jnp.where(ok, tax, 0).reshape(-1)].add(
                jnp.where(ok, inv_t[:, None], 0.0).reshape(-1), mode="drop")
        return (j + 1, sf, ca)

    _, scores_flat, counts_all = jax.lax.while_loop(
        tail_cond, tail_body, (jnp.int32(1), scores_flat, counts_all))

    tail = scores_flat[:num_reads * num_species].reshape(
        num_reads, num_species)
    scores = (scores_dense + tail) if dense_scores else tail
    return scores, counts_all, counts_unique, overflow


def run_classify(tables: StackedTables, q_limbs: np.ndarray,
                 read_ids: np.ndarray, num_reads: int, cap: int = 16):
    """Host wrapper: pad the batch to a bucketed static M and invoke."""
    m = len(read_ids)
    m_pad = 1024
    while m_pad < m:
        m_pad <<= 1
    L = tables.idx_limbs.shape[1]
    q = np.zeros((m_pad, L), np.int32)
    q[:m] = q_limbs
    r = np.zeros((m_pad,), np.int32)
    r[:m] = read_ids
    v = np.zeros((m_pad,), bool)
    v[:m] = True
    return classify_batch(
        tables.idx_limbs, tables.grp_id, tables.grp_start, tables.d_tax,
        tables.masks, tables.weights, tables.run_start, tables.run_end,
        tables.prefix_tbl, tables.idx_tax,
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(v),
        tables.num_steps, tables.sub_steps, tables.min_k, tables.max_k,
        tables.highest_k, tables.num_species, num_reads, cap)

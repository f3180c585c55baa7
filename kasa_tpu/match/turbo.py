"""Turbo classify kernel -- gather-minimal device path for identify.

Replaces the reference's per-thread merge-join (Compare.hpp:679-1069)
with a design that keeps random gathers and scatters few and favours
row-gathers, sorts and scans.  That balance was chosen for an earlier
accelerator and is a design note here: none of its primitive costs
has been measured on the GPU yet.

  * ONE full-key (two 30-bit limbs, lexicographic) lower_bound per
    query decides EVERY k level: the level-k group [a,b) of a query
    pins lower_bound(full key) into [a,b], so a nonempty group shows
    the k-prefix at pos or pos-1 (holds for any k with 5k >= router
    bits; the pos-1 row is read unconstrained, so router bucket
    boundaries cannot hide a prefix match).  The search is a dense
    24-bit router row + an adaptive dense sub-router for fat buckets
    (skewed prefixes) + <= a few residual probes.
  * Per-entry data rides in a (N,4) int32 row [limb0, limb1, tax,
    Tpack] (two gathers: the row at pos and its predecessor); per-
    level distinct-taxa counts are packed 5 bits each in Tpack, so
    the dominant T == 1 case needs no group-table access at all (the
    group's only taxon is the matched entry's own).
  * T == 1 scoring uses NO scatters: slots (taxon, credit) are laid
    out read-major and reduced by per-read sorts + segment scans into
    compact per-read (tax, ksum) lists -- what the sparse native
    ranker consumes (native/writer.cpp kasa_rank_format_sparse).
  * Multi-taxa groups (T >= 2) go through a GLOBAL batch worklist:
    flat compaction sort, exact-T descending sort, then position-
    banded expansion (the heaviest groups sit first, so static per-
    band taxa caps hold by construction) with early-exit while loops
    -- work scales with the batch's true (query, taxon) pair count,
    exactly like the reference's taxa walk (Compare.hpp:516-597), and
    no per-READ budget exists, so conserved-gene reads (hundreds of
    multi-taxa windows) stay on device.
  * Reads that still exceed a budget (a group with more taxa than the
    top band cap, > CW distinct (tax,k) pairs, worklist overflow) are
    flagged, their device contributions zeroed pre-scatter, and the
    host recomputes them exactly (host_classify_read).

Scoring semantics match match/join.py (split credit w(k)/T, '^'
validity, per-k prefix groups); bit-exact reference parity stays with
match/exact.py.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core import kmer
from .join import DeviceIndex, weight

ROUTER_BITS = 24            # dense router over the top bits of limb0
SUB_BITS = 24               # max extra bits resolved by a sub-router
                            # (r5: 16 left conserved 8-letter prefixes
                            # with ~255-key residuals -> 8 bisect steps
                            # of one (N, 2) gather each; 24 resolves
                            # 48 bits = 9.6 letters.  Memory stays
                            # ~2 * size / RESID rows per fat bucket --
                            # s_b is sized by the bucket, the cap only
                            # binds for buckets > RESID * 2^24)
RESID = int(os.environ.get("KASA_RESID", 8))  # target residual bucket size
LIMB_BITS = 30              # 6 letters x 5 bits per limb

MULTI_BUDGET = 1 << 19      # global multi-slot worklist size per batch
# (a batch with more multi slots than the worklist flags EVERY multi
# read onto the host; heavily conserved corpora hit ~130k slots per
# 4096-read batch, so keep generous headroom)
# multi expansion budget: total (slot, 4-taxa-row) expansion rows per
# batch.  The worklist is exact-T-ascending, so when a batch's true
# pair count exceeds the budget the HEAVIEST slots drop and their
# reads take the host fallback.  (This replaced position-banded
# while-loops, whose serial trip counts and tight caps had flagged
# 8.8% of reads.)
EXP_BUDGET = 1 << 19

# hot taxa-set path: conserved genes give MANY groups the SAME distinct
# taxa set; the top HOT_SETS sets (by index-entry weight) are scored as
# a dense (R, H) credit matrix folded through ONE (R,H)@(H,S) matrix
# product instead of per-pair scatters.  Budget-capped so the mask
# stays small for huge S.  Whether this tier pays on the GPU, where
# scatter-add is cheap, is not measured yet.
HOT_SETS = int(os.environ.get("KASA_HOT_SETS", 512))
# species-count threshold: above it the kernel folds multi credits
# through a sorted (read, tax) pair list instead of a dense (R, S)
# score matrix (whose sorts scale with S -- ~1/3 of the 197M-corpus
# kernel at S=10001), and the table builder skips the hot tier (the
# sparse fold has no dense membership mask to fold hot sets through)
SPARSE_FOLD_S = int(os.environ.get("KASA_SPARSE_FOLD_S", 4096))
HOT_MASK_BYTES = 64 << 20

# packed-readback tuning (fast path + mesh): CSR hit-list capacity is
# CSR_CAP_FACTOR * reads per block; count accumulators flush every
# COUNT_FLUSH batches
CSR_CAP_FACTOR = int(os.environ.get("KASA_CSR_CAP_FACTOR", 4))
COUNT_FLUSH = int(os.environ.get("KASA_COUNT_FLUSH", 64))

class TurboRowOverflow(RuntimeError):
    """d_tax4 would need >= 2^31 rows: the int32 grp2 pointers would
    wrap (negative pointers read as hot-set ids -> silent wrong
    classifications, ADVICE r4).  Callers fall back to the tiered /
    classic engines, whose per-chunk tables stay int32-safe."""


CW = 160                    # compact (tax, k) runs kept per read (T1)
# a window of six '^' letters: always invalid at every k, used to
# poison -e duplicates
POISON_LIMB = np.int32(sum(30 << (5 * j) for j in range(6)))
WOUT = 160                  # distinct taxa emitted per read (>= the
                            # realistic conserved-set size, so T~150
                            # ultra-conserved reads stay on device --
                            # r2's 48 forced every such read through
                            # the host; 256 measurably slowed the
                            # folds, 160 = CW covers the T1 width)
WM = 160                    # distinct multi taxa folded per read
I32_MAX = np.int32(2**31 - 1)
_HIGHEST = jax.lax.Precision.HIGHEST


def dedup_read_windows(q_limbs, num_reads, kmers_per_read):
    """-e: drop duplicate (kmer, readID) pairs (Compare.hpp:3166-3177)
    inside the kernel: one per-read L-key sort brings equal windows of
    a read adjacent; duplicates are poisoned to all-'^' limbs, which
    self-mask at every k.  Window order within a read is irrelevant to
    the read-major aggregation, so the sorted layout stands."""
    R, kpr = num_reads, kmers_per_read
    L = q_limbs.shape[1]
    cols = [q_limbs[:, i].reshape(R, kpr) for i in range(L)]
    ss = jax.lax.sort(tuple(cols), dimension=1, num_keys=L)
    dup = None
    for s in ss:
        p = jnp.concatenate([jnp.full((R, 1), -1, jnp.int32), s[:, :-1]],
                            axis=1)
        d = s == p
        dup = d if dup is None else (dup & d)
    out = [jnp.where(dup, POISON_LIMB, s).reshape(-1) for s in ss]
    return jnp.stack(out, axis=1)


def dedup_windows_np(q: np.ndarray) -> np.ndarray:
    """Host twin for the overflow fallback: distinct windows only."""
    if q.shape[1] == 2:
        q64 = (q[:, 0].astype(np.int64) << LIMB_BITS) \
            | q[:, 1].astype(np.int64)
        _, first = np.unique(q64, return_index=True)
        return q[np.sort(first)]
    qq = np.ascontiguousarray(q)
    v = qq.view([("", qq.dtype)] * qq.shape[1]).ravel()
    _, first = np.unique(v, return_index=True)
    return qq[np.sort(first)]


def _num_steps(n: int) -> int:
    s = 1
    while (1 << s) < n + 1:
        s += 1
    return s


def lex_lower_bound_np(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Vectorized lower_bound of each q row in lexicographically sorted
    `keys` (n, L) int32 -- the host twin of the kernel's L-limb bisect
    (numpy has no multi-column searchsorted)."""
    n = len(keys)
    m = len(q)
    lo = np.zeros(m, np.int64)
    if n == 0:
        return lo
    hi = np.full(m, n, np.int64)
    for _ in range(int(np.ceil(np.log2(n + 1))) + 1):
        act = lo < hi
        mid = (lo + hi) >> 1
        rows = keys[np.minimum(mid, n - 1)]
        less = np.zeros(m, bool)
        eq = np.ones(m, bool)
        for i in range(keys.shape[1]):
            less |= eq & (rows[:, i] < q[:, i])
            eq &= rows[:, i] == q[:, i]
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    return lo


def turbo_supported(n: int, num_limbs: int, min_k: int, max_k: int,
                    num_species: int) -> bool:
    """Cheap precondition check (no DeviceIndex needed).

    2 limbs = 64-bit indices (k <= 12); up to 5 limbs = 128-bit
    (k <= 25, packedPairs.hpp:132-136) -- the kernel is generic over
    the limb count (r5), it only needs >= 2 limbs for the router's
    40-bit key window."""
    num_k = max_k - min_k + 1
    return (n > 0 and 2 <= num_limbs <= 5 and num_k <= 6
            and min_k * 5 >= ROUTER_BITS
            and num_species < (1 << 24)
            and num_k * n < (1 << 31)
            and n < (1 << 28))


@dataclass
class TurboTables:
    """Device-side tables for the turbo kernel (built on host).

    Compact layout: rowdat is 4 cols (the kernel gathers the previous
    row itself), grp2 is ONE int32 per (entry, level) (> 0: d_tax4 row
    of the group's HEADER [T,0,0,0] followed by its taxa rows; < 0:
    -(hot_id+1); 0: no multi group), and hot-set sizes live in t_hot
    -- ~(28 + 4*numK) B/entry (fast.bytes_per_entry_resident)."""
    keys2: jax.Array        # (N, L) int32 sorted limbs (L=2 for 64-bit
                            # indices, up to 5 for 128-bit)
    rowdat: jax.Array       # (N, L+2) int32 [limbs..., tax, tpack]
    router: jax.Array       # (2^ROUTER_BITS, 2) int32 [lo, meta]
    sub2: jax.Array         # (SUB, 2) int32 [lo, hi] sub-router rows
    grp2: jax.Array         # (numK * N,) int32 row ptr / -hot / 0
    d_tax4: jax.Array       # (DR, 4) int32 header+taxa rows per group
    weights: jax.Array      # (numK,) float32 w(k), row ki <-> k=maxK-ki
    masks2: jax.Array       # (numK, L) int32 prefix masks
    hotmask: jax.Array      # (H, S) f32 0/1 membership of hot taxa sets
    t_hot: jax.Array        # (H,) int32 distinct-taxa count per hot set
    num_steps: int
    min_k: int
    max_k: int
    highest_k: int
    num_species: int
    n: int
    # host data for the exact overflow fallback (entry-level, with
    # duplicates; limb layout so 128-bit needs no u128 emulation)
    host_limbs: np.ndarray  # (N_entries, L) int32
    host_grp_start: list
    host_d_tax: list
    host_grp_id: list       # (N,) int32 per level (refs into DeviceIndex)
    host_masks: np.ndarray  # (numK, L) int32 (= masks2 on host)
    # lazy cache: packed u64 search keys for the L=2 host fallback
    # (packing 33M entries costs ~0.7 s -- per TABLE, never per read)
    _host_key64: np.ndarray | None = None

    def host_key64(self) -> np.ndarray:
        if self._host_key64 is None:
            self._host_key64 = \
                (self.host_limbs[:, 0].astype(np.int64) << LIMB_BITS) \
                | self.host_limbs[:, 1].astype(np.int64)
        return self._host_key64

    @classmethod
    def supported(cls, dev: DeviceIndex) -> bool:
        return turbo_supported(dev.n, dev.num_limbs, dev.min_k, dev.max_k,
                               dev.num_species)

    @classmethod
    def build(cls, dev: DeviceIndex) -> "TurboTables":
        tables = [dev.tables[dev.max_k - ki]
                  for ki in range(dev.max_k - dev.min_k + 1)]
        return cls._build(dev.idx_limbs_np, dev.tax_rows, tables,
                          dev.highest_k, dev.min_k, dev.max_k,
                          dev.num_species)

    @classmethod
    def build_from_arrays(cls, limbs: np.ndarray, tax_rows: np.ndarray,
                          highest_k: int, min_k: int, max_k: int,
                          num_species: int) -> "TurboTables":
        """Build without a DeviceIndex (no device upload of the raw
        limb array, no dict mapping): the turbo path's loader."""
        from .join import build_group_table
        from ..utils import timers
        with timers.stage("ttbuild/group-tables"):
            tables = [build_group_table(limbs, tax_rows, highest_k,
                                        max_k - ki)
                      for ki in range(max_k - min_k + 1)]
        return cls._build(limbs, tax_rows, tables, highest_k, min_k,
                          max_k, num_species)

    @classmethod
    def _build(cls, limbs, tax_rows, tables, highest_k, min_k, max_k,
               num_species) -> "TurboTables":
        from ..utils import timers
        n_entries = len(tax_rows)
        num_k = max_k - min_k + 1
        L = limbs.shape[1] if n_entries else 2
        host_limbs = limbs

        # DEVICE tables hold one row per DISTINCT full key:
        # (timed: stage profile of first-contact table construction) equal-key
        # runs (multi-taxa groups, up to hundreds of entries) pinned
        # the bisect depth -- no router can split equal keys -- and the
        # kernel only ever needs group-level data at a position (T==1
        # implies a single entry; multi reads taxa through grp2).  The
        # HOST fallback keeps the full entry-level arrays.
        with timers.stage("ttbuild/dedup-keys"):
            uniq = np.ones(n_entries, bool)
            uniq[1:] = np.any(limbs[1:] != limbs[:-1], axis=1)
            upos = np.nonzero(uniq)[0]
            limbs = np.ascontiguousarray(limbs[upos])
            # 60-bit prefix key of the first two limbs: drives router /
            # sub-router construction (their thresholds live in the top
            # 40 bits, so a prefix lower_bound equals the full-key one)
            key64 = (limbs[:, 0].astype(np.int64) << LIMB_BITS) \
                | limbs[:, 1].astype(np.int64)
            tax = tax_rows[upos].astype(np.int32)
            n = len(upos)

        # per-level T per entry (clamped) + flat grp table + d_tax4
        # layout: each multi group owns a HEADER row [T, 0, 0, 0]
        # followed by ceil(T/4) taxa rows; grp2 points at the header
        tpack = np.zeros(n, np.int32)
        grp2 = np.zeros((num_k * n,), np.int32)
        d_tax4_parts = [np.zeros((1, 4), np.int32)]   # row 0 reserved
        row_next = 1
        masks2 = np.zeros((num_k, L), np.int32)
        for ki in range(num_k):
          with timers.stage("ttbuild/grp2+dtax"):
            t = tables[ki]
            masks2[ki] = t.mask
            sizes = np.diff(t.grp_start).astype(np.int64)   # (G,)
            gid_d = t.grp_id[upos]                   # per distinct key
            T_entry = sizes[gid_d]                           # (n,)
            tpack |= (np.minimum(T_entry, 31) << (5 * ki)).astype(np.int32)
            multi = sizes >= 2
            rows_per = np.where(multi, 1 + (sizes + 3) // 4, 0)
            row_base = np.zeros(len(sizes) + 1, np.int64)
            np.cumsum(rows_per, out=row_base[1:])
            total_rows = int(row_base[-1])
            grp_row = np.where(multi, row_next + row_base[:-1], 0)
            grp2[ki * n:(ki + 1) * n] = grp_row[gid_d]
            if total_rows:
                # taxa rows pad their unused tail lanes with -1: the
                # kernel masks expansion lanes by `taxa >= 0` instead
                # of gathering a per-slot T bound (r5).  Header rows
                # only ever have column 0 read.
                buf = np.full(total_rows * 4, -1, np.int32)
                sizes32 = np.diff(t.grp_start)
                mg = np.nonzero(multi)[0]
                buf[row_base[mg] * 4] = sizes32[mg]          # headers
                pair_grp = np.repeat(np.arange(len(sizes32)), sizes32)
                within = np.arange(len(t.d_tax)) - t.grp_start[pair_grp]
                sel = multi[pair_grp]
                dst = (row_base[pair_grp[sel]] + 1) * 4 + within[sel]
                buf[dst] = t.d_tax[sel]
                d_tax4_parts.append(buf.reshape(-1, 4))
                row_next += total_rows
                if row_next >= (1 << 31):
                    raise TurboRowOverflow(
                        f"multi-group taxa table needs {row_next:,} "
                        "rows (>= 2^31): int32 grp2 pointers would "
                        "wrap")
        d_tax4 = np.concatenate(d_tax4_parts, axis=0)

        # ---- hot taxa sets: hash each multi group's taxa set (sum of
        # per-taxon mix hashes -- order-free, sets are equal iff sums
        # collide only with ~2^-64 probability), weight by index-entry
        # count, take the global top H; hot groups store -(hot_id+1)
        # in grp2 column 1 instead of a d_tax4 row
        tm_hot = timers.stage("ttbuild/hotsets")
        tm_hot.__enter__()
        H = min(HOT_SETS, max(HOT_MASK_BYTES // max(4 * num_species, 1),
                              1))
        mix = (np.arange(num_species, dtype=np.uint64)
               + np.uint64(0x9E3779B97F4A7C15))
        mix = (mix ^ (mix >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        mix = (mix ^ (mix >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        mix = mix ^ (mix >> np.uint64(31))
        all_h, all_w = [], []
        per_ki_gh = []
        hot_eligible = num_species <= SPARSE_FOLD_S
        for ki in range(num_k):
            if not hot_eligible:
                per_ki_gh.append(np.zeros(0, np.uint64))
                continue
            t = tables[ki]
            G = len(t.grp_start) - 1
            if G == 0:
                per_ki_gh.append(np.zeros(0, np.uint64))
                continue
            gh = np.add.reduceat(mix[t.d_tax], t.grp_start[:-1]) \
                if len(t.d_tax) else np.zeros(G, np.uint64)
            sizes = np.diff(t.grp_start)
            entry_w = np.bincount(t.grp_id, minlength=G)
            multi_g = sizes >= 2
            per_ki_gh.append(gh)
            all_h.append(gh[multi_g])
            all_w.append(entry_w[multi_g])
        hotmask = np.zeros((1, num_species), np.float32)
        t_hot = np.zeros(1, np.int32)
        hot_hashes = np.zeros(0, np.uint64)
        if num_species > SPARSE_FOLD_S:
            all_h = []          # sparse-fold regime: no hot tier
        if all_h and sum(len(a) for a in all_h):
            hcat = np.concatenate(all_h)
            wcat = np.concatenate(all_w).astype(np.int64)
            # rank distinct sets by weight: native sort of (hash, w)
            # brings equal hashes adjacent (np.unique re-sorts with a
            # stable mergesort, ~60 s at 100M multi groups -- profiled
            # r4 ttbuild/hotsets)
            from ..native import sort_kmer_tax
            hs = hcat.copy()
            ws32 = np.minimum(wcat, (1 << 31) - 1).astype(np.uint32)
            if sort_kmer_tax(hs, ws32, 64, os.cpu_count() or 1):
                newh = np.empty(len(hs), bool)
                newh[0] = True
                newh[1:] = hs[1:] != hs[:-1]
                uh = hs[newh]
                gidx = np.cumsum(newh) - 1
                # bincount ~10x np.add.at; f64 exact below 2^53
                wsum = np.bincount(
                    gidx, weights=ws32.astype(np.float64),
                    minlength=len(uh)).astype(np.int64)
            else:
                uh, inv = np.unique(hcat, return_inverse=True)
                wsum = np.zeros(len(uh), np.int64)
                np.add.at(wsum, inv, wcat)
            top = np.argsort(wsum)[::-1][:H]
            hot_hashes = uh[top]
            order_h = np.argsort(hot_hashes)
            hot_hashes = hot_hashes[order_h]
            hotmask = np.zeros((len(hot_hashes), num_species),
                               np.float32)
            t_hot = np.zeros(len(hot_hashes), np.int32)
            filled = np.zeros(len(hot_hashes), bool)
            for ki in range(num_k):
                t = tables[ki]
                gh = per_ki_gh[ki]
                if not len(gh):
                    continue
                pos = np.searchsorted(hot_hashes, gh)
                pos_c = np.minimum(pos, len(hot_hashes) - 1)
                is_hot = (hot_hashes[pos_c] == gh) \
                    & (np.diff(t.grp_start) >= 2)
                # representative fill of each hot set's mask row
                need = is_hot & ~filled[pos_c]
                for g in np.nonzero(need)[0]:
                    hid = int(pos_c[g])
                    if filled[hid]:
                        continue
                    hotmask[hid, t.d_tax[t.grp_start[g]:
                                         t.grp_start[g + 1]]] = 1.0
                    t_hot[hid] = t.grp_start[g + 1] - t.grp_start[g]
                    filled[hid] = True
                # rewrite grp2 for hot groups: -(hot_id + 1)
                gid_d = t.grp_id[upos]
                hot_of_e = np.where(is_hot[gid_d],
                                    -(pos_c[gid_d].astype(np.int64)
                                      + 1), 0)
                seg = grp2[ki * n:(ki + 1) * n]
                sel = hot_of_e != 0
                seg[sel] = hot_of_e[sel]

        tm_hot.__exit__(None, None, None)
        tm_router = timers.stage("ttbuild/router")
        tm_router.__enter__()
        rowdat = np.empty((n, L + 2), np.int32)
        rowdat[:, :L] = limbs
        rowdat[:, L], rowdat[:, L + 1] = tax, tpack

        # router (lo, meta): meta >= 0 is the bucket end; meta < 0 points
        # at a dense sub-router resolving the next s bits of the key
        buckets = (limbs[:, 0] >> (LIMB_BITS - ROUTER_BITS)).astype(np.int64)
        edges = np.searchsorted(
            buckets, np.arange((1 << ROUTER_BITS) + 1)).astype(np.int32)
        sizes_b = np.diff(edges)
        fat = sizes_b > RESID
        meta = edges[1:].copy()
        max_resid = int(sizes_b[~fat].max()) if (~fat).any() else 1
        if fat.any():
            fat_ids = np.nonzero(fat)[0].astype(np.int64)
            s_b = np.clip(np.ceil(np.log2(
                sizes_b[fat].astype(np.float64) / RESID)).astype(np.int64),
                1, SUB_BITS)
            reps = (1 << s_b)
            base = np.zeros(len(reps) + 1, np.int64)
            np.cumsum(reps, out=base[1:])
            fb = np.repeat(np.arange(len(fat_ids)), reps)
            within = np.arange(int(base[-1])) - base[fb]
            # threshold key for sub-bucket i of fat bucket b:
            # key60 >= (b << 36) | (i << (36 - s_b))
            shift_full = 60 - ROUTER_BITS
            thr = (fat_ids[fb] << shift_full) \
                | (within << (shift_full - s_b[fb]))
            lo_all = np.searchsorted(key64, thr).astype(np.int32)
            hi_all = np.empty_like(lo_all)
            hi_all[:-1] = lo_all[1:]
            last_pos = (base[1:] - 1).astype(np.int64)
            hi_all[last_pos] = edges[fat_ids + 1]
            sub2 = np.stack([lo_all, hi_all], axis=1)
            meta[fat_ids] = -(base[:-1] * 32 + s_b).astype(np.int32)
            max_resid = max(max_resid, int((hi_all - lo_all).max()))
        else:
            sub2 = np.zeros((1, 2), np.int32)
        router = np.stack([edges[:-1], meta], axis=1)

        tm_router.__exit__(None, None, None)
        w = np.array([weight(max_k - ki) for ki in range(num_k)],
                     np.float32)
        return cls(
            jnp.asarray(np.ascontiguousarray(limbs)), jnp.asarray(rowdat),
            jnp.asarray(router), jnp.asarray(sub2), jnp.asarray(grp2),
            jnp.asarray(d_tax4), jnp.asarray(w), jnp.asarray(masks2),
            jnp.asarray(hotmask), jnp.asarray(t_hot),
            _num_steps(max_resid), min_k, max_k, highest_k,
            num_species, n,
            host_limbs,
            [t.grp_start for t in tables],
            [t.d_tax for t in tables],
            [t.grp_id for t in tables],
            masks2)


def _turbo_core(keys2, rowdat, router, sub2, grp2, d_tax4, weights,
                masks2, hotmask, t_hot, q_limbs, num_steps, min_k,
                max_k, highest_k, num_species, num_reads, kmers_per_read,
                probe=None, flag_reduce=None, multi_budget=None,
                exp_budget=None, with_diag=False, file_of_read=None,
                num_files=1):
    """Kernel body (traced inside the jit wrappers below).

    probe: profiling hook (tools/profile_turbo.py --stages): an early
    return of one f32 scalar after the named stage, so XLA dead-code-
    eliminates everything later and stage costs fall out of deltas.

    flag_reduce: mesh hook (parallel/turbo_mesh.py): called on the
    per-read oflow_counts bool vector BEFORE any count contribution is
    masked or scattered.  Under shard_map it ORs the flag across the
    "ip" axis, so EVERY index shard zeroes its contributions for a
    read that overflowed on ANY shard -- the host then re-adds the
    whole read exactly once (the single-chip contract, just with the
    flag made global; VERDICT r3 weak #1's double-count fix).

    -> (hit_tax (R, WOUT) i32, hit_ksum (R, WOUT) f32,
        hit_cnt (R,) i32, counts_all (numK, S) f32,
        counts_unique (numK, S) i32, oflow_counts (R,) bool,
        oflow_lists (R,) bool).

    oflow_counts: the read exceeded a budget; ALL its contributions
    were zeroed on device and the host must recompute the whole read.
    oflow_lists: counts are exact but the hit list was truncated; the
    host recomputes only the list.

    q_limbs: (M, 2) int32 in uniform read-major layout (query row m
    belongs to read m // kmers_per_read); phantom windows self-mask via
    their '^' letters."""
    n = keys2.shape[0]
    M = q_limbs.shape[0]
    L = keys2.shape[1]
    num_k = max_k - min_k + 1
    R = num_reads
    S = num_species
    kpr = kmers_per_read
    assert M == R * kpr
    SW = kpr * num_k
    MB = int(multi_budget or MULTI_BUDGET)
    EB = int(exp_budget or EXP_BUDGET)
    # per-level prefix masks are STATIC given (highest_k, k): fold them
    # into the program so full-limb compares drop the AND and all-zero
    # limbs drop out entirely (masks2 stays an operand for API compat)
    masks_st = np.stack([kmer.prefix_masks(highest_k, max_k - ki)[:L]
                         for ki in range(num_k)]).astype(np.int64)
    full_st = kmer.prefix_masks(highest_k, highest_k)[:L]

    qh = q_limbs[:, 0]
    ql = q_limbs[:, 1]

    # ---- '^' validity cum over letter positions minK-1..maxK-1
    def letter(pos):
        i, j = divmod(pos, kmer.LETTERS_PER_LIMB)
        shift = kmer.BITS_PER_LETTER * (kmer.LETTERS_PER_LIMB - 1 - j)
        return (q_limbs[:, i] >> shift) & 31
    ok = jnp.ones((M,), bool)
    cum_ok_by_k = []
    for pos in range(min_k - 1, max_k):
        ok = ok & (letter(pos) != 30)
        cum_ok_by_k.append(ok)
    cum_ok = [cum_ok_by_k[max_k - min_k - ki] for ki in range(num_k)]

    # ---- search: router (+ sub-router) + residual lower_bound
    bucket = qh >> (LIMB_BITS - ROUTER_BITS)
    rr = router[bucket]                       # (M, 2)
    lo, meta = rr[:, 0], rr[:, 1]
    is_sub = meta < 0
    code = jnp.where(is_sub, -meta, 32)
    sub_base = code >> 5
    s = code & 31
    subkey = ((qh & 0x3F) << (SUB_BITS - 6)) \
        | (ql >> (LIMB_BITS - (SUB_BITS - 6)))
    sidx = sub_base + (subkey >> (SUB_BITS - s))
    srow = sub2[jnp.where(is_sub, sidx, 0)]
    lo = jnp.where(is_sub, srow[:, 0], lo)
    hi = jnp.where(is_sub, srow[:, 1], meta)

    def lex_less(rows):
        """rows (M, L) < q_limbs, lexicographic over the limb lanes."""
        less = rows[:, L - 1] < q_limbs[:, L - 1]
        for i in range(L - 2, -1, -1):
            less = (rows[:, i] < q_limbs[:, i]) \
                | ((rows[:, i] == q_limbs[:, i]) & less)
        return less

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) >> 1
        kk = keys2[jnp.minimum(mid, n - 1)]
        less = lex_less(kk)
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)
    lo, _ = jax.lax.fori_loop(0, num_steps, body, (lo, hi))
    pos = lo
    if probe == "search":
        return (jnp.sum(pos).astype(jnp.float32),)
    pos_c = jnp.minimum(pos, n - 1)
    at_n = pos >= n

    # two (L+2)-col gathers: the entry at pos and its predecessor (when
    # pos == n, max(pos-1, 0) = n-1 is exactly the predecessor)
    at_cols = rowdat[pos_c]                   # (M, L+2)
    prev = jnp.maximum(pos - 1, 0)
    pv_cols = rowdat[prev]
    prev_ok = pos > 0

    # ---- per-level slots (T1 direct; multi via the global worklist)
    # T1 keys pack (tax, ki) into 16 bits when S <= 4095: the two big
    # per-read sorts (T1 + compaction) move half the bytes (r5)
    small_s = S <= 4095
    SENT = 32767 if small_s else int(I32_MAX)
    kdt = jnp.int16 if small_s else jnp.int32
    skeys = []
    mflags, mpays = [], []
    for ki in range(num_k):
        hit_at, hit_pv = ~at_n, prev_ok
        for i in range(L):
            mi = int(masks_st[ki, i])
            if mi == 0:
                continue            # level-k prefix ends before limb i
            if mi == int(full_st[i]):
                qi = q_limbs[:, i]  # full limb: plain equality
                hit_at = hit_at & (at_cols[:, i] == qi)
                hit_pv = hit_pv & (pv_cols[:, i] == qi)
            else:
                qi = q_limbs[:, i] & mi
                hit_at = hit_at & ((at_cols[:, i] & mi) == qi)
                hit_pv = hit_pv & ((pv_cols[:, i] & mi) == qi)
        matched = (hit_at | hit_pv) & cum_ok[ki]
        tax = jnp.where(hit_pv, pv_cols[:, L], at_cols[:, L])
        tp = jnp.where(hit_pv, pv_cols[:, L + 1], at_cols[:, L + 1])
        tc = (tp >> (5 * ki)) & 31
        psel = jnp.where(hit_pv, prev, pos_c)
        t1 = matched & (tc == 1)
        multi = matched & (tc >= 2)
        skeys.append(jnp.where(t1, tax * 8 + ki, SENT))
        mflags.append(multi)
        mpays.append(psel * 8 + ki)

    # (R, SW) read-major T1 slot matrices
    def rm(cols, dtype):
        a = jnp.stack(cols, axis=1)           # (M, numK)
        return a.reshape(R, SW).astype(dtype)
    skey = rm(skeys, kdt)
    multi_rs = rm(mflags, jnp.bool_)
    mpay_rs = rm(mpays, jnp.int32)
    multi_cnt = jnp.sum(multi_rs, axis=1)
    if probe == "slots":
        return (jnp.sum(skey).astype(jnp.float32)
                + jnp.sum(multi_cnt).astype(jnp.float32),)

    # ---- global multi worklist, compacted WITHOUT a global sort over
    # all (M * numK) slots: compact each READ's multi slots left with a
    # per-read sort (the payload rides along), then address worklist
    # position j by the read whose [read_base, read_base + multi_cnt)
    # range contains j: read starts scatter (R lanes) + cummax
    # propagation, exactly the CSR-expansion trick one level up.
    B = min(MB, M * num_k)
    # unstable sort on an int8 not-multi flag: order within a read is
    # irrelevant (the worklist re-sorts by T, and ties there only move
    # which reads the budget sends to the host and the order of float
    # sums), so the key costs 1 byte
    _nm, cp1 = jax.lax.sort(
        ((~multi_rs).astype(jnp.int8), mpay_rs),
        dimension=1, num_keys=1, is_stable=False)
    read_base = jnp.cumsum(multi_cnt) - multi_cnt        # (R,)
    r_iota = jnp.arange(R, dtype=jnp.int32)
    rmark = jnp.full((B + 1,), -1, jnp.int32) \
        .at[jnp.where(multi_cnt > 0, read_base, B)].set(
            r_iota, mode="drop")[:B]
    rprop = jax.lax.cummax(rmark)
    rid_h = jnp.maximum(rprop, 0)
    j_iota = jnp.arange(B, dtype=jnp.int32)
    valid_h = (rprop >= 0) & (j_iota < jnp.sum(multi_cnt))
    within_h = j_iota - read_base[rid_h]
    mp = cp1.reshape(-1)[jnp.minimum(
        rid_h * SW + jnp.minimum(within_h, SW - 1), R * SW - 1)]
    ki_h = mp & 7
    psel_h = mp >> 3
    row0_h = grp2[jnp.where(valid_h, ki_h * n + psel_h, 0)]
    hot_h = valid_h & (row0_h < 0)       # hot taxa set: -(hot_id+1)
    hid_h = jnp.where(hot_h, -row0_h - 1, 0)
    cold0_h = valid_h & (row0_h > 0)
    # exact T: cold groups carry it in their d_tax4 header row, hot
    # sets in the t_hot side table (tpack clamps at 31)
    hdr = d_tax4[jnp.where(cold0_h, row0_h, 0)][:, 0]
    T_h = jnp.where(cold0_h, hdr,
                    jnp.where(hot_h, t_hot[hid_h], 0))
    ridki_h = rid_h * 8 + ki_h

    multi_total = jnp.sum(multi_cnt)
    batch_of = multi_total > B
    if probe == "wsort1":
        return (jnp.sum(T_h).astype(jnp.float32)
                + jnp.sum(ridki_h).astype(jnp.float32),)

    # ---- T1 path first part: one read-major sort + segment scans
    # (runs_per_read must exist before any multi scatter so overflow
    # reads can be masked everywhere).  No value column rides along:
    # every valid slot contributes exactly 1.0, recoverable from the
    # sorted keys, so the big sort moves half the bytes.
    sk = jax.lax.sort(skey, dimension=1)
    valid = sk != SENT
    sv = valid.astype(jnp.float32)
    nxt = jnp.concatenate([sk[:, 1:], jnp.full((R, 1), SENT, kdt)],
                          axis=1)
    run_end = (sk != nxt) & valid
    csum = jnp.cumsum(sv, axis=1)
    prv = jnp.concatenate([jnp.full((R, 1), -1, kdt), sk[:, :-1]],
                          axis=1)
    run_start = (sk != prv)
    base = jnp.where(run_start, csum - sv, -jnp.inf)
    base = jax.lax.cummax(base, axis=1)
    run_c = jnp.where(run_end, csum - base, 0.0)   # T1 occurrence count
    runs_per_read = jnp.sum(run_end, axis=1)
    if probe == "t1sort":
        return (jnp.sum(run_c) + jnp.sum(runs_per_read)
                .astype(jnp.float32),)

    # COLD slots only (hot sets fold through a matrix product below),
    # exact-T ascending: when the expansion budget overflows, the heaviest
    # cold slots drop -- they belong to few (conserved-gene) reads
    cold_h = cold0_h
    ord_key = jnp.where(cold_h, T_h, I32_MAX)
    sk2, row0_s, ridki_s = jax.lax.sort(
        (ord_key, row0_h, ridki_h), dimension=0, num_keys=1)
    valid_s = sk2 != I32_MAX
    T_s = jnp.where(valid_s, sk2, 0)
    rid_s = ridki_s >> 3
    ki_s = ridki_s & 7
    if probe == "wsort2":
        return (jnp.sum(T_s).astype(jnp.float32)
                + jnp.sum(rid_s).astype(jnp.float32),)

    # pre-scatter read flags: expansion-budget drops + worklist
    # overflow + too many distinct T1 (tax, k) runs.  rows_per/base
    # are known BEFORE any scatter, so flagged reads' contributions
    # are masked everywhere.
    rows_per = jnp.where(valid_s, (T_s + 3) >> 2, 0)
    base = jnp.cumsum(rows_per) - rows_per
    fits = valid_s & (base + rows_per <= EB)
    dropped = valid_s & ~fits
    of_i = jnp.zeros((R,), jnp.int32)
    of_i = of_i.at[jnp.where(dropped, rid_s, R)].max(
        dropped.astype(jnp.int32), mode="drop")
    oflow_counts = ((of_i > 0) | (batch_of & (multi_cnt > 0))
                    | (runs_per_read > CW))
    if flag_reduce is not None:
        oflow_counts = flag_reduce(oflow_counts)

    flagged_s = oflow_counts[jnp.minimum(rid_s, R - 1)]
    ok_slot = fits & ~flagged_s
    inv_s = jnp.where(ok_slot & (T_s > 0),
                      1.0 / T_s.astype(jnp.float32), 0.0)
    dr = d_tax4.shape[0]

    # one-pass CSR expansion (r5 layout): surviving slots re-pack
    # CONTIGUOUSLY (base2 over ok_slot only), so a row's owning slot is
    # just the last start at or before it (cummax) and no per-row T
    # bound is needed -- consecutive starts are exactly rows_per apart
    # and the taxa rows' unused tail lanes carry a -1 sentinel.  Three
    # scatters (row0 doubles as the start marker since row0 > 0 for
    # every cold group) and three gathers replace r4's five + four.
    rows_per2 = jnp.where(ok_slot, rows_per, 0)
    base2 = jnp.cumsum(rows_per2) - rows_per2
    total_used = jnp.sum(rows_per2)
    dst = jnp.where(ok_slot, base2, EB)
    ridki_e32 = jnp.where(ok_slot, rid_s * 8 + ki_s, 0)
    sl_row0 = jnp.zeros((EB + 1,), jnp.int32) \
        .at[dst].set(row0_s, mode="drop")
    sl_ridki = jnp.zeros((EB + 1,), jnp.int32) \
        .at[dst].set(ridki_e32, mode="drop")
    sl_inv = jnp.zeros((EB + 1,), jnp.float32) \
        .at[dst].set(inv_s, mode="drop")
    row_iota = jnp.arange(EB, dtype=jnp.int32)
    basemark = jnp.where(sl_row0[:EB] > 0, row_iota, -1)
    startpos = jax.lax.cummax(basemark)
    sp = jnp.maximum(startpos, 0)
    ok_row = (startpos >= 0) & (row_iota < total_used)
    row0_e = sl_row0[sp]
    ridki_e = sl_ridki[sp]
    inv_e = jnp.where(ok_row, sl_inv[sp], 0.0)
    rid_e = ridki_e >> 3
    ki_e = ridki_e & 7
    j_e = row_iota - sp
    # +1: row0 points at the group's [T,-1,-1,-1] header row
    taxa = d_tax4[jnp.minimum(jnp.where(ok_row, row0_e + 1 + j_e, 0),
                              dr - 1)]                     # (EXP, 4)
    okt = ok_row[:, None] & (taxa >= 0)

    # dense fold (small S, or tables that carry a hot tier): ONE
    # (R, numK, S) accumulator takes a single 4*EXP-lane scatter of
    # inv = 1/T; the per-read score matrix falls out as the weights
    # contraction and the per-k count matrix as the read reduction
    # (r4 paid two separate 4*EXP-lane scatters).  Sparse fold (big
    # S): one sorted (read, tax) pair list -- no S-proportional arrays
    Hh = hotmask.shape[0]
    use_dense = (Hh > 1) or (S <= SPARSE_FOLD_S)
    if use_dense:
        big = jnp.zeros((R * num_k * S + 1,), jnp.float32)
        cell = jnp.where(okt, (rid_e * num_k + ki_e)[:, None] * S + taxa,
                         R * num_k * S)
        big = big.at[cell.reshape(-1)].add(
            jnp.where(okt, inv_e[:, None], 0.0).reshape(-1))
        big = big[:R * num_k * S].reshape(R, num_k, S)
        if num_files > 1:
            # per-file profile counts (identify_multiple): reads are
            # file-contiguous, so one sorted segment-sum splits the
            # read reduction by file
            cold_cm = jax.ops.segment_sum(
                big.reshape(R, num_k * S), file_of_read,
                num_segments=num_files, indices_are_sorted=True
            ).reshape(num_files, num_k, S)
        else:
            cold_cm = jnp.sum(big, axis=0)                 # (numK, S)
        # every float32 product states HIGHEST: a GPU may otherwise run
        # it in TF32 (~3 decimal digits), outside the score tolerance
        cold_dm = jnp.einsum("rks,k->rs", big, weights,
                             precision=_HIGHEST)           # (R, S)

        # ---- hot sets: per-(read, ki, set) credit accumulation (one
        # small scatter over the worklist), then ONE dense matmul per
        # output against the 0/1 membership mask -- conserved genes
        # become matrix products instead of millions of scatter pairs
        flagged_h = oflow_counts[jnp.minimum(rid_h, R - 1)]
        ok_hot = hot_h & ~flagged_h
        inv_hh = jnp.where(ok_hot, 1.0 / jnp.maximum(T_h, 1)
                           .astype(jnp.float32), 0.0)
        acc3 = jnp.zeros((R * num_k * Hh + 1,), jnp.float32)
        acc3 = acc3.at[jnp.where(ok_hot, (rid_h * num_k + ki_h) * Hh
                                 + hid_h, R * num_k * Hh)].add(
            inv_hh, mode="drop")
        acc3 = acc3[:R * num_k * Hh].reshape(R, num_k, Hh)
        hot_dm = jnp.dot(jnp.einsum("rkh,k->rh", acc3, weights,
                                    precision=_HIGHEST), hotmask,
                         precision=_HIGHEST,
                         preferred_element_type=jnp.float32)
        if num_files > 1:
            hot_cm = jnp.dot(
                jax.ops.segment_sum(acc3.reshape(R, num_k * Hh),
                                    file_of_read,
                                    num_segments=num_files,
                                    indices_are_sorted=True)
                .reshape(num_files * num_k, Hh), hotmask,
                precision=_HIGHEST, preferred_element_type=jnp.float32
            ).reshape(num_files, num_k, S)
        else:
            hot_cm = jnp.dot(jnp.sum(acc3, axis=0), hotmask,
                             precision=_HIGHEST,
                             preferred_element_type=jnp.float32)

        counts_multi = cold_cm + hot_cm
        dm = cold_dm + hot_dm
        if probe == "bands":
            return (jnp.sum(dm) + jnp.sum(counts_multi),)
    else:
        val_e = weights[ki_e] * inv_e
        FKS = num_files * num_k * S
        fk_e = ki_e if num_files == 1 \
            else file_of_read[jnp.minimum(rid_e, R - 1)] * num_k + ki_e
        cflat = jnp.zeros((FKS + 1,), jnp.float32)
        cell_c = jnp.where(okt, fk_e[:, None] * S + taxa, FKS)
        cflat = cflat.at[cell_c.reshape(-1)].add(
            jnp.where(okt, inv_e[:, None], 0.0).reshape(-1))
        counts_multi = cflat[:FKS].reshape(num_k, S) if num_files == 1 \
            else cflat[:FKS].reshape(num_files, num_k, S)
        # sorted (read, tax, val) pairs -> per-pair segment sums ->
        # rank-addressed scatter into compact (R, WM+1) lists (slot WM
        # is the overflow sentinel: a read with > WM distinct multi
        # taxa writes it and is flagged for the host list rebuild)
        k1 = jnp.where(okt, rid_e[:, None],
                       jnp.int32(I32_MAX)).reshape(-1)
        k2 = jnp.where(okt, taxa, jnp.int32(I32_MAX)).reshape(-1)
        v4 = jnp.where(okt, val_e[:, None], 0.0).reshape(-1)
        k1s, k2s, vs = jax.lax.sort((k1, k2, v4), dimension=0,
                                    num_keys=2)
        validp = k1s != I32_MAX
        n1 = jnp.concatenate([k1s[1:], jnp.array([I32_MAX], jnp.int32)])
        n2 = jnp.concatenate([k2s[1:], jnp.array([I32_MAX], jnp.int32)])
        run_endp = validp & ((k1s != n1) | (k2s != n2))
        p1 = jnp.concatenate([jnp.array([-1], jnp.int32), k1s[:-1]])
        # every lane of a (read, tax) run shares one rank (the count
        # of runs ending before it); values scatter-ADD into the run's
        # compact slot, so each slot sums only its own few terms (a
        # global f32 cumsum carries the batch-total magnitude and
        # loses ~1e-2 absolute per segment difference -- measured)
        re_i = run_endp.astype(jnp.int32)
        cexc = jnp.cumsum(re_i) - re_i
        rdstart = k1s != p1
        rank = cexc - jax.lax.cummax(jnp.where(rdstart, cexc, -1))
        WMp = WM + 1
        dest_all = jnp.where(validp,
                             k1s * WMp + jnp.minimum(rank, WM),
                             R * WMp)
        mk2f = jnp.full((R * WMp + 1,), I32_MAX, jnp.int32) \
            .at[jnp.where(run_endp, dest_all, R * WMp)].set(
                k2s, mode="drop")
        mv2f = jnp.zeros((R * WMp + 1,), jnp.float32) \
            .at[dest_all].add(vs, mode="drop")
        mk2 = mk2f[:R * WMp].reshape(R, WMp)
        mv2 = mv2f[:R * WMp].reshape(R, WMp)
        multi_of = mk2[:, WM] != I32_MAX
        mk2 = mk2[:, :WM]
        mv2 = jnp.where(mk2 != I32_MAX, mv2[:, :WM], 0.0)
        if probe == "bands":
            return (jnp.sum(mv2) + jnp.sum(cflat),)

    # ---- T1 compaction to CW columns
    ckey = jnp.where(run_end, sk, SENT)
    ck, cc = jax.lax.sort((ckey, run_c), dimension=1, num_keys=1)
    ck, cc = ck[:, :CW].astype(jnp.int32), cc[:, :CW]
    # flagged reads are recomputed whole on host: zero ALL their count
    # contributions (T1 here; multi was masked pre-scatter)
    keep = ~oflow_counts
    cc = jnp.where(keep[:, None], cc, 0.0)
    cvalid = ck != SENT
    cki = jnp.where(cvalid, ck & 7, 0)
    ctax = jnp.where(cvalid, ck >> 3, 0)

    # T1 contributions feed counts_all and counts_unique with the SAME
    # per-(k, tax) sums (a T1 hit is by definition unique): one scatter
    FKS = num_files * num_k * S
    fki = cki if num_files == 1 \
        else file_of_read[:, None] * num_k + cki
    cell_t1 = jnp.where(cvalid, fki * S + ctax, FKS)
    flat_c = jnp.zeros((FKS + 1,), jnp.float32) \
        .at[cell_t1.reshape(-1)].add(cc.reshape(-1))
    t1_c = flat_c[:FKS].reshape(num_k, S) if num_files == 1 \
        else flat_c[:FKS].reshape(num_files, num_k, S)
    counts_all = t1_c + counts_multi
    counts_unique = t1_c.astype(jnp.int32)
    if probe == "fold":
        return (jnp.sum(counts_all) + jnp.sum(counts_unique)
                .astype(jnp.float32),)

    # ---- per-read (tax, ksum) lists: T1 fold + multi fold + merge
    ks_v = jnp.where(cvalid, weights[cki] * cc, 0.0)
    tkey = jnp.where(cvalid, ctax, I32_MAX)
    tnxt = jnp.concatenate([tkey[:, 1:],
                            jnp.full((R, 1), I32_MAX, jnp.int32)], axis=1)
    t_end = (tkey != tnxt) & cvalid
    t_prv = jnp.concatenate([jnp.full((R, 1), -1, jnp.int32),
                             tkey[:, :-1]], axis=1)
    t_start = (tkey != t_prv)
    tcsum = jnp.cumsum(ks_v, axis=1)
    tbase = jnp.where(t_start, tcsum - ks_v, -jnp.inf)
    tbase = jax.lax.cummax(tbase, axis=1)
    tax_sum = jnp.where(t_end, tcsum - tbase, 0.0)
    okey = jnp.where(t_end, tkey, I32_MAX)
    ok1, os1 = jax.lax.sort((okey, tax_sum), dimension=1, num_keys=1)
    ntax1 = jnp.sum(t_end, axis=1)

    # multi rows -> compact per-read lists
    if use_dense:
        iota_s = jnp.arange(S, dtype=jnp.int32)
        mk = jnp.where(dm > 0, iota_s[None, :], I32_MAX)
        mk2, mv2 = jax.lax.sort((mk, dm), dimension=1, num_keys=1)
        mk2, mv2 = mk2[:, :WM], mv2[:, :WM]
        multi_of = jnp.sum(dm > 0, axis=1) > WM

    allk2 = jnp.concatenate([ok1[:, :WOUT], mk2], axis=1)
    allv2 = jnp.concatenate([os1[:, :WOUT], mv2], axis=1)
    k3, v3 = jax.lax.sort((allk2, allv2), dimension=1, num_keys=1)
    v3 = jnp.where(k3 != I32_MAX, v3, 0.0)
    n3 = jnp.concatenate([k3[:, 1:], jnp.full((R, 1), I32_MAX, jnp.int32)],
                         axis=1)
    e3 = (k3 != n3) & (k3 != I32_MAX)
    p3 = jnp.concatenate([jnp.full((R, 1), -1, jnp.int32), k3[:, :-1]],
                         axis=1)
    s3 = (k3 != p3)
    c3 = jnp.cumsum(v3, axis=1)
    b3 = jnp.where(s3, c3 - v3, -jnp.inf)
    b3 = jax.lax.cummax(b3, axis=1)
    sum3 = jnp.where(e3, c3 - b3, 0.0)
    fk = jnp.where(e3, k3, I32_MAX)
    hk4, hs4 = jax.lax.sort((fk, sum3), dimension=1, num_keys=1)
    ntax = jnp.sum(e3, axis=1)
    oflow_lists = oflow_counts | (ntax1 > WOUT) | multi_of \
        | (ntax > WOUT)
    hit_tax = hk4[:, :WOUT]
    hit_ksum = hs4[:, :WOUT]
    hit_cnt = jnp.minimum(ntax, WOUT).astype(jnp.int32)

    if with_diag:
        # budget-usage telemetry: the drive loop tunes multi_budget /
        # exp_budget per corpus from the observed high-water marks
        return (hit_tax, hit_ksum, hit_cnt, counts_all, counts_unique,
                oflow_counts, oflow_lists, multi_total, total_used)
    return (hit_tax, hit_ksum, hit_cnt, counts_all, counts_unique,
            oflow_counts, oflow_lists)


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "min_k", "max_k", "highest_k",
                     "num_species", "num_reads", "kmers_per_read"))
def turbo_classify(keys2, rowdat, router, sub2, grp2, d_tax4, weights,
                   masks2, hotmask, t_hot, q_limbs, num_steps, min_k,
                   max_k, highest_k, num_species, num_reads,
                   kmers_per_read):
    """Standalone jit of the kernel core (see _turbo_core docstring)."""
    return _turbo_core(keys2, rowdat, router, sub2, grp2, d_tax4, weights,
                       masks2, hotmask, t_hot, q_limbs, num_steps, min_k,
                       max_k, highest_k, num_species, num_reads,
                       kmers_per_read)


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "min_k", "max_k", "highest_k",
                     "num_species", "num_reads", "protein", "one_frame",
                     "lines_per_read", "w_per_line", "probe"))
def fused_turbo_probe(keys2, rowdat, router, sub2, grp2, d_tax4, weights,
                      masks2, hotmask, t_hot, byte_mat, lut, num_steps,
                      min_k, max_k, highest_k, num_species, num_reads,
                      protein, one_frame, lines_per_read, w_per_line,
                      probe):
    """Profiling variant of fused_turbo: stops after `probe` stage and
    returns one scalar, so per-stage device cost = delta of timings
    (tools/profile_turbo.py --stages)."""
    from ..core.encode import dna_to_aa_codes, encode_windows

    rows, maxlen = byte_mat.shape
    stride = 1 if protein else 3
    flat = jnp.concatenate([
        byte_mat.reshape(-1),
        jnp.zeros((stride * highest_k,), byte_mat.dtype)])
    aa = dna_to_aa_codes(flat, lut, protein=protein)
    win = encode_windows(aa, highest_k, stride)
    win = win[:rows * maxlen].reshape(rows, maxlen, -1)
    if one_frame and not protein:
        win = win[:, ::3]
    q = win[:, :w_per_line].reshape(rows * w_per_line, -1)
    kpr = w_per_line * lines_per_read
    if probe == "encode":
        return jnp.sum(q).astype(jnp.float32)
    out = _turbo_core(
        keys2, rowdat, router, sub2, grp2, d_tax4, weights, masks2,
        hotmask, t_hot, q, num_steps, min_k, max_k, highest_k,
        num_species, num_reads, kpr, probe=probe)
    if probe is not None:
        return out[0]
    return (jnp.sum(out[2]).astype(jnp.float32)
            + jnp.sum(out[3]) + jnp.sum(out[1]))


def host_classify_read(tables: TurboTables, q_limbs: np.ndarray):
    """Exact scoring of ONE read's windows on host (overflow fallback).

    Mirrors the kernel's pos/prev full-key logic in numpy with the
    unpadded CSR taxa lists (no budgets).  Returns
    (hits dict tax -> ksum float32, counts_all (numK, S) f64 add,
    counts_unique (numK, S) int add)."""
    num_k = tables.max_k - tables.min_k + 1
    S = tables.num_species
    idx_limbs = tables.host_limbs
    n = len(idx_limbs)
    L = q_limbs.shape[1]
    if L == 2:
        q64 = (q_limbs[:, 0].astype(np.int64) << LIMB_BITS) \
            | q_limbs[:, 1].astype(np.int64)
        pos = np.searchsorted(tables.host_key64(), q64)
    else:
        pos = lex_lower_bound_np(idx_limbs, q_limbs)
    pos_c = np.minimum(pos, n - 1)
    prev = np.maximum(pos - 1, 0)

    def letter(p):
        i, j = divmod(p, kmer.LETTERS_PER_LIMB)
        shift = kmer.BITS_PER_LETTER * (kmer.LETTERS_PER_LIMB - 1 - j)
        return (q_limbs[:, i] >> shift) & 31
    ok = np.ones(len(q_limbs), bool)
    cum = {}
    for p in range(tables.min_k - 1, tables.max_k):
        ok = ok & (letter(p) != 30)
        cum[p + 1] = ok.copy()

    counts_all = np.zeros((num_k, S), np.float64)
    counts_unique = np.zeros((num_k, S), np.int64)
    score_vec = np.zeros(S, np.float32)
    for ki in range(num_k):
        k = tables.max_k - ki
        mrow = tables.host_masks[ki]
        qm = q_limbs & mrow
        hit_at = (pos < n) & np.all(
            (idx_limbs[pos_c] & mrow) == qm, axis=1)
        hit_pv = (pos > 0) & np.all(
            (idx_limbs[prev] & mrow) == qm, axis=1)
        matched = (hit_at | hit_pv) & cum[k]
        if not matched.any():
            continue
        psel = np.where(hit_pv, prev, pos_c)
        gs = tables.host_grp_start[ki]
        dt = tables.host_d_tax[ki]
        w = np.float32(weight(k))
        # vectorized group->taxa expansion (the per-match python loop
        # made conserved-gene fallback reads cost ~ms each, which at
        # round-2's 8.8% fallback rate dominated the whole pipeline)
        g = tables.host_grp_id[ki][psel[matched]]
        starts = gs[g].astype(np.int64)
        T = (gs[g + 1] - gs[g]).astype(np.int64)
        total = int(T.sum())
        if total == 0:
            continue
        cum_t = np.cumsum(T) - T
        flat = np.arange(total, dtype=np.int64)
        within = flat - np.repeat(cum_t, T)
        tax_flat = dt[np.repeat(starts, T) + within]
        invT = 1.0 / T
        np.add.at(counts_all[ki], tax_flat, np.repeat(invT, T))
        uniq = T == 1
        if uniq.any():
            np.add.at(counts_unique[ki], dt[starts[uniq]], 1)
        sv32 = np.zeros(S, np.float32)
        np.add.at(sv32, tax_flat,
                  np.repeat((w / T).astype(np.float32), T))
        score_vec += sv32
    nz = np.nonzero(score_vec)[0]
    scores = {int(t): np.float32(score_vec[t]) for t in nz}
    return scores, counts_all, counts_unique


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "min_k", "max_k", "highest_k",
                     "num_species", "num_reads", "protein", "one_frame",
                     "lines_per_read", "w_per_line"))
def fused_turbo(keys2, rowdat, router, sub2, grp2, d_tax4, weights, masks2,
                hotmask, t_hot, byte_mat, lut,
                num_steps, min_k, max_k, highest_k, num_species,
                num_reads, protein, one_frame, lines_per_read, w_per_line):
    """(rows, maxlen) uint8 -> turbo_classify outputs, one XLA program
    (same windowing as match/fast.py fused_classify)."""
    from ..core.encode import dna_to_aa_codes, encode_windows

    rows, maxlen = byte_mat.shape
    stride = 1 if protein else 3
    flat = jnp.concatenate([
        byte_mat.reshape(-1),
        jnp.zeros((stride * highest_k,), byte_mat.dtype)])
    aa = dna_to_aa_codes(flat, lut, protein=protein)
    win = encode_windows(aa, highest_k, stride)
    win = win[:rows * maxlen].reshape(rows, maxlen, -1)
    if one_frame and not protein:
        win = win[:, ::3]
    q = win[:, :w_per_line].reshape(rows * w_per_line, -1)
    kpr = w_per_line * lines_per_read
    return _turbo_core(
        keys2, rowdat, router, sub2, grp2, d_tax4, weights, masks2,
        hotmask, t_hot, q, num_steps, min_k, max_k, highest_k,
        num_species, num_reads, kpr)


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "min_k", "max_k", "highest_k",
                     "num_species", "num_reads", "protein", "one_frame",
                     "lines_per_read", "w_per_line", "csr_cap",
                     "unique", "multi_budget", "exp_budget"),
    donate_argnames=("acc_ca", "acc_cu"))
def fused_turbo_acc(keys2, rowdat, router, sub2, grp2, d_tax4, weights,
                    masks2, hotmask, t_hot, byte_mat, lut, acc_ca, acc_cu,
                    num_steps, min_k, max_k, highest_k, num_species,
                    num_reads, protein, one_frame, lines_per_read,
                    w_per_line, csr_cap, unique=False, multi_budget=None,
                    exp_budget=None):
    """Readback-minimal fused batch step.

    Same windowing + kernel as fused_turbo, but with the device->host
    traffic kept minimal (the reference loop has no such link at all,
    Compare.hpp:2733): per-batch host traffic is ONE packed int32
    array, and the per-taxon count matrices accumulate on device across
    batches (fetched once per flush instead of per batch).

    Returns (packed, hit_tax, hit_ksum, new_ca, new_cu):
      packed (2R + 2*csr_cap + 2,) int32:
        [0:R]              per-read hit counts (hc)
        [R:2R]             flags: bit0 oflow_counts, bit1 oflow_lists
        [2R:2R+2*csr_cap]  CSR (tax, ksum-bits) pairs, read-major, only
                           valid when total <= csr_cap
        [-4]               multi worklist slots this batch (diag)
        [-3]               multi expansion rows used this batch (diag)
        [-2]               total CSR entries (sum hc)
        [-1]               number of flagged reads (fast any() check)
      hit_tax/hit_ksum: dense (R, WOUT) lists -- NOT normally fetched;
        the host falls back to them when total > csr_cap.
      new_ca/new_cu: donated accumulators + this batch's counts.
    """
    from ..core.encode import dna_to_aa_codes, encode_windows

    rows, maxlen = byte_mat.shape
    stride = 1 if protein else 3
    flat = jnp.concatenate([
        byte_mat.reshape(-1),
        jnp.zeros((stride * highest_k,), byte_mat.dtype)])
    aa = dna_to_aa_codes(flat, lut, protein=protein)
    win = encode_windows(aa, highest_k, stride)
    win = win[:rows * maxlen].reshape(rows, maxlen, -1)
    if one_frame and not protein:
        win = win[:, ::3]
    q = win[:, :w_per_line].reshape(rows * w_per_line, -1)
    kpr = w_per_line * lines_per_read
    if unique:
        q = dedup_read_windows(q, num_reads, kpr)
    ht, hk, hc, ca, cu, ofc, ofl, mtot, eused = _turbo_core(
        keys2, rowdat, router, sub2, grp2, d_tax4, weights, masks2,
        hotmask, t_hot, q, num_steps, min_k, max_k, highest_k,
        num_species, num_reads, kpr, multi_budget=multi_budget,
        exp_budget=exp_budget, with_diag=True)

    R = num_reads
    cum = jnp.cumsum(hc) - hc                      # exclusive prefix
    iw = jnp.arange(WOUT, dtype=jnp.int32)
    validm = iw[None, :] < hc[:, None]
    dest = jnp.where(validm, cum[:, None] + iw[None, :], csr_cap)
    pairs = jnp.stack(
        [ht, jax.lax.bitcast_convert_type(hk, jnp.int32)],
        axis=-1).reshape(-1, 2)
    csr = jnp.zeros((csr_cap + 1, 2), jnp.int32)
    csr = csr.at[dest.reshape(-1)].set(pairs, mode="drop")
    flags = ofc.astype(jnp.int32) | (ofl.astype(jnp.int32) << 1)
    tail = jnp.stack([mtot, eused, jnp.sum(hc),
                      jnp.sum(flags != 0)]).astype(jnp.int32)
    packed = jnp.concatenate([
        hc, flags, csr[:csr_cap].reshape(-1), tail])
    return packed, ht, hk, acc_ca + ca, acc_cu + cu


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "min_k", "max_k", "highest_k",
                     "num_species", "num_reads", "protein", "one_frame",
                     "lines_per_read", "w_per_line", "csr_cap",
                     "unique", "multi_budget", "exp_budget",
                     "num_files"))
def fused_turbo_files(keys2, rowdat, router, sub2, grp2, d_tax4, weights,
                      masks2, hotmask, t_hot, byte_mat, lut,
                      file_of_read, num_steps, min_k, max_k, highest_k,
                      num_species, num_reads, protein, one_frame,
                      lines_per_read, w_per_line, csr_cap, unique=False,
                      multi_budget=None, exp_budget=None, num_files=1):
    """fused_turbo_acc's identify_multiple twin: batches may span file
    boundaries (file_of_read, non-decreasing), and the count matrices
    come back PER FILE and per batch -- (num_files, numK, S) -- instead
    of accumulating on device (the reference's job shop keeps separate
    count arrays per concurrent file task, main.cpp:1292-1326)."""
    from ..core.encode import dna_to_aa_codes, encode_windows

    rows, maxlen = byte_mat.shape
    stride = 1 if protein else 3
    flat = jnp.concatenate([
        byte_mat.reshape(-1),
        jnp.zeros((stride * highest_k,), byte_mat.dtype)])
    aa = dna_to_aa_codes(flat, lut, protein=protein)
    win = encode_windows(aa, highest_k, stride)
    win = win[:rows * maxlen].reshape(rows, maxlen, -1)
    if one_frame and not protein:
        win = win[:, ::3]
    q = win[:, :w_per_line].reshape(rows * w_per_line, -1)
    kpr = w_per_line * lines_per_read
    if unique:
        q = dedup_read_windows(q, num_reads, kpr)
    ht, hk, hc, ca, cu, ofc, ofl, mtot, eused = _turbo_core(
        keys2, rowdat, router, sub2, grp2, d_tax4, weights, masks2,
        hotmask, t_hot, q, num_steps, min_k, max_k, highest_k,
        num_species, num_reads, kpr, multi_budget=multi_budget,
        exp_budget=exp_budget, with_diag=True,
        file_of_read=file_of_read, num_files=num_files)

    R = num_reads
    cum = jnp.cumsum(hc) - hc
    iw = jnp.arange(WOUT, dtype=jnp.int32)
    validm = iw[None, :] < hc[:, None]
    dest = jnp.where(validm, cum[:, None] + iw[None, :], csr_cap)
    pairs = jnp.stack(
        [ht, jax.lax.bitcast_convert_type(hk, jnp.int32)],
        axis=-1).reshape(-1, 2)
    csr = jnp.zeros((csr_cap + 1, 2), jnp.int32)
    csr = csr.at[dest.reshape(-1)].set(pairs, mode="drop")
    flags = ofc.astype(jnp.int32) | (ofl.astype(jnp.int32) << 1)
    tail = jnp.stack([mtot, eused, jnp.sum(hc),
                      jnp.sum(flags != 0)]).astype(jnp.int32)
    packed = jnp.concatenate([
        hc, flags, csr[:csr_cap].reshape(-1), tail])
    return packed, ht, hk, ca, cu


def read_windows_np(mat_rows: np.ndarray, lut_np: np.ndarray,
                    highest_k: int, protein: bool, one_frame: bool,
                    w_per_line: int) -> np.ndarray:
    """Host twin of the fused windowing for ONE read's padded line(s)
    (overflow fallback).  mat_rows: (lpr, maxlen) uint8."""
    from ..core.encode import dna_to_aa_codes_np, encode_windows_np
    stride = 1 if protein else 3
    outs = []
    for line in mat_rows:
        buf = np.concatenate([line, np.zeros(stride * highest_k, np.uint8)])
        aa = dna_to_aa_codes_np(buf, lut_np, protein=protein)
        win = encode_windows_np(aa, highest_k, stride)
        if one_frame and not protein:
            win = win[::3]
        outs.append(win[:w_per_line])
    return np.concatenate(outs, axis=0)


_CACHE_VERSION = 8
_TT_RAM_CACHE: dict = {}


def _tax_rows_crc(tax_rows: np.ndarray) -> int:
    """Checksum of the taxon-row mapping baked into rowdat/d_tax.  The
    mapping comes from the *content* file (content.tax_to_idx), which
    can change without the index file changing; the sidecar must be
    invalidated then (ADVICE r2)."""
    import zlib
    return zlib.crc32(np.ascontiguousarray(tax_rows, np.int32).tobytes())


def save_turbo(tt: TurboTables, path: str, tax_crc: int = 0):
    """Persist the derived tables as a DIRECTORY of raw .npy files
    (path gets a .tabs suffix).  np.savez reads back through zipfile's
    CRC32 at ~100 MB/s -- 99 s for the 10 GB sidecar at 197M entries
    (profiled r4); raw .npy files load via mmap, so "load" is instant
    and pages stream at disk speed during the device upload."""
    d = path + ".tabs"
    tmp = d + ".tmp"
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    arrays = dict(
        keys2=np.asarray(tt.keys2),
        rowdat=np.asarray(tt.rowdat), router=np.asarray(tt.router),
        sub2=np.asarray(tt.sub2),
        grp2=np.asarray(tt.grp2), d_tax4=np.asarray(tt.d_tax4),
        weights=np.asarray(tt.weights), masks2=np.asarray(tt.masks2),
        hotmask=np.asarray(tt.hotmask), t_hot=np.asarray(tt.t_hot))
    for i in range(tt.max_k - tt.min_k + 1):
        arrays[f"gs{i}"] = tt.host_grp_start[i]
        arrays[f"dt{i}"] = tt.host_d_tax[i]
        arrays[f"gi{i}"] = tt.host_grp_id[i]
    for name, a in arrays.items():
        np.save(os.path.join(tmp, name + ".npy"), a)
    import json
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump({"version": _CACHE_VERSION, "tax_crc": int(tax_crc),
                   "n_entries": int(len(tt.host_limbs)),
                   "resid": RESID, "sub_bits": SUB_BITS,
                   "params": [tt.num_steps, tt.min_k, tt.max_k,
                              tt.highest_k, tt.num_species, tt.n]}, fh)
    shutil.rmtree(d, ignore_errors=True)
    os.replace(tmp, d)
    # retire any old-format npz
    try:
        if os.path.exists(path):
            os.remove(path)
    except OSError:
        pass


def load_turbo(path: str, limbs: np.ndarray,
               tax_crc: int | None = None) -> TurboTables | None:
    try:
        import json
        d = path + ".tabs"
        with open(os.path.join(d, "meta.json")) as fh:
            meta = json.load(fh)
        if meta["version"] != _CACHE_VERSION:
            return None
        if tax_crc is not None and meta["tax_crc"] != tax_crc:
            return None
        if meta["n_entries"] != len(limbs):
            return None
        if meta.get("resid", 8) != RESID \
                or meta.get("sub_bits", 16) != SUB_BITS:
            return None     # router depth tunables changed: rebuild
        num_steps, min_k, max_k, highest_k, S, n = meta["params"]

        def arr(name, mmap=True):
            return np.load(os.path.join(d, name + ".npy"),
                           mmap_mode="r" if mmap else None)
        num_k = max_k - min_k + 1
        masks_np = np.asarray(arr("masks2", mmap=False))
        return TurboTables(
            jnp.asarray(arr("keys2")),
            jnp.asarray(arr("rowdat")), jnp.asarray(arr("router")),
            jnp.asarray(arr("sub2")),
            jnp.asarray(arr("grp2")), jnp.asarray(arr("d_tax4")),
            jnp.asarray(arr("weights")), jnp.asarray(masks_np),
            jnp.asarray(arr("hotmask")), jnp.asarray(arr("t_hot")),
            num_steps, min_k, max_k, highest_k, S, n,
            limbs,
            [arr(f"gs{i}") for i in range(num_k)],
            [arr(f"dt{i}") for i in range(num_k)],
            [arr(f"gi{i}") for i in range(num_k)],
            masks_np)
    except Exception:
        return None


def load_or_build_turbo(index_path: str, limbs: np.ndarray,
                        tax_rows: np.ndarray, highest_k: int, min_k: int,
                        max_k: int, num_species: int,
                        content_token=None) -> TurboTables:
    """Process + disk cached turbo tables for an on-disk index.

    The derived tables are an artifact-family extension (like the
    reference's trie, which is also derived from the sorted array and
    persisted, Trie.hpp:366): built once, reused by every identify run
    over the same index.

    content_token: any hashable stamp of the content file (e.g. its
    mtime_ns) -- with it, repeat calls hit the RAM cache without
    re-CRCing the 197M-row tax mapping (~1.3 s per identify call);
    the CRC still guards the DISK sidecar."""
    from ..utils import timers
    if content_token is not None:
        try:
            fast_key = (os.path.abspath(index_path),
                        os.path.getmtime(index_path), min_k, max_k,
                        num_species, "tok", content_token)
        except OSError:
            fast_key = None
        if fast_key is not None and fast_key in _TT_RAM_CACHE:
            return _TT_RAM_CACHE[fast_key]
    with timers.stage("turbo/tables-crc"):
        tax_crc = _tax_rows_crc(tax_rows)
    key = None
    try:
        key = (os.path.abspath(index_path), os.path.getmtime(index_path),
               min_k, max_k, num_species, tax_crc)
    except OSError:
        pass
    if key is not None and key in _TT_RAM_CACHE:
        if content_token is not None and fast_key is not None:
            _TT_RAM_CACHE[fast_key] = _TT_RAM_CACHE[key]
        return _TT_RAM_CACHE[key]
    tt = None
    cache_path = f"{index_path}.turbo_{min_k}_{max_k}.npz"
    meta_path = os.path.join(cache_path + ".tabs", "meta.json")
    fresh = (os.path.exists(meta_path)
             and os.path.getmtime(meta_path) >= os.path.getmtime(index_path))
    if key is not None and fresh:
        with timers.stage("turbo/tables-diskload"):
            tt = load_turbo(cache_path, limbs, tax_crc)
    if tt is None:
        with timers.stage("turbo/tables-build"):
            tt = TurboTables.build_from_arrays(limbs, tax_rows, highest_k,
                                               min_k, max_k, num_species)
        if key is not None:
            try:
                save_turbo(tt, cache_path, tax_crc)
            except OSError:
                pass
    tt._sidecar_dir = cache_path + ".tabs" \
        if os.path.isdir(cache_path + ".tabs") else None
    if key is not None:
        _TT_RAM_CACHE.clear()   # device memory: hold one index at a time
        _TT_RAM_CACHE[key] = tt
        if content_token is not None and fast_key is not None:
            _TT_RAM_CACHE[fast_key] = tt
    return tt

"""Turbo kernel correctness (match/turbo.py): the gather-minimal
search + per-read sort aggregation must reproduce intended-semantics
scoring/counting for any group size through its tier budgets, and the
overflow contract (device zeroes, host recomputes) must compose to the
exact answer."""

import numpy as np
import pytest

S = 2048
MIN_K, MAX_K, HK = 7, 12, 12
NUM_K = MAX_K - MIN_K + 1


def _index_with_tiers(n=50_000, seed=11,
                      heavy_ts=(2, 3, 5, 9, 12, 30, 60, 60, 200)):
    """Sorted index with skewed prefixes and engineered multi-taxa
    groups covering every expansion tier plus one overflow (T=200)."""
    rng = np.random.default_rng(seed)
    letters = rng.integers(1, 27, size=(n, 12), dtype=np.int32)
    letters[:, 0] = rng.integers(1, 5, size=n)      # skew limb0 runs
    limb0 = np.zeros(n, np.int32)
    limb1 = np.zeros(n, np.int32)
    for j in range(6):
        limb0 |= letters[:, j] << (5 * (5 - j))
        limb1 |= letters[:, 6 + j] << (5 * (5 - j))
    limbs = np.stack([limb0, limb1], axis=1)
    taxids = rng.integers(1, S, size=n).astype(np.uint32)

    extra_l, extra_t = [], []
    hot = []
    for T in heavy_ts:
        kl = limbs[rng.integers(0, n)]
        hot.append(kl)
        taxa = rng.choice(np.arange(1, S), size=T,
                          replace=False).astype(np.uint32)
        extra_l.append(np.repeat(kl[None, :], T, axis=0))
        extra_t.append(taxa)
    limbs = np.concatenate([limbs] + extra_l)
    taxids = np.concatenate([taxids] + extra_t)
    order = np.lexsort((taxids, limbs[:, 1], limbs[:, 0]))
    limbs, taxids = limbs[order], taxids[order]
    keep = np.ones(len(taxids), bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    return limbs[keep], taxids[keep], np.array(hot)


def _oracle(limbs, taxids, q, R, kpr):
    """Brute-force scores/counts with intended semantics (f64)."""
    from kasa_tpu.core import kmer
    ik = kmer.limbs_to_u64(limbs)
    qk = kmer.limbs_to_u64(q)
    scores = np.zeros((R, S), np.float64)
    counts_all = np.zeros((NUM_K, S), np.float64)
    counts_unique = np.zeros((NUM_K, S), np.int64)
    rid = np.arange(len(q)) // kpr
    for ki, k in enumerate(range(MAX_K, MIN_K - 1, -1)):
        sh = np.uint64(5 * (HK - k))
        ip = ik >> sh
        qp = qk >> sh
        lo = np.searchsorted(ip, qp, "left")
        hi = np.searchsorted(ip, qp, "right")
        w = (k * k) / 625.0
        for i in range(len(qp)):
            if lo[i] < hi[i]:
                taxa = np.unique(taxids[lo[i]:hi[i]].astype(np.int64))
                T = len(taxa)
                scores[rid[i], taxa] += w / T
                counts_all[ki, taxa] += 1.0 / T
                if T == 1:
                    counts_unique[ki, taxa] += 1
    return scores, counts_all, counts_unique


def _run_turbo(limbs, taxids, q, R, kpr):
    from kasa_tpu.match.join import DeviceIndex
    from kasa_tpu.match.turbo import (TurboTables, turbo_classify,
                                      host_classify_read)
    import jax.numpy as jnp

    tax_to_row = {t: t for t in range(S)}
    dev = DeviceIndex(limbs, taxids, tax_to_row, HK, MIN_K, MAX_K, S)
    assert TurboTables.supported(dev)
    tt = TurboTables.build(dev)
    out = turbo_classify(
        tt.keys2, tt.rowdat, tt.router, tt.sub2, tt.grp2, tt.d_tax4,
        tt.weights, tt.masks2, tt.hotmask, tt.t_hot, jnp.asarray(q),
        tt.num_steps, MIN_K, MAX_K, HK, S, R, kpr)
    ht, hk, hc, ca, cu, ofc, ofl = [np.asarray(o) for o in out]
    ca = ca.astype(np.float64)
    cu64 = cu.astype(np.int64)
    # host contract: recompute flagged reads exactly and merge
    lists = {}
    for r in range(R):
        if ofl[r]:
            sc, ca2, cu2 = host_classify_read(tt, q[r * kpr:(r + 1) * kpr])
            if ofc[r]:
                ca += ca2
                cu64 += cu2
            lists[r] = sorted(sc.items())
        else:
            lists[r] = [(int(ht[r, i]), float(hk[r, i]))
                        for i in range(hc[r])]
    return lists, ca, cu64, ofc, ofl


def test_turbo_matches_oracle_with_tiers_and_overflow():
    limbs, taxids, hot = _index_with_tiers()
    rng = np.random.default_rng(23)
    R, kpr = 64, 32
    m = R * kpr
    pick = rng.integers(0, len(taxids), size=m)
    q = limbs[pick].copy()
    miss = rng.random(m) < 0.3
    q[miss, 1] ^= (rng.integers(1, 31, size=int(miss.sum()))
                   .astype(np.int32) << 5)
    # plant hot k-mers (every tier incl. the T=200 overflow) in the
    # first reads so tier paths and the overflow contract all fire
    for i, kl in enumerate(hot):
        q[i * kpr + 3] = kl
    exp_scores, exp_ca, exp_cu = _oracle(limbs, taxids, q, R, kpr)
    lists, ca, cu, ofc, ofl = _run_turbo(limbs, taxids, q, R, kpr)

    assert ofc.any(), "T=200 group should overflow the tier budgets"
    np.testing.assert_allclose(ca, exp_ca, rtol=2e-5, atol=2e-3)
    np.testing.assert_array_equal(cu, exp_cu)
    for r in range(R):
        exp_taxa = np.nonzero(exp_scores[r])[0]
        got_taxa = np.array([t for t, _ in lists[r]], dtype=np.int64)
        np.testing.assert_array_equal(got_taxa, exp_taxa)
        got_v = np.array([v for _, v in lists[r]])
        np.testing.assert_allclose(got_v, exp_scores[r][exp_taxa],
                                   rtol=2e-4, atol=1e-4)


def test_turbo_list_overflow_only(monkeypatch):
    """A read with > WOUT distinct unique-taxon hits: counts stay exact
    on device (no oflow_counts) but the list overflows and is rebuilt
    on host.  (Production WOUT is 256; pinned to 48 here so the ~64-taxa
    corpus overflows it.)"""
    import kasa_tpu.match.turbo as turbo_mod
    monkeypatch.setattr(turbo_mod, "WOUT", 48)
    monkeypatch.setattr(turbo_mod, "WM", 64)
    turbo_mod.turbo_classify._clear_cache()
    WOUT = 48
    rng = np.random.default_rng(5)
    n = 4096
    letters = rng.integers(1, 27, size=(n, 12), dtype=np.int32)
    limb0 = np.zeros(n, np.int32)
    limb1 = np.zeros(n, np.int32)
    for j in range(6):
        limb0 |= letters[:, j] << (5 * (5 - j))
        limb1 |= letters[:, 6 + j] << (5 * (5 - j))
    limbs = np.stack([limb0, limb1], axis=1)
    # every entry a distinct taxon
    taxids = (np.arange(n) % (S - 1) + 1).astype(np.uint32)
    order = np.lexsort((taxids, limbs[:, 1], limbs[:, 0]))
    limbs, taxids = limbs[order], taxids[order]
    keep = np.ones(n, bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1)
    limbs, taxids = limbs[keep], taxids[keep]

    R, kpr = 4, 56
    q = limbs[np.arange(R * kpr) * 7 % len(limbs)].copy()
    # knock out letters 8..11 so each window matches only at k <= 8:
    # <= 2 (tax, k) runs per window keeps runs under CW while the
    # distinct-taxa count still exceeds WOUT
    lowmask = (31 << 15) | (31 << 10) | (31 << 5) | 31
    q[:, 1] = (q[:, 1] & ~lowmask) | (1 << 15) | (1 << 10) | (1 << 5) | 1
    exp_scores, exp_ca, exp_cu = _oracle(limbs, taxids, q, R, kpr)
    lists, ca, cu, ofc, ofl = _run_turbo(limbs, taxids, q, R, kpr)
    assert not ofc.any()
    assert ofl.any(), "reads hit ~64 distinct taxa > WOUT"
    assert (exp_scores[0] > 0).sum() > WOUT
    np.testing.assert_allclose(ca, exp_ca, rtol=2e-5, atol=2e-3)
    np.testing.assert_array_equal(cu, exp_cu)
    for r in range(R):
        exp_taxa = np.nonzero(exp_scores[r])[0]
        got_taxa = np.array([t for t, _ in lists[r]], dtype=np.int64)
        np.testing.assert_array_equal(got_taxa, exp_taxa)
    turbo_mod.turbo_classify._clear_cache()


def test_fused_turbo_acc_packed_roundtrip():
    """The packed readback (fast path's only per-batch transfer) must
    decode to the same hit lists as the dense outputs, accumulate
    counts on device across calls, and flag CSR overflow via the
    header when total hits exceed csr_cap."""
    import jax.numpy as jnp
    from kasa_tpu.match.join import DeviceIndex
    from kasa_tpu.match.turbo import (TurboTables, turbo_classify,
                                      fused_turbo_acc, WOUT)
    from kasa_tpu.core.encode import build_codon_code_lut

    # a byte matrix of DNA reads that decode through the real codon
    # LUT; the index is built from those reads' own windows so the
    # batch produces real hits
    rng = np.random.default_rng(3)
    R, maxlen = 8, 96
    mat = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(R, maxlen))
    lut = jnp.asarray(build_codon_code_lut().astype(np.int32))
    w = maxlen - 3 * HK + 1

    win = np.asarray(_windows_of(mat, lut, w))
    pick = win[rng.random(len(win)) < 0.5]
    taxids = rng.integers(1, S, size=len(pick)).astype(np.uint32)
    order = np.lexsort((taxids, pick[:, 1], pick[:, 0]))
    limbs, taxids = pick[order], taxids[order]
    keep = np.ones(len(taxids), bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    limbs, taxids = np.ascontiguousarray(limbs[keep]), taxids[keep]

    tax_to_row = {t: t for t in range(S)}
    dev = DeviceIndex(limbs, taxids, tax_to_row, HK, MIN_K, MAX_K, S)
    tt = TurboTables.build(dev)
    tabs = (tt.keys2, tt.rowdat, tt.router, tt.sub2, tt.grp2, tt.d_tax4,
            tt.weights, tt.masks2, tt.hotmask, tt.t_hot)

    def run(cap):
        acc_ca = jnp.zeros((NUM_K, S), jnp.float32)
        acc_cu = jnp.zeros((NUM_K, S), jnp.int32)
        outs = []
        for _ in range(2):      # two batches -> accumulation
            packed, ht, hk, acc_ca, acc_cu = fused_turbo_acc(
                *tabs, jnp.asarray(mat), lut, acc_ca, acc_cu,
                tt.num_steps, MIN_K, MAX_K, HK, S, R, False, False,
                1, w, cap)
            outs.append((np.asarray(packed), np.asarray(ht),
                         np.asarray(hk)))
        return outs, np.asarray(acc_ca), np.asarray(acc_cu)

    cap = WOUT * R
    outs, ca2, cu2 = run(cap=cap)
    packed, ht, hk = outs[0]
    hc = packed[:R]
    total = int(packed[-2])
    assert total == hc.sum()
    assert total <= cap, "corpus should fit the CSR budget"
    csr = packed[2 * R:2 * R + 2 * cap].reshape(cap, 2)
    pos = 0
    for r in range(R):
        for i in range(hc[r]):
            assert csr[pos, 0] == ht[r, i]
            assert csr[pos, 1].view(np.float32) == hk[r, i]
            pos += 1
    # identical second batch -> exactly double the accumulators
    one = turbo_classify(
        *tabs, jnp.asarray(
            _windows_of(mat, lut, w)), tt.num_steps, MIN_K, MAX_K, HK,
        S, R, w)
    ca_one = np.asarray(one[3])
    cu_one = np.asarray(one[4])
    np.testing.assert_allclose(ca2, 2 * ca_one, rtol=1e-6)
    np.testing.assert_array_equal(cu2, 2 * cu_one)

    # tiny cap -> header reports overflow, dense lists still correct
    outs_s, _, _ = run(cap=1)
    packed_s, ht_s, hk_s = outs_s[0]
    assert int(packed_s[-2]) == total > 1
    np.testing.assert_array_equal(ht_s, ht)


def _windows_of(mat, lut, w):
    import jax.numpy as jnp
    from kasa_tpu.core.encode import dna_to_aa_codes, encode_windows
    rows, maxlen = mat.shape
    flat = jnp.concatenate([jnp.asarray(mat).reshape(-1),
                            jnp.zeros((36,), jnp.uint8)])
    aa = dna_to_aa_codes(flat, lut, protein=False)
    win = encode_windows(aa, 12, 3)
    win = win[:rows * maxlen].reshape(rows, maxlen, -1)
    return win[:, :w].reshape(rows * w, -1)


def test_turbo_expansion_budget_drop(monkeypatch):
    """When the batch's true multi pair count exceeds EXP_BUDGET, the
    lightest slots drop and their reads are ofc-flagged; the host
    fallback contract must still reach the oracle answer."""
    import kasa_tpu.match.turbo as turbo_mod

    monkeypatch.setattr(turbo_mod, "EXP_BUDGET", 64)
    # keep the hot-set matrix-product path from absorbing the planted groups
    monkeypatch.setattr(turbo_mod, "HOT_SETS", 1)
    turbo_mod.turbo_classify._clear_cache()
    try:
        limbs, taxids, hot = _index_with_tiers(
            n=20_000, heavy_ts=(4, 8, 16, 16, 16, 16))
        rng = np.random.default_rng(31)
        R, kpr = 32, 24
        m = R * kpr
        pick = rng.integers(0, len(taxids), size=m)
        q = limbs[pick].copy()
        for i, kl in enumerate(hot):
            for j in range(4):
                q[(i * 4 + j) * kpr + 5] = kl
        exp_scores, exp_ca, exp_cu = _oracle(limbs, taxids, q, R, kpr)
        lists, ca, cu, ofc, ofl = _run_turbo(limbs, taxids, q, R, kpr)
        assert ofc.any(), "64-row budget must drop slots"
        np.testing.assert_allclose(ca, exp_ca, rtol=2e-5, atol=2e-3)
        np.testing.assert_array_equal(cu, exp_cu)
        for r in range(R):
            exp_taxa = np.nonzero(exp_scores[r])[0]
            got_taxa = np.array([t for t, _ in lists[r]], np.int64)
            np.testing.assert_array_equal(got_taxa, exp_taxa)
    finally:
        turbo_mod.turbo_classify._clear_cache()


def test_sparse_fold_matches_dense(monkeypatch):
    """The big-S sparse (read, tax) pair fold must produce identical
    outputs to the dense (R, S) fold on the same index/queries."""
    import numpy as np
    import jax.numpy as jnp
    import kasa_tpu.match.turbo as T

    rng = np.random.default_rng(5)
    S = 40
    # index with many multi-taxa groups (shared segments)
    n = 6000
    base = rng.integers(0, 1 << 18, size=n).astype(np.int64)
    limb0 = (base << 12 | rng.integers(0, 1 << 12, size=n)).astype(np.int32) & ((1 << 30) - 1)
    limb1 = rng.integers(0, 1 << 30, size=n, dtype=np.int64).astype(np.int32)
    # force duplicates of some keys across taxa (multi groups)
    dup = rng.integers(0, n, size=n // 2)
    limb0[dup] = limb0[(dup * 7) % n]
    limb1[dup] = limb1[(dup * 7) % n]
    tax = rng.integers(1, S, size=n).astype(np.int32)
    order = np.lexsort((tax, limb1, limb0))
    limbs = np.stack([limb0[order], limb1[order]], axis=1)
    taxr = tax[order]
    keep = np.ones(n, bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) | (taxr[1:] != taxr[:-1])
    limbs, taxr = np.ascontiguousarray(limbs[keep]), taxr[keep]

    R, kpr = 64, 24
    pick = rng.integers(0, len(limbs), size=R * kpr)
    q = jnp.asarray(limbs[pick])

    def run(sparse):
        monkeypatch.setattr(T, "SPARSE_FOLD_S", 8 if sparse else 1 << 30)
        T.turbo_classify._clear_cache()
        tt = T.TurboTables.build_from_arrays(limbs, taxr, 12, 7, 12, S)
        if sparse:
            assert tt.hotmask.shape[0] == 1, "hot tier must be off"
        out = T.turbo_classify(
            tt.keys2, tt.rowdat, tt.router, tt.sub2, tt.grp2, tt.d_tax4,
            tt.weights, tt.masks2, tt.hotmask, tt.t_hot, q,
            num_steps=tt.num_steps, min_k=7, max_k=12, highest_k=12,
            num_species=S, num_reads=R, kmers_per_read=kpr)
        return [np.asarray(o) for o in out]

    dense = run(False)
    sparse = run(True)
    np.testing.assert_array_equal(dense[0], sparse[0])          # hit_tax
    np.testing.assert_allclose(dense[1], sparse[1], rtol=1e-5,
                               atol=1e-5)                       # hit_ksum
    np.testing.assert_array_equal(dense[2], sparse[2])          # hit_cnt
    np.testing.assert_allclose(dense[3], sparse[3], rtol=1e-5,
                               atol=1e-4)                       # counts
    np.testing.assert_array_equal(dense[4], sparse[4])
    np.testing.assert_array_equal(dense[5], sparse[5])
    np.testing.assert_array_equal(dense[6], sparse[6])
    assert dense[2].sum() > 0


@pytest.mark.parametrize("num_files", [1, 2], ids=["acc", "files"])
def test_turbo_products_state_highest_precision(num_files):
    """Every float32 product of the lowered turbo program asks for
    HIGHEST precision: a GPU may otherwise run it in TF32 (~3 decimal
    digits), outside the score tolerance."""
    import jax.numpy as jnp
    from kasa_tpu.core.encode import build_codon_code_lut
    from kasa_tpu.match.turbo import TurboTables, fused_turbo_files
    limbs, taxids, _hot = _index_with_tiers(n=3000, heavy_ts=(2, 3, 5))
    tt = TurboTables.build_from_arrays(limbs, taxids.astype(np.int32), HK,
                                       MIN_K, MAX_K, S)
    assert tt.hotmask.shape[0] > 1, "the hot tier's products must exist"
    R, maxlen = 8, 96
    mat = jnp.zeros((R, maxlen), jnp.uint8)
    lut = jnp.asarray(build_codon_code_lut().astype(np.int32))
    fo = jnp.zeros((R,), jnp.int32)
    text = fused_turbo_files.lower(
        tt.keys2, tt.rowdat, tt.router, tt.sub2, tt.grp2, tt.d_tax4,
        tt.weights, tt.masks2, tt.hotmask, tt.t_hot, mat, lut, fo,
        tt.num_steps, MIN_K, MAX_K, HK, S, R, False, False, 1,
        maxlen - 3 * HK + 1, 4 * R, num_files=num_files).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert len(dots) >= 3
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln


@pytest.mark.gpu
def test_turbo_matches_oracle_on_gpu(gpu):
    """The tier and overflow oracle check on the card, where float32
    products could run in TF32 and scatters and sorts order ties
    differently from the CPU."""
    import jax
    assert jax.default_backend() == "gpu"
    test_turbo_matches_oracle_with_tiers_and_overflow()

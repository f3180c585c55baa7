"""Multi-chip classify: prefix-sharded index + batch data parallelism.

The reference scales with threads over disjoint stxxl ranges
(WorkerThread.hpp:22-129; range splits respect trie-range boundaries,
Compare.hpp:3263-3283).  The device equivalent is a 2-D device mesh:

  axis "ip" (index parallel):  the sorted index is split into
      contiguous shards ALIGNED TO 6-LETTER-PREFIX BOUNDARIES (so a
      k>=6 prefix group never spans shards and local group tables stay
      exact -- the same invariant the reference's thread split keeps);
  axis "dp" (data parallel):   the query batch is split by reads.

Each device matches its query shard against its index shard with the
single-chip kernel (match/device.py); a `psum` over "ip" merges the
partial score/count tensors, leaving results sharded over "dp".
All communication is XLA collectives (NCCL over NVLink on one
host); no host round-trips.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import kmer
from ..match.join import DeviceIndex, weight


def prefix_aligned_boundaries(limb0: np.ndarray, num_shards: int) -> np.ndarray:
    """Split points (num_shards+1,) aligned to 6-letter-prefix runs.

    Equal-size targets are snapped to the nearest prefix-run boundary
    (the trie data IS the histogram, SURVEY 'skewed prefix
    distribution').  The first 6 letters live in limb0.
    """
    n = len(limb0)
    run_starts = np.r_[0, np.nonzero(limb0[1:] != limb0[:-1])[0] + 1]
    bounds = [0]
    for s in range(1, num_shards):
        target = s * n // num_shards
        j = np.searchsorted(run_starts, target)
        cand = []
        if j < len(run_starts):
            cand.append(run_starts[j])
        if j > 0:
            cand.append(run_starts[j - 1])
        best = min(cand, key=lambda x: abs(int(x) - target))
        bounds.append(max(int(best), bounds[-1]))
    bounds.append(n)
    return np.asarray(bounds, dtype=np.int64)


@dataclass
class ShardedIndex:
    """Per-shard stacked group tables, stored as (ip, ...) arrays that
    get sharded over the "ip" mesh axis."""
    idx_limbs: np.ndarray   # (ip, Ns, L)
    grp_id: np.ndarray      # (ip, numK, Ns)
    grp_start: np.ndarray   # (ip, numK, Gmax)
    d_tax: np.ndarray       # (ip, numK, Tmax)
    masks: np.ndarray       # (numK, L) (replicated)
    weights: np.ndarray     # (numK,)
    run_start: np.ndarray   # (ip, Ns)
    run_end: np.ndarray     # (ip, Ns)
    prefix_tbl: np.ndarray  # (ip, 2^PREFIX_BITS + 1) per-shard offsets
    idx_tax: np.ndarray     # (ip, Ns)
    num_steps: int
    sub_steps: int
    min_k: int
    max_k: int
    highest_k: int
    num_species: int
    shard_lo: np.ndarray = None   # (ip,) first limb0 value of each shard

    @classmethod
    def build(cls, limbs: np.ndarray, taxids: np.ndarray, tax_to_row: dict,
              highest_k: int, min_k: int, max_k: int, num_species: int,
              num_shards: int) -> "ShardedIndex":
        from ..match.device import StackedTables

        n = len(taxids)
        bounds = prefix_aligned_boundaries(limbs[:, 0], num_shards)
        shard_sizes = np.diff(bounds)
        ns = max(int(shard_sizes.max()), 1)
        L = limbs.shape[1]
        num_k = max_k - min_k + 1

        from ..match.device import PREFIX_BITS
        all_limbs = np.zeros((num_shards, ns, L), np.int32)
        all_gid = np.zeros((num_shards, num_k, ns), np.int32)
        all_rs = np.zeros((num_shards, ns), np.int32)
        all_re = np.zeros((num_shards, ns), np.int32)
        all_ptbl = np.zeros((num_shards, (1 << PREFIX_BITS) + 1), np.int32)
        all_tax = np.zeros((num_shards, ns), np.int32)
        sub_steps = 1
        num_steps = 1
        g_tabs, t_tabs = [], []
        for s in range(num_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            sl, st = limbs[lo:hi], taxids[lo:hi]
            if hi == lo:  # empty shard: replicate one dummy entry
                sl, st = limbs[:1], taxids[:1]
            # pad by replicating the last entry (duplicates change no
            # group's taxa set, so tables stay exact)
            pad = ns - len(st)
            if pad:
                sl = np.concatenate([sl, np.repeat(sl[-1:], pad, axis=0)])
                st = np.concatenate([st, np.repeat(st[-1:], pad)])
            dev = DeviceIndex(sl, st, tax_to_row, highest_k, min_k, max_k,
                              num_species)
            tabs = StackedTables.build(dev)
            all_limbs[s] = np.asarray(tabs.idx_limbs)
            all_gid[s] = np.asarray(tabs.grp_id)
            all_rs[s] = np.asarray(tabs.run_start)
            all_re[s] = np.asarray(tabs.run_end)
            all_ptbl[s] = np.asarray(tabs.prefix_tbl)
            all_tax[s] = np.asarray(tabs.idx_tax)
            sub_steps = max(sub_steps, tabs.sub_steps)
            num_steps = max(num_steps, tabs.num_steps)
            g_tabs.append(np.asarray(tabs.grp_start))
            t_tabs.append(np.asarray(tabs.d_tax))
            masks = np.asarray(tabs.masks)
            weights = np.asarray(tabs.weights)

        g_max = max(t.shape[1] for t in g_tabs)
        t_max = max(t.shape[1] for t in t_tabs)
        all_gstart = np.zeros((num_shards, num_k, g_max), np.int32)
        all_dtax = np.zeros((num_shards, num_k, t_max), np.int32)
        for s in range(num_shards):
            g = g_tabs[s]
            all_gstart[s, :, :g.shape[1]] = g
            all_gstart[s, :, g.shape[1]:] = g[:, -1:]
            all_dtax[s, :, :t_tabs[s].shape[1]] = t_tabs[s]
        shard_lo = np.array(
            [int(limbs[min(int(bounds[s]), n - 1), 0]) for s in
             range(num_shards)], np.int32)
        shard_lo[0] = np.iinfo(np.int32).min   # shard 0 owns everything below
        return cls(all_limbs, all_gid, all_gstart, all_dtax, masks, weights,
                   all_rs, all_re, all_ptbl, all_tax, num_steps, sub_steps,
                   min_k, max_k, highest_k, num_species, shard_lo)


def make_sharded_classifier(si: ShardedIndex, mesh: Mesh,
                            num_reads_per_dp: int, m_per_dp: int,
                            cap: int = 16):
    """Build (jitted_fn, device_index_arrays).

    The returned fn takes per-batch query arrays laid out as
    (dp, m_per_dp, ...) and returns scores (dp, R_dp, S) plus profile
    count tensors; index arrays live sharded over "ip"."""
    from ..match.device import classify_batch

    dp = mesh.shape["dp"]
    ip = mesh.shape["ip"]
    assert si.idx_limbs.shape[0] == ip

    ispec = NamedSharding(mesh, P("ip"))
    dev_idx = {
        "idx_limbs": jax.device_put(si.idx_limbs, ispec),
        "grp_id": jax.device_put(si.grp_id, ispec),
        "grp_start": jax.device_put(si.grp_start, ispec),
        "d_tax": jax.device_put(si.d_tax, ispec),
        "masks": jax.device_put(si.masks, NamedSharding(mesh, P())),
        "weights": jax.device_put(si.weights, NamedSharding(mesh, P())),
        "run_start": jax.device_put(si.run_start, ispec),
        "run_end": jax.device_put(si.run_end, ispec),
        "prefix_tbl": jax.device_put(si.prefix_tbl, ispec),
        "idx_tax": jax.device_put(si.idx_tax, ispec),
    }

    def local_step(idx_limbs, grp_id, grp_start, d_tax, masks, weights,
                   run_start, run_end, prefix_tbl, idx_tax, q, rid, valid):
        # shard_map gives block-local arrays with the leading mesh dims
        scores, call, cuniq, ovf = classify_batch(
            idx_limbs[0], grp_id[0], grp_start[0], d_tax[0], masks, weights,
            run_start[0], run_end[0], prefix_tbl[0], idx_tax[0],
            q[0], rid[0], valid[0],
            si.num_steps, si.sub_steps, si.min_k, si.max_k, si.highest_k,
            si.num_species, num_reads_per_dp, cap)
        # merge partial results across index shards (one collective)
        scores = jax.lax.psum(scores, "ip")
        call = jax.lax.psum(call, "ip")
        cuniq = jax.lax.psum(cuniq, "ip")
        ovf = jax.lax.psum(ovf, "ip")
        return (scores[None], call[None], cuniq[None], ovf[None])

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("ip"), P("ip"), P("ip"), P("ip"), P(), P(),
                  P("ip"), P("ip"), P("ip"), P("ip"),
                  P("dp"), P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"), P("dp"), P("dp")),
        # the classify kernel builds loop carries from static shapes,
        # which trips the varying-manual-axes check inside fori_loop
        check_vma=False,
    )  # jax.shard_map (>=0.8) -- keyword-only signature

    @jax.jit
    def run(q, rid, valid):
        return sharded(dev_idx["idx_limbs"], dev_idx["grp_id"],
                       dev_idx["grp_start"], dev_idx["d_tax"],
                       dev_idx["masks"], dev_idx["weights"],
                       dev_idx["run_start"], dev_idx["run_end"],
                       dev_idx["prefix_tbl"], dev_idx["idx_tax"],
                       q, rid, valid)

    return run, dev_idx


def route_queries(si: ShardedIndex, q: np.ndarray, rid: np.ndarray,
                  valid: np.ndarray, dp: int, m_cap: int):
    """Host-side prefix routing (the all_to_all alternative): each
    query goes ONLY to the shard owning its limb0 range, packed as
    (dp, ip, m_cap) blocks for in_spec P("dp", "ip").

    Shards are prefix-run aligned, so ownership is a single
    searchsorted on the shards' first limb0 values.  With per-host
    ingest each host routes only its own dp slice; the only traffic on
    the interconnect is the psum that merges per-shard partial scores
    -- queries never move between devices at all.  (The reference has
    no counterpart: its threads all read the whole batch,
    Compare.hpp:3263-3310.)

    Returns (q_blocks, rid_blocks, valid_blocks, overflowed) --
    `overflowed` counts queries dropped because a (dp, ip) block
    exceeded m_cap; callers grow m_cap (bucketed) until it is zero."""
    ip = len(si.shard_lo)
    m = len(rid)
    per_dp = -(-m // dp)
    L = q.shape[1]
    qb = np.zeros((dp, ip, m_cap, L), np.int32)
    rb = np.zeros((dp, ip, m_cap), np.int32)
    vb = np.zeros((dp, ip, m_cap), bool)
    overflow = 0
    owner_all = np.searchsorted(si.shard_lo, q[:, 0], "right") - 1
    for d in range(dp):
        lo, hi = d * per_dp, min((d + 1) * per_dp, m)
        # vectorized pack: stable-sort by owner, then entry j of owner
        # s lands in block cell (s, j); invalid queries sort to a
        # sentinel owner and are dropped
        owner = np.where(valid[lo:hi], owner_all[lo:hi], ip)
        order = np.argsort(owner, kind="stable")
        os_ = owner[order]
        starts = np.searchsorted(os_, np.arange(ip + 1))
        within = np.arange(len(os_)) - starts[np.minimum(os_, ip)]
        keep = (os_ < ip) & (within < m_cap)
        overflow += int(np.sum((os_ < ip) & (within >= m_cap)))
        src = lo + order[keep]
        qb[d, os_[keep], within[keep]] = q[src]
        rb[d, os_[keep], within[keep]] = rid[src]
        vb[d, os_[keep], within[keep]] = True
    return qb, rb, vb, overflow


def make_routed_classifier(si: ShardedIndex, mesh: Mesh,
                           num_reads_per_dp: int, m_cap: int,
                           cap: int = 16):
    """Like make_sharded_classifier, but consumes host-routed
    (dp, ip, m_cap) query blocks: every device searches ONLY the
    queries destined for its index shard (compute 1/ip of the
    broadcast variant); the psum over "ip" still merges per-read
    partials, since one read's k-mers route to many shards."""
    from ..match.device import classify_batch

    ip = mesh.shape["ip"]
    assert si.idx_limbs.shape[0] == ip

    ispec = NamedSharding(mesh, P("ip"))
    dev_idx = {
        "idx_limbs": jax.device_put(si.idx_limbs, ispec),
        "grp_id": jax.device_put(si.grp_id, ispec),
        "grp_start": jax.device_put(si.grp_start, ispec),
        "d_tax": jax.device_put(si.d_tax, ispec),
        "masks": jax.device_put(si.masks, NamedSharding(mesh, P())),
        "weights": jax.device_put(si.weights, NamedSharding(mesh, P())),
        "run_start": jax.device_put(si.run_start, ispec),
        "run_end": jax.device_put(si.run_end, ispec),
        "prefix_tbl": jax.device_put(si.prefix_tbl, ispec),
        "idx_tax": jax.device_put(si.idx_tax, ispec),
    }

    def local_step(idx_limbs, grp_id, grp_start, d_tax, masks, weights,
                   run_start, run_end, prefix_tbl, idx_tax, q, rid, valid):
        scores, call, cuniq, ovf = classify_batch(
            idx_limbs[0], grp_id[0], grp_start[0], d_tax[0], masks, weights,
            run_start[0], run_end[0], prefix_tbl[0], idx_tax[0],
            q[0, 0], rid[0, 0], valid[0, 0],
            si.num_steps, si.sub_steps, si.min_k, si.max_k, si.highest_k,
            si.num_species, num_reads_per_dp, cap)
        scores = jax.lax.psum(scores, "ip")
        call = jax.lax.psum(call, "ip")
        cuniq = jax.lax.psum(cuniq, "ip")
        ovf = jax.lax.psum(ovf, "ip")
        return (scores[None], call[None], cuniq[None], ovf[None])

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("ip"), P("ip"), P("ip"), P("ip"), P(), P(),
                  P("ip"), P("ip"), P("ip"), P("ip"),
                  P("dp", "ip"), P("dp", "ip"), P("dp", "ip")),
        out_specs=(P("dp"), P("dp"), P("dp"), P("dp")),
        check_vma=False,
    )

    @jax.jit
    def run(q, rid, valid):
        return sharded(dev_idx["idx_limbs"], dev_idx["grp_id"],
                       dev_idx["grp_start"], dev_idx["d_tax"],
                       dev_idx["masks"], dev_idx["weights"],
                       dev_idx["run_start"], dev_idx["run_end"],
                       dev_idx["prefix_tbl"], dev_idx["idx_tax"],
                       q, rid, valid)

    return run, dev_idx

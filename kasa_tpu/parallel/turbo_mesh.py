"""Multi-chip turbo classify: the PRODUCTION kernel on a (dp, ip) mesh.

Round-2 left the mesh layer wrapping the classic per-batch kernel only
(parallel/mesh.py); this module shards the turbo kernel the CLI
actually runs (match/turbo.py) so `--engine tpu` scales to every
device:

  axis "dp" (data parallel):   the padded read matrix splits by rows.
      This is where throughput comes from -- the kernel's cost is per
      query window, so dp chips process dp batches' worth of reads in
      one step (the reference's thread pool over read ranges,
      Compare.hpp:3263-3310).
  axis "ip" (index parallel):  the sorted index splits into contiguous
      shards aligned to 6-letter-prefix runs (same invariant as the
      reference's trie-range-aligned thread splits, and as
      parallel/mesh.py).  Because min_k >= 6, every k-prefix group
      lives whole inside one shard, so per-shard turbo tables (router,
      rowdat Tpack, grp2, d_tax4) are exact without any cross-shard
      reconciliation.  ip exists for MEMORY: an index too big for one
      card's device memory shards across ip and each card searches
      its slice.

Per step, inside one shard_map:
  1. every (dp, ip) device windows its dp-slice of the byte matrix and
     runs _turbo_core against its ip index shard;
  2. count matrices psum over "ip" (a k-group lives in exactly one
     shard, so partials add exactly);
  3. per-read hit lists all_gather over "ip" and merge by one
     sort + segment-sum per read (a read's k-mers land in several
     shards; the same taxon may earn credit in each);
  4. the merged lists CSR-pack exactly like the single-chip path
     (turbo.fused_turbo_acc), one packed int32 row per dp block.

Host traffic stays one packed fetch per batch + accumulator flushes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..match.turbo import (TurboTables, _turbo_core, I32_MAX, WOUT,
                           dedup_read_windows, turbo_supported)
from .mesh import prefix_aligned_boundaries


@dataclass
class ShardedTurboTables:
    """Stacked per-shard turbo tables, leading dim = "ip"."""
    keys2: jax.Array        # (ip, Ns, 2)
    rowdat: jax.Array       # (ip, Ns, 4)
    router: jax.Array       # (ip, 2^ROUTER_BITS, 2)
    sub2: jax.Array         # (ip, SUBmax, 2)
    grp2: jax.Array         # (ip, numK * Ns)
    d_tax4: jax.Array       # (ip, DRmax, 4)
    weights: jax.Array      # (numK,) replicated
    masks2: jax.Array       # (numK, 2) replicated
    num_steps: int          # max over shards (extra steps are stable)
    min_k: int
    max_k: int
    highest_k: int
    num_species: int
    n: int
    ip: int
    bounds: np.ndarray      # (ip+1,) prefix-aligned entry boundaries
    host: TurboTables       # full-index tables: host overflow fallback
    hotmask_s: jax.Array = None   # (ip, Hmax, S) stacked hot-set masks
    t_hot_s: jax.Array = None     # (ip, Hmax) stacked hot-set sizes

    @classmethod
    def build(cls, limbs: np.ndarray, tax_rows: np.ndarray,
              highest_k: int, min_k: int, max_k: int, num_species: int,
              ip: int, host_tables: TurboTables | None = None
              ) -> "ShardedTurboTables":
        """Slice the sorted index at prefix-run boundaries, build one
        TurboTables per shard, then pad every shard to the max
        DISTINCT-key count nmax with layout-preserving semantics:

          keys2  pad rows get +inf keys (sortedness holds; a real
                 query prefix can never equal the +inf prefix; the
                 kernel gathers the predecessor row itself, so a query
                 sorting past the shard's content still sees its true
                 predecessor at pos-1),
          grp2   re-strided to the common nmax (the kernel indexes
                 ki * n + psel with n = stacked row count; r3 stacked
                 each shard's OWN-stride table and zero-padded, so
                 every shard with n_s < nmax read the wrong group
                 rows -- the actual root cause of the r3 mesh
                 wrongness),
          sub2 / d_tax4 / hotmask zero-pad (pads unreferenced).

        Empty shards get one all-'^' poison entry: every query that
        could match it is invalid at all k by the validity mask."""
        assert min_k >= 6, "prefix-aligned shards need min_k >= 6"
        assert turbo_supported(len(tax_rows), limbs.shape[1], min_k,
                               max_k, num_species)
        from ..match.turbo import POISON_LIMB
        n = len(tax_rows)
        bounds = prefix_aligned_boundaries(limbs[:, 0], ip)
        parts = []
        for s in range(ip):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            sl, st = limbs[lo:hi], tax_rows[lo:hi]
            if hi == lo:
                sl = np.array([[POISON_LIMB, POISON_LIMB]], np.int32)
                st = np.zeros(1, np.int32)
            parts.append(TurboTables.build_from_arrays(
                np.ascontiguousarray(sl), np.ascontiguousarray(st),
                highest_k, min_k, max_k, num_species))

        num_k = max_k - min_k + 1
        nmax = max(p.n for p in parts)
        keys2_s = np.full((ip, nmax, 2), I32_MAX, np.int32)
        rowdat_s = np.zeros((ip, nmax, 4), np.int32)
        grp2_s = np.zeros((ip, num_k * nmax), np.int32)
        for i, p in enumerate(parts):
            ns = p.n
            keys2_s[i, :ns] = np.asarray(p.keys2)
            rowdat_s[i, :ns] = np.asarray(p.rowdat)
            if ns < nmax:
                rowdat_s[i, ns:, 0:2] = I32_MAX
            g2 = np.asarray(p.grp2)
            for ki in range(num_k):
                grp2_s[i, ki * nmax:ki * nmax + ns] = \
                    g2[ki * ns:(ki + 1) * ns]

        def stack(attr):
            arrs = [np.asarray(getattr(p, attr)) for p in parts]
            rmax = max(a.shape[0] for a in arrs)
            out = np.zeros((ip, rmax) + arrs[0].shape[1:], arrs[0].dtype)
            for i, a in enumerate(arrs):
                out[i, :a.shape[0]] = a
            return out

        host = host_tables
        if host is None:
            host = TurboTables.build_from_arrays(
                limbs, tax_rows, highest_k, min_k, max_k, num_species)
        out = cls(
            jnp.asarray(keys2_s),
            jnp.asarray(rowdat_s),
            jnp.asarray(stack("router")),
            jnp.asarray(stack("sub2")),
            jnp.asarray(grp2_s),
            jnp.asarray(stack("d_tax4")),
            parts[0].weights, parts[0].masks2,
            max(p.num_steps for p in parts),
            min_k, max_k, highest_k, num_species, n, ip, bounds, host)
        out.hotmask_s = jnp.asarray(stack("hotmask"))
        out.t_hot_s = jnp.asarray(stack("t_hot"))
        return out


def make_turbo_mesh_step(st: ShardedTurboTables, mesh: Mesh):
    """Returns step(byte_mat, lut, acc_ca, acc_cu, *, rows_pad,
    protein, one_frame, lpr, w, csr_cap) -> (packed (dp, plen) i32,
    hit_tax (dp, Rdp, WOUT), hit_ksum (dp, Rdp, WOUT), new_ca
    (dp, numK, S), new_cu (dp, numK, S)).

    packed row d lays out reads [d*Rdp, (d+1)*Rdp) exactly like
    turbo.fused_turbo_acc's single-chip packing (hc | flags | CSR |
    [total, nflagged])."""
    jitted, tables = turbo_mesh_program(st, mesh)
    return functools.partial(jitted, *tables)


def turbo_mesh_program(st: ShardedTurboTables, mesh: Mesh):
    """-> (jitted, tables): the mesh step is jitted(*tables, byte_mat,
    lut, acc_ca, acc_cu, **static).  Device tables are placed sharded
    over "ip" once and passed to the jitted program as ARGUMENTS:
    tables a jitted function closes over become constants baked into
    each compiled program (hundreds of MB at bench scale, minutes of
    compile per batch geometry).  The program is cached per batch
    geometry."""
    dp = mesh.shape["dp"]
    ip = mesh.shape["ip"]
    assert st.ip == ip
    ispec = NamedSharding(mesh, P("ip"))
    rep = NamedSharding(mesh, P())
    tabs = tuple(jax.device_put(a, ispec) for a in (
        st.keys2, st.rowdat, st.router, st.sub2, st.grp2, st.d_tax4,
        st.hotmask_s, st.t_hot_s))
    wts = jax.device_put(st.weights, rep)
    mks = jax.device_put(st.masks2, rep)
    num_k = st.max_k - st.min_k + 1
    S = st.num_species

    @functools.partial(
        jax.jit,
        static_argnames=("rows_pad", "protein", "one_frame", "lpr", "w",
                         "csr_cap", "unique"),
        donate_argnames=("acc_ca", "acc_cu"))
    def jitted(tabs, wts, mks, byte_mat, lut, acc_ca, acc_cu, *, rows_pad,
               protein, one_frame, lpr, w, csr_cap, unique=False):
        from ..core.encode import dna_to_aa_codes, encode_windows

        R_local = rows_pad // dp
        cap = csr_cap

        def local(keys2, rowdat, router, sub2, grp2, d_tax4, hotm,
                  thot, weights, masks2, bm, lut, acc_ca, acc_cu):
            rows, maxlen = bm.shape
            stride = 1 if protein else 3
            flat = jnp.concatenate([
                bm.reshape(-1),
                jnp.zeros((stride * st.highest_k,), bm.dtype)])
            aa = dna_to_aa_codes(flat, lut, protein=protein)
            win = encode_windows(aa, st.highest_k, stride)
            win = win[:rows * maxlen].reshape(rows, maxlen, -1)
            if one_frame and not protein:
                win = win[:, ::3]
            q = win[:, :w].reshape(rows * w, -1)
            if unique:
                q = dedup_read_windows(q, R_local, w * lpr)
            # overflow flags must be GLOBAL across "ip" BEFORE any
            # count is masked/scattered inside the kernel: a read
            # flagged on ANY shard gets ALL its device contributions
            # zeroed on EVERY shard, so the post-psum ca/cu hold
            # nothing for it and the host's full-read re-add is exact
            # (r3 shipped per-shard masking -> double counts).
            def _global_or(f):
                return jax.lax.psum(f.astype(jnp.int32), "ip") > 0
            ht, hk, hc, ca, cu, ofc, ofl = _turbo_core(
                keys2[0], rowdat[0], router[0], sub2[0], grp2[0],
                d_tax4[0], weights, masks2, hotm[0], thot[0], q,
                st.num_steps, st.min_k, st.max_k, st.highest_k, S,
                R_local, w * lpr, flag_reduce=_global_or)

            # 2. exact partition of counts over index shards (every
            # shard already masked globally-flagged reads)
            ca = jax.lax.psum(ca, "ip")
            cu = jax.lax.psum(cu, "ip")
            ofc_m = ofc                      # already global (OR)
            # a shard-local truncated list poisons the merged list too
            ofl_m = _global_or(ofl)

            # 3. merge per-read lists across shards: same taxon may
            # earn credit from several shards' k-mers -> sum by taxon
            hts = jax.lax.all_gather(ht, "ip")       # (ip, R, WOUT)
            hks = jax.lax.all_gather(hk, "ip")
            tk = jnp.transpose(hts, (1, 0, 2)).reshape(R_local, ip * WOUT)
            tv = jnp.transpose(hks, (1, 0, 2)).reshape(R_local, ip * WOUT)
            k2, v2 = jax.lax.sort((tk, tv), dimension=1, num_keys=1)
            v2 = jnp.where(k2 != I32_MAX, v2, 0.0)
            nx = jnp.concatenate(
                [k2[:, 1:], jnp.full((R_local, 1), I32_MAX, jnp.int32)],
                axis=1)
            e2 = (k2 != nx) & (k2 != I32_MAX)
            pv = jnp.concatenate(
                [jnp.full((R_local, 1), -1, jnp.int32), k2[:, :-1]],
                axis=1)
            s2 = (k2 != pv)
            c2 = jnp.cumsum(v2, axis=1)
            b2 = jnp.where(s2, c2 - v2, -jnp.inf)
            b2 = jax.lax.cummax(b2, axis=1)
            sums = jnp.where(e2, c2 - b2, 0.0)
            fk = jnp.where(e2, k2, I32_MAX)
            mk, mv = jax.lax.sort((fk, sums), dimension=1, num_keys=1)
            ntax = jnp.sum(e2, axis=1)
            ofl_m = ofl_m | (ntax > WOUT)
            ht_m = mk[:, :WOUT]
            hk_m = mv[:, :WOUT]
            hc_m = jnp.minimum(ntax, WOUT).astype(jnp.int32)

            # 4. CSR pack, one row per dp block (layout == single-chip)
            cum = jnp.cumsum(hc_m) - hc_m
            iw = jnp.arange(WOUT, dtype=jnp.int32)
            validm = iw[None, :] < hc_m[:, None]
            dest = jnp.where(validm, cum[:, None] + iw[None, :], cap)
            csr = jnp.zeros((cap + 1, 2), jnp.int32)
            csr = csr.at[dest.reshape(-1), 0].set(
                ht_m.reshape(-1), mode="drop")
            csr = csr.at[dest.reshape(-1), 1].set(
                jax.lax.bitcast_convert_type(hk_m, jnp.int32).reshape(-1),
                mode="drop")
            flags = ofc_m.astype(jnp.int32) | (ofl_m.astype(jnp.int32) << 1)
            tail = jnp.stack([jnp.sum(hc_m),
                              jnp.sum(flags != 0)]).astype(jnp.int32)
            packed = jnp.concatenate(
                [hc_m, flags, csr[:cap].reshape(-1), tail])
            new_ca = acc_ca[0] + ca
            new_cu = acc_cu[0] + cu
            return (packed[None], ht_m[None], hk_m[None],
                    new_ca[None], new_cu[None])

        return shard_map(
            local, mesh=mesh,
            in_specs=(P("ip"), P("ip"), P("ip"), P("ip"), P("ip"),
                      P("ip"), P("ip"), P("ip"), P(), P(), P("dp"), P(),
                      P("dp"), P("dp")),
            out_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
            check_vma=False,
        )(*tabs, wts, mks, byte_mat, lut, acc_ca, acc_cu)

    return jitted, (tabs, wts, mks)


class MeshTurboDispatch:
    """Drive-side strategy for the fast path (match/fast.py): dispatch
    + packed decode for the (dp, ip) mesh, mirroring the single-chip
    TurboDispatch contract."""

    def __init__(self, st: ShardedTurboTables, mesh: Mesh):
        self.st = st
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.step = make_turbo_mesh_step(st, mesh)
        self.tt = st.host           # host fallback tables
        num_k = st.max_k - st.min_k + 1
        self._acc_shape = (self.dp, num_k, st.num_species)
        self._sharding = NamedSharding(mesh, P("dp"))

    def new_acc(self):
        z = jnp.zeros(self._acc_shape, jnp.float32)
        zi = jnp.zeros(self._acc_shape, jnp.int32)
        return (jax.device_put(z, self._sharding),
                jax.device_put(zi, self._sharding))

    def fetch(self, arr) -> np.ndarray:
        """Under jax.distributed the dp axis spans processes, so batch
        outputs are not fully addressable locally: allgather the global
        value (every process then ranks/writes the full result -- the
        identical-output agreement the dist dryrun asserts)."""
        if getattr(arr, "is_fully_addressable", True):
            return np.asarray(arr)
        from jax.experimental import multihost_utils
        return np.asarray(
            multihost_utils.process_allgather(arr, tiled=True))

    def reduce_acc(self, acc_ca, acc_cu):
        return (self.fetch(acc_ca).sum(axis=0),
                self.fetch(acc_cu).astype(np.int64).sum(axis=0))

    def round_rows(self, rows_pad: int) -> int:
        """rows_pad must split evenly over dp."""
        q = self.dp
        return -(-rows_pad // q) * q

    def csr_cap(self, rows_pad: int) -> int:
        from ..match.turbo import CSR_CAP_FACTOR
        return CSR_CAP_FACTOR * (rows_pad // self.dp)

    def dispatch(self, mat, lut, acc_ca, acc_cu, rows_pad, protein,
                 one_frame, lpr, w, cap, unique=False):
        mat_d = jax.device_put(
            mat, NamedSharding(self.mesh, P("dp", None)))
        return self.step(mat_d, lut, acc_ca, acc_cu,
                         rows_pad=rows_pad, protein=protein,
                         one_frame=one_frame, lpr=lpr, w=w, csr_cap=cap,
                         unique=unique)

    def decode(self, packed: np.ndarray, rows_pad: int, rb: int,
               cap: int, want_lists: bool, ht_d=None, hk_d=None):
        """(dp, plen) packed rows -> stitched (hc, ofc, ofl, ht, hk)
        over the first rb reads; ht/hk None unless want_lists."""
        dp = self.dp
        R_local = rows_pad // dp
        hc = np.concatenate([packed[d, :R_local] for d in range(dp)])
        fl = np.concatenate(
            [packed[d, R_local:2 * R_local] for d in range(dp)])
        ofc = (fl[:rb] & 1).astype(bool)
        ofl = (fl[:rb] >> 1).astype(bool)
        nflag = sum(int(packed[d, -1]) for d in range(dp))
        ht = hk = None
        if want_lists:
            over = any(int(packed[d, -2]) > cap for d in range(dp))
            if over:
                # rare: a dp block's CSR overflowed; the dense merged
                # lists were computed anyway (entries beyond hc[r] are
                # ignored by the sparse ranker)
                ht = self.fetch(ht_d).reshape(rows_pad, -1)[:rb].copy()
                hk = self.fetch(hk_d).reshape(rows_pad, -1)[:rb].copy()
            else:
                maxc = max(int(hc[:rb].max()) if rb else 0, 1)
                ht = np.zeros((rb, maxc), np.int32)
                hk = np.zeros((rb, maxc), np.float32)
                for d in range(dp):
                    r0, r1 = d * R_local, min((d + 1) * R_local, rb)
                    if r1 <= r0:
                        break
                    hcd = hc[r0:r1]
                    csr = packed[d, 2 * R_local:2 * R_local + 2 * cap] \
                        .reshape(cap, 2)
                    tot = int(hcd.sum())
                    rr = np.repeat(np.arange(r1 - r0), hcd)
                    cum = np.cumsum(hcd) - hcd
                    cc = np.arange(tot) - np.repeat(cum, hcd)
                    ht[r0 + rr, cc] = csr[:tot, 0]
                    hk[r0 + rr, cc] = csr[:tot, 1].view(np.float32)
        return hc[:rb].copy(), ofc, ofl, nflag, ht, hk

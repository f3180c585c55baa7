#!/usr/bin/env python3
"""Measure routed vs broadcast query placement on the sharded
classifier (parallel/mesh.py) -- the tradeoff docs/parallel.md
promises numbers for (VERDICT r2 #8).

Runs on the 8-virtual-device CPU mesh (JAX_PLATFORMS=cpu), so the
numbers are RELATIVE (collective and kernel cost ratios), not device
wall-clock.  Prints a markdown table row per (dp, ip) shape.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags
                               + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def main():
    from __graft_entry__ import _toy_index, _toy_queries
    from kasa_tpu.parallel.mesh import (ShardedIndex, make_routed_classifier,
                                        make_sharded_classifier,
                                        route_queries)
    from jax.sharding import Mesh

    limbs, taxids, ns = _toy_index(num_entries=65536, num_species=64)
    tax_to_row = {t: t for t in range(ns + 1)}
    m, r_per_dp = 8192, 512
    q, rid, valid = _toy_queries(limbs, m=m)
    rid = rid % r_per_dp

    rows = []
    for dp, ip in ((1, 8), (2, 4), (4, 2)):
        mesh = Mesh(np.asarray(jax.devices()[:dp * ip]).reshape(dp, ip),
                    ("dp", "ip"))
        si = ShardedIndex.build(limbs, taxids, tax_to_row, 12, 7, 12,
                                ns + 1, num_shards=ip)
        m_dp = m // dp
        qb = jnp.asarray(q.reshape(dp, m_dp, -1))
        rb = jnp.asarray(rid.reshape(dp, m_dp))
        vb = jnp.asarray(valid.reshape(dp, m_dp))
        run_b, _ = make_sharded_classifier(si, mesh, r_per_dp, m_dp)

        def timeit(fn, *a):
            out = fn(*a)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            for _ in range(5):
                out = fn(*a)
            jax.block_until_ready(out)
            return (time.perf_counter() - t0) / 5

        tb = timeit(run_b, qb, rb, vb)

        t0 = time.perf_counter()
        qr, rr, vr, dropped = route_queries(si, q, rid, valid, dp,
                                            m_cap=m_dp)
        t_route = time.perf_counter() - t0
        assert dropped == 0
        run_r, _ = make_routed_classifier(si, mesh, r_per_dp, m_dp)
        qrj, rrj, vrj = jnp.asarray(qr), jnp.asarray(rr), jnp.asarray(vr)
        tr = timeit(run_r, qrj, rrj, vrj)

        rows.append((dp, ip, tb * 1e3, tr * 1e3, t_route * 1e3,
                     tb / tr))
        print(f"# dp={dp} ip={ip}: broadcast {tb*1e3:.1f} ms, "
              f"routed {tr*1e3:.1f} ms (+ host routing "
              f"{t_route*1e3:.1f} ms) -> routed {tb/tr:.2f}x",
              file=sys.stderr, flush=True)

    print("| dp | ip | broadcast ms | routed ms | host routing ms | "
          "routed speedup |")
    print("|---|---|---|---|---|---|")
    for dp, ip, tb, tr, thr, sp in rows:
        print(f"| {dp} | {ip} | {tb:.1f} | {tr:.1f} | {thr:.1f} | "
              f"{sp:.2f}x |")


if __name__ == "__main__":
    main()

"""Multi-host initialization + mesh construction.

The reference is strictly single-process (SURVEY §2.5: no inter-node
communication of any kind); scaling beyond one host is new design:

  * every host runs the same program and calls ``init_distributed()``
    (jax.distributed.initialize), configured by the standard JAX env
    contract (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
    ``JAX_PROCESS_ID``);
  * the mesh keeps the INDEX-PARALLEL axis ("ip") inside each host,
    whose cards reach each other all to all over NVLink (the
    index-shard psum is the hot collective), while DATA-PARALLEL
    ("dp") spans hosts over the network -- per-host ingest feeds the
    host-local dp slice and nothing but the final per-read score rows
    ever crosses between hosts;
  * host-side prefix routing (mesh.route_queries) means queries are
    placed directly on their owning shard's host feed, so there is no
    all_to_all at all: the tradeoff vs broadcast+psum is in
    docs/parallel.md.
"""

from __future__ import annotations

import os

import numpy as np


def init_distributed() -> bool:
    """Initialize jax.distributed when a multi-process environment is
    configured; returns True when running multi-process."""
    import jax

    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize(
            coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]))
        return True
    return False


def make_identify_mesh(ip: int | None = None, dp: int | None = None):
    """Device mesh (dp, ip) with "ip" innermost so the per-shard psum
    stays inside one host; across hosts, "dp" maps to whole processes.

    Single-host: a plain reshape of local devices.  Multi-host: a
    hybrid mesh with dp spanning processes (each host holds complete
    index-shard groups, so the score psum never leaves the host)."""
    import jax
    from jax.sharding import Mesh

    n_local = jax.local_device_count()
    n_proc = jax.process_count()
    n_total = jax.device_count()

    if ip is None:
        ip = n_local if dp is None else max(n_total // dp, 1)
    if dp is None:
        dp = n_total // ip
    if dp * ip != n_total:
        raise ValueError(f"mesh {dp}x{ip} != {n_total} devices")

    if n_proc > 1:
        if ip > n_local or n_local % ip:
            raise ValueError(
                "index-parallel axis must divide the per-host device count "
                "so the index-shard psum stays inside one host")
        from jax.experimental import mesh_utils
        # the process (one host) is the granule the network joins
        devices = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=(n_local // ip, ip),
            dcn_mesh_shape=(n_proc, 1),
            process_is_granule=True)
        return Mesh(devices, ("dp", "ip"))
    devices = np.asarray(jax.devices()[:dp * ip]).reshape(dp, ip)
    return Mesh(devices, ("dp", "ip"))

"""Vectorized lexicographic binary search over limb-encoded keys.

Replaces the reference's per-query ``std::lower_bound`` over stxxl
ranges (Compare.hpp:824, 980) with a branchless fixed-iteration search
that runs for every query in parallel: log2(N) rounds of
(gather, compare, select).  All compares are int32 limb compares.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _lex_less(a_limbs: list, b_limbs: list) -> jax.Array:
    """a < b lexicographically, given per-limb arrays (broadcastable)."""
    L = len(a_limbs)
    result = jnp.zeros(jnp.broadcast_shapes(a_limbs[0].shape, b_limbs[0].shape), dtype=bool)
    decided = jnp.zeros_like(result)
    for i in range(L):
        lt = a_limbs[i] < b_limbs[i]
        gt = a_limbs[i] > b_limbs[i]
        result = jnp.where(~decided & lt, True, result)
        decided = decided | lt | gt
    return result


@functools.partial(jax.jit, static_argnames=("num_steps",))
def searchsorted_limbs(index_limbs: jax.Array, queries: jax.Array,
                       num_steps: int) -> jax.Array:
    """Lower bound of each query row in the sorted (N, L) index.

    index_limbs: (N, L) int32, sorted lexicographically.
    queries: (M, L) int32.
    num_steps: static iteration count >= ceil(log2(N+1)).
    Returns (M,) int32 positions in [0, N].
    """
    n = index_limbs.shape[0]
    L = index_limbs.shape[1]
    m = queries.shape[0]
    lo = jnp.zeros((m,), dtype=jnp.int32)
    hi = jnp.full((m,), n, dtype=jnp.int32)

    q_limbs = [queries[:, i] for i in range(L)]

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) >> 1
        mid_limbs = [index_limbs[:, i][mid] for i in range(L)]
        less = _lex_less(mid_limbs, q_limbs)  # index[mid] < q
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, num_steps, body, (lo, hi))
    return lo


def num_steps_for(n: int) -> int:
    steps = 0
    while (1 << steps) < n + 1:
        steps += 1
    return max(steps, 1)

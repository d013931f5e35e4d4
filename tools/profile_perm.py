"""Measure permutation-application primitives at 2M rows on the device.

The n-body frame applies the cell-sort permutation twice (forward to build
the kernel snapshot, inverse to unsort kernel outputs).  The variants below
compare: gather, scatter, argsort-inverse + gather, and multi-operand
carrying sort (lax.sort moving the payload through the sort network).

Run: ``python tools/profile_perm.py``; prints one line per primitive.
"""

from __future__ import annotations

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from particlesystem_tpu.utils.compile_cache import use_compile_cache  # noqa: E402


def timed(name, f, *args, reps=5):
    """Median wall time of ``reps`` calls, each ending in
    ``block_until_ready`` (one warm call first compiles)."""
    jax.block_until_ready(f(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        samples.append(time.perf_counter() - t0)
    ms = float(np.median(samples)) * 1e3
    print(f"{name:34s} {ms:8.3f} ms", flush=True)
    return ms


def main():
    use_compile_cache()
    n = 2 * 1024 * 1024
    num_cells = 4096
    k0 = jax.random.key(0)
    key = jax.random.randint(jax.random.split(k0, 1)[0], (n,), 0,
                             num_cells + 1, jnp.int32)
    cols16 = [jax.random.uniform(k, (n,), jnp.float32)
              for k in jax.random.split(k0, 16)]
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    out8 = jnp.stack(cols16[:8])  # (8, N)
    packed16 = jnp.stack(cols16, axis=1)  # (N, 16)
    jax.block_until_ready((order, out8, packed16))

    timed("argsort key", jax.jit(lambda k: jnp.argsort(k, stable=True)), key)
    timed("argsort order (inverse)",
          jax.jit(lambda o: jnp.argsort(o)), order)

    def carry_sort_n(m):
        @jax.jit
        def f(key, *cols):
            return jax.lax.sort((key,) + cols, num_keys=1, is_stable=True)
        return timed(f"lax.sort carry {m} f32 cols", f, key, *cols16[:m])

    carry_sort_n(1)
    carry_sort_n(4)
    carry_sort_n(8)
    carry_sort_n(16)

    timed("gather (N,16) rows", jax.jit(lambda p, o: p[o]), packed16, order)
    timed("gather (N,8) rows",
          jax.jit(lambda p, o: p[:, :8][o]), packed16, order)
    timed("gather (N,) f32", jax.jit(lambda c, o: c[o]), cols16[0], order)
    timed("gather (N,) bool",
          jax.jit(lambda c, o: (c > 0.5)[o]), cols16[0], order)

    timed("scatter (N,8) rows",
          jax.jit(lambda o, v: jnp.zeros((n, 8), jnp.float32).at[o].set(
              v.T, mode="drop", unique_indices=True)), order, out8)
    timed("scatter (N,) f32",
          jax.jit(lambda o, v: jnp.zeros((n,), jnp.float32).at[o].set(
              v, mode="drop", unique_indices=True)), order, cols16[0])
    timed("scatter (N,) bool",
          jax.jit(lambda o, v: jnp.zeros((n,), jnp.bool_).at[o].set(
              v > 0.5, mode="drop", unique_indices=True)), order, cols16[0])

    @jax.jit
    def unsort_via_sort(order, out8):
        res = jax.lax.sort((order,) + tuple(out8), num_keys=1,
                           is_stable=False)
        return res[1:]
    timed("unsort via sort(order,+8)", unsort_via_sort, order, out8)

    @jax.jit
    def inv_then_gather(order, out8):
        inv = jnp.argsort(order)
        return out8.T[inv]
    timed("argsort-inv + gather (N,8)", inv_then_gather, order, out8)

    skey = key[order]
    jax.block_until_ready(skey)
    timed("bincount+cumsum",
          jax.jit(lambda k: jnp.cumsum(jnp.bincount(k, length=num_cells + 1))),
          key)
    timed("searchsorted starts",
          jax.jit(lambda s: jnp.searchsorted(
              s, jnp.arange(num_cells + 2, dtype=jnp.int32))), skey)


if __name__ == "__main__":
    main()

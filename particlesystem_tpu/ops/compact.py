"""Dead-slot recycling via prefix-sum compaction.

Data-parallel replacement for the reference's per-segment circular free-id
queues (``QUEUE_INFO`` + ``q_remove``/``q_insert``,
``/root/reference/source/code/inc/app_common.cu:305-429``), including the
warp-serialized atomicCAS spin-locks of the GPU path (:383-429) — all of
which disappear: allocation becomes a deterministic scan.

Allocation rule (shared with the CPU oracle so trajectories match):
free slots are handed out in ascending slot order, to requests in ascending
request order.  Requests beyond the number of free slots are dropped — the
reference behaves the same when ``q_remove`` underflows (returns -1, no
spawn: ``particleSystem.cpp:1321-1332``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def free_slots_ascending(alive: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Return (free_sorted, n_free): indices of dead slots in ascending
    order, padded with ``n`` past the count."""
    n = alive.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    keys = jnp.where(alive, n, idx)
    free_sorted = jnp.sort(keys)
    n_free = jnp.sum(~alive).astype(jnp.int32)
    return free_sorted, n_free


def allocate(alive: jax.Array, request: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Assign a target slot to each requesting row.

    ``request`` is a boolean mask over an arbitrary axis (e.g. parents that
    spawn a child, or valid emitter rows).  Returns ``(target, ok)`` where
    ``target[i]`` is the allocated slot for request ``i`` (undefined where
    ``ok`` is False).  Deterministic: request rank (ascending index among
    requests) meets free rank (ascending dead slot index).
    """
    free_sorted, n_free = free_slots_ascending(alive)
    rank = jnp.cumsum(request.astype(jnp.int32)) - 1
    ok = request & (rank < n_free)
    target = free_sorted[jnp.clip(rank, 0, alive.shape[0] - 1)]
    return jnp.where(ok, target, alive.shape[0]), ok

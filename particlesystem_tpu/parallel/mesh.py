"""Device mesh helpers + multi-host initialization.

The reference's launcher is ``mpirun -n 2 --hostfile mpi-hosts``
(``/root/reference/makefile:3-4``); the JAX equivalent is
``jax.distributed.initialize`` (once per process) and a
``jax.sharding.Mesh`` over the global device list.  Single-host/single-chip runs need neither —
these helpers degrade gracefully.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def maybe_init_distributed() -> bool:
    """Initialize jax.distributed when launched under a multi-host
    coordinator (env-driven, mirrors the mpirun hostfile role).  Returns
    True when running multi-host."""
    coord = os.environ.get("PSTPU_COORDINATOR")
    if not coord:
        return False
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["PSTPU_NUM_PROCESSES"]),
        process_id=int(os.environ["PSTPU_PROCESS_ID"]),
    )
    return True


def mesh_1d(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    """1D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def mesh_2d(d3: int, d1: int, axes=("x", "y")) -> Mesh:
    """2D ``(d3, d1)`` mesh for the pencil decomposition
    (``parallel/nbody_pencil.py``).  Axis "x" shards grid planes (i3),
    "y" shards rows (i1)."""
    devs = jax.devices()
    if len(devs) < d3 * d1:
        raise ValueError(f"need {d3 * d1} devices, have {len(devs)}")
    return Mesh(np.array(devs[: d3 * d1]).reshape(d3, d1), axes)


def mesh_3d(d3: int, d1: int, d2: int, axes=("x", "y", "z")) -> Mesh:
    """3D ``(d3, d1, d2)`` mesh for the brick decomposition
    (``parallel/nbody_brick.py``) — the full analog of the reference's
    4x4x4 chunk ownership (``app_common.cu:150-232``)."""
    devs = jax.devices()
    n = d3 * d1 * d2
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]).reshape(d3, d1, d2), axes)


def _process_ids(devices) -> Optional[Sequence[int]]:
    """Per-device process index, or None when a device does not carry one.
    Separated out so tests can mock multi-process topologies."""
    ids = [getattr(d, "process_index", None) for d in devices]
    if any(i is None for i in ids):
        return None
    return ids


def _block_device_array(granules, intra_shape, inter_shape) -> np.ndarray:
    """Deterministic granule-block layout: granule ``gi`` (the devices of
    one process) tiles the ``intra_shape`` block at super-grid position
    ``gi`` of ``inter_shape``.  Pure (np object array in, no Mesh
    construction) so layout properties — ring axes staying inside one
    node — are unit-testable with stub devices."""
    global_shape = tuple(d * i for d, i in zip(inter_shape, intra_shape))
    arr = np.empty(global_shape, dtype=object)
    for gi, idx in enumerate(np.ndindex(*inter_shape)):
        block = np.array(granules[gi], dtype=object).reshape(intra_shape)
        sl = tuple(slice(idx[k] * intra_shape[k],
                         (idx[k] + 1) * intra_shape[k])
                   for k in range(len(intra_shape)))
        arr[sl] = block
    return arr


def default_mesh(shape, axes) -> Mesh:
    """Mesh of logical ``shape`` over the first ``prod(shape)`` devices.

    Within one node every device reaches every other at the same rate, so
    a single-process mesh is plain device order.  Across several processes
    (a multi-node job) the FIRST axis spans the inter-node seam block-wise
    and every other axis stays inside a node, so per-frame ring collectives
    (cyclic migration ``ppermute``) leave the node only at the two block
    boundaries of the first axis — the :func:`hybrid_mesh` placement rule,
    applied automatically.  Falls back to flat device order with a LOUD
    warning when that layout is impossible (axis size not divisible by the
    process count, uneven processes)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    devs = jax.devices()
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    devs = devs[:n]
    pids = _process_ids(devs)
    n_procs = len(set(pids)) if pids is not None else 1
    if n_procs > 1:
        counts = [pids.count(p) for p in sorted(set(pids))]
        if shape[0] % n_procs == 0 and len(set(counts)) == 1:
            intra = (shape[0] // n_procs,) + shape[1:]
            inter = (n_procs,) + (1,) * (len(shape) - 1)
            return hybrid_mesh(intra, inter, axes)
        warnings.warn(
            f"multi-process topology ({n_procs} processes) cannot be "
            f"honored for mesh shape {shape} (axis '{axes[0]}' size "
            f"{shape[0]} must divide evenly into equal processes); falling "
            f"back to flat device order — cyclic migration rings may cross "
            f"nodes every hop. Pass an explicit hybrid_mesh(...) instead.",
            RuntimeWarning, stacklevel=2)
    return Mesh(np.array(devs).reshape(shape), axes)


def _device_granules(devices, n_granules: int):
    """Group devices by process (one granule per node process); fall back
    to contiguous equal blocks — loudly when processes exist but do not
    match ``n_granules``."""
    keys = _process_ids(devices)
    if keys is not None and len(set(keys)) == n_granules:
        order = sorted(set(keys))
        return [[d for d, k in zip(devices, keys) if k == g] for g in order]
    if keys is not None and len(set(keys)) > 1:
        warnings.warn(
            f"{len(set(keys))} processes do not match the requested "
            f"{n_granules} inter-node blocks; using contiguous device blocks "
            f"— rings may cross nodes", RuntimeWarning, stacklevel=3)
    if len(devices) % n_granules:
        raise ValueError(
            f"{len(devices)} devices cannot split into {n_granules} granules")
    per = len(devices) // n_granules
    return [list(devices[i * per:(i + 1) * per]) for i in range(n_granules)]


def hybrid_mesh(intra_shape, inter_shape, axes) -> Mesh:
    """Node-aware ``Mesh`` for multi-node scale-out — the story the
    reference gets from its 2-host mpirun launch
    (``/root/reference/makefile:3-4``, ``build/linux/mpi-hosts:1-2``).

    Global mesh axis ``i`` has size ``inter_shape[i] * intra_shape[i]``;
    the devices of one process tile the ``intra_shape`` block, and blocks
    are laid out on the ``inter_shape`` super-grid.  **Placement rule**:
    give every axis that carries a per-frame ring collective (cyclic
    migration ``ppermute``) an ``inter_shape`` entry of 1 so its ring stays
    inside a node; reserve the inter-node split for ONE spatial axis, where
    traffic crosses nodes only between the two adjacent sub-domains (halo
    faces + the few migrants crossing that plane — O(face), never O(ring)).

    Examples over 2 nodes of 4 devices:

    * slab over 8:   ``hybrid_mesh((4,), (2,), ("x",))``
    * pencil (4,2):  ``hybrid_mesh((2, 2), (2, 1), ("x", "y"))`` —
      the "y" migration ring stays inside a node; "x" crosses once.
    * brick (2,2,2): ``hybrid_mesh((1, 2, 2), (2, 1, 1), ("x", "y", "z"))``
    """
    intra_shape = tuple(int(s) for s in intra_shape)
    inter_shape = tuple(int(s) for s in inter_shape)
    if len(intra_shape) != len(inter_shape) or len(intra_shape) != len(axes):
        raise ValueError(
            f"rank mismatch: {intra_shape} {inter_shape} {axes}")
    n_granules = int(np.prod(inter_shape))
    per_granule = int(np.prod(intra_shape))
    devs = jax.devices()[: n_granules * per_granule]
    if len(devs) < n_granules * per_granule:
        raise ValueError(
            f"need {n_granules * per_granule} devices, have {len(devs)}")
    granules = _device_granules(devs, n_granules)
    return Mesh(_block_device_array(granules, intra_shape, inter_shape),
                axes)

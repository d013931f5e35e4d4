"""Checkpoint / resume.

The reference has none — state lives only in pmlib address spaces for the
duration of a run (SURVEY.md §5); ``pFetchBack`` copies to host arrays but
nothing persists.  Two formats:

* **Monolithic** (:func:`save` / :func:`load`): any sim-state pytree
  (ParticleState, EngineState) round-trips through a single ``.npz`` with
  the frame counter and config fingerprint — the single-chip format.
* **Sharded** (:func:`save_sharded` / :func:`load_sharded`): a DIRECTORY of
  per-process ``.npz`` shard files + one ``meta.json``.  Each process
  writes ONLY its addressable device shards (their data plus their global
  index ranges) and, on load, reads back ONLY the saved chunks that
  intersect its addressable shards — no process ever materializes the full
  global state on either side, so checkpoint memory/IO scales with
  state/process_count instead of state (the scale-out fix for the
  gather-to-every-process save path).  Chunk geometry
  is stored per chunk, so a checkpoint written by P processes loads under
  any process count / mesh whose global shapes match.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _flatten(tree) -> Tuple[dict, Any]:
    leaves, treedef = jax.tree.flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    return arrays, treedef


def save(path: str, tree, meta: dict | None = None) -> None:
    """Write a sim-state pytree (and optional JSON-able metadata) to .npz."""
    arrays, _ = _flatten(tree)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load(path: str, template, expect_config=None):
    """Read a checkpoint written by :func:`save`; ``template`` provides the
    pytree structure (e.g. a freshly built state of the same config).
    Returns (tree, meta).

    ``expect_config``: the config the caller will resume under.  Most physics
    knobs (dt, gravity, eps2, seed...) don't change array shapes, so shape
    checks alone would let a checkpoint silently resume under a different
    config; pass the config (or its fingerprint dict) to reject that."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if expect_config is not None:
            _check_config(meta, expect_config)
        leaves, treedef = jax.tree.flatten(template)
        n = len(leaves)
        loaded = [data[f"leaf_{i}"] for i in range(n)]
        for tpl, got in zip(leaves, loaded):
            if tuple(np.shape(tpl)) != got.shape:
                raise ValueError(
                    f"checkpoint shape {got.shape} != template "
                    f"{tuple(np.shape(tpl))} — config mismatch?")
            if np.asarray(tpl).dtype != got.dtype:
                raise ValueError(
                    f"checkpoint dtype {got.dtype} != template "
                    f"{np.asarray(tpl).dtype} — config mismatch?")
        tree = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in loaded])
    return tree, meta


# -- sharded (directory) format ----------------------------------------------

_SHARDED_FORMAT = "pstpu-sharded-v1"


def is_sharded(path: str) -> bool:
    """True if ``path`` is a directory written by :func:`save_sharded`."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "meta.json"))


def _canon_index(index, shape) -> list:
    """Canonicalize a shard ``index`` (tuple of slices, possibly shorter
    than ndim / with Nones) to [[start, stop], ...] per dimension."""
    out = []
    for d, dim in enumerate(shape):
        sl = index[d] if d < len(index) else slice(None)
        start, stop, step = sl.indices(dim)
        assert step == 1, f"strided shard index unsupported: {sl}"
        out.append([start, stop])
    return out


def save_sharded(path: str, tree, meta: dict | None = None) -> None:
    """Write a (possibly multi-process) sharded pytree as a checkpoint
    DIRECTORY: ``meta.json`` (process 0) + one ``shard_p{pid}.npz`` per
    process holding only that process's addressable device shards with
    their global index ranges.  Replicated shards are deduplicated within
    a process.  Returns after a cross-process barrier, so every process
    may immediately :func:`load_sharded` the result.

    Multi-process runs require ``path`` to be on a filesystem shared by
    ALL processes: ``meta.json`` is written only by process 0 and each
    process's load reads the other processes' shard files.  On per-host
    local disks the load fails with a missing-shard error.

    Overwriting an existing checkpoint directory is safe: process 0
    removes stale ``shard_p*.npz`` / ``meta.json`` first (behind a
    barrier), so a re-save under a SMALLER process count cannot leave
    higher-pid shard files behind to corrupt a later load."""
    leaves, _ = jax.tree.flatten(tree)
    leaves = [jax.block_until_ready(l) if hasattr(l, "block_until_ready")
              else l for l in leaves]
    pid = jax.process_index()
    os.makedirs(path, exist_ok=True)
    if pid == 0:
        for fn in glob.glob(os.path.join(path, "shard_p*.npz")):
            os.unlink(fn)
        stale_meta = os.path.join(path, "meta.json")
        if os.path.exists(stale_meta):
            os.unlink(stale_meta)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        # nobody writes until process 0 has cleared stale files.  The
        # barrier name must NOT embed the path: processes may legitimately
        # spell the same shared directory differently (symlinks, mount
        # points), and sync_global_devices asserts name equality — a
        # mismatched-path failure here would mask the real error (the
        # shared-filesystem requirement), which load reports clearly
        multihost_utils.sync_global_devices("pstpu_ckpt_clear")
    arrays, chunk_meta = {}, []
    for i, leaf in enumerate(leaves):
        shape = tuple(np.shape(leaf))
        seen, j = set(), 0
        shards = (leaf.addressable_shards if hasattr(leaf, "addressable_shards")
                  else [None])
        for sh in shards:
            idx = (_canon_index(sh.index, shape) if sh is not None
                   else [[0, d] for d in shape])
            key_t = tuple(map(tuple, idx))
            if key_t in seen:
                continue  # replicated copy on another local device
            seen.add(key_t)
            data = np.asarray(sh.data if sh is not None else leaf)
            arrays[f"l{i}s{j}"] = data
            arrays[f"l{i}s{j}_idx"] = np.asarray(idx, dtype=np.int64
                                                 ).reshape(-1, 2)
            j += 1
        chunk_meta.append(dict(shape=list(shape),
                               dtype=str(leaf.dtype if hasattr(leaf, "dtype")
                                         else np.asarray(leaf).dtype)))
    np.savez(os.path.join(path, f"shard_p{pid:05d}.npz"), **arrays)
    if pid == 0:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(dict(format=_SHARDED_FORMAT, meta=meta or {},
                           n_processes=jax.process_count(),
                           leaves=chunk_meta), f)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("pstpu_ckpt_save")


def _read_sharded_meta(path: str, expect_config=None) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        info = json.load(f)
    if info.get("format") != _SHARDED_FORMAT:
        raise ValueError(f"unknown checkpoint format {info.get('format')!r}")
    if expect_config is not None:
        _check_config(info["meta"], expect_config)
    return info


def _chunk_index(path: str, n_processes: int):
    """Map leaf id -> list of (npz, key, [[start,stop],...]) WITHOUT loading
    chunk data: npz member arrays load lazily, so only the tiny ``_idx``
    arrays are read here.  Reads EXACTLY the ``n_processes`` shard files
    recorded in meta.json — never a glob, so stale higher-pid files from an
    older save cannot leak in — and errors if any expected file is absent
    (e.g. a multi-process checkpoint written to per-host local disks
    instead of a shared filesystem).  Returns (chunks, handles); the caller
    must close every handle after assembling (the NpzFiles stay open for
    lazy member reads until then)."""
    chunks: dict = {}
    handles = []
    for pid in range(n_processes):
        fn = os.path.join(path, f"shard_p{pid:05d}.npz")
        if not os.path.exists(fn):
            for z in handles:
                z.close()
            raise FileNotFoundError(
                f"checkpoint {path!r} lists {n_processes} processes in "
                f"meta.json but {os.path.basename(fn)} is missing — "
                f"multi-process checkpoints need a shared filesystem")
        z = np.load(fn)
        handles.append(z)
        for key in z.files:
            if key.endswith("_idx"):
                base = key[:-4]
                i = int(base[1:base.index("s")])
                chunks.setdefault(i, []).append(
                    (z, base, z[key].tolist()))
    return chunks, handles


def _assemble(dst_idx, dtype, chunks) -> np.ndarray:
    """Assemble the global slice ``dst_idx`` ([[start,stop],...]) from the
    saved chunks, loading ONLY chunk members that intersect it."""
    out = np.empty([b - a for a, b in dst_idx], dtype=dtype)
    # full-rank coverage mask (1 byte/element): replicated chunks may
    # overlap, so intersection volumes cannot simply be summed, and a
    # dim-0-only mask would miss a chunk that covers rows but only part of
    # the trailing dims
    filled = np.zeros(out.shape if out.ndim else (1,), dtype=bool)
    for z, base, src_idx in chunks:
        inter = [[max(a, c), min(b, d)]
                 for (a, b), (c, d) in zip(dst_idx, src_idx)]
        if any(a >= b for a, b in inter) and out.size:
            continue
        data = z[base]  # lazy zip-member read: only intersecting chunks
        dst_sl = tuple(slice(a - o[0], b - o[0])
                       for (a, b), o in zip(inter, dst_idx))
        src_sl = tuple(slice(a - o[0], b - o[0])
                       for (a, b), o in zip(inter, src_idx))
        out[dst_sl] = data[src_sl]
        if out.ndim:
            filled[dst_sl] = True
        else:
            filled[:] = True
    if not filled.all():
        raise ValueError(
            "checkpoint chunks do not cover the requested slice "
            f"({int(filled.sum())}/{filled.size} elements covered)")
    return out


def load_sharded(path: str, template, expect_config=None):
    """Load a :func:`save_sharded` directory INTO the shardings of
    ``template`` (a live pytree of jax arrays, e.g. the driver's current
    sharded state).  Each process reads only the saved chunks intersecting
    its addressable shards (``jax.make_array_from_callback``), so no
    process materializes the full state.  Global shapes/dtypes must match
    ``template``.  Multi-process checkpoints must live on a shared
    filesystem (see :func:`save_sharded`); a missing shard file raises
    ``FileNotFoundError``.  Returns (tree, meta)."""
    info = _read_sharded_meta(path, expect_config)
    leaves, treedef = jax.tree.flatten(template)
    if len(info["leaves"]) != len(leaves):
        raise ValueError(f"checkpoint has {len(info['leaves'])} leaves, "
                         f"template {len(leaves)}")
    for tpl, lm in zip(leaves, info["leaves"]):
        if list(np.shape(tpl)) != lm["shape"]:
            raise ValueError(f"checkpoint leaf shape {lm['shape']} != "
                             f"template {list(np.shape(tpl))}")
        tpl_dt = (tpl.dtype if hasattr(tpl, "dtype")
                  else np.asarray(tpl).dtype)
        if np.dtype(lm["dtype"]) != np.dtype(tpl_dt):
            raise ValueError(f"checkpoint leaf dtype {lm['dtype']} != "
                             f"template {np.dtype(tpl_dt)} — config "
                             f"mismatch?")
    chunks, handles = _chunk_index(path, info["n_processes"])
    try:
        out = []
        for i, tpl in enumerate(leaves):
            dtype = np.dtype(info["leaves"][i]["dtype"])
            shape = tuple(info["leaves"][i]["shape"])

            def cb(index, _i=i, _dt=dtype, _shape=shape):
                return _assemble(_canon_index(index, _shape), _dt,
                                 chunks.get(_i, []))

            sharding = tpl.sharding if hasattr(tpl, "sharding") else None
            if sharding is None:
                out.append(jnp.asarray(_assemble([[0, d] for d in shape],
                                                 dtype, chunks.get(i, []))))
            else:
                out.append(jax.make_array_from_callback(shape, sharding, cb))
        # make_array_from_callback invokes cb for every addressable shard
        # before returning, so all lazy npz reads are done here
        out = [jax.block_until_ready(x) for x in out]
    finally:
        for z in handles:
            z.close()
    return jax.tree.unflatten(treedef, out), info["meta"]


def load_sharded_host(path: str, treedef=None, expect_config=None):
    """Assemble the FULL global state on the host — the cross-decomposition
    portability path (the loading spec's slot layout differs, so the caller
    must re-``distribute``).  Memory cost: the whole state in THIS process.
    ``treedef``: unflatten target (e.g. from a live state of any config);
    returns (tree-or-leaf-list, meta)."""
    info = _read_sharded_meta(path, expect_config)
    chunks, handles = _chunk_index(path, info["n_processes"])
    try:
        leaves = [jnp.asarray(_assemble([[0, d] for d in lm["shape"]],
                                        np.dtype(lm["dtype"]),
                                        chunks.get(i, [])))
                  for i, lm in enumerate(info["leaves"])]
    finally:
        for z in handles:
            z.close()
    if treedef is not None:
        return jax.tree.unflatten(treedef, leaves), info["meta"]
    return leaves, info["meta"]


def _check_config(meta: dict, expect_config) -> None:
    want = (expect_config if isinstance(expect_config, dict)
            else config_fingerprint(expect_config))
    stored = {k: meta[k] for k in want if k in meta}
    if stored != want:
        diff = {k: (stored.get(k), want[k])
                for k in want if stored.get(k) != want[k]}
        raise ValueError(
            f"checkpoint config mismatch (stored, current): {diff}")


def config_fingerprint(cfg) -> dict:
    """JSON-able snapshot of a frozen config dataclass, for save() metadata."""
    def enc(v):
        if dataclasses.is_dataclass(v):
            return {f.name: enc(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, tuple):
            return [enc(x) for x in v]
        return v
    return enc(cfg)

"""Unified multi-device n-body driver.

``DistributedNBodySimulation`` is the multi-chip completion of
``api.NBodySimulation`` — the full ``DoParallelProcess`` equivalent
(``/root/reference/source/code/src/particleSystem.cpp:1733-1986``: allocate,
fill, iterate with timings, fetch back) over a sharded state.  It takes any
of the three decomposition specs (:class:`~.nbody_sharded.SlabSpec`,
:class:`~.nbody_pencil.PencilSpec`, :class:`~.nbody_brick.BrickSpec`) plus a
``Mesh`` and provides the same facilities the single-chip driver has:

* ``run``            — the iteration loop, per-phase timers, drop warnings;
* ``save`` / ``load`` — SHARDED checkpoint round-trip (per-process shard
  files, config- and spec-fingerprinted; no process ever holds the full
  state on the same-spec path; ``load`` re-distributes when the spec
  differs, so checkpoints move between decompositions);
* ``validate``       — the sharded production step vs the independent numpy
  oracle (the reference stubs this comparison out — ``DoCompare``,
  ``particleSystem.cpp:2254-2257``); SHARD-LOCAL: each process checks only
  its addressable shards' rows (joined to the oracle by persistent tag) and
  the device state is never gathered;
* ``profile_frame``  — dispatch-count-slope frame timing;
* ``autosize_buffers`` — measure-then-derive halo/migration capacities from
  the reported high-water marks (replaces the worst-case whole-face
  defaults).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..core.config import NBodyConfig
from ..core.state import ParticleState
from ..models import nbody
from ..runtime import checkpoint
from ..utils.timers import PhaseTimers
from .mesh import default_mesh
from .nbody_brick import BrickSpec, make_brick_step
from .nbody_brick import distribute as _dist_brick
from .nbody_pencil import PencilSpec, make_pencil_step
from .nbody_pencil import distribute as _dist_pencil
from .nbody_sharded import SlabSpec, make_sharded_step
from .nbody_sharded import distribute as _dist_slab

# default meshes are node-aware (parallel/mesh.default_mesh): across
# several processes the first axis spans the inter-node seam block-wise and
# the others stay inside a node; pass an explicit `mesh` to override
_BY_SPEC = {
    SlabSpec: (make_sharded_step, _dist_slab,
               lambda s: default_mesh((s.n_devices,), (s.axis,))),
    PencilSpec: (make_pencil_step, _dist_pencil,
                 lambda s: default_mesh((s.d3, s.d1), s.axes)),
    BrickSpec: (make_brick_step, _dist_brick,
                lambda s: default_mesh((s.d3, s.d1, s.d2), s.axes)),
}


class DistributedNBodySimulation:
    """Drive the reference simulation over a device mesh.

    >>> spec = BrickSpec(d3=2, d1=2, d2=2, impl="dense")
    >>> sim = DistributedNBodySimulation(cfg, spec)   # mesh defaults to 3D
    >>> sim.run(10)
    >>> sim.autosize_buffers()      # shrink halo/migration buffers
    >>> sim.save("ckpt.npz"); sim.validate()
    """

    def __init__(self, cfg: NBodyConfig, spec, mesh: Optional[Mesh] = None,
                 state: Optional[ParticleState] = None):
        try:
            make_step, dist, default_mesh = _BY_SPEC[type(spec)]
        except KeyError:
            raise TypeError(f"unknown decomposition spec {type(spec)!r}")
        self.cfg = cfg
        self._spec_raw = spec          # user capacities (0 = derive)
        self.spec = spec.derive(cfg)   # concrete capacities in force
        self.mesh = mesh if mesh is not None else default_mesh(spec)
        self._make_step = make_step
        self._distribute = dist
        self.timers = PhaseTimers()
        self.frame = 0
        self.last_stats = None
        self.n_degraded_frames = 0
        self._step_fn, self._shard_state = make_step(cfg, self.spec,
                                                     self.mesh)
        self._loop_jits = {}  # batch -> jitted guard-accumulating loop
        with self.timers.phase("fill"):
            if state is None:
                state = nbody.init_fill(cfg)
            state, n_dropped = dist(state, cfg, self.spec)
            self.n_fill_dropped = n_dropped
            self.state = self._shard_state(state)

    # -- simulation -------------------------------------------------------
    _SUM_KEYS = ("halo_dropped", "migration_dropped", "n_listed_dropped")
    _MAX_KEYS = ("halo_used_max", "migration_used_max")

    def _loop_fn(self, batch: int):
        """Batch-``k`` device-side loop around the sharded step with the
        drop counters summed and the buffer high-water marks maximized on
        device — ONE packed host readback per batch instead of three stat
        syncs per frame.  The returned stats dict carries the WHOLE batch's
        accumulated drops/marks in place of the final frame's."""
        fn = self._loop_jits.get(batch)
        if fn is None:
            step = self._step_fn
            sum_keys, max_keys = self._SUM_KEYS, self._MAX_KEYS

            def body(i, carry):
                s, _, acc = carry
                s2, st = step(s, jnp.int32(i))
                acc2 = {k: acc[k] + st[k] for k in sum_keys}
                acc2.update({k: jnp.maximum(acc[k], st[k])
                             for k in max_keys})
                return (s2, st, acc2)

            def loop(s, f0):
                s1, st1 = step(s, f0)
                acc = {k: st1[k] for k in sum_keys + max_keys}
                s2, st, acc = jax.lax.fori_loop(
                    f0 + 1, f0 + batch, body, (s1, st1, acc))
                st = dict(st, **acc)
                guards = jnp.stack([st[k] for k in sum_keys]
                                   + [st["n_alive"], st["n_spawned"]]
                                   + [st[k] for k in max_keys])
                return s2, st, guards

            fn = jax.jit(loop)
            self._loop_jits[batch] = fn
        return fn

    def run(self, num_iterations: int = 10, verbose: bool = False,
            batch: int = 0) -> dict:
        """Advance ``num_iterations`` frames.  ``batch=0`` (the default)
        auto-batches — the largest divisor of ``num_iterations`` <= 16
        (:func:`..api.auto_batch`), so plain ``run()`` takes the sync-free
        path.  ``batch=k`` (k > 1) runs device-side ``fori_loop`` batches
        with drop counters accumulated on device and ONE host readback per
        batch (overflow warnings then arrive at batch boundaries and cover
        the whole batch); ``num_iterations`` must be a multiple of ``k``.
        ``batch=1`` keeps per-frame readbacks (the debugging mode)."""
        if batch == 0:
            from ..api import auto_batch
            batch = auto_batch(num_iterations)
        if batch > 1 and num_iterations % batch:
            raise ValueError(f"num_iterations {num_iterations} must be a "
                             f"multiple of batch {batch}")
        for _ in range(num_iterations // batch if batch > 1
                       else num_iterations):
            with self.timers.phase("step"):
                if batch > 1:
                    self.state, stats, guards = self._loop_fn(batch)(
                        self.state, jnp.int32(self.frame))
                    g = np.asarray(guards)  # the batch's single host sync
                    drops = {k: int(g[i]) for i, k in
                             enumerate(self._SUM_KEYS) if int(g[i])}
                    n_alive, n_spawned = int(g[3]), int(g[4])
                    halo_max, mig_max = int(g[5]), int(g[6])
                else:
                    self.state, stats = self._step_fn(self.state,
                                                      jnp.int32(self.frame))
                    drops = {k: int(stats[k]) for k in self._SUM_KEYS
                             if int(stats.get(k, 0))}
                    n_alive = int(stats["n_alive"])
                    n_spawned = int(stats["n_spawned"])
                    halo_max = int(stats["halo_used_max"])
                    mig_max = int(stats["migration_used_max"])
            self.frame += batch
            self.last_stats = stats
            if drops:
                self.n_degraded_frames += 1
                warnings.warn(
                    f"frame {self.frame}: buffer overflow drops {drops} — "
                    f"raise the spec capacities (see autosize_buffers)",
                    RuntimeWarning, stacklevel=2)
            if verbose:
                print(f"iter {self.frame}: alive={n_alive} "
                      f"spawned={n_spawned} halo_max={halo_max} "
                      f"mig_max={mig_max}")
        return {k: int(v) for k, v in self.last_stats.items()}

    # -- state access -----------------------------------------------------
    def gather(self) -> ParticleState:
        """Fetch the full global state to host memory (the ``pFetchBack``
        analog, ``particleSystem.cpp:1778-1786``) — slot arrangement is the
        device-major layout the decomposition maintains.  Under multi-process
        meshes ``np.asarray`` cannot see the other processes' shards, so the
        cross-host path rides ``process_allgather`` (every process receives
        the full state — matching the reference's fetch-to-master, which the
        master then rebroadcast via pmlib DSM)."""
        return jax.tree.map(jnp.asarray, _to_host(self.state))

    def alive_count(self) -> int:
        if self.last_stats is not None:
            return int(self.last_stats["n_alive"])
        return int(np.asarray(self.gather().alive).sum())

    # -- persistence ------------------------------------------------------
    def _spec_fp(self) -> dict:
        """JSON-normalized spec fingerprint (tuples become lists, exactly
        as they read back from a checkpoint's meta.json)."""
        import dataclasses
        import json
        return json.loads(json.dumps(dataclasses.asdict(self.spec)))

    def _meta(self) -> dict:
        return dict(frame=self.frame, spec_type=type(self.spec).__name__,
                    spec=self._spec_fp(),
                    **checkpoint.config_fingerprint(self.cfg))

    def save(self, path: str) -> None:
        """Checkpoint to a SHARDED directory at ``path``: each process
        writes only its addressable device shards + global indices, stamped
        with the config AND spec fingerprints (same-shape-different-physics
        resume is refused on load, like the single-chip driver).  No
        process gathers the full state — checkpoint memory and IO scale
        with state/process_count (the reference fetches everything to the
        master, ``pmFetchMemory``; that shape breaks at multi-host scale)."""
        checkpoint.save_sharded(path, self.state, meta=self._meta())

    def load(self, path: str) -> int:
        """Resume from a checkpoint written by this driver (sharded
        directory) OR the single-chip ``NBodySimulation`` (monolithic
        ``.npz`` — the state layout is one global slot array either way).

        * **Same spec** (the production resume case): shards stream
          straight onto their owning devices — no process materializes the
          full state, no redistribution (the slot invariant is already this
          spec's).
        * **Different spec / decomposition / monolithic file**: the global
          state is assembled on host (full-state memory in each process —
          the documented portability cost) and re-distributed to THIS
          spec's slot invariant.

        Returns the number of particles dropped by redistribution (always
        0 on the same-spec path)."""
        if checkpoint.is_sharded(path):
            meta = checkpoint._read_sharded_meta(path, self.cfg)["meta"]
            same_spec = (meta.get("spec_type") == type(self.spec).__name__
                         and meta.get("spec") == self._spec_fp())
            if same_spec:
                self.state, meta = checkpoint.load_sharded(
                    path, self.state, expect_config=self.cfg)
                n_dropped = 0
            else:
                treedef = jax.tree.structure(self.state)
                state, meta = checkpoint.load_sharded_host(
                    path, treedef, expect_config=self.cfg)
                state, n_dropped = self._distribute(state, self.cfg,
                                                    self.spec)
                self.state = self._shard_state(state)
        else:
            template = self.gather()
            state, meta = checkpoint.load(path, template,
                                          expect_config=self.cfg)
            state, n_dropped = self._distribute(state, self.cfg, self.spec)
            self.state = self._shard_state(state)
        self.frame = int(meta.get("frame", 0))
        self.last_stats = None
        return n_dropped

    # -- validation -------------------------------------------------------
    def _host_state_no_gather(self, scratch_dir: Optional[str] = None
                              ) -> ParticleState:
        """Global host copy of the current state WITHOUT gathering the
        device state across processes.  Single-process: every shard is
        addressable, so plain ``np.asarray`` per leaf.  Multi-process: the
        state round-trips through the sharded-checkpoint format on
        ``scratch_dir`` (a shared filesystem) — each process writes ONLY
        its own shards and assembles the others' from their files; the
        only collective is the save barrier, never an allgather of
        array data."""
        if jax.process_count() == 1:
            return jax.tree.map(np.asarray, self.state)
        if scratch_dir is None:
            raise ValueError(
                "multi-process validate() needs scratch_dir on a shared "
                "filesystem: the oracle's start state is assembled from a "
                "sharded checkpoint there instead of gathering the device "
                "state (pass the same path in every process)")
        import os
        path = os.path.join(scratch_dir, "pstpu_validate_start")
        checkpoint.save_sharded(path, self.state, meta=self._meta())
        treedef = jax.tree.structure(self.state)
        host, _ = checkpoint.load_sharded_host(path, treedef,
                                               expect_config=self.cfg)
        return jax.tree.map(np.asarray, host)

    def validate(self, frames: int = 7,
                 scratch_dir: Optional[str] = None) -> dict:
        """Run the PRODUCTION sharded step and the independent numpy oracle
        in lockstep from the current state; discrete lifecycle events must
        match exactly, alive rows to float tolerance.

        SHARD-LOCAL: the device state is never
        gathered.  Each frame, every process reads only its ADDRESSABLE
        device shards and joins their alive rows to the oracle's by the
        persistent ``tag`` — the placement-independent particle identity
        (``core/state.py``), which sidesteps the ulp-fragility of assigning
        oracle rows to shards by position near domain boundaries.  A device
        row whose tag is missing from the oracle's alive set fails the
        check; global row-count agreement rides the already-compared
        ``n_alive`` event counter (``stats`` scalars are psum'd over the
        whole mesh).  The oracle's start state is the one global host
        materialization (see :meth:`_host_state_no_gather`; multi-process
        runs must pass ``scratch_dir``).

        The default window is 7 frames — just inside the MEASURED
        exact-parity horizon (tools/parity_horizon.py: first
        float-accumulation-order tag flip at frame 8-12 over 3 seeds x 3
        decompositions; round 4's tag-keyed collision ordering erased the
        slot-reallocation divergence that used to bound this at 3).  Does
        not advance state."""
        from ..cpu_ref import oracle_nbody
        from ..cpu_ref.oracle_emitter import NpState

        dev = self.state
        ora = NpState.from_jax(self._host_state_no_gather(scratch_dir))
        fields_fn = jax.jit(
            lambda f, t: nbody.frame_fields(self.cfg, f, t))
        events_match = True
        worst = 0.0
        n_local = 0
        for f in range(self.frame, self.frame + frames):
            dev, stats = self._step_fn(dev, jnp.int32(f))
            uvec, fert = fields_fn(jnp.int32(f), jnp.asarray(ora.tag))
            ora, ostats = oracle_nbody.step(ora, np.asarray(uvec),
                                            np.asarray(fert), f, self.cfg)
            for k, v in ostats.items():
                if k in stats and int(stats[k]) != v:
                    events_match = False
            # oracle alive rows sorted by tag.  Tags are 32-bit: a child's
            # tag can equal a living particle's (a few per frame at 1M,
            # rare at the fills the oracle can run), and such a pair may
            # join the wrong oracle row and show as a row deviation
            o_m = ora.alive
            o_rows = np.concatenate(
                [ora.pos, ora.vel, ora.age[:, None], ora.life[:, None]],
                axis=1)[o_m]
            o_tags = ora.tag[o_m]
            o_order = np.argsort(o_tags, kind="stable")
            o_tags, o_rows = o_tags[o_order], o_rows[o_order]
            n_local = 0
            for start, (t_d, rows_d) in _local_shard_rows(dev).items():
                n_local += len(t_d)
                if len(t_d) == 0:
                    continue
                at = np.searchsorted(o_tags, t_d)
                found = ((at < len(o_tags))
                         & (o_tags[np.minimum(at, len(o_tags) - 1)] == t_d))
                if not found.all():
                    events_match = False
                    continue
                worst = max(worst,
                            float(np.abs(rows_d - o_rows[at]).max()))
            if jax.process_count() == 1 and n_local != int(stats["n_alive"]):
                events_match = False
        return {"events_match": events_match,
                "max_row_deviation": worst, "frames": frames,
                "local_alive": n_local}

    # -- profiling --------------------------------------------------------
    def profile_frame(self, k1: int = 2, k2: int = 6,
                      reps: int = 3) -> dict:
        """Frame time as the MEDIAN of ``reps`` dispatch-count slopes (each
        slope: run ``k1`` frames, then ``k2``, from the same state; the
        slope removes fixed dispatch/sync overhead and the median rejects
        scheduler hiccups — the same method ``bench.py`` publishes, see
        NOTES.md measurement gotchas).  Stage-level breakdown is a
        single-chip facility (``NBodySimulation.profile_frame``); the
        sharded step is one fused program, so the frame is its unit of
        timing.  Does not advance state."""
        import time

        def run_k(k):
            s = self.state
            t0 = time.perf_counter()
            for i in range(k):
                s, stats = self._step_fn(s, jnp.int32(self.frame + i))
            np.asarray(stats["n_alive"])  # host sync
            return time.perf_counter() - t0

        run_k(k1)  # warm compile
        samples = []
        for _ in range(max(1, reps)):
            t1, t2 = run_k(k1), run_k(k2)
            samples.append((t2 - t1) / (k2 - k1) * 1e3)
        ms = float(np.median(samples))
        self.timers.totals["frame/full_frame"] += ms / 1e3
        self.timers.counts["frame/full_frame"] += 1
        return {"full_frame": ms}

    # -- buffer sizing ----------------------------------------------------
    def autosize_buffers(self, frames: int = 10, margin: float = 2.0,
                         floor: int = 64) -> dict:
        """Measure-then-derive halo/migration capacities: run ``frames``
        steps at the CURRENT (default: worst-case) capacities without
        advancing state, take the per-frame high-water
        marks (``halo_used_max`` / ``migration_used_max``), and rebuild the
        step with ``ceil(mark * margin)`` capacities (at least ``floor``).
        Returns the new sizes.  The marks are per-device maxima reduced over
        the mesh, so the margin covers frame-to-frame drift, not device
        imbalance.  If a later frame still overflows, ``run`` warns and the
        red-path stats count every drop — nothing is silent."""
        s = self.state
        halo_hw = mig_hw = 0
        for i in range(frames):
            s, stats = self._step_fn(s, jnp.int32(self.frame + i))
            halo_hw = max(halo_hw, int(stats["halo_used_max"]))
            mig_hw = max(mig_hw, int(stats["migration_used_max"]))
        halo_cap = max(floor, math.ceil(halo_hw * margin))
        mig_cap = max(floor, math.ceil(mig_hw * margin))
        kw = dict(halo_capacity=halo_cap, migration_capacity=mig_cap)
        if isinstance(self.spec, PencilSpec):
            kw["halo1_capacity"] = halo_cap
        import dataclasses
        self.spec = dataclasses.replace(self._spec_raw, **kw).derive(self.cfg)
        self._step_fn, self._shard_state = self._make_step(
            self.cfg, self.spec, self.mesh)
        return kw


def _to_host(state) -> ParticleState:
    """Pytree of host numpy arrays for a (possibly multi-process) sharded
    state.  ``np.asarray`` raises on arrays spanning non-addressable
    devices, so the cross-host path rides ``process_allgather``."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return jax.tree.map(
            lambda a: multihost_utils.process_allgather(a, tiled=True),
            state)
    return jax.tree.map(lambda a: np.asarray(a), state)


def _local_shard_rows(state) -> dict:
    """Per ADDRESSABLE device shard of a sharded :class:`ParticleState`:
    ``{slot_start: (tags, rows)}`` of its alive particles, tag-sorted —
    read with no collective (``addressable_shards`` only).  ``rows`` packs
    (pos, vel, age, life) like :func:`_alive_rows`."""
    def by_start(a):
        if not hasattr(a, "addressable_shards"):
            return {0: np.asarray(a)}
        return {(s.index[0].start or 0) if s.index else 0: np.asarray(s.data)
                for s in a.addressable_shards}

    pos, vel = by_start(state.pos), by_start(state.vel)
    age, life = by_start(state.age), by_start(state.life)
    alive, tag = by_start(state.alive), by_start(state.tag)
    out = {}
    for st in pos:
        m = alive[st]
        rows = np.concatenate(
            [pos[st], vel[st], age[st][:, None], life[st][:, None]],
            axis=1)[m]
        t = tag[st][m]
        order = np.argsort(t, kind="stable")
        out[st] = (t[order], rows[order])
    return out


def _alive_rows(pos, vel, age, life, alive) -> np.ndarray:
    """Alive rows sorted lexicographically — multiset comparison key."""
    rows = np.concatenate([pos, vel, age[:, None], life[:, None]],
                          axis=1)[alive]
    if rows.size == 0:
        return rows
    return rows[np.lexsort(rows.T[::-1])]

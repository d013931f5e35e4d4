"""User-facing API.

``ParticleSystem`` is the emitter-scene engine (scene/state API of the
BASELINE configs: emitter params, force list, dt, particle capacity) and
``NBodySimulation`` is the reference simulation driver (the equivalent of
``DoParallelProcess``, ``/root/reference/source/code/src/particleSystem.cpp:1733-1986``,
with per-phase timing; ``run(batch=k)`` runs sync-free — on-device guard
accumulation, one host readback per batch — while ``run()`` keeps
per-frame stat readbacks for per-frame reactions).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core.config import (Emitter, EmitterSceneConfig, NBodyConfig,
                          PlaneCollider, SphereCollider)
from .models import nbody
from .runtime import checkpoint
from .runtime.engine import PackedEngine
from .runtime.readback import AsyncReadback
from .utils.timers import PhaseTimers


def auto_batch(num_iterations: int, cap: int = 16) -> int:
    """Default batching policy for ``run(batch=0)``: the largest divisor of
    ``num_iterations`` that is <= ``cap`` — one host sync per batch, and the
    reference's own 10-iteration run length (common.h:69) becomes a single
    sync-free device-side loop.  Falls back to 1 (per-frame) only when
    ``num_iterations`` has no divisor in [2, cap] (e.g. a prime > cap)."""
    for b in range(min(cap, num_iterations), 0, -1):
        if num_iterations % b == 0:
            return b
    return 1


class ParticleSystem:
    """Builder + runner for emitter scenes.

    >>> ps = (ParticleSystem(capacity=1_000_000, dt=1/60, gravity=(0,-9.8,0))
    ...       .add_emitter(pos=(0, 1, 0), rate=100_000, speed=9.0)
    ...       .add_plane(restitution=0.5, friction=0.2))
    >>> ps.step(600)
    >>> xyz = ps.positions()

    The first ``step()`` freezes the scene and compiles the fused kernel;
    adding emitters/colliders afterwards raises.
    """

    def __init__(self, capacity: int = 1 << 20, dt: float = 1 / 60,
                 gravity=(0.0, -9.8, 0.0), wind=(0.0, 0.0, 0.0),
                 drag: float = 0.0, seed: int = 1, alloc: str = "ring",
                 refresh_interval: int = 1, layout: str = "packed8"):
        self._base = dict(capacity=capacity, dt=dt, gravity=tuple(gravity),
                          wind=tuple(wind), drag=drag, seed=seed)
        self._emitters = []
        self._planes = []
        self._spheres = []
        self._alloc = alloc
        self._layout = layout
        self._refresh = refresh_interval
        self._engine: Optional[PackedEngine] = None
        self._es = None
        self.timers = PhaseTimers()
        self._readback: Optional[AsyncReadback] = None

    # -- scene construction -------------------------------------------------
    def add_emitter(self, **kw) -> "ParticleSystem":
        self._mutable()
        self._emitters.append(Emitter(**kw))
        return self

    def add_plane(self, **kw) -> "ParticleSystem":
        self._mutable()
        self._planes.append(PlaneCollider(**kw))
        return self

    def add_sphere(self, **kw) -> "ParticleSystem":
        self._mutable()
        self._spheres.append(SphereCollider(**kw))
        return self

    def _mutable(self):
        if self._engine is not None:
            raise RuntimeError("scene is frozen after the first step()")

    @property
    def config(self) -> EmitterSceneConfig:
        return EmitterSceneConfig(emitters=tuple(self._emitters),
                                  planes=tuple(self._planes),
                                  spheres=tuple(self._spheres), **self._base)

    def _ensure(self):
        if self._engine is None:
            self._engine = PackedEngine(self.config, alloc=self._alloc,
                                        refresh_interval=self._refresh,
                                        layout=self._layout)
            self._es = self._engine.init()

    # -- simulation ----------------------------------------------------------
    def step(self, n: int = 1) -> "ParticleSystem":
        self._ensure()
        with self.timers.phase("step"):
            if n > 1:
                self._es = self._engine.step_many(self._es, n)
            else:
                self._es = self._engine.step(self._es)
        if self._readback is not None:
            with self.timers.phase("readback"):
                self._readback.publish(self.packed())
        return self

    @property
    def frame(self) -> int:
        return 0 if self._es is None else int(self._es.frame)

    # -- state access ----------------------------------------------------------
    def packed(self) -> jax.Array:
        """Device (n_fields, capacity) packed state: x,y,z,vx,vy,vz then
        (age, life) on the packed8 layout or (death_frame,) on slim."""
        self._ensure()
        return jnp.stack(self._engine.flat_fields(self._es))

    def alive_mask(self) -> np.ndarray:
        p = np.asarray(self.packed())
        if self._engine.layout == "slim":
            return int(self._es.frame) < p[6]
        return (p[6] <= p[7]) & (p[7] > 0)

    def positions(self, alive_only: bool = True) -> np.ndarray:
        p = np.asarray(self.packed())
        xyz = p[0:3].T
        return xyz[self.alive_mask()] if alive_only else xyz

    def alive_count(self) -> int:
        self._ensure()
        return int(self._engine.alive_count(self._es))

    def fade(self) -> np.ndarray:
        """Per-particle alpha 1 - age/life (alive rows).  Needs the packed8
        layout: slim stores only the death frame (remaining lifetime is
        exact, the age/life ratio is not reconstructible)."""
        self._ensure()
        if self._engine.layout == "slim":
            raise RuntimeError("fade() needs layout='packed8'; the slim "
                               "layout does not carry age/life")
        p = np.asarray(self.packed())
        m = self.alive_mask()
        return 1.0 - p[6][m] / p[7][m]

    # -- render-loop readback -------------------------------------------------
    def enable_readback(self, depth: int = 3) -> AsyncReadback:
        self._ensure()
        frame_bytes = self._engine.n_fields * self._engine.cfg.slots * 4
        self._readback = AsyncReadback(frame_bytes, depth)
        return self._readback

    # -- persistence ------------------------------------------------------------
    def save(self, path: str) -> None:
        self._ensure()
        checkpoint.save(path, self._es,
                        meta=checkpoint.config_fingerprint(self.config))

    def load(self, path: str) -> "ParticleSystem":
        self._ensure()
        self._es, _ = checkpoint.load(path, self._es,
                                      expect_config=self.config)
        return self


class NBodySimulation:
    """Driver for the reference simulation — the ``DoParallelProcess``
    equivalent: initial uniform fill, then N iterations of the fused step,
    with per-phase timing and on-device stats (the reference's printf
    timings, ``particleSystem.cpp:1927``)."""

    BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024)

    def __init__(self, cfg: NBodyConfig = NBodyConfig(),
                 adaptive_width: bool = True, impl: str = "blocks",
                 active_bucketing: bool = True):
        self.cfg = cfg
        self.impl = impl
        self.adaptive_width = adaptive_width and impl == "dense"
        # occupancy-adaptive slot prefix: compact alive rows forward, then
        # run frames on a power-of-2 prefix sized to the live count — every
        # O(slots) stage (sorts, binning, lifecycle, RNG) scales with LIVE
        # particles (see nbody.compact_state; results identical by
        # construction, n_tail_alive guards the contract)
        self.active_bucketing = active_bucketing
        self.timers = PhaseTimers()
        with self.timers.phase("fill"):
            self.state = nbody.init_fill(cfg)
        self.frame = 0
        self.last_stats = None
        self.n_degraded_frames = 0  # frames whose neighbor pass truncated
        self._width = 0  # 0 = full cell_capacity (always exact)
        self._active = 0  # 0 = full slots
        self._step_jits = {}  # (width, impl, active) -> step jit
        self._loop_jits = {}  # (width, impl, active, batch) -> batched jit
        self._compact_jit = None

    def _pick_width(self, max_occ: int) -> int:
        """Bucketized list width with 25% headroom over the last observed
        max cell occupancy — the reference's per-frame gridmax readback
        (``particleSystem.cpp:1900``) serving the same purpose.  The dense
        neighbor pass costs O(width^2), so tracking real occupancy instead
        of the kill cap is a large win (520 -> ~192 at reference steady
        state ~= 7x fewer pair ops)."""
        want = int(max_occ * 1.25) + 8
        for b in self.BUCKETS:
            if b >= want:
                return min(b, self.cfg.cell_capacity)
        return 0  # full capacity

    def _step_fn(self):
        """Per-(width, impl, active) jit of ``nbody.step``."""
        key = (self._width, self.impl, self._active)
        fn = self._step_jits.get(key)
        if fn is None:
            w, impl, cfg = self._width, self.impl, self.cfg
            act = self._active
            fn = jax.jit(lambda s, fr: nbody.step(s, fr, cfg, w, impl, act))
            self._step_jits[key] = fn
        return fn

    #: active-prefix granularity; see models/nbody.pick_active (shared with
    #: bench.py so the bench measures the production program shape)
    ACTIVE_QUANTUM = nbody.ACTIVE_QUANTUM

    def _pick_active(self, alive: int) -> int:
        return nbody.pick_active(self.cfg, alive, self.ACTIVE_QUANTUM)

    def _apply_bucketing(self, alive: int) -> None:
        want = self._pick_active(alive)
        want_rows = want or self.cfg.slots
        cur_rows = self._active or self.cfg.slots
        if want_rows < cur_rows:
            # shrink: compact alive rows into the prefix first
            if self._compact_jit is None:
                self._compact_jit = jax.jit(nbody.compact_state)
            with self.timers.phase("compact"):
                self.state = self._compact_jit(self.state)
            self._active = want
        elif want_rows > cur_rows:
            # grow (alive crept toward the prefix): pure re-slice, the
            # prefix invariant is preserved by containment
            self._active = want

    def _step_once(self, state, frame: int):
        return self._step_fn()(state, jnp.int32(frame))

    def _loop_fn(self, batch: int):
        """Per-(width, impl, active, batch) jit running ``batch`` frames in
        ONE device-side ``fori_loop`` with the contract guards accumulated
        on device — the host syncs once per batch, not once per frame (the
        sync-free loop ``bench.py`` measures, now the production path)."""
        key = (self._width, self.impl, self._active, batch)
        fn = self._loop_jits.get(key)
        if fn is None:
            w, impl, cfg = self._width, self.impl, self.cfg
            act = self._active

            def body(i, carry):
                s, _, mc, mt, nd = carry
                s2, st = nbody.step(s, i, cfg, w, impl, act)
                # accumulate the guards across EVERY frame: spawn capping
                # and drops are transient, so sampling only the final
                # frame's stats would let a mid-batch violation pass
                return (s2, st, jnp.maximum(mc, st.n_spawn_capped),
                        jnp.maximum(mt, st.n_tail_alive),
                        nd + st.n_listed_dropped)

            def loop(s, f0):
                s1, st1 = nbody.step(s, f0, cfg, w, impl, act)
                init = (s1, st1, st1.n_spawn_capped, st1.n_tail_alive,
                        st1.n_listed_dropped)
                s2, st, mc, mt, nd = jax.lax.fori_loop(
                    f0 + 1, f0 + batch, body, init)
                # ONE packed guard vector -> ONE host readback per batch
                guards = jnp.stack([mc, mt, nd, st.n_alive,
                                    st.max_cell_occupancy, st.n_spawned])
                return s2, st, guards

            fn = jax.jit(loop)
            self._loop_jits[key] = fn
        return fn

    def _run_batched(self, num_iterations: int, batch: int, verbose: bool):
        if num_iterations % batch:
            raise ValueError(f"num_iterations {num_iterations} must be a "
                             f"multiple of batch {batch}")
        for _ in range(num_iterations // batch):
            with self.timers.phase("step"):
                prev = self.state
                self.state, stats, guards = self._loop_fn(batch)(
                    prev, jnp.int32(self.frame))
                g = np.asarray(guards)  # the batch's single host sync
                if int(g[2]) and self._width != 0:
                    # the adaptive width truncated some frame in the batch:
                    # REDO the whole batch from the saved state at full
                    # width, which is exact by construction — adaptive mode
                    # never keeps a degraded frame
                    self._width = 0
                    self.state, stats, guards = self._loop_fn(batch)(
                        prev, jnp.int32(self.frame))
                    g = np.asarray(guards)
            mc, mt, nd = int(g[0]), int(g[1]), int(g[2])
            self.frame += batch
            self.last_stats = stats
            if mt:
                raise RuntimeError(
                    f"batch ending at frame {self.frame}: {mt} alive rows "
                    f"beyond active prefix {self._active}")
            if self._active and mc:
                raise RuntimeError(
                    f"batch ending at frame {self.frame}: active prefix "
                    f"{self._active} saturated — {mc} spawns capped that "
                    f"full width would grant")
            if nd:
                self.n_degraded_frames += 1  # >=1 frame in this batch
                import warnings
                warnings.warn(
                    f"batch ending at frame {self.frame}: {nd} neighbor "
                    f"entries dropped — forces truncated (impl={self.impl});"
                    f" raise the chunk budget or cell capacity",
                    RuntimeWarning, stacklevel=3)
            if self.active_bucketing:
                self._apply_bucketing(int(g[3]))
            if self.adaptive_width and nd == 0:
                new_w = self._pick_width(int(g[4]))
                if new_w != self._width:
                    self._width = new_w
            if verbose:
                print(f"iter {self.frame}: alive={int(g[3])} "
                      f"last_spawned={int(g[5])} max_cell={int(g[4])} "
                      f"width={self._width or self.cfg.cell_capacity}")
        return self.last_stats

    def run(self, num_iterations: int = 10, verbose: bool = False,
            batch: int = 0):
        """Advance ``num_iterations`` frames.

        ``batch=0`` (the default) auto-batches: the largest divisor of
        ``num_iterations`` <= 16 (:func:`auto_batch`), so the sync-free
        loop below is what plain ``run()`` executes.  Pass ``batch=1``
        explicitly for per-frame readbacks and per-frame reactions (the
        debugging mode, and the shape ``validate()`` shares).

        ``batch=k`` (k > 1) runs the frames in device-side ``fori_loop``
        batches with the contract guards (``n_tail_alive``,
        ``n_spawn_capped``, ``n_listed_dropped``) accumulated on device and
        ONE host readback per batch — no per-frame host syncs.
        Guards are evaluated at batch boundaries: violations raise/warn
        after at most ``k`` frames instead of 1, and a truncated adaptive-
        width batch is redone whole at full width (still exact, like the
        per-frame redo).  ``num_iterations`` must be a multiple of ``k``.
        ``batch=1`` keeps per-frame readbacks and per-frame reactions."""
        if batch == 0:
            batch = auto_batch(num_iterations)
        if batch > 1:
            return self._run_batched(num_iterations, batch, verbose)
        for _ in range(num_iterations):
            with self.timers.phase("step"):
                prev = self.state  # kept so an overflowed frame can be redone
                self.state, stats = self._step_once(prev, self.frame)
                if int(stats.n_listed_dropped) and self._width != 0:
                    # occupancy spiked past the adaptive bucket: REDO this
                    # frame from the saved state at full width, which is
                    # exact by construction — adaptive mode never keeps a
                    # degraded frame
                    self._width = 0
                    self.state, stats = self._step_once(prev, self.frame)
            self.frame += 1
            self.last_stats = stats
            if int(stats.n_tail_alive):
                # active-prefix contract violated (should be impossible:
                # _pick_active reserves full-burst headroom) — fail loudly,
                # physics beyond the prefix was frozen this frame
                raise RuntimeError(
                    f"frame {self.frame}: {int(stats.n_tail_alive)} alive "
                    f"rows beyond active prefix {self._active}")
            if self._active and int(stats.n_spawn_capped):
                # the prefix ran out of free slots while the tail (alive
                # count 0 by the guard above) still had room: children the
                # full-width run would have granted were dropped, so the
                # bit-exactness contract is broken.  Re-bucketing cannot
                # normally get here (_pick_active reserves 2 bursts).
                raise RuntimeError(
                    f"frame {self.frame}: active prefix {self._active} "
                    f"saturated — {int(stats.n_spawn_capped)} spawns capped "
                    f"that full width would grant")
            if self.active_bucketing:
                self._apply_bucketing(int(stats.n_alive))
            if int(stats.n_listed_dropped):
                # full width still truncated — the frame stands but
                # exactness was lost; surface it loudly
                self.n_degraded_frames += 1
                import warnings
                warnings.warn(
                    f"frame {self.frame}: {int(stats.n_listed_dropped)} "
                    f"neighbor entries dropped — forces truncated "
                    f"(impl={self.impl}); raise the chunk budget or cell "
                    f"capacity", RuntimeWarning, stacklevel=2)
            if self.adaptive_width:
                new_w = self._pick_width(int(stats.max_cell_occupancy))
                if new_w != self._width and int(stats.n_listed_dropped) == 0:
                    self._width = new_w
            if verbose:
                print(f"iter {self.frame}: alive={int(stats.n_alive)} "
                      f"spawned={int(stats.n_spawned)} "
                      f"max_cell={int(stats.max_cell_occupancy)} "
                      f"width={self._width or self.cfg.cell_capacity}")
        return self.last_stats

    def profile_frame(self, reps: int = 3) -> dict:
        """Stage-by-stage timing of one frame at the CURRENT state — the
        structured equivalent of the reference's per-iteration
        ``total / init_iframe / build_grid / calc_forces`` printout
        (``particleSystem.cpp:1927``); INIT_IFRAME has no cost here (bins
        are rebuilt functionally).  Stages:

        * ``rng_fields``  — per-frame random field generation
        * ``cell_ids``    — torus wrap + cell id assignment
        * ``build_grid``  — the BUILD_GRID analog
          (``particleSystem.cpp:1468-1537``): carrying sort + range table
          for "blocks", cell lists for "dense"
        * ``calc_forces`` — the cluster-pair kernel ("blocks" only;
          ``particleSystem.cpp:1120-1383`` analog)
        * ``unsort``      — inverse-permutation carrying sort ("blocks")
        * ``lifecycle``   — death/survive/integrate/spawn masked updates
        * ``full_frame``  — the whole fused step for cross-checking

        Each stage is jitted on its own, called once to compile, then timed
        as the median of ``reps`` calls that each end in
        ``block_until_ready``.  Results are recorded into ``self.timers``
        (phases ``frame/<stage>``) and returned as {stage: ms}.  Does not
        advance ``self.state``."""
        import time

        from .ops import neighbor_blocks as nbk
        from .ops.grid import build_bins, coords_to_cell, wrap_positions
        from .ops.neighbor import collision_okey

        cfg, width, impl, active = self.cfg, self._width, self.impl, \
            self._active
        state, frame = self.state, jnp.int32(self.frame)
        if active and active < state.slots:
            # production stages run on the active slot prefix
            # (models/nbody.step slices [:active]) — profile the same shapes
            state = jax.tree.map(lambda a: a[:active], state)
        out: dict = {}

        def timed(name, f, *args):
            f = jax.jit(f)
            r = jax.block_until_ready(f(*args))
            samples = []
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                jax.block_until_ready(f(*args))
                samples.append(time.perf_counter() - t0)
            out[name] = float(np.median(samples)) * 1e3
            return r

        uvec, fert = timed("rng_fields",
                           lambda fr, t: nbody.frame_fields(cfg, fr, t),
                           frame, state.tag)
        cell = timed("cell_ids", lambda p: coords_to_cell(
            wrap_positions(p, cfg.grid)[1], cfg.grid), state.pos)
        if impl == "blocks":
            snap, ranges, order, ovf_s, *_ = timed(
                "build_grid", lambda p, a, w, c, al, t: nbk.prepare(
                    p, a, w, c, al, cfg, tags=t),
                state.pos, state.age, state.w, cell, state.alive, state.tag)
            kout = timed("calc_forces",
                         lambda s, r: nbk.kernel_call(cfg, s, r),
                         snap, ranges)
            timed("unsort", lambda k, o, v, t: nbk.unsort_outputs(
                k, o, v, okeys=collision_okey(t)),
                kout, order, ovf_s, state.tag)
        else:
            timed("build_grid", lambda c, al: build_bins(
                c, al, cfg.grid.num_cells, cfg.cell_capacity,
                list_width=width), cell, state.alive)

        def lifecycle(st, uv, fe, fr):
            pw, _ = wrap_positions(st.pos, cfg.grid)
            zero3 = jnp.zeros_like(st.pos)
            no = jnp.zeros(st.pos.shape[:1], jnp.bool_)
            return nbody.lifecycle_update(st, pw, no, zero3, no, no, uv, fe,
                                          fr, cfg)
        timed("lifecycle", lifecycle, state, uvec, fert, frame)
        timed("full_frame", lambda st, fr: nbody.step(
            st, fr, cfg, width, impl, active), self.state, frame)

        for name, ms in out.items():
            self.timers.totals[f"frame/{name}"] += ms / 1e3
            self.timers.counts[f"frame/{name}"] += 1
        return out

    def save(self, path: str) -> None:
        checkpoint.save(path, self.state,
                        meta=dict(frame=self.frame,
                                  **checkpoint.config_fingerprint(self.cfg)))

    def load(self, path: str) -> None:
        self.state, meta = checkpoint.load(path, self.state,
                                           expect_config=self.cfg)
        self.frame = int(meta.get("frame", 0))
        self._active = 0  # loaded layout unknown; run() re-buckets

    def validate(self, frames: int = 5) -> dict:
        """Run ``frames`` steps of both the device path and the independent
        numpy oracle from the CURRENT state and report the deviation — the
        working version of the reference's serial-vs-parallel comparison,
        which is stubbed to always pass (``DoCompare``,
        ``particleSystem.cpp:2254-2257``).  Discrete lifecycle events must
        match exactly; float trajectories to accumulation-order tolerance.
        Does not advance ``self.state``."""
        import numpy as np

        from .cpu_ref import oracle_nbody
        from .cpu_ref.oracle_emitter import NpState

        dev = self.state
        ora = NpState.from_jax(dev)
        worst = 0.0
        events_match = True
        # Device side runs the PRODUCTION impl; the oracle gets the same
        # per-frame random fields
        # recomputed separately — deterministic threefry keyed on
        # (seed, frame, tag), so both sides see identical draws.
        fields_fn = jax.jit(lambda f, t: nbody.frame_fields(self.cfg, f, t))
        saved_width = self._width
        self._width = 0  # validation always runs exact full width
        try:
            for f in range(self.frame, self.frame + frames):
                uvec, fert = fields_fn(jnp.int32(f), dev.tag)
                dev, stats = self._step_once(dev, f)
                ora, ostats = oracle_nbody.step(ora, np.asarray(uvec),
                                                np.asarray(fert), f,
                                                self.cfg)
                for k, v in ostats.items():
                    if int(getattr(stats, k)) != v:
                        events_match = False
                if not np.array_equal(np.asarray(dev.alive), ora.alive):
                    events_match = False
                m = np.asarray(dev.alive)
                if m.any():
                    worst = max(worst, float(np.abs(
                        np.asarray(dev.pos)[m] - ora.pos[m]).max()))
        finally:
            self._width = saved_width
        return {"events_match": events_match,
                "max_position_deviation": worst, "frames": frames}

"""Packed-state frame engine: the production sim loop for emitter scenes.

One jitted function per frame — spawn-row generation, the fused physics
step, recycling bookkeeping and spawn writes — with zero host round trips
(the reference reads ``gridmax`` back every frame,
``particleSystem.cpp:1900``; here even the recycling bookkeeping stays on
device).

State is eight separate ``(N,)`` f32 field arrays (x, y, z, vx, vy, vz, age,
life), which XLA streams as one fused elementwise pass (see
``ops/fused_step.py``).

Two allocation policies (``alloc=``):

* ``"exact"`` — dead slots ascending, refreshed every ``refresh_interval``
  frames by cumsum compaction.  ``refresh_interval=1`` reproduces
  ``models/emitter.step_core`` (the parity tests rely on it); larger K
  amortizes the O(N) compaction with <=K frames recycling latency.
* ``"ring"`` — slots reused in spawn order through a ring cursor; O(S) per
  frame with no O(N) bookkeeping at all.  The production/bench default.
* ``"strided"`` — budget-strided ring (``ops/fused_step.strided_spawn``):
  the cursor advances by the full padded spawn budget every frame, so the
  window never wraps and the whole compaction/shadow/cond machinery
  disappears — the fewest-ops spawn path.  Requires ``slots`` divisible by
  the padded budget; slots recycle one budget-lap sooner than ``ring``.
* ``"select"`` — strided recycling semantics with the spawn write expressed
  as a pure elementwise broadcast-select over natively-2D state: fields are
  ``(slots/W, W)`` with W the padded spawn budget, the write window IS row
  ``cursor/W``, and ``out[b,j] = where(b==lap & valid[j], row[j], phys)``
  fuses into the physics pass, where a ``dynamic_update_slice`` of a
  spawn window into the big 1-D arrays can make XLA materialize the
  physics fusion and then re-copy every array.  Alive-row multiset
  bitwise-identical to ``strided``.

Two state layouts (``layout=``):

* ``"packed8"`` — (x, y, z, vx, vy, vz, age, life); dead rows frozen.
  The general-purpose default (readback exposes age/life directly).
* ``"slim"`` — (x, y, z, vx, vy, vz, death_frame); ring alloc only.
  Liveness is *derived* (``frame < death_frame``) instead of read-modify-
  written, and expired rows keep integrating (garbage until respawn; mask
  at readback with ``ops.fused_step.alive_mask_slim``).  13 HBM words per
  particle-frame instead of 15 — the fastest path for HBM-bound scenes.
  Readback exposes exact REMAINING lifetime (``(death - frame) * dt``);
  age itself is gone with the life field — scenes that need age/life fade
  ratios belong on ``packed8``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.config import EmitterSceneConfig
from ..models import emitter as em
from ..ops import fused_step as fs


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EngineState:
    fields: Tuple[jax.Array, ...]  # 8 x (N [+ shadow],) f32
    accum: jax.Array       # (n_emitters,) f32 fractional spawn credit
    free_list: jax.Array   # (L,) int32 dead slots, padded with N (exact mode)
    cursor: jax.Array      # scalar int32: consumed entries / ring position
    n_free: jax.Array      # scalar int32: valid free-list entries
    frame: jax.Array       # scalar int32

    @property
    def packed(self) -> jax.Array:
        """(8, N) stacked view for readback/inspection (copies)."""
        return jnp.stack(self.fields)


class PackedEngine:
    """Frame loop over per-field SoA state."""

    def __init__(self, cfg: EmitterSceneConfig, refresh_interval: int = 1,
                 free_list_size: Optional[int] = None, alloc: str = "exact",
                 layout: str = "packed8"):
        if alloc not in ("exact", "ring", "strided", "select"):
            raise ValueError(f"unknown alloc policy {alloc!r}")
        if layout not in ("packed8", "slim"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "slim" and alloc == "exact":
            raise ValueError("layout='slim' requires alloc='ring'/'strided'/"
                             "'select'")
        self.cfg = cfg
        self.alloc = alloc
        self.layout = layout
        self.n_fields = 7 if layout == "slim" else 8
        self.refresh_interval = int(refresh_interval)
        budget = cfg.max_spawn_per_step * self.refresh_interval
        self.free_list_size = int(free_list_size or max(1024, 4 * budget))
        # ring mode: shadow region sized to the (padded) spawn budget
        self.spawn_width = _round_up(cfg.max_spawn_per_step, 1024)
        self.shadow = self.spawn_width if alloc == "ring" else 0
        if alloc in ("strided", "select") and cfg.slots % self.spawn_width:
            raise ValueError(
                f"alloc={alloc!r} needs slots ({cfg.slots}) divisible by "
                f"the padded spawn budget ({self.spawn_width}); round the "
                f"capacity or use alloc='ring'")
        self.total = cfg.slots + self.shadow
        # select mode: fields live as (b_rows, spawn_width)
        self.b_rows = cfg.slots // self.spawn_width if alloc == "select" \
            else None
        self.field_shape = ((self.b_rows, self.spawn_width)
                            if alloc == "select" else (self.total,))
        self._step = jax.jit(self._frame, donate_argnums=0)
        self._step_many = {}

    # ------------------------------------------------------------------
    def init(self, fields: Optional[Tuple[jax.Array, ...]] = None
             ) -> EngineState:
        n = self.cfg.slots
        if fields is None:
            fields = tuple(jnp.zeros((n,), jnp.float32)
                           for _ in range(self.n_fields))
        if self.layout == "slim" and len(fields) == 8:
            # accept packed8 initial state: (age, life) -> absolute death
            # frame relative to frame 0.  packed8 integrates a row while
            # age <= life, i.e. floor((life-age)/dt) + 1 more steps from
            # here (boundary INCLUSIVE: an age == life row is still alive),
            # so the bare quotient would drop exactly-on-boundary rows from
            # the census (frame 0 < death fails at death == 0); dead -> 0
            x, y, z, vx, vy, vz, age, life = fields
            alive = (age <= life) & (life > 0)
            steps = jnp.floor((life - age) / jnp.float32(self.cfg.dt)) + 1.0
            death = jnp.where(alive, steps, 0.0)
            fields = (x, y, z, vx, vy, vz, death)
        assert len(fields) == self.n_fields, (len(fields), self.n_fields)
        if self.alloc == "select":
            # (n,) or already-(b_rows, W) input -> the native 2-D layout;
            # reshape produces fresh buffers, so donation never aliases
            # caller arrays
            fields = tuple(jnp.asarray(f).reshape(self.field_shape)
                           for f in fields)
        elif fields[0].shape[0] == n and self.shadow:
            pad = jnp.zeros((self.shadow,), jnp.float32)
            fields = tuple(jnp.concatenate([f, pad]) for f in fields)
        else:
            # defensive copy: step() donates its input, and caller-provided
            # fields may alias caller arrays (e.g. pack_state views)
            fields = tuple(jnp.array(f) for f in fields)
        assert fields[0].shape == self.field_shape, fields[0].shape
        if self.layout == "slim" or self.alloc in ("strided", "select"):
            fl = jnp.zeros((1,), jnp.int32)
            n_free = jnp.int32(0)
        else:
            fl, n_free = fs.refresh_free_list(fields, self.free_list_size)
        return EngineState(
            fields=tuple(fields),
            accum=jnp.zeros((max(1, len(self.cfg.emitters)),), jnp.float32),
            free_list=fl, cursor=jnp.int32(0), n_free=n_free,
            frame=jnp.int32(0),
        )

    # ------------------------------------------------------------------
    def _frame(self, s: EngineState, salt=0) -> EngineState:
        cfg = self.cfg
        spawn, accum = em.spawn_fields(cfg, s.frame, s.accum, salt)
        if self.layout == "slim":
            fields = fs.physics_step_slim(s.fields, cfg)
            rows = fs.pack_spawn_rows_slim(spawn, s.frame, cfg.dt)
        else:
            fields = fs.physics_step(s.fields, cfg)
            rows = fs.pack_spawn_rows(spawn)

        if self.alloc in ("ring", "strided", "select"):
            pad = self.spawn_width - rows[0].shape[0]
            if pad:
                rows = tuple(jnp.pad(r, (0, pad)) for r in rows)
                valid = jnp.pad(spawn.valid, (0, pad))
            else:
                valid = spawn.valid
            if self.alloc == "select":
                fields, cursor = fs.select_spawn(fields, rows, valid,
                                                 s.cursor, cfg.slots)
            elif self.alloc == "strided":
                fields, cursor = fs.strided_spawn(fields, rows, valid,
                                                  s.cursor, cfg.slots)
            else:
                fields, cursor = fs.ring_spawn(fields, rows, valid, s.cursor,
                                               cfg.slots)
            free_list, n_free = s.free_list, s.n_free
        else:
            def refresh(_):
                fl, nf = fs.refresh_free_list(fields, self.free_list_size)
                return fl, nf, jnp.int32(0)

            def keep(_):
                return s.free_list, s.n_free, s.cursor

            do = (s.frame % self.refresh_interval) == 0
            free_list, n_free, cursor = jax.lax.cond(do, refresh, keep, None)
            fields, cursor = fs.spawn_exact(fields, rows, spawn.valid,
                                            free_list, cursor, n_free)

        return EngineState(fields=fields, accum=accum, free_list=free_list,
                           cursor=cursor, n_free=n_free, frame=s.frame + 1)

    # ------------------------------------------------------------------
    def step(self, s: EngineState) -> EngineState:
        return self._step(s)

    def step_many(self, s: EngineState, k: int) -> EngineState:
        """Run ``k`` frames in one device dispatch (``fori_loop``); the tool
        of choice when per-call dispatch latency would dominate.  The loop
        body is unrolled twice so consecutive frames alternate buffers."""
        if k not in self._step_many:
            self._step_many[k] = jax.jit(
                lambda st: jax.lax.fori_loop(
                    0, k, lambda _, x: self._frame(x), st, unroll=2),
                donate_argnums=0)
        return self._step_many[k](s)

    def flat_fields(self, s: EngineState) -> Tuple[jax.Array, ...]:
        """Per-field ``(slots,)`` views of the live region — drops the ring
        shadow and flattens the select layout (slot i of the select layout
        is element ``(i // W, i % W)``, so flattening preserves slot
        order).  The readback/inspection shape; not for the hot loop."""
        if self.alloc == "select":
            return tuple(f.reshape(-1) for f in s.fields)
        return tuple(f[: self.cfg.slots] for f in s.fields)

    def alive_count(self, s: EngineState) -> jax.Array:
        if self.layout == "slim":
            death = self._live_region(s.fields[6])
            return jnp.sum(
                fs.alive_mask_slim(death, s.frame).astype(jnp.int32))
        age = self._live_region(s.fields[6])
        life = self._live_region(s.fields[7])
        return jnp.sum(((age <= life) & (life > 0)).astype(jnp.int32))

    def _live_region(self, f: jax.Array) -> jax.Array:
        """The real slots of one field, in native shape (no flatten)."""
        return f if self.alloc == "select" else f[: self.cfg.slots]

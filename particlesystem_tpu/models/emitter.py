"""Emitter scene: the BASELINE benchmark configs' force-stack engine.

Single fused jitted step over the SoA state:

    forces (gravity/wind/drag) -> semi-implicit Euler -> plane/sphere
    collision response -> aging/lifetime death -> emitter spawn into
    recycled dead slots (prefix-sum compaction).

This is the data-parallel counterpart of the reference's whole per-frame
pipeline (INIT_IFRAME -> BUILD_GRID -> CALC_FORCES waves,
``/root/reference/source/code/src/particleSystem.cpp:1843-1911``) for scenes
without pairwise interactions: one ``jit`` call, no host round trips — the
reference reads back ``gridmax`` from the device every frame (:1900); here
every statistic stays on device.

Randomness is factored out of the physics: :func:`spawn_fields` derives all
per-frame spawn rows from counter-based keys, and :func:`step_core` is a
deterministic function of (state, spawn rows).  The numpy oracle consumes
identical spawn rows, so host-vs-device trajectory comparison isolates physics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.config import Emitter, EmitterSceneConfig
from ..core.state import ParticleState
from ..ops import compact
from ..ops.forces import accel, collide


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SpawnRows:
    """Per-frame spawn requests, statically sized to the scene's budget."""

    pos: jax.Array    # (S, 3)
    vel: jax.Array    # (S, 3)
    life: jax.Array   # (S,)
    w: jax.Array      # (S,)
    valid: jax.Array  # (S,) bool


def emitter_budget(e: Emitter, dt: float) -> int:
    return int(math.ceil(e.rate * dt)) + 1


def _basis(direction) -> np.ndarray:
    """Static orthonormal basis (d, e1, e2) for the cone sampler."""
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(np.dot(d, up))) > 0.9:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    e1 = np.cross(d, up)
    e1 = e1 / np.linalg.norm(e1)
    e2 = np.cross(d, e1)
    return np.stack([d, e1, e2])


def spawn_fields(cfg: EmitterSceneConfig, frame: jax.Array,
                 accum: jax.Array, salt=0) -> Tuple[SpawnRows, jax.Array]:
    """Generate this frame's spawn rows and the updated fractional-rate
    accumulators (one float per emitter).  ``salt`` decorrelates parallel
    streams (e.g. the device index under data-parallel sharding).

    ONE uniform draw and ONE unit-vector draw cover every emitter's rows
    (counter-based key per (seed, frame, salt); emitters are decorrelated
    by row position), and the downstream sampling math runs once on the
    concatenated rows with per-row static parameter columns.  At 1M-scene
    scale the spawn path is pure op-launch overhead (~tens of us for ~2k
    rows), so the op count IS the cost — the numpy oracle consumes the
    produced rows, not the stream layout, so draw restructuring is free."""
    if not cfg.emitters:
        z3 = jnp.zeros((1, 3), jnp.float32)
        z1 = jnp.zeros((1,), jnp.float32)
        return (SpawnRows(z3, z3, z1, z1, jnp.zeros((1,), jnp.bool_)),
                accum)

    base = jax.random.fold_in(rng.frame_key(cfg.seed, frame, rng.EMIT), salt)
    budgets = [emitter_budget(e, cfg.dt) for e in cfg.emitters]
    total = sum(budgets)
    u = jax.random.uniform(base, (total, 8), jnp.float32)
    dirs = rng.random_unit_vectors(jax.random.fold_in(base, 1), total)

    # fractional-rate accumulators: vector math over the (E,) accum row,
    # then one tiny (S,) gather maps per-emitter counts onto rows
    rates = jnp.asarray([e.rate * cfg.dt for e in cfg.emitters], jnp.float32)
    want = accum + rates
    n_spawn = jnp.floor(want)
    new_accum = want - n_spawn
    row_emitter = np.concatenate(
        [np.full((s,), ei, np.int32) for ei, s in enumerate(budgets)])
    row_local = np.concatenate(
        [np.arange(s, dtype=np.float32) for s in budgets])
    valid = jnp.asarray(row_local) < n_spawn[jnp.asarray(row_emitter)]

    # static per-row parameter columns (trace-time numpy constants)
    def per_row(getter):
        cols = [np.broadcast_to(
            np.asarray(getter(e), np.float32),
            ((emitter_budget(e, cfg.dt),) + np.shape(getter(e))))
            for e in cfg.emitters]
        return jnp.asarray(np.concatenate(cols))
    pos0 = per_row(lambda e: e.pos)               # (S, 3)
    radius = per_row(lambda e: e.radius)          # (S,)
    b = [per_row(lambda e, i=i: _basis(e.direction)[i]) for i in range(3)]
    cone = per_row(lambda e: e.cone_angle)
    speed0 = per_row(lambda e: e.speed)
    jitter = per_row(lambda e: e.speed_jitter)
    lmin = per_row(lambda e: e.life_min)
    lspan = per_row(lambda e: e.life_max - e.life_min)
    weight = per_row(lambda e: e.weight)

    # position: uniform in a ball of radius around pos0
    r = radius * jnp.cbrt(u[:, 0])
    pos = pos0 + dirs * r[:, None]
    # velocity: cone around the emitter direction
    theta = cone * jnp.sqrt(u[:, 1])
    phi = 2.0 * jnp.pi * u[:, 2]
    dirv = (jnp.cos(theta)[:, None] * b[0]
            + (jnp.sin(theta) * jnp.cos(phi))[:, None] * b[1]
            + (jnp.sin(theta) * jnp.sin(phi))[:, None] * b[2])
    speed = speed0 * (1.0 + jitter * (2.0 * u[:, 3] - 1.0))
    vel = dirv * speed[:, None]
    life = lmin + u[:, 4] * lspan

    rows = SpawnRows(pos=pos, vel=vel, life=life, w=weight, valid=valid)
    return rows, new_accum


def step_core(state: ParticleState, spawn: SpawnRows,
              cfg: EmitterSceneConfig) -> ParticleState:
    """Deterministic physics step.  Mirrored field-for-field by the numpy
    oracle (``cpu_ref/oracle_emitter.py``); keep the two in lockstep."""
    alive = state.alive

    a = accel(state.vel, cfg)
    v1 = state.vel + a * cfg.dt
    p1 = state.pos + v1 * cfg.dt
    p1, v1 = collide(p1, v1, cfg)
    age1 = state.age + cfg.dt

    keep = alive[:, None]
    pos = jnp.where(keep, p1, state.pos)
    vel = jnp.where(keep, v1, state.vel)
    acc = jnp.where(keep, a, state.acc)
    age = jnp.where(alive, age1, state.age)
    alive1 = alive & (age1 <= state.life)

    # spawn into recycled slots
    target, ok = compact.allocate(alive1, spawn.valid)
    pos = pos.at[target].set(spawn.pos, mode="drop")
    vel = vel.at[target].set(spawn.vel, mode="drop")
    acc = acc.at[target].set(0.0, mode="drop")
    age = age.at[target].set(0.0, mode="drop")
    life = state.life.at[target].set(spawn.life, mode="drop")
    w = state.w.at[target].set(spawn.w, mode="drop")
    alive1 = alive1.at[target].set(ok, mode="drop")
    parent = state.parent.at[target].set(False, mode="drop")
    tag = state.tag.at[target].set(0, mode="drop")

    return ParticleState(pos=pos, vel=vel, acc=acc, w=w, age=age,
                         life=life, alive=alive1, parent=parent, tag=tag)


def step(state: ParticleState, accum: jax.Array, frame: jax.Array,
         cfg: EmitterSceneConfig):
    """Full frame: RNG spawn-row generation + physics.  jit with
    ``static_argnums`` on ``cfg`` or close over it."""
    spawn, accum = spawn_fields(cfg, frame, accum)
    state = step_core(state, spawn, cfg)
    return state, accum

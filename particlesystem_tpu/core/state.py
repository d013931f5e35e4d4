"""Particle state as a structure-of-arrays pytree.

The reference stores particles as a 72-byte array-of-structs
(``P_DATA_TYPE``, ``/root/reference/source/code/inc/common.h:94-120``) inside
a segmented container whose slot index encodes spatial ownership.  On an
accelerator the natural layout is a flat SoA of device arrays with a static
slot count: vectorized loads, XLA fusion across fields, and no id<->segment
coupling (cells are recomputed from positions each frame).

The reference's snapshot buffer ``T_DATA_TYPE`` (``common.h:122-132``) —
double-buffering so neighbor reads see the previous frame — is implicit here:
the step function is pure, so the input state *is* the read-side snapshot.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from .config import NBodyConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ParticleState:
    """SoA particle store with ``slots`` fixed-capacity rows.

    Field map from ``P_DATA_TYPE`` (``common.h:94-120``):

    * ``pos``/``vel``/``acc`` — x,y,z / vx,vy,vz / ax,ay,az, shape ``(N, 3)``
    * ``w``      — particle weight (gravitational mass)
    * ``age``    — seconds alive; drives kid/adult/death lifecycle
    * ``life``   — ``fertility_age`` in the n-body scene; *lifetime* in
      emitter scenes (death when ``age > life``)
    * ``alive``  — replaces the reference's ``cell == -1`` dead marker
      (``app.cu:239-264``) and the free-id queues
    * ``parent`` — ``is_parent`` reproduction latch (``common.h:103``)
    * ``tag``    — persistent per-particle identity (uint32) that survives
      migration across devices; all per-particle randomness is keyed on
      ``(seed, frame, tag)`` so trajectories are independent of slot
      placement and device count.  (The reference keys curand on the slot id
      — ``particleSystemCUDA.cu:45`` — so its randomness changes whenever a
      particle migrates segments; this fixes that.)

    Collision kill/survive ordering (``app_common.cu:293-298``: larger id
    survives) keys on ``tag`` via ``ops.neighbor.collision_okey`` — a
    placement-independent total order, identical on 1 and N devices; slot
    indices serve only pair self-exclusion.  ``id``, ``cell``, ``chunk``,
    ``seg_*`` fields of the reference are derived quantities here, never
    stored.
    """

    pos: jax.Array
    vel: jax.Array
    acc: jax.Array
    w: jax.Array
    age: jax.Array
    life: jax.Array
    alive: jax.Array
    parent: jax.Array
    tag: jax.Array

    @property
    def slots(self) -> int:
        return self.pos.shape[0]

    @property
    def num_alive(self) -> jax.Array:
        return jnp.sum(self.alive.astype(jnp.int32))


def zero_state(slots: int, dtype=jnp.float32) -> ParticleState:
    """All-dead state; matches INIT_PARTICLES semantics
    (``particleSystem.cpp:703-753``: reset every slot)."""
    f = lambda *shape: jnp.zeros(shape, dtype)
    return ParticleState(
        pos=f(slots, 3),
        vel=f(slots, 3),
        acc=f(slots, 3),
        w=f(slots),
        age=f(slots),
        life=f(slots),
        alive=jnp.zeros((slots,), jnp.bool_),
        parent=jnp.zeros((slots,), jnp.bool_),
        tag=jnp.zeros((slots,), jnp.uint32),
    )


def pack_state(state: ParticleState):
    """Pack hot fields into eight separate contiguous ``(N,)`` f32 arrays
    (x, y, z, vx, vy, vz, age, life) — the layout the fused step streams at
    full HBM bandwidth (see ``ops/fused_step.py``)."""
    return (
        state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
        state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
        state.age, state.life,
    )


def unpack_state(packed, template: Optional[ParticleState] = None) -> ParticleState:
    """Inverse of :func:`pack_state`; non-packed fields (w, parent, acc, tag)
    come from ``template`` when given.  ``alive`` is derived as
    ``age <= life`` and ``life > 0`` (emitter-scene convention)."""
    n = packed[0].shape[0]
    pos = jnp.stack(packed[0:3], axis=1)
    vel = jnp.stack(packed[3:6], axis=1)
    age = packed[6]
    life = packed[7]
    alive = (age <= life) & (life > 0)
    if template is None:
        template = zero_state(n)
    return ParticleState(
        pos=pos, vel=vel, acc=template.acc, w=template.w,
        age=age, life=life, alive=alive, parent=template.parent,
        tag=template.tag,
    )

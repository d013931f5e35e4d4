"""Fused emitter step vs the reference emitter step.

Physics must match ``models/emitter.step_core`` to float tolerance, and the
PackedEngine with refresh_interval=1 must match it including slot
allocation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from particlesystem_tpu import Emitter, EmitterSceneConfig, PlaneCollider, SphereCollider
from particlesystem_tpu.core.state import ParticleState, pack_state, zero_state
from particlesystem_tpu.models import emitter as em
from particlesystem_tpu.ops import fused_step as fs
from particlesystem_tpu.runtime.engine import PackedEngine

CFG = EmitterSceneConfig(
    capacity=2048, dt=1 / 60, gravity=(0.0, -9.8, 0.0),
    drag=0.5, wind=(2.0, 0.0, -1.0),
    emitters=(Emitter(pos=(0.0, 1.0, 0.0), speed=7.0, rate=4000.0,
                      life_min=0.5, life_max=1.2),),
    planes=(PlaneCollider(restitution=0.6, friction=0.25),),
    spheres=(SphereCollider(center=(0.3, 1.5, 0.0), radius=0.5,
                            restitution=0.4, friction=0.1),),
)


def random_state(key, n):
    ks = jax.random.split(key, 4)
    pos = jax.random.uniform(ks[0], (n, 3), jnp.float32, -3.0, 5.0)
    vel = jax.random.uniform(ks[1], (n, 3), jnp.float32, -6.0, 6.0)
    life = jax.random.uniform(ks[2], (n,), jnp.float32, 0.0, 2.0)
    life = jnp.where(jax.random.uniform(ks[3], (n,)) < 0.3, 0.0, life)
    age = life * 0.4
    s = zero_state(n)
    alive = life > 0
    return dataclasses.replace(s, pos=pos, vel=vel, age=age, life=life,
                               alive=alive)


def _ref_step(state):
    spawn = em.SpawnRows(
        pos=jnp.zeros((1, 3)), vel=jnp.zeros((1, 3)),
        life=jnp.zeros((1,)), w=jnp.zeros((1,)),
        valid=jnp.zeros((1,), jnp.bool_))
    return pack_state(em.step_core(state, spawn, CFG))


def test_xla_kernel_matches_step_core():
    state = random_state(jax.random.key(0), CFG.slots)
    out = fs.physics_step(pack_state(state), CFG)
    ref = _ref_step(state)
    for got, want, name in zip(out, ref, "x y z vx vy vz age life".split()):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_engine_matches_step_core_with_refresh_1():
    eng = PackedEngine(CFG, refresh_interval=1)
    init = random_state(jax.random.key(1), CFG.slots)
    es = eng.init(pack_state(init))

    state = init
    accum = jnp.zeros((1,), jnp.float32)
    gen = jax.jit(lambda a, f: em.spawn_fields(CFG, f, a))
    core = jax.jit(lambda s, sp: em.step_core(s, sp, CFG))

    for frame in range(25):
        es = eng.step(es)
        spawn, accum = gen(accum, jnp.int32(frame))
        state = core(state, spawn)

        ref = np.stack([np.asarray(f) for f in pack_state(state)])
        got = np.asarray(es.packed)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=f"frame {frame}")


def test_ring_engine_matches_exact_as_multiset():
    """With ample capacity the ring allocator never overwrites, so the set
    of alive particles (not their slot order) must match the exact path."""
    eng = PackedEngine(CFG, alloc="ring")
    es = eng.init()

    state = zero_state(CFG.slots)
    accum = jnp.zeros((1,), jnp.float32)
    gen = jax.jit(lambda a, f: em.spawn_fields(CFG, f, a))
    core = jax.jit(lambda s, sp: em.step_core(s, sp, CFG))

    for frame in range(30):
        es = eng.step(es)
        spawn, accum = gen(accum, jnp.int32(frame))
        state = core(state, spawn)

    def alive_sorted(packed):
        arr = np.stack([np.asarray(f) for f in packed])
        age, life = arr[6], arr[7]
        alive = (age <= life) & (life > 0)
        rows = arr[:, alive]
        return rows[:, np.lexsort(rows)]

    ring = alive_sorted(tuple(f[: CFG.slots] for f in es.fields))
    ref = alive_sorted(pack_state(state))
    assert ring.shape == ref.shape
    np.testing.assert_allclose(ring, ref, rtol=1e-5, atol=1e-5)


def test_ring_engine_saturation_replaces_oldest():
    cfg = dataclasses.replace(CFG, capacity=1024,
                              emitters=(Emitter(rate=30000.0, life_min=5.0,
                                                life_max=9.0),))
    eng = PackedEngine(cfg, alloc="ring")
    es = eng.init()
    for _ in range(10):
        es = eng.step(es)
    age = np.asarray(es.fields[6][:cfg.slots])
    life = np.asarray(es.fields[7][:cfg.slots])
    alive = (age <= life) & (life > 0)
    assert alive.sum() == cfg.slots      # saturated: every slot live
    assert age.max() < 10 * cfg.dt + 1e-5  # oldest were replaced, not kept


def test_engine_refresh_interval_bounded_latency():
    """With K>1 the engine must still never exceed capacity and must keep
    spawning from slots freed at the last refresh."""
    cfg = dataclasses.replace(CFG, capacity=1024,
                              emitters=(Emitter(rate=30000.0, life_min=0.2,
                                                life_max=0.4),))
    eng = PackedEngine(cfg, refresh_interval=4)
    es = eng.init()
    for _ in range(90):
        es = eng.step(es)
    age, life = np.asarray(es.packed[6]), np.asarray(es.packed[7])
    alive = (age <= life) & (life > 0)
    assert alive.sum() <= cfg.slots
    assert alive.sum() > 0.5 * cfg.slots

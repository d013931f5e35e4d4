"""Active-prefix bucketing (occupancy-adaptive frame width).

``compact_state`` + ``step(active=...)`` must reproduce the full-width
trajectory BIT-EXACTLY: compaction is a deterministic stable partition
(mirrorable by any oracle), and a prefix with spawn headroom contains
every row the frame can touch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.api import NBodySimulation
from particlesystem_tpu.models import nbody

CFG = NBodyConfig(n_fill=3000, capacity=8192,
                  grid=GridSpec(grid_dim=8, chunk_factor=2),
                  particle_life=2.0, spawn_budget=1024, seed=5)


step_full = jax.jit(lambda s, f: nbody.step(s, f, CFG, 0, "blocks", 0))
step_buck = jax.jit(lambda s, f: nbody.step(s, f, CFG, 0, "blocks", 4096))


def run_traj(step, st, f0, frames):
    out = []
    for f in range(f0, f0 + frames):
        st, stats = step(st, jnp.int32(f))
        out.append((st, stats))
    return out


def warmed(frames=4):
    st = nbody.init_fill(CFG)
    for f in range(frames):
        st, _ = step_full(st, jnp.int32(f))
    return st, frames


def test_compact_state_is_stable_partition():
    st, _ = warmed()
    cs = nbody.compact_state(st)
    alive = np.asarray(st.alive)
    calive = np.asarray(cs.alive)
    na = alive.sum()
    # alive rows form the prefix, in original slot order
    assert calive[:na].all() and not calive[na:].any()
    order = np.concatenate([np.flatnonzero(alive), np.flatnonzero(~alive)])
    for f in ("pos", "vel", "acc", "w", "age", "life", "parent", "tag"):
        np.testing.assert_array_equal(np.asarray(getattr(cs, f)),
                                      np.asarray(getattr(st, f))[order], f)


def test_bucketed_step_matches_full_width_exactly():
    st, f0 = warmed()
    st = nbody.compact_state(st)
    active = 4096  # > alive + spawn_budget, < capacity, multiple of 1024
    assert int(np.asarray(st.alive).sum()) + CFG.max_spawns_per_frame < active

    traj_f = run_traj(step_full, st, f0, 4)
    traj_b = run_traj(step_buck, st, f0, 4)
    for f, ((full, fs), (buck, bs)) in enumerate(zip(traj_f, traj_b)):
        assert int(bs.n_tail_alive) == 0
        for k in ("n_alive", "n_age_deaths", "n_collision_kills",
                  "n_survivals", "n_spawned"):
            assert int(getattr(fs, k)) == int(getattr(bs, k)), (f, k)
        for fld in ("pos", "vel", "acc", "w", "age", "life", "alive",
                    "parent", "tag"):
            np.testing.assert_array_equal(
                np.asarray(getattr(full, fld)),
                np.asarray(getattr(buck, fld)), f"frame {f} {fld}")


def test_prefix_saturation_reports_spawn_cap():
    """A saturated prefix (zero free slots inside, free room in the tail)
    must REPORT the spawns it capped (stats.n_spawn_capped) — otherwise a
    growing population could diverge from the full-width trajectory with every guard
    still green (n_tail_alive only sees alive rows beyond the prefix)."""
    st = nbody.init_fill(CFG)
    n = st.slots
    active = 1024
    alive = np.zeros((n,), bool)
    alive[:active] = True          # prefix completely full ...
    age = np.full((n,), 0.2, np.float32)
    life = np.full((n,), 5.0, np.float32)
    age[:100] = 0.99               # ... and 100 rows explode this frame
    life[:100] = 1.0
    st = dataclasses.replace(
        st, alive=jnp.asarray(alive), age=jnp.asarray(age),
        life=jnp.asarray(life),
        parent=jnp.zeros((n,), bool))

    _, stats_pfx = nbody.step(st, jnp.int32(0), CFG, 0, "dense", active)
    _, stats_full = nbody.step(st, jnp.int32(0), CFG, 0, "dense", 0)
    # full width grants every child from the dead tail; the prefix can't
    # (a few of the 100 candidates may be collision-killed before
    # exploding, identically in both runs — compare the two runs, not 100)
    # (same-frame deaths free a few prefix slots, granting that many)
    assert int(stats_full.n_spawn_capped) == 0
    assert int(stats_pfx.n_spawned) < int(stats_full.n_spawned)
    capped = int(stats_pfx.n_spawn_capped)
    assert capped == int(stats_full.n_spawned) - int(stats_pfx.n_spawned)
    assert capped > 80
    assert int(stats_pfx.n_tail_alive) == 0  # the old guard saw nothing


def test_driver_bucketing_matches_unbucketed_run():
    cfg = dataclasses.replace(CFG, capacity=1 << 20)  # large enough that
    # _pick_active actually selects a shrunken prefix
    a = NBodySimulation(cfg, impl="blocks", active_bucketing=True)
    b = NBodySimulation(cfg, impl="blocks", active_bucketing=False)
    # 4 frames: children born after the first compaction stay under
    # kid_age, so no collision tie-break can involve a renumbered slot yet
    # and the two runs must agree bit-for-bit
    a.run(4)
    b.run(4)
    assert a._active != 0  # bucketing actually engaged
    for k in ("n_alive", "n_collision_kills", "n_spawned"):
        assert int(getattr(a.last_stats, k)) == int(getattr(b.last_stats, k))
    # trajectories identical as an alive-row multiset (compaction renumbers
    # slots, so per-slot comparison needs the permutation; multiset + the
    # exact event ledger above pin the physics)
    def rows(sim):
        m = np.asarray(sim.state.alive)
        r = np.concatenate([np.asarray(sim.state.pos),
                            np.asarray(sim.state.vel)], axis=1)[m]
        return r[np.lexsort(r.T[::-1])]
    np.testing.assert_allclose(rows(a), rows(b), rtol=0, atol=0)

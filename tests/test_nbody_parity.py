"""CPU-oracle vs jitted-XLA trajectory parity for the n-body scene.

Discrete lifecycle outcomes (alive masks, kill/survive/spawn counts, slot
allocation) must match EXACTLY; float trajectories to accumulation-order
tolerance.  Exercises every lifecycle path of the reference's CALC_FORCES
kernel (``particleSystem.cpp:1120-1383``): collision kill + survive,
age death, explosion reproduction, cell-overflow kill, torus wrap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.cpu_ref import oracle_nbody
from particlesystem_tpu.cpu_ref.oracle_emitter import NpState
from particlesystem_tpu.models import nbody

DENSE = NBodyConfig(
    n_fill=2000, capacity=4096, grid=GridSpec(grid_dim=4, cell_size=5.0,
                                              chunk_factor=2),
    max_per_cell=48, seed=3,
)
LIFECYCLE = NBodyConfig(
    n_fill=500, capacity=2048, grid=GridSpec(grid_dim=8, cell_size=5.0,
                                             chunk_factor=2),
    particle_life=2.0, seed=5,
)


def run_parity(cfg, n_frames, impl="dense"):
    state = nbody.init_fill(cfg)
    ora = NpState.from_jax(state)
    events = {k: 0 for k in ("n_collision_kills", "n_age_deaths",
                             "n_survivals", "n_spawned", "n_overflow_kills")}

    # the oracle's random fields are recomputed separately, identical by
    # threefry determinism
    fields = jax.jit(lambda f, t: nbody.frame_fields(cfg, f, t))

    for frame in range(n_frames):
        uvec, fert = fields(jnp.int32(frame), state.tag)
        state, stats = nbody.step(state, jnp.int32(frame), cfg, 0, impl)
        ora, ostats = oracle_nbody.step(
            ora, np.asarray(uvec), np.asarray(fert), frame, cfg)

        for k, v in ostats.items():
            assert int(getattr(stats, k)) == v, (
                f"frame {frame}: {k} jax={int(getattr(stats, k))} oracle={v}")
            if k in events:
                events[k] += v

        np.testing.assert_array_equal(np.asarray(state.alive), ora.alive,
                                      err_msg=f"frame {frame} alive")
        np.testing.assert_array_equal(np.asarray(state.parent), ora.parent,
                                      err_msg=f"frame {frame} parent")
        for field in ("pos", "vel", "age", "life", "w"):
            assert_close_chaotic(
                np.asarray(getattr(state, field)), getattr(ora, field),
                f"frame {frame} {field}")
    return events


def assert_close_chaotic(a, b, msg):
    """Trajectory comparison for chaotic dynamics: single-ulp accumulation
    differences amplify through close encounters, so require 99.5% of
    elements within tight tolerance and ALL within a loose absolute bound.
    Wrong physics produces O(1) errors everywhere; this still catches it."""
    err = np.abs(a - b)
    tol = 1e-3 + 1e-2 * np.abs(b)
    frac_bad = float(np.mean(err > tol))
    assert frac_bad <= 0.005, f"{msg}: {frac_bad:.2%} elements out of tolerance"
    assert float(err.max()) < 0.25, f"{msg}: max abs err {err.max()}"


def test_dense_collisions_parity():
    events = run_parity(DENSE, 12)
    assert events["n_collision_kills"] > 0, "config never exercised collisions"
    assert events["n_survivals"] > 0


def test_blocks_oracle_parity():
    """The production impl (cluster-pair Pallas kernel) checked DIRECTLY
    against the numpy oracle — not only via dense-path transitivity."""
    events = run_parity(DENSE, 12, impl="blocks")
    assert events["n_collision_kills"] > 0
    assert events["n_survivals"] > 0


def test_lifecycle_parity():
    events = run_parity(LIFECYCLE, 50)
    assert events["n_age_deaths"] > 0, "config never exercised age death"
    assert events["n_spawned"] > 0, "config never exercised reproduction"


def test_positions_stay_in_box():
    cfg = LIFECYCLE
    state = nbody.init_fill(cfg)
    for frame in range(30):
        state, _ = nbody.step(state, jnp.int32(frame), cfg)
    p = np.asarray(state.pos)[np.asarray(state.alive)]
    half = cfg.grid.half_extent
    assert np.all(np.abs(p) <= half + cfg.grid.cell_size)


def test_fill_matches_reference_distribution():
    cfg = NBodyConfig(n_fill=4000, grid=GridSpec(grid_dim=8), capacity=8192)
    state = nbody.init_fill(cfg)
    p = np.asarray(state.pos)[:4000]
    half = cfg.grid.half_extent
    assert np.all(np.abs(p) < half)
    assert abs(float(p.mean())) < 1.0        # symmetric around origin
    age = np.asarray(state.age)[:4000]
    assert age.min() >= cfg.min_adult_age and age.max() <= cfg.max_adult_age

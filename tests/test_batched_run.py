"""Sync-free batched driver loops.

``run(batch=k)`` must reproduce the per-frame ``run()`` trajectory exactly
(the loop body IS the same step program) while reading the host back once
per batch, and the contract guards must still trip from inside a batch —
accumulated on device, evaluated at the batch boundary.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.api import NBodySimulation
from particlesystem_tpu.models import nbody
from particlesystem_tpu.parallel.driver import (DistributedNBodySimulation,
                                                _alive_rows)
from particlesystem_tpu.parallel.nbody_sharded import SlabSpec

CFG = NBodyConfig(n_fill=3000, capacity=8192,
                  grid=GridSpec(grid_dim=8, chunk_factor=2),
                  particle_life=2.0, spawn_budget=1024, seed=5)


def test_batched_run_matches_per_frame_exactly():
    a = NBodySimulation(CFG, impl="dense")
    b = NBodySimulation(CFG, impl="dense")
    a.run(6, batch=1)
    b.run(6, batch=3)
    assert a.frame == b.frame == 6
    for k in ("n_alive", "n_age_deaths", "n_collision_kills",
              "n_survivals", "n_spawned"):
        assert int(getattr(a.last_stats, k)) == int(getattr(b.last_stats, k))
    for fld in ("pos", "vel", "acc", "w", "age", "life", "alive",
                "parent", "tag"):
        np.testing.assert_array_equal(np.asarray(getattr(a.state, fld)),
                                      np.asarray(getattr(b.state, fld)), fld)


def test_batched_run_rejects_indivisible_iterations():
    sim = NBodySimulation(CFG, impl="dense")
    with pytest.raises(ValueError, match="multiple of batch"):
        sim.run(5, batch=2)


def _saturated_prefix_sim():
    """A sim whose 1024-row active prefix is completely full while 100 rows
    explode this frame — full width grants the children from the dead
    tail, the prefix cannot (test_active_prefix's construction)."""
    sim = NBodySimulation(CFG, impl="dense", adaptive_width=False,
                          active_bucketing=False)
    st = nbody.init_fill(CFG)
    n = st.slots
    alive = np.zeros((n,), bool)
    alive[:1024] = True
    age = np.full((n,), 0.2, np.float32)
    life = np.full((n,), 5.0, np.float32)
    age[:100] = 0.99
    life[:100] = 1.0
    sim.state = dataclasses.replace(
        st, alive=jnp.asarray(alive), age=jnp.asarray(age),
        life=jnp.asarray(life), parent=jnp.zeros((n,), bool))
    sim._active = 1024
    return sim


def test_batched_run_still_trips_spawn_cap_guard():
    sim = _saturated_prefix_sim()
    with pytest.raises(RuntimeError, match="saturated"):
        sim.run(2, batch=2)


def test_batched_run_still_trips_tail_alive_guard():
    sim = _saturated_prefix_sim()
    alive = np.asarray(sim.state.alive).copy()
    alive[2000] = True  # alive row BEYOND the 1024 prefix
    sim.state = dataclasses.replace(sim.state, alive=jnp.asarray(alive))
    with pytest.raises(RuntimeError, match="beyond active prefix"):
        sim.run(2, batch=2)


def test_auto_batch_policy():
    """batch=0 (the new default): largest divisor of the
    iteration count <= 16; per-frame only when no divisor exists."""
    from particlesystem_tpu.api import auto_batch

    assert auto_batch(10) == 10     # the reference's own run length
    assert auto_batch(32) == 16
    assert auto_batch(48) == 16
    assert auto_batch(17) == 1      # prime > 16: fall back to per-frame
    assert auto_batch(1) == 1
    assert auto_batch(100) == 10


def test_default_run_is_batched():
    """Plain run() must take the sync-free batched path by default, and
    still produce the exact per-frame trajectory."""
    a = NBodySimulation(CFG, impl="dense")
    b = NBodySimulation(CFG, impl="dense")
    a.run(6, batch=1)
    b.run(6)  # default: auto_batch(6) == 6 -> one device-side loop
    assert b._loop_jits, "default run() did not use the batched loop"
    assert (6, ) in {(k[-1],) for k in b._loop_jits}
    for fld in ("pos", "vel", "age", "life", "alive", "tag"):
        np.testing.assert_array_equal(np.asarray(getattr(a.state, fld)),
                                      np.asarray(getattr(b.state, fld)), fld)

    da = DistributedNBodySimulation(CFG, SlabSpec(n_devices=8))
    da.run(4)  # default: auto_batch(4) == 4
    assert 4 in da._loop_jits, "driver default run() not batched"


def test_distributed_batched_run_matches_per_frame():
    a = DistributedNBodySimulation(CFG, SlabSpec(n_devices=8))
    b = DistributedNBodySimulation(CFG, SlabSpec(n_devices=8))
    sa = a.run(4, batch=1)
    sb = b.run(4, batch=2)
    assert a.frame == b.frame == 4
    assert sa["n_alive"] == sb["n_alive"]
    # batched stats carry batch-accumulated drops (here zero) in place of
    # the final frame's
    assert sb["halo_dropped"] == 0 and sb["migration_dropped"] == 0

    def rows(sim):
        g = sim.gather()
        return _alive_rows(*(np.asarray(x) for x in
                             (g.pos, g.vel, g.age, g.life, g.alive)))

    np.testing.assert_array_equal(rows(a), rows(b))


def test_distributed_batched_run_still_warns_on_drops():
    spec = SlabSpec(n_devices=8, halo_capacity=2, migration_capacity=1)
    sim = DistributedNBodySimulation(CFG, spec)
    with pytest.warns(RuntimeWarning, match="buffer overflow drops"):
        stats = sim.run(4, batch=2)
    assert stats["halo_dropped"] > 0  # whole-batch accumulated count
    assert sim.n_degraded_frames > 0


def test_cli_multidevice_routes_through_driver(tmp_path, capsys):
    """The launcher front door drives DistributedNBodySimulation:
    batched iteration BY DEFAULT (no --batch flag: auto_batch resolves 4
    iterations to one 4-frame device loop),
    timers report, checkpoint on request."""
    import os

    from particlesystem_tpu.__main__ import main

    ck = os.path.join(tmp_path, "cli.npz")
    main(["nbody", "--particles", "3000", "--grid-dim", "16",
          "--iterations", "4", "--devices", "8", "--decomp", "slab",
          "--impl", "dense", "--save", ck])
    out = capsys.readouterr().out
    assert "final: alive=" in out
    assert "step" in out  # timers report includes the step phase
    assert os.path.exists(ck)
    # verbose per-iteration lines print once per BATCH, not per frame:
    # iterations=4 auto-batches to one 4-frame loop -> exactly one line
    assert out.count("iter ") == 1, out

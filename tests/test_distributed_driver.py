"""Unified distributed driver: run / checkpoint / validate / autosize over
sharded state — the multi-chip
``DoParallelProcess`` equivalent, driven end to end on the 8-virtual-device
CPU mesh through a brick spec, plus the measured-buffer flow and its
red path."""

import os

import jax
import numpy as np
import pytest

from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.parallel.driver import (DistributedNBodySimulation,
                                                _alive_rows)
from particlesystem_tpu.parallel.nbody_brick import BrickSpec
from particlesystem_tpu.parallel.nbody_pencil import PencilSpec
from particlesystem_tpu.parallel.nbody_sharded import SlabSpec

CFG = NBodyConfig(
    n_fill=3000, capacity=8192,
    grid=GridSpec(grid_dim=16, cell_size=5.0, chunk_factor=4),
    particle_life=3.0, seed=11,
)


def test_brick_driver_end_to_end(tmp_path):
    sim = DistributedNBodySimulation(CFG, BrickSpec(d3=2, d1=2, d2=2))
    assert sim.n_fill_dropped == 0
    stats = sim.run(4)
    assert stats["n_alive"] > 0
    assert sim.frame == 4
    assert stats["halo_dropped"] == 0 and stats["migration_dropped"] == 0

    # sharded validate: production sharded step vs numpy oracle
    rep = sim.validate(frames=3)
    assert rep["events_match"], rep
    assert rep["max_row_deviation"] < 1e-4, rep

    # sharded checkpoint round-trip: load re-distributes (compacts alive
    # rows per device), so state equality is as an alive-row multiset
    def rows(sim):
        g = sim.gather()
        return _alive_rows(*(np.asarray(x) for x in
                             (g.pos, g.vel, g.age, g.life, g.alive)))

    path = os.path.join(tmp_path, "brick.npz")
    sim.save(path)
    before = rows(sim)
    sim.run(2)
    assert not np.array_equal(before, rows(sim))
    dropped = sim.load(path)
    assert dropped == 0
    assert sim.frame == 4
    np.testing.assert_array_equal(rows(sim), before)

    # resumed run continues cleanly
    sim.run(1)
    assert sim.frame == 5


def test_validate_shard_local_no_gather(monkeypatch):
    """validate() must never gather the device state:
    the device side reads only addressable shards, the oracle join is by
    persistent tag, and the 7-frame default window is sized to the
    measured exact-parity horizon (tools/parity_horizon.py)."""
    from particlesystem_tpu.parallel import driver as driver_mod

    sim = DistributedNBodySimulation(CFG, SlabSpec(n_devices=8))
    sim.run(2)
    monkeypatch.setattr(DistributedNBodySimulation, "gather",
                        lambda self: pytest.fail("validate() gathered"))
    monkeypatch.setattr(driver_mod, "_to_host",
                        lambda s: pytest.fail("validate() gathered"))
    rep = sim.validate()
    assert rep["frames"] == 7
    assert rep["events_match"], rep
    assert rep["max_row_deviation"] < 1e-3, rep
    assert rep["local_alive"] > 0
    assert sim.frame == 2  # validate does not advance state


def test_checkpoint_portable_across_decompositions(tmp_path):
    src = DistributedNBodySimulation(CFG, SlabSpec(n_devices=8))
    src.run(3)
    path = os.path.join(tmp_path, "slab.npz")
    src.save(path)
    alive_src = int(np.asarray(src.gather().alive).sum())

    dst = DistributedNBodySimulation(CFG, PencilSpec(d3=4, d1=2))
    dropped = dst.load(path)
    assert dropped == 0
    assert dst.frame == 3
    assert int(np.asarray(dst.gather().alive).sum()) == alive_src
    stats = dst.run(2)
    assert stats["halo_dropped"] == 0 and stats["migration_dropped"] == 0


def test_autosize_buffers_shrinks_and_stays_exact():
    sim = DistributedNBodySimulation(CFG, SlabSpec(n_devices=8))
    worst_halo = sim.spec.halo_capacity
    worst_mig = sim.spec.migration_capacity
    sizes = sim.autosize_buffers(frames=6, margin=2.0)
    # measured capacities must be far below the worst-case whole-face
    # defaults, and stay drop-free over a long horizon.  At this tiny CPU
    # config the worst case is only ~4x the measured mark (cell_capacity is
    # derived from capacity/num_cells, so the default shrinks with the
    # test); at reference scale (1M, 520/cell cap) the same flow is >10x.
    assert sizes["halo_capacity"] * 4 <= worst_halo
    assert sizes["migration_capacity"] * 10 <= worst_mig
    for _ in range(15):
        stats = sim.run(1)
        assert stats["halo_dropped"] == 0, stats
        assert stats["migration_dropped"] == 0, stats
    assert sim.n_degraded_frames == 0


def test_sharded_checkpoint_fast_path(tmp_path, monkeypatch):
    """Same-spec sharded checkpoints: save writes
    per-device shard chunks WITHOUT gathering the full state, and load
    streams them straight back onto their owning devices — slot-EXACT
    state equality (stronger than the redistribute path's alive-row
    multiset), frame restored, no redistribution drops."""
    import json

    from particlesystem_tpu.runtime import checkpoint

    sim = DistributedNBodySimulation(CFG, SlabSpec(n_devices=8))
    sim.run(3)
    path = os.path.join(tmp_path, "ckpt")

    # the save path must never materialize the full global state
    monkeypatch.setattr(DistributedNBodySimulation, "gather",
                        lambda self: pytest.fail("save() gathered"))
    sim.save(path)
    monkeypatch.undo()

    # on-disk layout: meta.json + one shard file for this (only) process,
    # holding one chunk per device per leaf with its global index range
    with open(os.path.join(path, "meta.json")) as f:
        info = json.load(f)
    assert info["format"] == "pstpu-sharded-v1"
    assert info["meta"]["spec_type"] == "SlabSpec"
    assert info["meta"]["frame"] == 3
    z = np.load(os.path.join(path, "shard_p00000.npz"))
    c_local = CFG.slots // 8
    starts = sorted(int(z[k][0, 0]) for k in z.files
                    if k.startswith("l0s") and k.endswith("_idx"))
    assert starts == [d * c_local for d in range(8)]

    before = jax.tree.map(np.asarray, sim.state)
    sim.run(2)
    dropped = sim.load(path)
    assert dropped == 0 and sim.frame == 3
    after = jax.tree.map(np.asarray, sim.state)
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        np.testing.assert_array_equal(a, b)

    # spec mismatch (different capacities) routes through redistribute,
    # not the streaming fast path — and still round-trips the particles
    spec2 = SlabSpec(n_devices=8, halo_capacity=512, migration_capacity=256)
    sim2 = DistributedNBodySimulation(CFG, spec2)
    assert sim2.load(path) == 0
    assert sim2.frame == 3
    rows_a = _alive_rows(before.pos, before.vel, before.age, before.life,
                         before.alive)
    g2 = sim2.gather()
    rows_b = _alive_rows(*(np.asarray(x) for x in
                           (g2.pos, g2.vel, g2.age, g2.life, g2.alive)))
    np.testing.assert_array_equal(rows_a, rows_b)

    # config mismatch is refused on the sharded path too
    import dataclasses
    cfg_bad = dataclasses.replace(CFG, seed=99)
    sim3 = DistributedNBodySimulation(cfg_bad, SlabSpec(n_devices=8))
    with pytest.raises(ValueError, match="config mismatch"):
        sim3.load(path)


def test_sharded_checkpoint_overwrite_clears_stale_shards(tmp_path):
    """Re-saving into an existing checkpoint directory must not let stale
    shard files from an older (e.g. higher-process-count) save corrupt a
    later load: save clears shard_p*.npz first, and
    load reads exactly the meta-listed process files — a stale higher-pid
    file is ignored even if clearing were skipped."""
    import json

    from particlesystem_tpu.runtime import checkpoint

    sim = DistributedNBodySimulation(CFG, SlabSpec(n_devices=8))
    sim.run(2)
    path = os.path.join(tmp_path, "ckpt")
    sim.save(path)

    # plant a stale higher-pid shard whose chunks would overwrite leaf 0
    # if load globbed the directory
    z0 = np.load(os.path.join(path, "shard_p00000.npz"))
    poisoned = {}
    for k in z0.files:
        if k.startswith("l0s"):
            poisoned[k] = (z0[k] if k.endswith("_idx")
                           else np.full_like(z0[k], 7.5))
    z0.close()
    stale = os.path.join(path, "shard_p00001.npz")
    np.savez(stale, **poisoned)

    before = jax.tree.map(np.asarray, sim.state)
    sim.run(1)
    assert sim.load(path) == 0
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(sim.state)):
        np.testing.assert_array_equal(a, np.asarray(b))

    # re-save clears the stale file
    sim.save(path)
    assert not os.path.exists(stale)
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["n_processes"] == 1

    # a MISSING meta-listed shard file fails loudly (per-host local disks
    # instead of the required shared filesystem)
    os.unlink(os.path.join(path, "shard_p00000.npz"))
    with pytest.raises(FileNotFoundError, match="shared filesystem"):
        sim.load(path)


def test_sharded_checkpoint_dtype_mismatch(tmp_path):
    """load_sharded must reject a checkpoint whose leaf dtype differs from
    the template: previously it silently assembled with the
    stored dtype."""
    from particlesystem_tpu.runtime import checkpoint

    tree = {"x": jax.numpy.arange(16, dtype=jax.numpy.float32)}
    path = os.path.join(tmp_path, "ck")
    checkpoint.save_sharded(path, tree)
    bad_tpl = {"x": jax.numpy.arange(16, dtype=jax.numpy.int32)}
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load_sharded(path, bad_tpl)


def test_undersized_buffers_report_drops():
    spec = SlabSpec(n_devices=8, halo_capacity=2, migration_capacity=1)
    sim = DistributedNBodySimulation(CFG, spec)
    with pytest.warns(RuntimeWarning, match="buffer overflow drops"):
        stats = sim.run(3)
    assert stats["halo_dropped"] > 0
    assert sim.n_degraded_frames > 0

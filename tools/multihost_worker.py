"""Worker process for the 2-process multi-host tests
(``tests/test_multihost.py``).

Each process owns 4 virtual CPU devices; ``jax.distributed.initialize``
(via ``mesh.maybe_init_distributed``, driven by the PSTPU_* env the way the
reference is driven by the mpirun hostfile, ``/root/reference/makefile:3-4``)
joins them into one 8-device global mesh.  ``PSTPU_DECOMP`` selects the
decomposition (slab / pencil / brick); the mesh comes from
``mesh.hybrid_mesh`` so the process (inter-node) split lands on the "x"
axis while every other migration ring stays intra-process — the placement
rule multi-node runs follow.  Runs a few sharded
n-body steps over the GLOBAL mesh — 1-, 2- and 3-axis collectives cross the
process boundary — and prints one JSON stats line for the parent to compare
against the single-device run.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from particlesystem_tpu.parallel.mesh import (  # noqa: E402
    hybrid_mesh, maybe_init_distributed)

assert maybe_init_distributed(), "PSTPU_* env not set"
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from particlesystem_tpu import GridSpec, NBodyConfig  # noqa: E402
from particlesystem_tpu.models import nbody  # noqa: E402

CFG = NBodyConfig(
    n_fill=2000, capacity=8192,
    grid=GridSpec(grid_dim=16, cell_size=5.0, chunk_factor=4),
    particle_life=3.0, seed=11,
)

decomp = os.environ.get("PSTPU_DECOMP", "slab")
if decomp == "slab":
    from particlesystem_tpu.parallel.nbody_sharded import (
        SlabSpec, distribute, make_sharded_step)
    spec = SlabSpec(n_devices=8)
    mesh = hybrid_mesh((4,), (2,), ("x",))
    step_fn, shard_state = make_sharded_step(CFG, spec, mesh)
elif decomp == "pencil":
    from particlesystem_tpu.parallel.nbody_pencil import (
        PencilSpec, distribute, make_pencil_step)
    spec = PencilSpec(d3=4, d1=2)
    # "y" ring intra-process; "x" crosses the process seam once
    mesh = hybrid_mesh((2, 2), (2, 1), ("x", "y"))
    step_fn, shard_state = make_pencil_step(CFG, spec, mesh)
elif decomp == "brick":
    from particlesystem_tpu.parallel.nbody_brick import (
        BrickSpec, distribute, make_brick_step)
    spec = BrickSpec(d3=2, d1=2, d2=2)
    # "y"/"z" rings intra-process; "x" crosses the process seam once
    mesh = hybrid_mesh((1, 2, 2), (2, 1, 1), ("x", "y", "z"))
    step_fn, shard_state = make_brick_step(CFG, spec, mesh)
else:
    raise SystemExit(f"unknown PSTPU_DECOMP {decomp!r}")

# every process computes the same global initial state, device_put places
# only the addressable shards
init, dropped = distribute(nbody.init_fill(CFG), CFG, spec)
assert dropped == 0
ms = shard_state(init)

out = []
for frame in range(3):
    ms, stats = step_fn(ms, jnp.int32(frame))
    out.append({k: int(np.asarray(v)) for k, v in stats.items()})

print("STATS " + json.dumps(out), flush=True)

# -- the unified driver across the process boundary -------------------------
# gather() must ride process_allgather here (np.asarray cannot see the other
# process's shards); validate() runs the production step against the numpy
# oracle SHARD-LOCALLY — the counter wrapper below proves it never gathers
# the device state across the process boundary; save()
# checkpoints without gathering either.
import shutil  # noqa: E402
import tempfile  # noqa: E402

from jax.experimental import multihost_utils  # noqa: E402

from particlesystem_tpu.parallel.driver import (  # noqa: E402
    DistributedNBodySimulation)

_pag_calls = {"n": 0}
_orig_pag = multihost_utils.process_allgather


def _counting_pag(in_tree, *a, **k):
    # count only DATA-bearing gathers: sync_global_devices barriers (used
    # by the sharded checkpoint format) ride a 1-element process_allgather
    # internally — a barrier is not a state gather
    n_elems = sum(int(np.prod(np.shape(l))) for l in jax.tree.leaves(in_tree))
    if n_elems > 16:
        _pag_calls["n"] += 1
    return _orig_pag(in_tree, *a, **k)


sim = DistributedNBodySimulation(CFG, spec, mesh=mesh)
sim.run(2)
g = sim.gather()
port = os.environ["PSTPU_COORDINATOR"].rsplit(":", 1)[1]
scratch = os.path.join(tempfile.gettempdir(),
                       f"pstpu_mh_scratch_{port}_{decomp}")
multihost_utils.process_allgather = _counting_pag
v = sim.validate(1, scratch_dir=scratch)
assert _pag_calls["n"] == 0, "validate() gathered the device state"
multihost_utils.process_allgather = _orig_pag
# sharded checkpoints REQUIRE one shared path across processes (the
# format's documented contract) — a per-process mkdtemp would write two
# half-checkpoints
path = os.path.join(tempfile.gettempdir(),
                    f"pstpu_mh_save_{port}_{decomp}")
sim.save(path)
assert os.path.exists(path)
digest = float(np.asarray(g.pos).sum()) + float(np.asarray(g.age).sum())
print("DRIVER " + json.dumps({
    "alive": sim.alive_count(), "digest": round(digest, 3),
    "events_match": bool(v["events_match"]),
    "max_dev": float(v["max_row_deviation"])}), flush=True)

# -- sharded checkpoint across the process boundary --------------------------
# Each process writes ONLY its own shards and reads ONLY the chunks that
# intersect them; no full-state materialization anywhere on the save/load
# path.  Proofs: (a) process_allgather is never invoked
# during save/load (counter wrapper), (b) this process's shard file holds
# about half the global bytes, never all of them, (c) the round-trip is
# slot-EXACT on the local shards.
multihost_utils.process_allgather = _counting_pag

ck = os.path.join(tempfile.gettempdir(),
                  f"pstpu_mh_ckpt_{port}_{decomp}")
try:
    frame_at_save = sim.frame
    sim.save(ck)  # barrier inside: both shard files exist on return

    global_bytes = sum(np.dtype(l.dtype).itemsize * int(np.prod(l.shape))
                       for l in jax.tree.leaves(sim.state))
    mine = os.path.getsize(
        os.path.join(ck, f"shard_p{jax.process_index():05d}.npz"))
    other = os.path.getsize(
        os.path.join(ck, f"shard_p{1 - jax.process_index():05d}.npz"))
    assert mine < 0.6 * global_bytes, (mine, global_bytes)
    assert other > 0

    def local_shards(state):
        return [np.asarray(s.data) for leaf in jax.tree.leaves(state)
                for s in leaf.addressable_shards]

    before = local_shards(sim.state)
    sim.run(2)
    dropped = sim.load(ck)
    assert dropped == 0 and sim.frame == frame_at_save
    for a, b in zip(before, local_shards(sim.state)):
        np.testing.assert_array_equal(a, b)
    assert _pag_calls["n"] == 0, "save/load materialized the full state"
    sim.run(1)  # resumed run crosses the process boundary cleanly
    print("SHARDCKPT " + json.dumps({
        "ok": True, "my_bytes": mine, "global_bytes": global_bytes,
        "alive": sim.alive_count()}), flush=True)
finally:
    multihost_utils.process_allgather = _orig_pag
    if jax.process_index() == 0:
        multihost_utils.sync_global_devices("pstpu_mh_ckpt_done")
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(scratch, ignore_errors=True)
        shutil.rmtree(path, ignore_errors=True)
    else:
        multihost_utils.sync_global_devices("pstpu_mh_ckpt_done")

"""Measure sharded checkpoint save/load at the 10M config on one device:
wall time and on-disk size of ``DistributedNBodySimulation.save``/``load``
(the per-process sharded directory format, runtime/checkpoint.py) for the
~1.1 GB 10M state.

Single process + ``SlabSpec(n_devices=1)``: the save path np.asarray's
every addressable shard (device->host of the full state here, since one
process owns everything) and the load
path streams chunks back with ``jax.make_array_from_callback``; the same
code crosses process boundaries in the 2-process tests
(tests/test_multihost.py), where each process moves only its share.

No step is compiled or dispatched — this is pure state IO, so it runs in
seconds and needs no compile cache.

Run: ``python tools/measure_ckpt_10m.py [dir]``; prints one JSON line.
"""

import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax
    import numpy as np

    from particlesystem_tpu.core.config import GridSpec, NBodyConfig
    from particlesystem_tpu.parallel.driver import DistributedNBodySimulation
    from particlesystem_tpu.parallel.nbody_sharded import SlabSpec

    base = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp()
    path = os.path.join(base, "ckpt_10m")

    cfg = NBodyConfig(n_fill=10 << 20, grid=GridSpec(grid_dim=32))
    t0 = time.perf_counter()
    sim = DistributedNBodySimulation(cfg, SlabSpec(n_devices=1))
    t_init = time.perf_counter() - t0

    state_bytes = sum(np.dtype(l.dtype).itemsize * int(np.prod(l.shape))
                      for l in jax.tree.leaves(sim.state))

    t0 = time.perf_counter()
    sim.save(path)
    t_save = time.perf_counter() - t0

    disk = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))

    t0 = time.perf_counter()
    dropped = sim.load(path)
    # load_sharded streams via make_array_from_callback and blocks until
    # every addressable shard is materialized, so this timing is complete
    t_load = time.perf_counter() - t0

    print(json.dumps({
        "backend": jax.default_backend(),
        "state_bytes": state_bytes,
        "disk_bytes": disk,
        "fill_and_distribute_s": round(t_init, 2),
        "save_s": round(t_save, 2),
        "load_s": round(t_load, 2),
        "save_MBps": round(state_bytes / 1e6 / t_save, 1),
        "load_MBps": round(state_bytes / 1e6 / t_load, 1),
        "n_dropped_on_load": dropped,
    }))
    if len(sys.argv) <= 1:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main()

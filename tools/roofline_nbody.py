"""Stage-by-stage frame accounting for the n-body workload at any scale.

Settles the population for a few frames through ``NBodySimulation.run``
(which re-buckets the active prefix to the live count), then times each
stage with ``NBodySimulation.profile_frame``.

Usage: python tools/roofline_nbody.py [n_fill_log2=20] [grid_dim=16] [frames=10]
       python tools/roofline_nbody.py 10M      # 10*2^20 / 32^3 shortcut
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from particlesystem_tpu.api import NBodySimulation  # noqa: E402
from particlesystem_tpu.core.config import GridSpec, NBodyConfig  # noqa: E402
from particlesystem_tpu.utils.compile_cache import use_compile_cache  # noqa: E402


def _parse(argv):
    if argv and argv[0].upper() == "10M":
        return 10 << 20, 32, int(argv[1]) if len(argv) > 1 else 10
    n_fill = 1 << (int(argv[0]) if argv else 20)
    grid_dim = int(argv[1]) if len(argv) > 1 else 16
    frames = int(argv[2]) if len(argv) > 2 else 10
    return n_fill, grid_dim, frames


def main():
    use_compile_cache()
    n_fill, grid_dim, frames = _parse(sys.argv[1:])
    cfg = NBodyConfig(n_fill=n_fill, grid=GridSpec(grid_dim=grid_dim))
    sim = NBodySimulation(cfg)
    sim.run(frames)
    alive = int(sim.last_stats.n_alive)
    print(f"n_fill={n_fill} grid={grid_dim}^3 slots={cfg.slots} "
          f"active={sim._active or cfg.slots} frame={sim.frame} "
          f"alive={alive}", flush=True)
    stages = sim.profile_frame()
    total = sum(v for k, v in stages.items() if k != "full_frame")
    for k, v in stages.items():
        print(f"  {k:14s} {v:8.2f} ms", flush=True)
    print(f"  {'stage sum':14s} {total:8.2f} ms")
    print(json.dumps({"n_fill": n_fill, "grid_dim": grid_dim,
                      "frame": sim.frame, "active": sim._active or cfg.slots,
                      "alive": alive, **stages}))


if __name__ == "__main__":
    main()

"""Run the reference simulation end-to-end and dump the final state.

The JAX equivalent of the reference's default workload: uniform fill of
``n_fill`` particles in the 16^3-cell box, then ``--iters`` iterations of
the fused CALC_FORCES step (age death -> collision kill/survive -> 27-cell
softened gravity -> clamped Euler -> torus wrap -> aging -> explosion
reproduction), with the per-iteration stats printout standing in for the
reference's phase-timing printf (``particleSystem.cpp:1927``) and the final
dump standing in for its commented-out debug block (``:1933-1983``:
particles, queues, grids).

Usage:  python examples/nbody_demo.py [n_fill=100000] [iters=10]
        (CPU works: JAX_PLATFORMS=cpu with a small n_fill, e.g. 20000)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from particlesystem_tpu.api import NBodySimulation
from particlesystem_tpu.core.config import GridSpec, NBodyConfig


def dump_state(sim: NBodySimulation) -> None:
    """Final-state summary: the reference's debug dump, aggregated."""
    s = sim.state
    alive = np.asarray(s.alive)
    pos = np.asarray(s.pos)[alive]
    age = np.asarray(s.age)[alive]
    w = np.asarray(s.w)[alive]
    g = sim.cfg.grid
    print(f"\n-- final state (frame {sim.frame}) --")
    print(f"alive {alive.sum()} / {alive.size} slots "
          f"(fill was {sim.cfg.n_fill})")
    print(f"pos   x [{pos[:, 0].min():+7.2f}, {pos[:, 0].max():+7.2f}]  "
          f"y [{pos[:, 1].min():+7.2f}, {pos[:, 1].max():+7.2f}]  "
          f"z [{pos[:, 2].min():+7.2f}, {pos[:, 2].max():+7.2f}]  "
          f"(box +-{g.half_extent})")
    print(f"age   [{age.min():6.2f}, {age.max():6.2f}]  "
          f"(kid<{sim.cfg.kid_age}, life={sim.cfg.particle_life})")
    print(f"w     [{w.min():.1f}, {w.max():.1f}]")
    st = sim.last_stats
    print(f"stats n_alive={int(st.n_alive)} n_spawned={int(st.n_spawned)} "
          f"max_cell_occupancy={int(st.max_cell_occupancy)} "
          f"(cell kill cap {sim.cfg.cell_capacity})")
    # per-chunk occupancy: the reference's chunkgrid dump, 4x4x4 totals
    cf = g.chunk_factor
    cw = g.grid_dim // cf * g.cell_size
    idx = np.clip(((pos + g.half_extent) // cw).astype(int), 0, cf - 1)
    occ = np.zeros((cf, cf, cf), int)
    np.add.at(occ, (idx[:, 0], idx[:, 1], idx[:, 2]), 1)
    print(f"chunk occupancy ({cf}^3): min {occ.min()}  "
          f"median {int(np.median(occ))}  max {occ.max()}")


def main() -> None:
    n_fill = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    cfg = NBodyConfig(n_fill=n_fill, grid=GridSpec(grid_dim=16))
    print(f"n_fill={n_fill} slots={cfg.slots} grid={cfg.grid.grid_dim}^3 "
          f"dt={cfg.dt} iters={iters}")

    sim = NBodySimulation(cfg)
    sim.run(iters, verbose=True)
    for name, rec in sim.timers.summary().items():
        print(f"phase {name:8s} total {rec['total_s'] * 1e3:8.1f} ms "
              f"({rec['count']} calls, mean {rec['mean_ms']:.1f} ms)")
    dump_state(sim)


if __name__ == "__main__":
    main()

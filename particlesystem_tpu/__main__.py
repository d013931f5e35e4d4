"""CLI launcher — the analog of the reference's ``make run``
(``/root/reference/makefile:3-4``: ``mpirun -n 2 ... particleSystem.exe``).

    python -m particlesystem_tpu nbody  --particles 1048576 --iterations 10
    python -m particlesystem_tpu demo   --capacity 1000000 --frames 600
    python -m particlesystem_tpu bench
"""

from __future__ import annotations

import argparse
import sys


def _cmd_nbody(args):
    from .core.config import GridSpec, NBodyConfig

    cfg = NBodyConfig(n_fill=args.particles,
                      grid=GridSpec(grid_dim=args.grid_dim))
    if args.devices > 1:
        _run_nbody_sharded(args, cfg)
        return
    from .api import NBodySimulation

    sim = NBodySimulation(cfg, impl=args.impl)
    sim.run(args.iterations, verbose=True, batch=args.batch)
    if args.validate:
        print(f"validate: {sim.validate()}")
    if args.save:
        sim.save(args.save)
        print(f"checkpoint written to {args.save}")
    print(sim.timers.report())


def _run_nbody_sharded(args, cfg):
    """Multi-device n-body through the unified driver
    (``parallel.driver.DistributedNBodySimulation``) — the analog of the
    reference's ``mpirun -n 2`` launch (``makefile:3-4``), with the
    driver's facilities on the command line: batched sync-free iteration,
    per-phase timers, checkpointing, buffer autosizing, and oracle
    validation.  Initializes jax.distributed when launched under a
    multi-host coordinator (PSTPU_* envs, see parallel/mesh.py)."""
    from .parallel import mesh as meshmod
    from .parallel.driver import DistributedNBodySimulation

    meshmod.maybe_init_distributed()
    d = args.devices
    if args.decomp == "slab":
        from .parallel.nbody_sharded import SlabSpec
        spec = SlabSpec(n_devices=d, impl=args.impl)
    elif args.decomp == "pencil":
        from .parallel.nbody_pencil import PencilSpec
        d3 = args.d3 or max(2, d // 2)
        spec = PencilSpec(d3=d3, d1=d // d3, impl=args.impl)
    else:
        from .parallel.nbody_brick import BrickSpec
        d3 = args.d3 or 2
        rest = d // d3
        d1 = max(2, rest // 2) if rest > 1 else 1
        spec = BrickSpec(d3=d3, d1=d1, d2=rest // d1, impl=args.impl)

    sim = DistributedNBodySimulation(cfg, spec)
    if sim.n_fill_dropped:
        print(f"warning: {sim.n_fill_dropped} particles dropped at "
              f"distribution")
    if args.autosize:
        print(f"autosized buffers: {sim.autosize_buffers()}")
    stats = sim.run(args.iterations, verbose=True,
                    batch=args.batch)
    print(f"final: alive={stats['n_alive']} "
          f"degraded_batches={sim.n_degraded_frames}")
    if args.validate:
        print(f"validate: {sim.validate()}")
    if args.save:
        sim.save(args.save)
        print(f"checkpoint written to {args.save}")
    print(sim.timers.report())


def _cmd_demo(args):
    from .api import ParticleSystem

    ps = (ParticleSystem(capacity=args.capacity, dt=1 / 60,
                         gravity=(0, -9.8, 0), drag=0.2, wind=(2.0, 0, 0),
                         alloc=args.alloc, layout=args.layout)
          .add_emitter(pos=(0.0, 1.0, 0.0), rate=args.capacity * 0.5,
                       speed=9.0, life_min=1.0, life_max=2.0)
          .add_plane(restitution=0.5, friction=0.2))
    chunk = 60
    for _ in range(args.frames // chunk):
        ps.step(chunk)
        print(f"frame {ps.frame}: alive {ps.alive_count()}")
    print(ps.timers.report())


def _cmd_bench(args):
    sys.path.insert(0, ".")
    import bench
    bench.main()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="particlesystem_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("nbody", help="run the reference n-body simulation")
    p.add_argument("--particles", type=int, default=1 << 20)
    p.add_argument("--grid-dim", type=int, default=16)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--devices", type=int, default=1,
                   help="shard over N devices (the mpirun -n analog)")
    p.add_argument("--decomp", choices=("slab", "pencil", "brick"),
                   default="slab", help="spatial decomposition for --devices>1")
    p.add_argument("--d3", type=int, default=0,
                   help="devices along i3 for pencil/brick (0 = auto)")
    p.add_argument("--impl", choices=("blocks", "dense"), default="blocks",
                   help="neighbor pass (per-device for --devices>1)")
    p.add_argument("--batch", type=int, default=0,
                   help="frames per device-side loop (sync-free driver "
                        "iteration; iterations must divide by it). 0 = "
                        "auto: largest divisor of --iterations <= 16. "
                        "1 = per-frame readbacks (debugging)")
    p.add_argument("--save", default="",
                   help="write a checkpoint here after the run")
    p.add_argument("--validate", action="store_true",
                   help="compare the production step against the numpy "
                        "oracle after the run")
    p.add_argument("--autosize", action="store_true",
                   help="measure-then-shrink halo/migration buffers before "
                        "the run (--devices>1 only)")
    p.set_defaults(fn=_cmd_nbody)

    p = sub.add_parser("demo", help="run an emitter demo scene")
    p.add_argument("--capacity", type=int, default=1 << 20)
    p.add_argument("--frames", type=int, default=600)
    p.add_argument("--alloc", choices=("exact", "ring", "strided", "select"),
                   default="ring",
                   help="slot recycling policy (select: fused broadcast-"
                        "select spawn over 2-D state, the fastest path)")
    p.add_argument("--layout", choices=("packed8", "slim"),
                   default="packed8",
                   help="state layout (slim: derived liveness, 13 vs 15 "
                        "HBM words/particle-frame)")
    p.set_defaults(fn=_cmd_demo)

    p = sub.add_parser("bench", help="run the headline benchmark")
    p.set_defaults(fn=_cmd_bench)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

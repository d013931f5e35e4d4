"""Measure the exact-parity horizon: how many frames an 8-device sharded
run (slab / pencil / brick) tracks the single-device trajectory EXACTLY
(alive-tag multiset equal AND event counters equal every frame), over
several seeds.

Round 4 keyed collision ordering on persistent tags (d17a695), erasing the
slot-reallocation divergence that used to bound the parity windows at 3-4
frames; the remaining bound is float accumulation order (different row
arrangements sum gravity in different orders — single-ulp noise that the
chaotic system amplifies until a hard collision/threshold decision flips).
This tool measures WHERE that actually bites so the parity tests and the
``validate()`` default window can be sized to evidence instead of folklore.

Run on the CPU backend (8 virtual devices):

    python tools/parity_horizon.py [--frames 40] [--seeds 11 23 37]

Prints one line per (decomposition, seed): the first frame whose tag
multiset diverged (or "none" within the horizon) plus the first frame
where any event counter differed, and a summary table.
"""

import argparse
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from particlesystem_tpu import GridSpec, NBodyConfig  # noqa: E402
from particlesystem_tpu.models import nbody  # noqa: E402
from particlesystem_tpu.parallel import nbody_brick, nbody_pencil  # noqa: E402
from particlesystem_tpu.parallel import nbody_sharded  # noqa: E402

BASE_CFG = NBodyConfig(
    n_fill=3000, capacity=8192,
    grid=GridSpec(grid_dim=16, cell_size=5.0, chunk_factor=4),
    particle_life=3.0,   # fast lifecycle: deaths + births within few frames
    seed=11,
)

DECOMPS = {
    "slab": (nbody_sharded,
             lambda impl: nbody_sharded.SlabSpec(n_devices=8, impl=impl),
             lambda d: jax.sharding.Mesh(np.array(d), ("x",)),
             nbody_sharded.make_sharded_step),
    "pencil": (nbody_pencil,
               lambda impl: nbody_pencil.PencilSpec(d3=4, d1=2, impl=impl),
               lambda d: jax.sharding.Mesh(np.array(d).reshape(4, 2),
                                           ("x", "y")),
               nbody_pencil.make_pencil_step),
    "brick": (nbody_brick,
              lambda impl: nbody_brick.BrickSpec(d3=2, d1=2, d2=2,
                                                 impl=impl),
              lambda d: jax.sharding.Mesh(np.array(d).reshape(2, 2, 2),
                                          ("x", "y", "z")),
              nbody_brick.make_brick_step),
}

EVENTS = ("n_age_deaths", "n_collision_kills", "n_survivals", "n_alive")


def alive_tags(state):
    return np.sort(np.asarray(state.tag)[np.asarray(state.alive)])


def horizon(name: str, seed: int, frames: int, impl: str = "dense"):
    cfg = dataclasses.replace(BASE_CFG, seed=seed)
    _, mk_spec, mk_mesh, mk_step = DECOMPS[name]
    spec = mk_spec(impl)
    mesh = mk_mesh(jax.devices())
    mod = DECOMPS[name][0]

    init = nbody.init_fill(cfg)
    sharded_init, dropped = mod.distribute(init, cfg, spec)
    assert dropped == 0
    step_fn, shard_state = mk_step(cfg, spec, mesh)
    ms = shard_state(sharded_init)
    ss = sharded_init  # single-device run on the SAME slot arrangement

    first_tag = first_event = None
    for frame in range(frames):
        ms, stats = step_fn(ms, jnp.int32(frame))
        uvec, fert = nbody.frame_fields(cfg, jnp.int32(frame), ss.tag)
        ss, sstats = nbody.step_fields(ss, uvec, fert, jnp.int32(frame), cfg)
        if first_event is None and any(
                int(stats[k]) != int(getattr(sstats, k)) for k in EVENTS):
            first_event = frame
        ta, tb = alive_tags(ms), alive_tags(ss)
        if first_tag is None and (len(ta) != len(tb)
                                  or not np.array_equal(ta, tb)):
            first_tag = frame
        if first_tag is not None and first_event is not None:
            break
    return first_tag, first_event


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 23, 37])
    ap.add_argument("--decomps", nargs="+", default=list(DECOMPS))
    ap.add_argument("--impl", choices=("dense", "blocks"), default="dense",
                    help="per-device neighbor pass; blocks carries the MXU "
                         "fast-accum noise (~2e-5 rel) so its horizon is "
                         "shorter than dense's single-ulp one")
    args = ap.parse_args()

    results = {}
    for name in args.decomps:
        for seed in args.seeds:
            ft, fe = horizon(name, seed, args.frames, args.impl)
            results[(name, seed)] = (ft, fe)
            print(f"{name:7s} {args.impl} seed {seed:3d}: first "
                  f"tag-multiset mismatch "
                  f"{'none' if ft is None else ft} / first event mismatch "
                  f"{'none' if fe is None else fe} "
                  f"(horizon {args.frames})", flush=True)

    print("\nsummary (min over seeds = safe exact-parity window):")
    for name in args.decomps:
        fts = [results[(name, s)][0] for s in args.seeds]
        fts = [args.frames if x is None else x for x in fts]
        print(f"  {name:7s}: exact through frame {min(fts) - 1} "
              f"(per-seed first-mismatch: {fts})")


if __name__ == "__main__":
    main()

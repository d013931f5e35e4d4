"""End-to-end frame time of the two neighbor passes through
``NBodySimulation.run``: ``impl="blocks"`` (the cluster-pair kernel) and
``impl="dense"`` (the XLA cell-pair pass with occupancy-adaptive width).

Each impl warms ``warm`` frames (compiles, re-buckets the active prefix),
keeps that state, then times ``run(10)`` from it ``reps`` times, in turns
(blocks, dense, dense, blocks, ...), restoring the state before each rep so
every rep runs the same ten frames with no recompilation.

Usage: python tools/nbody_impls.py [1M|10M ...] [--reps N]
Prints one JSON line per size.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from particlesystem_tpu.api import NBodySimulation  # noqa: E402
from particlesystem_tpu.core.config import GridSpec, NBodyConfig  # noqa: E402
from particlesystem_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

SIZES = {"1M": (1 << 20, 16), "10M": (10 << 20, 32)}


def _median_ms(f, *a, reps):
    jax.block_until_ready(f(*a))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*a))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def time_passes(cfg, sims, saved, reps):
    """The neighbor pass alone, both ways, on the blocks run's window-start
    state: the cluster-pair pass (sort + kernel + unsort, and the kernel by
    itself via ``profile_frame``) and the dense pass at the width the dense
    run had adapted to."""
    import jax.numpy as jnp

    from particlesystem_tpu.ops.grid import (build_bins, coords_to_cell,
                                             wrap_positions)
    from particlesystem_tpu.ops.neighbor import collision_okey, neighbor_pass
    from particlesystem_tpu.ops.neighbor_blocks import neighbor_pass_blocks

    sim = sims["blocks"]
    sim.state, sim.frame, sim._active, sim._width = saved["blocks"]
    st = sim.state
    if sim._active:
        st = jax.tree.map(lambda a: a[:sim._active], st)
    width = saved["dense"][3]
    g = cfg.grid.grid_dim

    def cells(p):
        return coords_to_cell(wrap_positions(p, cfg.grid)[1], cfg.grid)

    def blocks(p, a, w, al, t):
        return neighbor_pass_blocks(p, a, w, cells(p), al, cfg, tags=t)

    def dense(p, a, w, al, t):
        bins = build_bins(cells(p), al, cfg.grid.num_cells,
                          cfg.cell_capacity, list_width=width)
        ids = jnp.arange(p.shape[0], dtype=jnp.int32)
        return neighbor_pass(p, a, w, ids, bins.cell_list, (g, g, g), cfg,
                             okeys=collision_okey(t))

    args = (st.pos, st.age, st.w, st.alive, st.tag)
    out = {"blocks_pass": _median_ms(jax.jit(blocks), *args, reps=reps + 1),
           "dense_pass": _median_ms(jax.jit(dense), *args, reps=reps + 1),
           "dense_width": width or cfg.cell_capacity,
           "rows": int(st.pos.shape[0])}
    out["blocks_frame_stages"] = sim.profile_frame(reps=reps + 1)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", nargs="*", default=["1M", "10M"])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--warm", type=int, default=20)
    args = ap.parse_args()
    use_compile_cache()
    if shutil.which("nvidia-smi"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    dev = jax.devices()[0]
    for size in args.sizes:
        n_fill, grid_dim = SIZES[size]
        cfg = NBodyConfig(n_fill=n_fill, grid=GridSpec(grid_dim=grid_dim))
        sims, saved = {}, {}
        for impl in ("blocks", "dense"):
            sim = NBodySimulation(cfg, impl=impl)
            sim.run(args.warm)
            saved[impl] = (sim.state, sim.frame, sim._active, sim._width)
            sim.run(10)  # compiles the program the timed window runs
            sims[impl] = sim
        samples = {"blocks": [], "dense": []}
        alive = {}
        order = ["blocks", "dense", "dense", "blocks"] * args.reps
        for impl in order[: 2 * args.reps]:
            sim = sims[impl]
            sim.state, sim.frame, sim._active, sim._width = saved[impl]
            jax.block_until_ready(sim.state.pos)
            t0 = time.perf_counter()
            stats = sim.run(10)
            jax.block_until_ready(sim.state.pos)
            samples[impl].append((time.perf_counter() - t0) / 10 * 1e3)
            alive[impl] = int(stats.n_alive)
        passes = time_passes(cfg, sims, saved, args.reps)
        print(json.dumps({
            "size": size, "device": dev.device_kind, "passes_ms": passes,
            "frames": [args.warm, args.warm + 10],
            "alive": alive,
            "ms_per_frame": {k: float(np.median(v)) for k, v in
                             samples.items()},
            "samples_ms": samples}), flush=True)
        del sims, saved


if __name__ == "__main__":
    main()

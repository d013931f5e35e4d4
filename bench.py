"""Benchmark: particle-steps/sec/chip on the fused emitter-scene step.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

``vs_baseline`` is value/1e10 (BASELINE.json's ``north_star`` target).

Scene = BASELINE config 5 shape: multi-emitter, full force stack
(gravity + wind + drag), ground plane + sphere collider, on-device ring
recycling.  All slots start alive so the metric counts real particle
updates.

Measurement method: frames run in device-side ``fori_loop`` batches
(``step_many``) and sync via a tiny host readback; per-frame time is the
slope between a short and a long batch, which cancels the fixed
dispatch/sync cost of each measurement.

Every stage runs in a child process and the parent never touches JAX, so
each child has the GPU to itself.  The run fails unless the device is a GPU.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from particlesystem_tpu.core.config import (Emitter, EmitterSceneConfig,
                                            PlaneCollider, SphereCollider)
from particlesystem_tpu.runtime.engine import PackedEngine

BASELINE_TARGET = 1e10  # particle-steps/sec/chip (BASELINE.json north star)


def scene(capacity: int) -> EmitterSceneConfig:
    return EmitterSceneConfig(
        capacity=capacity,
        dt=1.0 / 60.0,
        gravity=(0.0, -9.8, 0.0),
        wind=(2.0, 0.0, -0.5),
        drag=0.2,
        emitters=(
            Emitter(pos=(0.0, 1.0, 0.0), direction=(0.0, 1.0, 0.0),
                    speed=10.0, rate=60_000.0, life_min=20.0, life_max=40.0),
            Emitter(pos=(5.0, 1.0, 0.0), direction=(-0.2, 1.0, 0.1),
                    speed=8.0, rate=40_000.0, life_min=20.0, life_max=40.0),
        ),
        planes=(PlaneCollider(point=(0, 0, 0), normal=(0, 1, 0),
                              restitution=0.5, friction=0.2),),
        spheres=(SphereCollider(center=(2.0, 3.0, 0.0), radius=1.5,
                                restitution=0.4, friction=0.1),),
        seed=1,
    )


def full_packed(cfg, key):
    """All slots alive with long lifetimes: the metric counts real updates."""
    n = cfg.slots
    ks = jax.random.split(key, 3)
    pos = jax.random.uniform(ks[0], (3, n), jnp.float32, -20.0, 20.0)
    vel = jax.random.uniform(ks[1], (3, n), jnp.float32, -5.0, 5.0)
    life = jax.random.uniform(ks[2], (n,), jnp.float32, 30.0, 60.0)
    age = life * 0.1
    return (pos[0], pos[1], pos[2], vel[0], vel[1], vel[2], age, life)


def _sync(es) -> float:
    return float(jnp.sum(es.fields[0][:8]))


def bench_capacity(capacity: int, k_short: int = 16, k_long: int = 112,
                   reps: int = 5, soak: int = 0):
    cfg = scene(capacity)
    # alloc='select': spawn as a broadcast-select fused into the physics
    # pass over natively-2D state (runtime/engine.py)
    eng = PackedEngine(cfg,
                       alloc=os.environ.get("PS_BENCH_ALLOC", "select"),
                       layout=os.environ.get("PS_BENCH_LAYOUT", "packed8"))
    es = eng.init(full_packed(cfg, jax.random.key(0)))

    # compile both batch sizes
    es = eng.step_many(es, k_short)
    es = eng.step_many(es, k_long)
    _sync(es)
    # heat soak: hold the device busy before measuring so the captured
    # number reflects the sustained-load clock
    for _ in range(soak):
        es = eng.step_many(es, k_long)
    if soak:
        _sync(es)

    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        es = eng.step_many(es, k_short)
        _sync(es)
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        es = eng.step_many(es, k_long)
        _sync(es)
        t_long = time.perf_counter() - t0
        samples.append((t_long - t_short) / (k_long - k_short))
    per_frame = float(np.median(samples))
    assert per_frame > 0, samples
    alive = int(eng.alive_count(es))
    return cfg.slots / per_frame, per_frame * 1e3, alive


def bench_nbody_warm(n_fill: int, grid_dim: int, frames: int, path: str):
    """Phase 1 of the two-process n-body bench: run the initial-collapse
    frames through the production driver and checkpoint the plateau
    state.  The measuring process reloads it and re-picks the
    plateau-sized active prefix."""
    from particlesystem_tpu.api import NBodySimulation
    from particlesystem_tpu.core.config import GridSpec, NBodyConfig

    cfg = NBodyConfig(n_fill=n_fill, grid=GridSpec(grid_dim=grid_dim))
    sim = NBodySimulation(cfg, impl="blocks")
    sim.run(frames)
    sim.save(path)
    return (sim._active or cfg.slots, int(sim.last_stats.n_alive), sim.frame)


def bench_nbody(n_fill: int = 1 << 20, grid_dim: int = 16,
                k: int = 2, d_short: int = 1, d_long: int = 2,
                reps: int = 3, ckpt: str = ""):
    """The reference simulation (cluster-pair kernel) — per-frame time by
    dispatch-count slope, the same method ``bench_capacity`` uses: the
    slope between ``d_short`` and ``d_long`` back-to-back dispatches of
    ONE (k+1)-frame loop program (one sync at the end) cancels the fixed
    per-measurement cost.  With ``ckpt`` (the two-process flow, see
    ``bench_nbody_warm``) the prefix is re-picked from the loaded plateau
    population exactly as ``NBodySimulation.run`` does after a load;
    without it the prefix is sized from the fill count (init_fill is
    already compacted)."""
    from particlesystem_tpu.api import NBodySimulation
    from particlesystem_tpu.core.config import GridSpec, NBodyConfig
    from particlesystem_tpu.models import nbody

    cfg = NBodyConfig(n_fill=n_fill, grid=GridSpec(grid_dim=grid_dim))
    if ckpt:
        sim = NBodySimulation(cfg, impl="blocks")
        sim.load(ckpt)
        # load() defers the prefix pick to run(), which this bench
        # bypasses — mirror it here so the plateau measurement never
        # silently runs at full slot width
        state = jax.jit(nbody.compact_state)(sim.state)
        alive = int(np.asarray(state.alive).sum())
        frame0, active = sim.frame, nbody.pick_active(cfg, alive)
    else:
        state = nbody.init_fill(cfg)
        frame0 = 0
        # THE production sizing rule (init_fill is already compacted)
        active = nbody.pick_active(cfg, n_fill)
    print(f"n-body {n_fill}: active prefix "
          f"{active or cfg.slots}/{cfg.slots} from frame {frame0}",
          file=sys.stderr)

    def body(i, carry):
        s, _, mc, mt = carry
        s2, st = nbody.step(s, i, cfg, 0, "blocks", active)
        # accumulate the bit-exactness guards across EVERY frame: spawn
        # capping is transient (deaths free slots and later frames read
        # 0 again), so sampling only the final frame's stats would let a
        # mid-measurement contract violation pass silently
        return (s2, st, jnp.maximum(mc, st.n_spawn_capped),
                jnp.maximum(mt, st.n_tail_alive))

    def _loop(s, f0, mc, mt):
        s1, st1 = nbody.step(s, f0 - 1, cfg, 0, "blocks", active)
        init = (s1, st1, jnp.maximum(mc, st1.n_spawn_capped),
                jnp.maximum(mt, st1.n_tail_alive))
        return jax.lax.fori_loop(f0, f0 + k, body, init)

    loop = jax.jit(_loop)

    def run_d(s, frame, d, mc, mt):
        """d back-to-back dispatches of the (k+1)-frame loop, one sync."""
        for _ in range(d):
            s, st, mc, mt = loop(s, jnp.int32(frame + 1), mc, mt)
            frame += k + 1
        int(st.n_alive)  # sync
        return s, st, frame, mc, mt

    # Warm: compile + settle.  The whole measurement stays INSIDE the
    # initial-cohort plateau (alive ~0.35*n_fill, frames < ~35 at 1M —
    # the window the reference's own 10-iteration run length lives in,
    # common.h:69; past it the population collapses in expiry waves and
    # per-frame cost is no longer comparable between rounds).
    mc = mt = jnp.int32(0)
    state, stats, frame, mc, mt = run_d(state, frame0, 1 if ckpt else 2,
                                        mc, mt)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, stats, frame, mc, mt = run_d(state, frame, d_short, mc, mt)
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, stats, frame, mc, mt = run_d(state, frame, d_long, mc, mt)
        t_long = time.perf_counter() - t0
        samples.append((t_long - t_short) / ((d_long - d_short) * (k + 1)))
    # bit-exactness contract held on EVERY frame (accumulated maxima): no
    # alive rows beyond the prefix, no spawns capped that full width
    # would have granted
    assert int(mt) == 0, f"tail rows went live mid-measurement ({int(mt)})"
    assert int(mc) == 0, f"spawns capped mid-measurement ({int(mc)})"
    return float(np.median(samples)) * 1e3, int(stats.n_alive)


def bench_nbody_sharded_d1(n_fill: int = 1 << 20, grid_dim: int = 16,
                           k: int = 2, d_short: int = 1, d_long: int = 2,
                           reps: int = 3):
    """The SHARDED n-body path (`make_sharded_step` + the distributed
    driver's batched loop) on one device at ``SlabSpec(n_devices=1,
    impl='blocks')`` — the kernel under ``shard_map``.  Same
    dispatch-count-slope method as :func:`bench_nbody`.  NOT directly
    comparable to the single-chip
    headline: the sharded step has no active-prefix picking, so it runs
    at the full slot width (``x_factor * n_fill`` rows) where the
    single-chip plateau flow runs a ~0.37x-sized prefix — expect the
    sort stages to cost accordingly more."""
    from particlesystem_tpu.core.config import GridSpec, NBodyConfig
    from particlesystem_tpu.parallel.driver import DistributedNBodySimulation
    from particlesystem_tpu.parallel.nbody_sharded import SlabSpec

    cfg = NBodyConfig(n_fill=n_fill, grid=GridSpec(grid_dim=grid_dim))
    sim = DistributedNBodySimulation(cfg, SlabSpec(n_devices=1,
                                                   impl="blocks"))
    loop = sim._loop_fn(k)

    def run_d(s, frame, d):
        for _ in range(d):
            s, st, guards = loop(s, jnp.int32(frame))
            frame += k
        g = np.asarray(guards)  # the ONE host sync
        return s, frame, g

    state, frame, g = run_d(sim.state, 0, 1)  # warm: compile + settle
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, frame, g = run_d(state, frame, d_short)
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, frame, g = run_d(state, frame, d_long)
        t_long = time.perf_counter() - t0
        samples.append((t_long - t_short) / ((d_long - d_short) * k))
    # guard layout: [3 drop sums, n_alive, n_spawned, 2 high-water marks]
    drops = [int(x) for x in g[:3]]
    assert drops == [0, 0, 0], f"sharded d1 run dropped particles: {drops}"
    return float(np.median(samples)) * 1e3, int(g[3])


STAGES = {
    # 1M emitter: heat-soak + dense batches so the captured number reflects
    # the sustained-load clock, median slope over many reps
    "cap_1m": lambda: bench_capacity(1 << 20, k_short=64, k_long=1024,
                                     reps=7, soak=4),
    "cap_10m": lambda: bench_capacity(10 * (1 << 20)),
    "nbody_warm_1m": lambda ckpt: bench_nbody_warm(1 << 20, 16, 3, ckpt),
    "nbody_warm_10m": lambda ckpt: bench_nbody_warm(10 << 20, 32, 3, ckpt),
    "nbody_1m": lambda ckpt="": bench_nbody(ckpt=ckpt),
    "nbody_10m": lambda ckpt="": bench_nbody(n_fill=10 << 20, grid_dim=32,
                                             k=1, reps=2, ckpt=ckpt),
    "nbody_sharded_d1": lambda: bench_nbody_sharded_d1(),
}


def device_info():
    """The device this child sees: (platform, device_kind, count)."""
    d = jax.devices()
    return d[0].platform, d[0].device_kind, len(d)


STAGES["device"] = device_info


def run_stage(name: str, args):
    from particlesystem_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"bench needs a GPU; JAX found {platform!r}")
    r = STAGES[name](*args)
    print("RESULT " + json.dumps(list(r)), flush=True)


def _stage_in_subprocess(name: str, *args: str, budget: float | None = None):
    """One bench stage per process (the parent never touches JAX, so each
    child has the device to itself): each measurement gets an isolated,
    minimal compile set, and ``budget`` bounds it — wall-clock seconds for
    the stage; on expiry the subprocess is killed and RuntimeError raised,
    so one slow stage cannot forfeit the whole artifact."""
    import subprocess

    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--stage", name,
             *args],
            capture_output=True, text=True, timeout=budget,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"stage {name} exceeded its {budget:.0f}s budget")
    for line in proc.stderr.splitlines():
        if "WARNING" not in line:
            print(line, file=sys.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"stage {name} failed:\n{proc.stderr[-3000:]}")
    out = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    return json.loads(out[-1][7:])


def _nbody_two_phase(size: str, ckpt_dir: str, budget: float):
    """Warm to the plateau + checkpoint in one process, measure from the
    reloaded (re-bucketed) state in a fresh one.  Falls back to the
    single-process from-init measurement if either phase fails, and says
    WHICH flow produced the number (third return value, published in the
    bench JSON) — a from-init fallback runs at the fill-sized prefix and
    is NOT comparable to the plateau headline.  ``budget`` covers EACH
    subprocess phase (warm / measure / fallback)."""
    ckpt = os.path.join(ckpt_dir, f"nbody_{size}.npz")
    try:
        prefix, alive, frame = _stage_in_subprocess(f"nbody_warm_{size}",
                                                    ckpt, budget=budget)
        print(f"n-body {size} warm: {frame} frames at fill prefix {prefix}, "
              f"alive {alive}, checkpointed", file=sys.stderr)
    except RuntimeError as e:
        print(f"n-body {size} warm phase failed ({e}); falling back to "
              f"from-init measurement", file=sys.stderr)
        return (*_stage_in_subprocess(f"nbody_{size}", budget=budget),
                "from-init")
    try:
        return (*_stage_in_subprocess(f"nbody_{size}", ckpt, budget=budget),
                "plateau")
    except RuntimeError as e:
        print(f"n-body {size} PLATEAU MEASUREMENT FAILED ({e}) — the "
              f"number below is from-init at the fill-sized prefix, NOT "
              f"the plateau flow; investigate before comparing",
              file=sys.stderr)
        return (*_stage_in_subprocess(f"nbody_{size}", budget=budget),
                "from-init-after-measure-failure")


# Wall-clock budget per stage SUBPROCESS, seconds.  The summary line below
# is re-emitted after every stage, so a budget kill costs one stage, not
# the whole artifact.  Scale with PS_BENCH_BUDGET_SCALE for cold-cache
# runs.
_BUDGETS = {
    "cap_10m": 1500.0, "cap_1m": 1500.0,
    "nbody_1m": 2400.0, "nbody_10m": 3600.0,
    "nbody_sharded_d1": 2400.0,
}


def main():
    import tempfile

    backend, kind, count = _stage_in_subprocess("device", budget=600.0)
    print(f"device: {backend} {kind} x{count}", file=sys.stderr)

    scale = float(os.environ.get("PS_BENCH_BUDGET_SCALE", "1.0"))
    budgets = {k: v * scale for k, v in _BUDGETS.items()}

    # Every value starts explicit-null and the full summary line is
    # re-emitted after EVERY stage (stdout, latest line wins): a timeout
    # or crash in any later stage still leaves a parseable artifact with
    # the completed stages' numbers and the skip reasons.
    res = {
        "metric": "particle_steps_per_sec_at_10M",
        "value": None,
        "unit": "particle-steps/s/chip",
        "vs_baseline": None,
        "p50_frame_ms_10M": None,
        "particle_steps_per_sec_at_1M": None,
        "p50_frame_ms_1M": None,
        "nbody_1M_ms_per_frame": None,
        "nbody_1M_flow": None,
        "nbody_10M_ms_per_frame": None,
        "nbody_10M_flow": None,
        "nbody_1M_sharded_d1_ms": None,
        "skipped": {},
        "backend": backend,
    }

    def emit():
        print(json.dumps(res), flush=True)

    emit()
    try:
        rate_10m, p50_10m, alive_10m = _stage_in_subprocess(
            "cap_10m", budget=budgets["cap_10m"])
        print(f"10M: {rate_10m:.3e} particle-steps/s  p50 {p50_10m:.3f} ms "
              f"(alive {alive_10m})", file=sys.stderr)
        res["value"] = round(rate_10m, 1)
        res["vs_baseline"] = round(rate_10m / BASELINE_TARGET, 4)
        res["p50_frame_ms_10M"] = round(p50_10m, 4)
    except RuntimeError as e:
        res["skipped"]["cap_10m"] = str(e)[:300]
    emit()
    try:
        rate_1m, p50_1m, alive_1m = _stage_in_subprocess(
            "cap_1m", budget=budgets["cap_1m"])
        print(f"1M:  {rate_1m:.3e} particle-steps/s  p50 {p50_1m:.3f} ms "
              f"(alive {alive_1m})", file=sys.stderr)
        res["particle_steps_per_sec_at_1M"] = round(rate_1m, 1)
        res["p50_frame_ms_1M"] = round(p50_1m, 4)
    except RuntimeError as e:
        res["skipped"]["cap_1m"] = str(e)[:300]
    emit()
    with tempfile.TemporaryDirectory() as td:
        try:
            nbody_ms, nbody_alive, nbody_flow = _nbody_two_phase(
                "1m", td, budgets["nbody_1m"])
            print(f"n-body 1M (reference sim): {nbody_ms:.0f} ms/frame "
                  f"(alive {nbody_alive}, {nbody_flow})", file=sys.stderr)
            res["nbody_1M_ms_per_frame"] = round(nbody_ms, 1)
            res["nbody_1M_flow"] = nbody_flow
        except RuntimeError as e:
            res["skipped"]["nbody_1m"] = str(e)[:300]
        emit()
        try:
            sharded_ms, sharded_alive = _stage_in_subprocess(
                "nbody_sharded_d1", budget=budgets["nbody_sharded_d1"])
            print(f"n-body 1M SHARDED d=1 (make_sharded_step on chip): "
                  f"{sharded_ms:.0f} ms/frame (alive {sharded_alive})",
                  file=sys.stderr)
            res["nbody_1M_sharded_d1_ms"] = round(sharded_ms, 1)
        except RuntimeError as e:
            res["skipped"]["nbody_sharded_d1"] = str(e)[:300]
        emit()
        try:
            nbody10_ms, nbody10_alive, nbody10_flow = _nbody_two_phase(
                "10m", td, budgets["nbody_10m"])
            print(f"n-body 10M/32^3: {nbody10_ms:.0f} ms/frame "
                  f"(alive {nbody10_alive}, {nbody10_flow})", file=sys.stderr)
            res["nbody_10M_ms_per_frame"] = round(nbody10_ms, 1)
            res["nbody_10M_flow"] = nbody10_flow
        except RuntimeError as e:
            res["skipped"]["nbody_10m"] = str(e)[:300]
    emit()


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--stage":
        run_stage(sys.argv[2], sys.argv[3:])
    else:
        main()

"""Smoke run of the n-body and emitter paths on one GPU.

    python chip_smoke.py            # one card: phases (a)-(f) below
    python chip_smoke.py --multi    # four cards: phase (g) only

Drives the user entry points at full size (``NBodySimulation``, the
``python -m particlesystem_tpu nbody`` CLI, ``DistributedNBodySimulation``,
``ParticleSystem``/``PackedEngine``) and checks what they produce:

(a) the device is a GPU (there is no CPU fallback);
(b) the cluster-pair kernel against the dense XLA pass on the same prepared
    state, at 1M/16^3 and 10M/32^3 after warm frames: collision and overflow
    flags and the max cell occupancy exactly, accelerations within
    ``ACC_TOL`` of the largest one;
(c) the compiled step holds the kernel as a Triton custom call;
(d) ``NBodySimulation.validate()`` against the numpy oracle (at
    ``ORACLE_FILL``: the per-particle Python oracle takes tens of minutes
    per frame at 1M);
(e) the slab-sharded step at d=1 against the single-card run;
(f) the 10M emitter scene through ``ParticleSystem`` (health) and a window
    of ``PackedEngine`` at 1M against ``cpu_ref/oracle_emitter.py``;
(g) ``--multi``: slab d=4 and pencil 2x2 at 1M/16^3 against the
    single-card run, frame by frame from the same state (alive sets and
    event counts exactly), with the drift of a free run reported beside
    it; and sharded ``validate()`` at an eighth of ``ORACLE_FILL``.

Every phase prints one line with its numbers, its wall time and the compile
time inside it.  Any failure raises; the last line, printed only when every
phase passed, is ``{"ok": true, "device": {...}}``.  ``--rehearse`` runs the
same control flow at tiny sizes on any backend (for checking the script
without a GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

# accelerations: kernel vs dense differ only in float32 summation order and
# in rs^3 vs 1/sqrt(dd^3); 1e-5 of the largest |acc| is the CPU tests'
# bound and ~50x what the card measured (2e-7 at 1M and 10M)
ACC_TOL = 1e-5
# positions after a few frames when the same particles are summed in
# another order (other slot layout, other device count): one-ulp force
# differences integrate into position differences far below this
POS_TOL = 1e-3
ORACLE_FILL = 1 << 16
COMPARE_FRAMES = 5
# lifecycle counters the sharded step must reproduce frame by frame
EVENT_KEYS = ("n_alive", "n_age_deaths", "n_collision_kills",
              "n_overflow_kills", "n_survivals", "n_spawned")


def log(name: str, **fields) -> None:
    print(f"[{name}] " + json.dumps(fields, default=str), flush=True)


class CompileClock:
    """Seconds XLA spent compiling (backend compiles, cache loads included)
    inside each ``phase()``."""

    EVENTS = ("/jax/core/compile/backend_compile_duration",)

    def __init__(self, jax):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration

    def phase(self):
        return _Phase(self)


class _Phase:
    def __init__(self, clock):
        self.clock = clock

    def __enter__(self):
        self.t0, self.c0 = time.perf_counter(), self.clock.total
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self.t0
        self.compile_s = self.clock.total - self.c0
        return False

    def times(self):
        return dict(wall_s=round(self.wall_s, 3),
                    compile_s=round(self.compile_s, 3))


def gpu_line() -> str:
    if not shutil.which("nvidia-smi"):
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or out.stderr.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# n-body helpers
# ---------------------------------------------------------------------------


def kernel_vs_dense(cfg, state, tag: str, clock) -> dict:
    """(b) + (c): the cluster-pair pass and the dense pass on one state."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from particlesystem_tpu.ops import neighbor_blocks as nbk
    from particlesystem_tpu.ops.grid import (build_bins, coords_to_cell,
                                             wrap_positions)
    from particlesystem_tpu.ops.neighbor import collision_okey, neighbor_pass

    g = cfg.grid.grid_dim

    def cells(p):
        return coords_to_cell(wrap_positions(p, cfg.grid)[1], cfg.grid)

    def blocks(p, a, w, al, t):
        return nbk.neighbor_pass_blocks(p, a, w, cells(p), al, cfg, tags=t)

    def dense(p, a, w, al, t):
        bins = build_bins(cells(p), al, cfg.grid.num_cells,
                          cfg.cell_capacity)
        ids = jnp.arange(p.shape[0], dtype=jnp.int32)
        acc, kill, touch = neighbor_pass(p, a, w, ids, bins.cell_list,
                                         (g, g, g), cfg,
                                         okeys=collision_okey(t))
        return (acc, kill, touch, bins.overflow, bins.max_cell_occupancy,
                bins.n_listed_dropped)

    args = (state.pos, state.age, state.w, state.alive, state.tag)
    with clock.phase() as ph:
        fb = jax.jit(blocks)
        lowered = fb.lower(*args)
        compiled_text = lowered.compile().as_text()
        got = jax.block_until_ready(fb(*args))
        want = jax.block_until_ready(jax.jit(dense)(*args))
    acc_b, kill_b, touch_b, ovf_b, occ_b, _ = map(np.asarray, got)
    acc_d, kill_d, touch_d, ovf_d, occ_d, dropped_d = map(np.asarray, want)
    scale = max(1.0, float(np.abs(acc_d).max()))
    rep = dict(
        rows=int(state.pos.shape[0]), alive=int(np.asarray(state.alive).sum()),
        kill_equal=bool((kill_b == kill_d).all()),
        touch_equal=bool((touch_b == touch_d).all()),
        overflow_equal=bool((ovf_b == ovf_d).all()),
        max_cell_occupancy=[int(occ_b), int(occ_d)],
        dense_list_dropped=int(dropped_d),
        kills=int(kill_d.sum()), touches=int(touch_d.sum()),
        acc_err_over_max=float(np.abs(acc_b - acc_d).max() / scale),
        acc_tol=ACC_TOL,
        triton_call=("__gpu$xla.gpu.triton" in lowered.as_text()),
        compiled_triton="triton" in compiled_text.lower(),
        interpret=nbk._interpret(), **ph.times())
    log(f"b/c kernel-vs-dense {tag}", **rep)
    check(rep["kill_equal"] and rep["touch_equal"] and rep["overflow_equal"],
          f"{tag}: kernel flags differ from the dense pass")
    check(occ_b == occ_d, f"{tag}: max cell occupancy differs")
    check(int(dropped_d) == 0, f"{tag}: dense reference truncated lists")
    check(rep["acc_err_over_max"] <= ACC_TOL, f"{tag}: acc error too large")
    if jax.default_backend() == "gpu":
        check(rep["triton_call"] and rep["compiled_triton"],
              f"{tag}: no Triton kernel in the compiled step")
        check(not rep["interpret"], f"{tag}: kernel interpreted")
    return rep


def nbody_runs(cfg, tag: str, runs: int, clock):
    """Main path: ``NBodySimulation.run(10)`` ``runs`` times."""
    from particlesystem_tpu.api import NBodySimulation

    sim = NBodySimulation(cfg)
    for i in range(runs):
        with clock.phase() as ph:
            stats = sim.run(10)
            alive = int(stats.n_alive)
        log(f"nbody {tag} run(10) #{i}", frame=sim.frame, alive=alive,
            n_listed_dropped=int(stats.n_listed_dropped),
            degraded=sim.n_degraded_frames, active=sim._active or sim.cfg.slots,
            max_cell_occupancy=int(stats.max_cell_occupancy), **ph.times())
        check(alive > 0, f"{tag}: population died out")
        check(int(stats.n_listed_dropped) == 0 and not sim.n_degraded_frames,
              f"{tag}: neighbor entries dropped")
    return sim


def active_state(sim):
    import jax
    if sim._active:
        return jax.tree.map(lambda a: a[:sim._active], sim.state)
    return sim.state


def alive_by_tag(state):
    """(tags, pos) of the alive rows on the host, sorted by tag.  Tags are
    32-bit and a child's tag can equal a living particle's (a few per frame
    at 1M); age and life, which no summation order changes, pair such rows
    up the same way in both runs."""
    import numpy as np
    alive = np.asarray(state.alive)
    tags = np.asarray(state.tag)[alive]
    order = np.lexsort((np.asarray(state.life)[alive],
                        np.asarray(state.age)[alive], tags))
    return tags[order], np.asarray(state.pos)[alive][order]


def divergence(ref_state, got_state) -> dict:
    """How far two runs of one configuration drifted apart: particles alive
    in only one of them (as multisets of tags), and the largest position
    difference of those alive in both whose tag no other particle shares."""
    import numpy as np
    t_ref, p_ref = alive_by_tag(ref_state)
    t_got, p_got = alive_by_tag(got_state)
    u_ref, c_ref = np.unique(t_ref, return_counts=True)
    u_got, c_got = np.unique(t_got, return_counts=True)
    tags = np.union1d(u_ref, u_got)
    n_ref = np.zeros(len(tags), np.int64)
    n_got = np.zeros(len(tags), np.int64)
    n_ref[np.searchsorted(tags, u_ref)] = c_ref
    n_got[np.searchsorted(tags, u_got)] = c_got
    once = tags[(n_ref == 1) & (n_got == 1)]
    dev = np.abs(p_ref[np.searchsorted(t_ref, once)]
                 - p_got[np.searchsorted(t_got, once)]).max(axis=1)
    return dict(alive_ref=len(t_ref), alive=len(t_got),
                only_in_one=int(np.abs(n_ref - n_got).sum()),
                max_position_deviation=float(dev.max(initial=0.0)),
                beyond_pos_tol=int((dev > POS_TOL).sum()))


def compare_runs(tag: str, ref_state, got_state, **extra) -> None:
    """Same alive set (by persistent tag) and positions within POS_TOL."""
    import numpy as np
    t_ref, p_ref = alive_by_tag(ref_state)
    t_got, p_got = alive_by_tag(got_state)
    same = t_ref.shape == t_got.shape and bool((t_ref == t_got).all())
    dev = (np.abs(p_ref - p_got).max(axis=1) if same and len(t_ref)
           else np.zeros(0))
    rep = dict(alive_ref=len(t_ref), alive=len(t_got), same_alive_set=same,
               max_position_deviation=float(dev.max(initial=0.0)),
               beyond_pos_tol=int((dev > POS_TOL).sum()), pos_tol=POS_TOL)
    log(tag, **rep, **extra)
    check(same, f"{tag}: alive sets differ")
    check(rep["beyond_pos_tol"] == 0, f"{tag}: positions differ")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def single_card(sizes, clock) -> None:
    import jax
    import numpy as np

    from particlesystem_tpu import __main__ as cli
    from particlesystem_tpu.api import NBodySimulation
    from particlesystem_tpu.core.config import GridSpec, NBodyConfig
    from particlesystem_tpu.parallel.driver import DistributedNBodySimulation
    from particlesystem_tpu.parallel.nbody_sharded import SlabSpec

    n1, g1, n10, g10, n_or = sizes
    cfg1 = NBodyConfig(n_fill=n1, grid=GridSpec(grid_dim=g1))
    cfg10 = NBodyConfig(n_fill=n10, grid=GridSpec(grid_dim=g10))

    # main path at 1M/16^3 (the reference's design scale and run length)
    sim1 = nbody_runs(cfg1, "1M", 2, clock)
    kernel_vs_dense(cfg1, active_state(sim1), "1M", clock)
    del sim1

    # the CLI, in this process (a second process could not get the card)
    with clock.phase() as ph:
        cli.main(["nbody", "--particles", str(n1), "--grid-dim", str(g1),
                  "--iterations", "10"])
    log("cli nbody 1M", **ph.times())

    # 10M/32^3 for a few batches
    sim10 = nbody_runs(cfg10, "10M", 3, clock)
    kernel_vs_dense(cfg10, active_state(sim10), "10M", clock)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log("memory", peak_bytes_in_use=peak)
    del sim10

    # (d) the oracle
    cfg_or = NBodyConfig(n_fill=n_or, grid=GridSpec(grid_dim=g1))
    sim = NBodySimulation(cfg_or)
    with clock.phase() as ph:
        sim.run(10)
        rep = sim.validate()
    log("d oracle", n_fill=n_or, frame=sim.frame, alive=int(
        sim.last_stats.n_alive), pos_tol=POS_TOL, **rep, **ph.times())
    check(rep["events_match"], "oracle: lifecycle events differ")
    check(rep["max_position_deviation"] <= POS_TOL, "oracle: positions")

    # (e) slab-sharded step at d=1 against the single-card run
    ref = NBodySimulation(cfg1)
    with clock.phase() as ph:
        ref.run(COMPARE_FRAMES)
        dist = DistributedNBodySimulation(
            cfg1, SlabSpec(n_devices=1, impl="blocks"))
        stats = dist.run(COMPARE_FRAMES)
    drops = {k: stats[k] for k in dist._SUM_KEYS}
    compare_runs("e sharded d=1", ref.state, dist.gather(),
                 frames=COMPARE_FRAMES, drops=drops, **ph.times())
    check(not any(drops.values()), "sharded d=1 drops")
    del ref, dist
    emitter(sizes, clock)


def emitter(sizes, clock) -> None:
    """(f) the 10M scene through ParticleSystem; 1M engine vs the oracle."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from particlesystem_tpu.api import ParticleSystem
    from particlesystem_tpu.core.state import pack_state, zero_state
    from particlesystem_tpu.cpu_ref import oracle_emitter
    from particlesystem_tpu.models import emitter as em
    from particlesystem_tpu.runtime.engine import PackedEngine

    n_big, n_small = sizes[2], sizes[0]
    cfg = bench.scene(n_big)
    ps = ParticleSystem(capacity=cfg.capacity, dt=cfg.dt,
                        gravity=cfg.gravity, wind=cfg.wind, drag=cfg.drag,
                        seed=cfg.seed)
    for e in cfg.emitters:
        ps.add_emitter(**dataclasses.asdict(e))
    for p in cfg.planes:
        ps.add_plane(**dataclasses.asdict(p))
    for s in cfg.spheres:
        ps.add_sphere(**dataclasses.asdict(s))
    with clock.phase() as ph:
        ps.step(120)
        packed = np.asarray(ps.packed())
    alive = ps.alive_mask()
    y = packed[1][alive]
    rep = dict(slots=ps.config.slots, frames=ps.frame, alive=int(alive.sum()),
               finite=bool(np.isfinite(packed).all()),
               min_alive_y=float(y.min()) if y.size else None)
    log("f emitter 10M health", **rep, **ph.times())
    check(rep["finite"], "emitter: non-finite state")
    check(0 < rep["alive"] <= ps.config.slots, "emitter: alive count")
    check(rep["min_alive_y"] >= 0.0, "emitter: particle below the plane")
    del ps, packed

    # a window of the engine at 1M against the numpy oracle
    cfg = bench.scene(n_small)
    n = cfg.slots
    k = jax.random.split(jax.random.key(3), 4)
    life = jax.random.uniform(k[2], (n,), jnp.float32, 1.0, 3.0)
    life = jnp.where(jax.random.uniform(k[3], (n,)) < 0.3, 0.0, life)
    state = dataclasses.replace(
        zero_state(n),
        pos=jax.random.uniform(k[0], (n, 3), jnp.float32, 0.0, 10.0),
        vel=jax.random.uniform(k[1], (n, 3), jnp.float32, -5.0, 5.0),
        age=life * 0.5, life=life, alive=life > 0)
    eng = PackedEngine(cfg, alloc="exact", refresh_interval=1)
    es = eng.init(pack_state(state))
    ora = oracle_emitter.NpState.from_jax(state)
    accum = jnp.zeros((len(cfg.emitters),), jnp.float32)
    spawn_fn = jax.jit(lambda a, f: em.spawn_fields(cfg, f, a))
    worst = 0.0
    with clock.phase() as ph:
        for frame in range(30):
            es = eng.step(es)
            spawn, accum = spawn_fn(accum, jnp.int32(frame))
            ora = oracle_emitter.step(
                ora, np.asarray(spawn.pos), np.asarray(spawn.vel),
                np.asarray(spawn.life), np.asarray(spawn.w),
                np.asarray(spawn.valid), cfg)
            got = np.stack([np.asarray(f) for f in eng.flat_fields(es)])
            want = np.concatenate([ora.pos.T, ora.vel.T, ora.age[None],
                                   ora.life[None]])
            check(bool(((got[6] <= got[7]) & (got[7] > 0) == ora.alive)
                       .all()), f"emitter oracle: alive set, frame {frame}")
            err = np.abs(got - want) / (1e-3 * np.abs(want) + 5e-5)
            worst = max(worst, float(err.max()))
    log("f emitter 1M vs oracle", slots=n, frames=30,
        alive=int(ora.alive.sum()), worst_over_tol=worst,
        tol="rtol 1e-3, atol 5e-5 (tests/test_emitter_parity.py)",
        **ph.times())
    check(worst <= 1.0, "emitter oracle: fields outside tolerance")


def multi(sizes, clock) -> None:
    """(g) slab d=4 and pencil 2x2 against the single-card run.

    Each sharded frame starts from the single-card state of that frame
    (lockstep): from identical positions every contact test sees the same
    distances, so the events must match exactly and only the float32
    summation order of the forces differs.  A free run over the same frames
    is reported beside it: there a one-ulp position difference can flip a
    contact near the collision radius, so its divergence is measured, not
    bounded."""
    import jax

    from particlesystem_tpu.api import NBodySimulation
    from particlesystem_tpu.core.config import GridSpec, NBodyConfig
    from particlesystem_tpu.models.nbody import init_fill
    from particlesystem_tpu.parallel.driver import DistributedNBodySimulation
    from particlesystem_tpu.parallel.nbody_pencil import PencilSpec
    from particlesystem_tpu.parallel.nbody_sharded import SlabSpec

    n1, g1, _, _, n_or = sizes
    check(len(jax.devices()) >= 4, "--multi needs four devices")
    cfg = NBodyConfig(n_fill=n1, grid=GridSpec(grid_dim=g1))
    # one program for every frame: the active prefix is bit-identical to
    # the full width, and each re-bucket would cost a compile here
    ref = NBodySimulation(cfg, active_bucketing=False)
    states, ref_stats = [ref.state], []
    with clock.phase() as ph:
        for _ in range(COMPARE_FRAMES):
            ref_stats.append(ref.run(1))
            states.append(ref.state)
    log("g single-card reference", frames=COMPARE_FRAMES,
        alive=int(ref.last_stats.n_alive), **ph.times())
    # which particle a full cell kills follows slot order, and sharded
    # runs place children in other slots than the oracle: a cell cap that
    # never overflows keeps the comparison to what placement cannot change
    cfg_or = NBodyConfig(n_fill=n_or // 8, grid=GridSpec(grid_dim=g1),
                         max_per_cell=128)
    for name, spec in (("slab d=4", SlabSpec(n_devices=4, impl="blocks")),
                       ("pencil 2x2", PencilSpec(d3=2, d1=2,
                                                 impl="blocks"))):
        dist = DistributedNBodySimulation(cfg, spec)
        with clock.phase() as ph:
            for f in range(COMPARE_FRAMES):
                dist.state = dist._shard_state(
                    dist._distribute(states[f], cfg, dist.spec)[0])
                dist.frame = f
                stats = dist.run(1)
                want = ref_stats[f]
                counts = {k: [stats[k], int(getattr(want, k))]
                          for k in EVENT_KEYS}
                drops = {k: stats[k] for k in dist._SUM_KEYS}
                compare_runs(f"g {name} lockstep frame {f + 1}",
                             states[f + 1], dist.gather(), counts=counts,
                             drops=drops)
                check(all(a == b for a, b in counts.values()),
                      f"{name}: event counts differ at frame {f + 1}")
                check(not any(drops.values()), f"{name}: drops")
        log(f"g {name} lockstep", frames=COMPARE_FRAMES, **ph.times())
        dist.state = dist._shard_state(
            dist._distribute(init_fill(cfg), cfg, dist.spec)[0])
        dist.frame = 0
        for _ in range(COMPARE_FRAMES):
            dist.run(1)
        log(f"g {name} free run", **divergence(ref.state, dist.gather()),
            frames=COMPARE_FRAMES)
        with clock.phase() as ph:
            small = DistributedNBodySimulation(cfg_or, spec)
            val = small.validate(frames=COMPARE_FRAMES)
        log(f"g {name} validate", n_fill=cfg_or.n_fill, **val,
            pos_tol=POS_TOL, **ph.times())
        check(val["events_match"], f"{name}: oracle events differ")
        check(val["max_row_deviation"] <= POS_TOL, f"{name}: oracle rows")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase (g)")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any backend (script control flow)")
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import jax

    from particlesystem_tpu.utils.compile_cache import use_compile_cache

    cache = use_compile_cache()
    devs = jax.devices()
    platform, kind = devs[0].platform, devs[0].device_kind
    log("a device", platform=platform, kind=kind, count=len(devs),
        XLA_FLAGS=os.environ.get("XLA_FLAGS"), compile_cache=cache)
    if platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (JAX found {platform!r})", file=sys.stderr)
        return 1
    print(gpu_line(), flush=True)

    sizes = ((1 << 20, 16, 10 << 20, 32, ORACLE_FILL) if not args.rehearse
             else (4096, 8, 16384, 8, 2048))
    clock = CompileClock(jax)
    with clock.phase() as ph:
        (multi if args.multi else single_card)(sizes, clock)
    log("total", **ph.times())
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

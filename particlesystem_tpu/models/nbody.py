"""The reference particle simulation as one jitted step.

One pure jitted step reproduces the semantics of the reference's per-frame
pipeline (``/root/reference/source/code/src/particleSystem.cpp``):

    INIT_IFRAME (:1574)  -> implicit: bins are rebuilt functionally
    BUILD_GRID  (:1468)  -> sort-based binning + cell-overflow kill
    CALC_FORCES (:1120)  -> age death, pairwise collision kill/survive,
                            softened gravity over the 27-cell stencil,
                            clamped Euler integration, torus wrap, aging,
                            explosion reproduction
    seg_fault migration (:1336-1374) -> not needed: flat slot space

Semantic redesigns (deterministic, order-independent — the reference's GPU
path depends on warp-lock timing and its host RNG is nondeterministic):

* Collision resolution (``bodyBodyCollision``, ``app_common.cu:269-301``)
  becomes a reduction: a particle is KILLED if any colliding neighbor has a
  larger order key, SURVIVES (age/velocity reset) if it collides only with
  smaller-or-equal keys.  This is exactly the fixed point of the
  reference's scan (flag 2 dominates and breaks the loop), now order-free.
  The key is ``collision_okey`` of the persistent particle TAG
  (``ops/neighbor.py``) — any total order satisfies the reference's
  larger-id-survives rule, and the tag order is placement-independent, so
  kill/survive decisions are identical across device counts and slot
  compactions.
* Free-slot allocation: ascending dead slots meet ascending requests
  (``ops/compact.py``) instead of per-segment FIFO queues; like the
  reference, ids freed this frame are immediately reusable and spawn
  requests beyond capacity are dropped.
* Neighbor reads use the previous frame's state (the ``T_DATA_TYPE``
  snapshot, ``common.h:122-132``) — automatic here because the step is pure.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.config import NBodyConfig
from ..core.state import ParticleState, zero_state
from ..ops.grid import (build_bins, chunk_occupancy, coords_to_cell,
                        wrap_positions)
from ..ops.neighbor import collision_okey, neighbor_pass


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NBodyStats:
    """Per-frame statistics; all stay on device (the reference syncs
    ``gridmax`` back to the host every frame, ``particleSystem.cpp:1900``)."""

    n_alive: jax.Array
    n_age_deaths: jax.Array
    n_collision_kills: jax.Array
    n_overflow_kills: jax.Array
    n_survivals: jax.Array
    n_spawned: jax.Array
    # children dropped because the operated width ran out of free slots
    # (full width: genuine saturation; active prefix: contract violation)
    n_spawn_capped: jax.Array
    n_listed_dropped: jax.Array
    max_cell_occupancy: jax.Array
    max_chunk_occupancy: jax.Array
    # alive rows beyond the active prefix (step(active=...) misuse guard;
    # always 0 on full-width steps)
    n_tail_alive: jax.Array


def init_fill(cfg: NBodyConfig, n: int | None = None) -> ParticleState:
    """Uniform initial fill — FILL_PARTICLES
    (``particleSystem.cpp:962-1048``): each coordinate is ``sign * r * range``
    with ``r ~ U[0,1)`` and a fair sign; age uniform adult, fertility age
    uniform.  Slots 0..n-1 are used in draw order (the reference scatters ids
    across segment queues; slot numbering is an implementation detail)."""
    n = cfg.n_fill if n is None else n
    if n > cfg.slots:
        raise ValueError(f"n_fill={n} exceeds capacity {cfg.slots}")
    key = rng.frame_key(cfg.seed, jnp.int32(0), rng.FILL)
    kr, ks, ka, kf = jax.random.split(key, 4)
    rrange = cfg.grid.half_extent
    r = jax.random.uniform(kr, (n, 3), jnp.float32)
    sign = jnp.where(jax.random.uniform(ks, (n, 3)) >= 0.5, 1.0, -1.0)
    pos = (sign * r * rrange).astype(jnp.float32)
    age = rng.uniform(ka, (n,), cfg.min_adult_age, cfg.max_adult_age)
    fert = rng.uniform(kf, (n,), cfg.min_fertility_age, cfg.max_fertility_age)

    s = zero_state(cfg.slots)
    pad = cfg.slots - n
    padf = lambda a, k: jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a
    return ParticleState(
        pos=padf(pos, 3), vel=s.vel, acc=s.acc,
        w=padf(jnp.full((n,), cfg.weight, jnp.float32), 1),
        age=padf(age, 1), life=padf(fert, 1),
        alive=padf(jnp.ones((n,), jnp.bool_), 1), parent=s.parent,
        tag=jnp.arange(cfg.slots, dtype=jnp.uint32),
    )


def _neighbor_pass(state: ParticleState, cell_list: jax.Array,
                   cfg: NBodyConfig, batch_cells: int = 64):
    """Collision flags + gravity over the 27-cell stencil (single device:
    self-exclusion ids are slot indices; collision ordering keys on the
    persistent tags).  See ``ops/neighbor.py`` for the core."""
    g = cfg.grid.grid_dim
    ids = jnp.arange(state.slots, dtype=jnp.int32)
    return neighbor_pass(state.pos, state.age, state.w, ids, cell_list,
                         (g, g, g), cfg, batch_cells=batch_cells,
                         okeys=collision_okey(state.tag))


def lifecycle_update(state: ParticleState, pos_w: jax.Array,
                     overflow: jax.Array, acc: jax.Array, kill: jax.Array,
                     touch: jax.Array, uvec: jax.Array, fert: jax.Array,
                     frame: jax.Array, cfg: NBodyConfig):
    """Lifecycle flags + clamped integration + explosion reproduction,
    given the neighbor-pass results.  Shared between the single-chip step
    and the per-device body of the slab-sharded step
    (``parallel/nbody_sharded.py``).  Returns (new_state, counts dict)."""
    grid = cfg.grid
    dt = jnp.float32(cfg.dt)
    n = state.slots
    alive1 = state.alive & ~overflow
    age0 = state.age
    die_age = alive1 & (age0 > cfg.particle_life)
    die_coll = alive1 & ~die_age & kill
    dead_now = die_age | die_coll | overflow
    survive = alive1 & ~die_age & ~die_coll & touch
    normal = alive1 & ~die_age & ~die_coll & ~survive

    # --- integrate (clamped Euler + torus wrap, particleSystem.cpp:1267-1302)
    dx = state.vel * dt + 0.5 * acc * dt * dt
    dx = jnp.clip(dx, -cfg.max_dx, cfg.max_dx)
    newpos, _ = wrap_positions(state.pos + dx, grid)
    v1 = jnp.clip(state.vel + acc * dt, -cfg.max_v, cfg.max_v)
    age1 = age0 + dt

    nm = normal[:, None]
    dm = dead_now[:, None]
    sm = survive[:, None]
    pos = jnp.where(nm, newpos, jnp.where(dm, 0.0, pos_w))
    vel = jnp.where(nm, v1, jnp.where(dm | sm, 0.0, state.vel))
    accf = jnp.where(nm, acc, 0.0)
    age = jnp.where(normal, age1, jnp.where(dead_now | survive, 0.0, age0))
    w = jnp.where(dead_now, 0.0, state.w)
    lifef = jnp.where(dead_now, 0.0, state.life)
    parent = jnp.where(dead_now | survive, False, state.parent)
    alive2 = alive1 & ~dead_now

    # --- explosion reproduction (particleSystem.cpp:1307-1333) -----------
    explode = normal & (age1 >= state.life) & ~state.parent
    parent = jnp.where(explode, True, parent)
    evel = uvec * jnp.float32(cfg.explosion_speed)
    vel = jnp.where(explode[:, None], evel, vel)

    # Children: compact requests and free slots to a static budget first so
    # every scatter has only E update rows (an N-row scatter costs as much
    # as its update rows even when almost all rows drop).  Ascending parents
    # meet ascending free slots, as before; children beyond the per-frame
    # budget are dropped (mirrored by the oracle).
    #
    # Round-3 trims (both physics-preserving):
    # * ONE combined-category sort replaces the separate request sort +
    #   free-slot compaction sort (each a full-N int32 sort ~3 ms at 2M):
    #   key = category * N + slot with category 0 = exploding parent,
    #   1 = free slot, 2 = rest — parents are the sorted prefix, the free
    #   block starts at index n_child (read via one dynamic slice of the
    #   padded keys).  Both come out ascending, exactly as before.
    # * a small-spawn fast path behind ``lax.cond``: steady-state frames
    #   spawn a few dozen children, so the E-row gather/scatter (~6 ms at
    #   the default 65k budget, cost is per update-row) runs at a 16x
    #   smaller width whenever n_child fits; the full-budget branch only
    #   executes on explosion-burst frames.  k is identical in both
    #   branches, so trajectories are unchanged.
    e = min(cfg.max_spawns_per_frame, n)
    e_small = min(max(1024, e // 16), e)
    slot_idx = jnp.arange(n, dtype=jnp.int32)
    cat = jnp.where(explode, jnp.int32(0),
                    jnp.where(alive2, jnp.int32(2), jnp.int32(1)))
    skey = jnp.sort(cat * jnp.int32(n) + slot_idx)
    skey_pad = jnp.concatenate(
        [skey, jnp.full((e,), jnp.int32(3) * jnp.int32(n))])
    n_child = jnp.sum(explode.astype(jnp.int32))
    n_free = jnp.sum((~alive2).astype(jnp.int32))
    k = jnp.minimum(jnp.minimum(n_child, n_free), e)

    f = jnp.float32
    bc32 = lambda a: jax.lax.bitcast_convert_type(a, f)
    src_mat = jnp.stack([
        pos[:, 0], pos[:, 1], pos[:, 2],
        evel[:, 0], evel[:, 1], evel[:, 2],
        fert, bc32(state.tag),
    ], axis=1)                                  # (N, 8)
    base = jnp.stack([
        pos[:, 0], pos[:, 1], pos[:, 2],
        vel[:, 0], vel[:, 1], vel[:, 2],
        accf[:, 0], accf[:, 1], accf[:, 2],
        w, age, lifef, alive2.astype(f), parent.astype(f),
        bc32(state.tag), jnp.zeros((n,), f),
    ], axis=1)                                  # (N, 16)

    def spawn_into(e_sz: int):
        """ONE combined (e_sz, 8) row gather + ONE (e_sz, 16) row scatter
        instead of per-field gathers and nine field scatters.  Bools ride
        as 0/1 f32, the uint32 tag as an exact bitcast."""
        def apply(b):
            ok_row = jnp.arange(e_sz, dtype=jnp.int32) < k
            parents = skey_pad[:e_sz]           # cat-0 prefix = parent slots
            free_rows = jax.lax.dynamic_slice(
                skey_pad, (n_child,), (e_sz,)) - jnp.int32(n)
            tgt = jnp.where(ok_row, free_rows, n)
            src = jnp.clip(parents, 0, n - 1)
            picked = src_mat[src]               # (e_sz, 8): one row gather
            tag_src = jax.lax.bitcast_convert_type(picked[:, 7], jnp.uint32)
            child_tag = rng.tag_mix(tag_src, frame)
            zcol = jnp.zeros((e_sz,), f)
            child_rows = jnp.stack([
                picked[:, 0], picked[:, 1], picked[:, 2],
                -picked[:, 3], -picked[:, 4], -picked[:, 5],
                zcol, zcol, zcol,                    # acc
                jnp.full((e_sz,), cfg.weight, f), zcol,  # w, age
                picked[:, 6], jnp.ones((e_sz,), f), zcol,  # life, alive, parent
                bc32(child_tag), zcol,
            ], axis=1)                          # (e_sz, 16)
            return b.at[tgt].set(child_rows, mode="drop",
                                 unique_indices=True)
        return apply

    if e_small < e:
        merged = jax.lax.cond(n_child <= e_small, spawn_into(e_small),
                              spawn_into(e), base)
    else:
        merged = spawn_into(e)(base)
    pos = merged[:, 0:3]
    vel = merged[:, 3:6]
    accf = merged[:, 6:9]
    w = merged[:, 9]
    age = merged[:, 10]
    lifef = merged[:, 11]
    alive_out = merged[:, 12] > 0.5
    parent = merged[:, 13] > 0.5
    tagf = jax.lax.bitcast_convert_type(merged[:, 14], jnp.uint32)

    out = ParticleState(pos=pos, vel=vel, acc=accf, w=w, age=age,
                        life=lifef, alive=alive_out, parent=parent, tag=tagf)
    counts = dict(
        n_alive=jnp.sum(alive_out.astype(jnp.int32)),
        n_age_deaths=jnp.sum(die_age.astype(jnp.int32)),
        n_collision_kills=jnp.sum(die_coll.astype(jnp.int32)),
        n_overflow_kills=jnp.sum(overflow.astype(jnp.int32)),
        n_survivals=jnp.sum(survive.astype(jnp.int32)),
        n_spawned=k,
        # children dropped for lack of free slots in the operated width
        # (budget drops are already excluded by the min with e).  At full
        # width this is genuine container saturation, mirrored by the
        # oracle; under step(active=...) it means the PREFIX saturated
        # while the tail may still have room — the bit-exactness contract
        # is broken and the driver must fail loudly (api.NBodySimulation)
        n_spawn_capped=jnp.minimum(n_child, jnp.int32(e)) - k,
    )
    return out, counts


def step_fields(state: ParticleState, uvec: jax.Array, fert: jax.Array,
                frame: jax.Array, cfg: NBodyConfig,
                list_width: int = 0,
                impl: str = "dense") -> Tuple[ParticleState, NBodyStats]:
    """Deterministic step given per-frame random fields:

    * ``uvec`` (N,3) — explosion unit velocity per slot (keyed by the slot's
      particle tag, so placement-independent)
    * ``fert`` (N,)  — child fertility-age draw per parent slot (same keying)

    ``frame`` enters only through child tag assignment.
    Mirrored by ``cpu_ref/oracle_nbody.py``; keep in lockstep.
    """
    grid = cfg.grid

    # --- BUILD_GRID: bin, snapshot, overflow kill ------------------------
    pos_w, coords = wrap_positions(state.pos, grid)  # stored pos is wrapped; no-op shift
    cell = coords_to_cell(coords, grid)

    # --- CALC_FORCES: neighbor pass on the pre-step snapshot -------------
    if impl == "blocks":
        # cluster-pair kernel: no cell lists, work scales with live
        # particles, and no interaction is ever dropped
        # (ops/neighbor_blocks.py)
        from ..ops.neighbor_blocks import neighbor_pass_blocks
        acc, kill, touch, overflow, max_occ, cell_counts = \
            neighbor_pass_blocks(state.pos, state.age, state.w, cell,
                                 state.alive, cfg, tags=state.tag)
        listed_dropped = jnp.int32(0)
    else:
        bins = build_bins(cell, state.alive, grid.num_cells,
                          cfg.cell_capacity, list_width=list_width)
        acc, kill, touch = _neighbor_pass(state, bins.cell_list, cfg)
        overflow = bins.overflow
        max_occ = bins.max_cell_occupancy
        listed_dropped = bins.n_listed_dropped

    out, counts = lifecycle_update(state, pos_w, overflow, acc, kill,
                                   touch, uvec, fert, frame, cfg)
    if impl == "blocks":
        # per-cell counts are a prepare() byproduct: chunk occupancy is a
        # reshape-sum over them (the separate bincount costs ~45 ms at 2M)
        cd, cf = grid.chunk_dim, grid.chunk_factor
        per_cell = cell_counts[: grid.num_cells].reshape(
            cf, cd, cf, cd, cf, cd)          # (q3, r3, q1, r1, q2, r2)
        max_chunk = jnp.max(jnp.sum(per_cell, axis=(1, 3, 5)))
    else:
        alive1 = state.alive & ~overflow
        cell_key = jnp.where(state.alive, cell,
                             grid.num_cells).astype(jnp.int32)
        max_chunk = jnp.max(chunk_occupancy(cell_key, alive1, grid))
    stats = NBodyStats(
        n_listed_dropped=listed_dropped,
        max_cell_occupancy=max_occ,
        max_chunk_occupancy=max_chunk,
        n_tail_alive=jnp.int32(0),
        **counts,
    )
    return out, stats


def frame_fields(cfg: NBodyConfig, frame: jax.Array, tags: jax.Array):
    """Per-slot random fields keyed by each slot's particle tag — identical
    for a given particle regardless of slot or device placement."""
    uvec = rng.per_tag_unit_vectors(rng.frame_key(cfg.seed, frame, rng.UVEC),
                                    tags)
    fert = rng.per_tag_uniform(rng.frame_key(cfg.seed, frame, rng.FERT), tags,
                               cfg.min_fertility_age, cfg.max_fertility_age)
    return uvec, fert


#: active-prefix granularity (rows).  Coarse enough to bound the number of
#: compiled step programs, fine enough not to round a prefix up to the next
#: power of two.
ACTIVE_QUANTUM = 1 << 18


def pick_active(cfg: NBodyConfig, alive: int,
                quantum: int = ACTIVE_QUANTUM) -> int:
    """Smallest quantized active prefix holding ``alive`` rows plus TWO full
    spawn-burst headrooms (prefix free slots can never fall below one burst
    between bucket re-checks, so the prefix never caps a spawn the
    full-width run would grant — the bit-exactness contract of
    ``step(active=...)``) and 10% drift margin.  0 means full width.
    THE single sizing rule: the driver (``api.NBodySimulation``) and
    ``bench.py`` must both call this so published frame times measure the
    production program shape."""
    need = int(alive * 1.1) + 2 * cfg.max_spawns_per_frame
    b = max(quantum, ((need + quantum - 1) // quantum) * quantum)
    return 0 if b >= cfg.slots else b


def compact_state(state: ParticleState) -> ParticleState:
    """Stable-partition alive rows to the slot prefix (slot order preserved
    within each class) — ONE carrying sort by ``slot + dead*N`` moving all
    state columns (no row scatter).

    Slot re-numbering no longer perturbs physics: collision ordering keys
    on the persistent tags (which ride the sort), and slot ids only serve
    pair self-exclusion.  Mirror the compaction on any oracle state being
    ROW-compared (numpy mirror: stable argsort of the same key).  Combined
    with ``step(..., active=...)`` it makes every O(slots)
    stage of the frame scale with LIVE particles: after compaction, alive
    rows occupy ``[0, n_alive)``, and ascending free-slot allocation keeps
    new spawns inside any prefix with dead headroom, so the whole step can
    run on a sliced prefix with results identical to the full-width run."""
    n = state.slots
    iot = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(state.alive, iot, iot + n)
    f = jnp.float32
    bc = lambda a: jax.lax.bitcast_convert_type(a, f)
    (_, px, py, pz, vx, vy, vz, ax, ay, az, w, age, life, al, par, tag) = \
        jax.lax.sort(
            (key, state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
             state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
             state.acc[:, 0], state.acc[:, 1], state.acc[:, 2],
             state.w, state.age, state.life, state.alive.astype(f),
             state.parent.astype(f), bc(state.tag)),
            num_keys=1, is_stable=False)  # keys distinct -> stable anyway
    return ParticleState(
        pos=jnp.stack([px, py, pz], axis=1),
        vel=jnp.stack([vx, vy, vz], axis=1),
        acc=jnp.stack([ax, ay, az], axis=1),
        w=w, age=age, life=life, alive=al > 0.5, parent=par > 0.5,
        tag=jax.lax.bitcast_convert_type(tag, jnp.uint32))


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def step(state: ParticleState, frame: jax.Array, cfg: NBodyConfig,
         list_width: int = 0, impl: str = "dense", active: int = 0):
    """Full frame: per-frame random fields + physics.

    ``impl="blocks"`` uses the cluster-pair kernel (fastest; work scales
    with live particles).  ``impl="dense"`` is the XLA cell-pair
    pass; its ``list_width`` (static) narrows the padded neighbor lists —
    cost is O(width^2), so size it from the previous frame's
    ``max_cell_occupancy`` (see ``api.NBodySimulation``) and keep
    ``stats.n_listed_dropped == 0``.

    ``active`` (static, multiple of 1024) runs the WHOLE frame on the slot
    prefix ``[0, active)`` — sorts, binning, kernel, lifecycle and RNG all
    scale with the prefix instead of capacity.  Caller contract (see
    ``compact_state`` and ``api.NBodySimulation._pick_active``): every
    alive row and enough dead headroom for a full spawn burst lie inside
    the prefix; then results are bit-identical to ``active=0``.
    ``stats.n_tail_alive`` counts contract violations (alive rows beyond
    the prefix are frozen that frame — any nonzero value means the caller
    sized the prefix wrong)."""
    if active and active < state.slots:
        head = jax.tree.map(lambda a: a[:active], state)
        uvec, fert = frame_fields(cfg, frame, head.tag)
        out_head, stats = step_fields(head, uvec, fert, frame, cfg,
                                      list_width, impl)
        tail = jax.tree.map(lambda a: a[active:], state)
        out = jax.tree.map(lambda h, t: jnp.concatenate([h, t]),
                           out_head, tail)
        stats = dataclasses.replace(
            stats, n_tail_alive=jnp.sum(tail.alive.astype(jnp.int32)))
        return out, stats
    uvec, fert = frame_fields(cfg, frame, state.tag)
    return step_fields(state, uvec, fert, frame, cfg, list_width, impl)

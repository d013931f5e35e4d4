"""Multi-chip n-body: spatial slab decomposition with halo exchange.

SPMD replacement for the reference's distributed scheme — Unicorn/pmlib
ships co-owned boundary segments between MPI ranks on demand via byte-range
subscriptions (``set_pkg_segments`` ``app_common.cu:150-232``; subscriptions
``particleSystem.cpp:380-504``).  Here the mapping is explicit SPMD:

* 1D device mesh over the slowest grid axis (i3): device ``d`` owns planes
  ``[d*P, (d+1)*P)`` of the 16^3 cell grid; particle slots are sharded
  ``slots/D`` per device with the invariant that every alive local particle
  lies in the local slab.
* **Halo exchange**: each device packs its boundary planes' snapshot data
  (pos, age, w, global id) into fixed-size buffers and ``ppermute``s them to
  its neighbors.  The stencil never wraps at the global boundary
  (reference ``fill_cells`` clipping, ``app.cu:352-409``), so halo traffic is
  non-cyclic — edge devices simply receive empty buffers.
* The neighbor pass runs on the local slab EXTENDED by one halo plane per
  side (``ops/neighbor.py`` with dims (G, G, P+2)); collision ordering keys
  on the persistent TAGS (``collision_okey`` — the same total order every
  device count sees), with globally-unique slot-derived ids for pair
  self-exclusion, so kill/survive decisions are identical to a
  single-device run.
* **Migration**: after integration + torus wrap, particles that left the slab
  (at most one plane per step: ``MAX_DX <= CELL_SIZE``) are packed and
  ``ppermute``d cyclically (the torus wrap in i3 crosses the ring seam) and
  merged into the destination's free slots — the analog of the reference's
  ``seg_fault`` id migration (``particleSystem.cpp:1336-1374``).

Slot numbering legitimately differs from the single-device run (explosion
children and immigrants land in *per-device* free slots), but since round 4
that no longer perturbs physics: collision ordering keys on persistent tags
and per-particle randomness was always tag-keyed, so slot placement only
decides WHERE a particle is stored.  The remaining cross-device-count
divergence is float accumulation order (different row arrangements sum
gravity in different orders, single-ulp noise that chaos amplifies), which
bounds how long EXACT trajectory comparisons can run — the parity tests
size their windows to it and compare event ledgers and invariants beyond
(see ``test_pencil_long_horizon_invariants``).
Halo/migration buffer overflow drops particles (fixed shapes); stats report
drops so production configs can size buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import NBodyConfig
from ..core.state import ParticleState
from ..models.nbody import frame_fields, lifecycle_update
from ..ops import compact
from ..ops.grid import build_bins, cell_coords, wrap_positions
from ..ops.neighbor import collision_okey, neighbor_pass


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """Slab decomposition parameters.

    ``impl``: per-device neighbor pass — "blocks" (cluster-pair Pallas
    kernel over the halo-extended slab) or "dense" (XLA cell-pair pass).
    """

    n_devices: int
    axis: str = "x"
    halo_capacity: int = 0       # rows per halo buffer; 0 -> derived
    migration_capacity: int = 0  # rows per direction;   0 -> derived
    impl: str = "dense"

    def derive(self, cfg: NBodyConfig) -> "SlabSpec":
        g = cfg.grid
        if g.grid_dim % self.n_devices:
            raise ValueError(f"grid_dim {g.grid_dim} % devices {self.n_devices}")
        if cfg.slots % self.n_devices:
            raise ValueError(f"slots {cfg.slots} % devices {self.n_devices}")
        plane_cap = cfg.cell_capacity * g.grid_dim * g.grid_dim
        halo = self.halo_capacity or plane_cap
        mig = self.migration_capacity or plane_cap
        return dataclasses.replace(self, halo_capacity=halo,
                                   migration_capacity=mig)


def _pack_rows(mask: jax.Array, cap: int, *fields):
    """Compact masked rows (ascending) into fixed (cap, ...) buffers.
    Returns (packed fields..., valid (cap,))."""
    n = mask.shape[0]
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask & (rank < cap), rank, cap)
    out = []
    for f in fields:
        buf = jnp.zeros((cap,) + f.shape[1:], f.dtype)
        out.append(buf.at[tgt].set(f, mode="drop", unique_indices=True))
    nv = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), cap)
    valid = jnp.arange(cap, dtype=jnp.int32) < nv
    dropped = jnp.maximum(jnp.sum(mask.astype(jnp.int32)) - cap, 0)
    return (*out, valid, dropped)


def make_sharded_step(cfg: NBodyConfig, spec: SlabSpec, mesh: Mesh):
    """Build (step_fn, shard_state_fn).

    ``step_fn(state, frame) -> (state, stats_dict)`` is jitted over the mesh
    with every state field sharded on its leading axis.  ``state`` must
    satisfy the slab invariant — use :func:`distribute` on a fresh fill.
    """
    spec = spec.derive(cfg)
    g = cfg.grid
    gd = g.grid_dim
    d_count = spec.n_devices
    planes = gd // d_count
    c_local = cfg.slots // d_count
    h = spec.halo_capacity
    m = spec.migration_capacity
    ax = spec.axis

    def device_step(state: ParticleState, frame):
        d = jax.lax.axis_index(ax)
        uvec, fert = frame_fields(cfg, frame, state.tag)
        base_plane = d * planes

        pos_w, coords = wrap_positions(state.pos, g)
        i3 = coords[..., 2]

        gids = d * c_local + jnp.arange(c_local, dtype=jnp.int32)
        if d_count == 1:
            # one device owns every plane: the halo exchange would pack
            # two boundary planes (two masked compactions over the whole
            # shard) and append 2*h inert rows through the binning sort,
            # only for the empty-perm ppermute to deliver all-invalid
            # rows.  Statically skip it, like the migration ring below
            pos0, age0, w0 = pos_w, state.age, state.w
            ids0, tags0, valid0 = gids, state.tag, state.alive
            lmask = rmask = None
            ldrop = rdrop = jnp.int32(0)
        else:
            # ---- halo exchange (non-cyclic: the stencil does not wrap) --
            lmask = state.alive & (i3 == base_plane)
            rmask = state.alive & (i3 == base_plane + planes - 1)
            lpos, lage, lw, lgid, ltag, lvalid, ldrop = _pack_rows(
                lmask, h, pos_w, state.age, state.w, gids, state.tag)
            rpos, rage, rw, rgid, rtag, rvalid, rdrop = _pack_rows(
                rmask, h, pos_w, state.age, state.w, gids, state.tag)

            to_right = [(i, i + 1) for i in range(d_count - 1)]
            to_left = [(i, i - 1) for i in range(1, d_count)]
            pr = lambda x, perm: jax.lax.ppermute(x, ax, perm)
            # my right plane -> right neighbor's left halo; and vice versa
            halo_l = tuple(pr(x, to_right)
                           for x in (rpos, rage, rw, rgid, rtag, rvalid))
            halo_r = tuple(pr(x, to_left)
                           for x in (lpos, lage, lw, lgid, ltag, lvalid))

            # ---- extended-slab binning ----------------------------------
            pos0 = jnp.concatenate([pos_w, halo_l[0], halo_r[0]])
            age0 = jnp.concatenate([state.age, halo_l[1], halo_r[1]])
            w0 = jnp.concatenate([state.w, halo_l[2], halo_r[2]])
            ids0 = jnp.concatenate([gids, halo_l[3], halo_r[3]])
            tags0 = jnp.concatenate([state.tag, halo_l[4], halo_r[4]])
            valid0 = jnp.concatenate([state.alive, halo_l[5], halo_r[5]])

        c_all = cell_coords(pos0, g)  # halo positions are already wrapped
        lp = c_all[:, 2] - (base_plane - 1)            # local plane: halos 0 / P+1
        lp = jnp.clip(lp, 0, planes + 1)
        ext_cell = lp * gd * gd + c_all[:, 0] * gd + c_all[:, 1]
        num_ext = (planes + 2) * gd * gd

        if spec.impl == "blocks":
            from ..ops.neighbor_blocks import neighbor_pass_blocks
            acc, kill, touch, ovf, max_cell, _ = neighbor_pass_blocks(
                pos0, age0, w0, ext_cell, valid0, cfg, dims=(gd, gd, planes + 2),
                ids=ids0, tags=tags0)
            overflow_local = ovf[:c_local]
            listed_dropped = jnp.int32(0)
        else:
            bins = build_bins(ext_cell, valid0, num_ext, cfg.cell_capacity)
            acc, kill, touch = neighbor_pass(pos0, age0, w0, ids0,
                                             bins.cell_list,
                                             (gd, gd, planes + 2), cfg,
                                             okeys=collision_okey(tags0))
            overflow_local = bins.overflow[:c_local]
            max_cell = bins.max_cell_occupancy
            listed_dropped = bins.n_listed_dropped

        out, counts = lifecycle_update(
            state, pos_w, overflow_local, acc[:c_local],
            kill[:c_local], touch[:c_local], uvec, fert, frame, cfg)

        # ---- migration (cyclic: the torus wrap crosses the ring seam) ---
        # d_count == 1 owns every plane: the ring would be the identity
        # permute and `dest == (d+1) % 1` would mark EVERY alive particle
        # as both staying and migrating — duplicating it into free slots —
        # so the whole exchange is statically skipped (one device needs no
        # migration, exactly like the single-chip step)
        if d_count == 1:
            psum1 = lambda v: jax.lax.psum(v, ax)
            stats = {k: psum1(v) for k, v in counts.items()}
            stats["n_alive"] = psum1(jnp.sum(out.alive.astype(jnp.int32)))
            stats["halo_dropped"] = psum1(ldrop + rdrop)
            stats["halo_used_max"] = jnp.int32(0)  # no halo exists at d=1
            stats["migration_used_max"] = jnp.int32(0)
            stats["n_listed_dropped"] = psum1(listed_dropped)
            stats["migration_dropped"] = jnp.int32(0)
            stats["max_cell_occupancy"] = jax.lax.pmax(max_cell, ax)
            return out, stats

        _, coords_n = wrap_positions(out.pos, g)
        dest = coords_n[..., 2] // planes
        stay = ~out.alive | (dest == d)
        go_r = out.alive & (dest == (d + 1) % d_count)
        go_l = out.alive & (dest == (d - 1) % d_count) & ~go_r

        def pack_migrants(mask):
            return _pack_rows(mask, m, out.pos, out.vel, out.w, out.age,
                              out.life, out.parent, out.tag)

        er = pack_migrants(go_r)
        el = pack_migrants(go_l)
        mig_dropped = er[-1] + el[-1]

        ring_r = [(i, (i + 1) % d_count) for i in range(d_count)]
        ring_l = [(i, (i - 1) % d_count) for i in range(d_count)]
        im_l = tuple(jax.lax.ppermute(x, ax, ring_r) for x in er[:-1])
        im_r = tuple(jax.lax.ppermute(x, ax, ring_l) for x in el[:-1])

        alive_stay = out.alive & stay
        zero3 = lambda a, msk: jnp.where(msk[:, None], a, 0.0)
        zero1 = lambda a, msk: jnp.where(msk, a, 0.0)
        leaving = out.alive & ~stay
        state2 = ParticleState(
            pos=zero3(out.pos, ~leaving), vel=zero3(out.vel, ~leaving),
            acc=zero3(out.acc, ~leaving), w=zero1(out.w, ~leaving),
            age=zero1(out.age, ~leaving), life=zero1(out.life, ~leaving),
            alive=alive_stay, parent=out.parent & ~leaving,
            tag=out.tag)

        # merge immigrants into local free slots (ascending)
        imm_pos = jnp.concatenate([im_l[0], im_r[0]])
        imm_vel = jnp.concatenate([im_l[1], im_r[1]])
        imm_w = jnp.concatenate([im_l[2], im_r[2]])
        imm_age = jnp.concatenate([im_l[3], im_r[3]])
        imm_life = jnp.concatenate([im_l[4], im_r[4]])
        imm_parent = jnp.concatenate([im_l[5], im_r[5]])
        imm_tag = jnp.concatenate([im_l[6], im_r[6]])
        imm_valid = jnp.concatenate([im_l[7], im_r[7]])

        target, ok = compact.allocate(state2.alive, imm_valid)
        tgt = jnp.where(ok, target, c_local)
        st = lambda a, v: a.at[tgt].set(v, mode="drop", unique_indices=True)
        state3 = ParticleState(
            pos=st(state2.pos, imm_pos), vel=st(state2.vel, imm_vel),
            acc=state2.acc.at[tgt].set(0.0, mode="drop", unique_indices=True),
            w=st(state2.w, imm_w), age=st(state2.age, imm_age),
            life=st(state2.life, imm_life),
            alive=state2.alive.at[tgt].set(ok, mode="drop",
                                           unique_indices=True),
            parent=st(state2.parent, imm_parent),
            tag=st(state2.tag, imm_tag))

        psum = lambda v: jax.lax.psum(v, ax)
        stats = {k: psum(v) for k, v in counts.items()}
        stats["n_alive"] = psum(jnp.sum(state3.alive.astype(jnp.int32)))
        stats["halo_dropped"] = psum(ldrop + rdrop)
        stats["halo_used_max"] = jax.lax.pmax(jnp.maximum(
            jnp.sum(lmask.astype(jnp.int32)),
            jnp.sum(rmask.astype(jnp.int32))), ax)
        stats["migration_used_max"] = jax.lax.pmax(jnp.maximum(
            jnp.sum(go_r.astype(jnp.int32)),
            jnp.sum(go_l.astype(jnp.int32))), ax)
        stats["n_listed_dropped"] = psum(listed_dropped)
        stats["migration_dropped"] = psum(mig_dropped)
        stats["max_cell_occupancy"] = jax.lax.pmax(max_cell, ax)
        return state3, stats

    pspec = P(ax)
    state_specs = ParticleState(*([pspec] * 9))
    step_sharded = shard_map(
        device_step, mesh=mesh,
        in_specs=(state_specs, P()),
        out_specs=(state_specs, P()),
        check_vma=False,
    )

    step_fn = jax.jit(lambda state, frame: step_sharded(state, frame))

    def shard_state(state: ParticleState) -> ParticleState:
        sh = NamedSharding(mesh, pspec)
        return jax.tree.map(lambda a: jax.device_put(a, sh), state)

    return step_fn, shard_state


def dest_np(pos, cfg: NBodyConfig, spec: SlabSpec):
    """Owning device index per row (host-side numpy) — the slab invariant.
    Shared by :func:`distribute` and the driver's streaming sharded-
    checkpoint loader."""
    import numpy as np

    spec = spec.derive(cfg)
    g = cfg.grid
    planes = g.grid_dim // spec.n_devices
    i3 = (np.floor(-pos[:, 2] / np.float32(g.cell_size)).astype(np.int64)
          + g.grid_dim // 2)
    return np.clip(i3 // planes, 0, spec.n_devices - 1)


def distribute(state: ParticleState, cfg: NBodyConfig, spec: SlabSpec
               ) -> Tuple[ParticleState, int]:
    """Reorder a global state so shard d holds exactly the particles of slab
    d (the invariant ``make_sharded_step`` requires).  Host-side, used on a
    fresh fill.  Returns (reordered state, n_dropped) — particles beyond a
    shard's local capacity are dropped (size capacity generously).
    """
    import numpy as np

    spec = spec.derive(cfg)
    c_local = cfg.slots // spec.n_devices

    alive = np.asarray(state.alive)
    dest = dest_np(np.asarray(state.pos), cfg, spec)

    out = {f: np.zeros_like(np.asarray(getattr(state, f)))
           for f in ("pos", "vel", "acc", "w", "age", "life", "alive",
                     "parent", "tag")}
    dropped = 0
    for d in range(spec.n_devices):
        idx = np.flatnonzero(alive & (dest == d))
        if len(idx) > c_local:
            dropped += len(idx) - c_local
            idx = idx[:c_local]
        rows = d * c_local + np.arange(len(idx))
        for f in out:
            out[f][rows] = np.asarray(getattr(state, f))[idx]
    return ParticleState(**{k: jnp.asarray(v) for k, v in out.items()}), dropped

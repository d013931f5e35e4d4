"""Multi-chip n-body: full 3D brick decomposition over a (d3, d1, d2) mesh.

This is the SPMD completion of the reference's ownership scheme — the
reference decomposes the 16^3 grid into 4x4x4 chunks whose working set is
the chunk plus its co-owned faces/edges/corners (``set_pkg_segments``,
``/root/reference/source/code/inc/app_common.cu:150-232``).  Device
(a, b, c) of mesh axes ("x", "y", "z") owns the *brick*

    i3 in [a*P3, (a+1)*P3) x i1 in [b*P1, (b+1)*P1) x i2 in [c*P2, (c+1)*P2)

so the device count scales to ``(G/P3)*(G/P1)*(G/P2)`` (= 64 devices at the
reference's own chunking) and per-device halo traffic shrinks to the six
brick faces.

Face/edge/corner co-ownership is ONE mechanism here, not 26 special cases:
halo exchange runs axis by axis (i3, then i1, then i2), and each later
phase exchanges the boundary faces of the set EXTENDED by the earlier
phases — forwarded halo rows are exactly the edge and corner cells.
Migration runs the same three axis rings cyclically (the torus wrap crosses
ring seams); ``MAX_DX <= CELL_SIZE`` bounds motion to one cell per frame,
so a corner-crossing particle takes at most three hops in one frame, one
per axis.  ``nbody_pencil`` is the 2-axis specialization of this scheme and
``nbody_sharded`` the 1-axis one; this module implements the general
axis-loop form (set ``d1 = d2 = 1`` to degenerate to slabs).

Same cross-device-count divergence bound as the slab/pencil paths: free
slots are per-device, but since round 4 slot placement no longer perturbs
physics (collision ordering keys on persistent tags, randomness was
always tag-keyed) — the remaining bound on EXACT trajectory comparison is
float accumulation order (different row arrangements sum gravity in
different orders; see the ``nbody_sharded`` module docstring and the
measured horizon in tools/parity_horizon.py).  Buffer overflow drops are
counted, never silent; per-frame high-water marks (``halo_used_max``,
``migration_used_max``) size buffers from measured occupancy.
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
from .nbody_sharded import _pack_rows


@dataclasses.dataclass(frozen=True)
class BrickSpec:
    """(d3, d1, d2) brick decomposition parameters.

    ``d3`` devices along grid axis i3 (mesh axis "x"), ``d1`` along i1
    ("y"), ``d2`` along i2 ("z").  Degenerate axes (d = 1) cost nothing:
    no halo phase, no migration ring.  ``impl``: per-device neighbor pass —
    "blocks" (cluster-pair Pallas kernel) or "dense" (XLA cell-pair pass).
    """

    d3: int
    d1: int = 1
    d2: int = 1
    axes: Tuple[str, str, str] = ("x", "y", "z")
    halo_capacity: int = 0       # rows per face buffer;  0 -> derived
    migration_capacity: int = 0  # rows per direction;    0 -> derived
    impl: str = "dense"

    @property
    def n_devices(self) -> int:
        return self.d3 * self.d1 * self.d2

    def derive(self, cfg: NBodyConfig) -> "BrickSpec":
        g = cfg.grid
        for d, nm in ((self.d3, "d3"), (self.d1, "d1"), (self.d2, "d2")):
            if g.grid_dim % d:
                raise ValueError(f"grid_dim {g.grid_dim} % {nm}={d}")
        if cfg.slots % self.n_devices:
            raise ValueError(f"slots {cfg.slots} % devices {self.n_devices}")
        p3 = g.grid_dim // self.d3
        p1 = g.grid_dim // self.d1
        p2 = g.grid_dim // self.d2
        # worst-case face occupancy across the three (extended-set) faces;
        # production configs should size from the reported halo_used_max /
        # migration_used_max high-water marks instead
        faces = (cfg.cell_capacity * p1 * p2,
                 cfg.cell_capacity * (p3 + 2) * p2,
                 cfg.cell_capacity * (p3 + 2) * (p1 + 2))
        halo = self.halo_capacity or max(faces)
        mig = self.migration_capacity or max(faces)
        return dataclasses.replace(self, halo_capacity=halo,
                                   migration_capacity=mig)


def make_brick_step(cfg: NBodyConfig, spec: BrickSpec, mesh: Mesh):
    """Build (step_fn, shard_state_fn) over a 3D mesh.

    ``step_fn(state, frame) -> (state, stats_dict)``; state fields are
    sharded on the leading axis over ALL mesh axes (device (a, b, c) holds
    rows [((a*d1+b)*d2+c)*c_local, ...)).  Use :func:`distribute` on a
    fresh fill to establish the brick invariant.
    """
    spec = spec.derive(cfg)
    g = cfg.grid
    gd = g.grid_dim
    p3, p1, p2 = gd // spec.d3, gd // spec.d1, gd // spec.d2
    c_local = cfg.slots // spec.n_devices
    h = spec.halo_capacity
    m = spec.migration_capacity
    ax3, ax1, ax2 = spec.axes

    def device_step(state: ParticleState, frame):
        a = jax.lax.axis_index(ax3)
        b = jax.lax.axis_index(ax1)
        c = jax.lax.axis_index(ax2)
        d_lin = (a * spec.d1 + b) * spec.d2 + c
        uvec, fert = frame_fields(cfg, frame, state.tag)
        base3, base1, base2 = a * p3, b * p1, c * p2

        pos_w, _ = wrap_positions(state.pos, g)
        gids = d_lin * c_local + jnp.arange(c_local, dtype=jnp.int32)

        # ---- halo: axis-by-axis, later phases forward earlier halos ------
        # (coord_col, mesh axis, device count, base plane, local extent)
        phases = ((2, ax3, spec.d3, base3, p3),
                  (0, ax1, spec.d1, base1, p1),
                  (1, ax2, spec.d2, base2, p2))
        ext = (pos_w, state.age, state.w, gids, state.tag, state.alive)
        halo_drop = jnp.int32(0)
        halo_used = jnp.int32(0)
        for ci, axn, d_count, base, p in phases:
            if d_count == 1:
                continue
            coords_e = cell_coords(ext[0], g)
            ce = coords_e[:, ci]
            lo_mask = ext[5] & (ce == base)
            hi_mask = ext[5] & (ce == base + p - 1)
            lo_pack = _pack_rows(lo_mask, h, *ext[:5])
            hi_pack = _pack_rows(hi_mask, h, *ext[:5])
            # non-cyclic: the 27-stencil never wraps the global box
            # (reference fill_cells clipping, app.cu:352-409)
            fwd = [(i, i + 1) for i in range(d_count - 1)]
            bwd = [(i, i - 1) for i in range(1, d_count)]
            pr = lambda x, perm: jax.lax.ppermute(x, axn, perm)
            from_lo = tuple(pr(x, fwd) for x in hi_pack[:-1])
            from_hi = tuple(pr(x, bwd) for x in lo_pack[:-1])
            halo_drop = halo_drop + lo_pack[-1] + hi_pack[-1]
            halo_used = jnp.maximum(
                halo_used, jnp.maximum(jnp.sum(lo_mask.astype(jnp.int32)),
                                       jnp.sum(hi_mask.astype(jnp.int32))))
            ext = tuple(jnp.concatenate([e, lo_h, hi_h])
                        for e, lo_h, hi_h in zip(ext, from_lo, from_hi))

        pos0, age0, w0, ids0, tags0, valid0 = ext

        # ---- extended-brick binning --------------------------------------
        # uniform p+2 extents per axis (degenerate axes just carry two empty
        # boundary layers); cell id = lp3*(e1*e2) + lp1*e2 + lp2
        c_all = cell_coords(pos0, g)
        lp3 = jnp.clip(c_all[:, 2] - (base3 - 1), 0, p3 + 1)
        lp1 = jnp.clip(c_all[:, 0] - (base1 - 1), 0, p1 + 1)
        lp2 = jnp.clip(c_all[:, 1] - (base2 - 1), 0, p2 + 1)
        e1, e2 = p1 + 2, p2 + 2
        ext_cell = lp3 * (e1 * e2) + lp1 * e2 + lp2
        num_ext = (p3 + 2) * e1 * e2
        ext_dims = (e1, e2, p3 + 2)

        if spec.impl == "blocks":
            from ..ops.neighbor_blocks import neighbor_pass_blocks
            acc, kill, touch, ovf, max_cell, _ = neighbor_pass_blocks(
                pos0, age0, w0, ext_cell, valid0, cfg, dims=ext_dims,
                ids=ids0, tags=tags0)
            overflow_local = ovf[:c_local]
            listed_dropped = jnp.int32(0)
        else:
            bins = build_bins(ext_cell, valid0, num_ext, cfg.cell_capacity)
            acc, kill, touch = neighbor_pass(pos0, age0, w0, ids0,
                                             bins.cell_list, ext_dims, cfg,
                                             okeys=collision_okey(tags0))
            overflow_local = bins.overflow[:c_local]
            max_cell = bins.max_cell_occupancy
            listed_dropped = bins.n_listed_dropped

        out, counts = lifecycle_update(
            state, pos_w, overflow_local, acc[:c_local],
            kill[:c_local], touch[:c_local], uvec, fert, frame, cfg)

        # ---- migration: axis-by-axis rings (cyclic: torus wrap) ----------
        def migrate_axis(st: ParticleState, axis_name, d_count, my_idx,
                         ci, p):
            _, coords_n = wrap_positions(st.pos, g)
            dest = coords_n[..., ci] // p
            stay = ~st.alive | (dest == my_idx)
            go_f = st.alive & (dest == (my_idx + 1) % d_count)
            go_b = st.alive & (dest == (my_idx - 1) % d_count) & ~go_f

            def pack(mask):
                return _pack_rows(mask, m, st.pos, st.vel, st.w, st.age,
                                  st.life, st.parent, st.tag)

            ef = pack(go_f)
            eb = pack(go_b)
            dropped = ef[-1] + eb[-1]
            used = jnp.maximum(jnp.sum(go_f.astype(jnp.int32)),
                               jnp.sum(go_b.astype(jnp.int32)))
            ring_f = [(i, (i + 1) % d_count) for i in range(d_count)]
            ring_b = [(i, (i - 1) % d_count) for i in range(d_count)]
            im_b = tuple(jax.lax.ppermute(x, axis_name, ring_f)
                         for x in ef[:-1])
            im_f = tuple(jax.lax.ppermute(x, axis_name, ring_b)
                         for x in eb[:-1])

            leaving = st.alive & ~stay
            z3 = lambda arr: jnp.where(leaving[:, None], 0.0, arr)
            z1 = lambda arr: jnp.where(leaving, 0.0, arr)
            st2 = ParticleState(
                pos=z3(st.pos), vel=z3(st.vel), acc=z3(st.acc),
                w=z1(st.w), age=z1(st.age), life=z1(st.life),
                alive=st.alive & stay, parent=st.parent & ~leaving,
                tag=st.tag)

            imm = [jnp.concatenate([x, y]) for x, y in zip(im_b, im_f)]
            target, ok = compact.allocate(st2.alive, imm[7])
            tgt = jnp.where(ok, target, c_local)
            sset = lambda arr, v: arr.at[tgt].set(
                v, mode="drop", unique_indices=True)
            st3 = ParticleState(
                pos=sset(st2.pos, imm[0]), vel=sset(st2.vel, imm[1]),
                acc=st2.acc.at[tgt].set(0.0, mode="drop",
                                        unique_indices=True),
                w=sset(st2.w, imm[2]), age=sset(st2.age, imm[3]),
                life=sset(st2.life, imm[4]),
                alive=st2.alive.at[tgt].set(ok, mode="drop",
                                            unique_indices=True),
                parent=sset(st2.parent, imm[5]), tag=sset(st2.tag, imm[6]))
            return st3, dropped, used

        mig_drop = jnp.int32(0)
        mig_used = jnp.int32(0)
        for (ci, axn, d_count, _base, p), my_idx in zip(phases, (a, b, c)):
            if d_count == 1:
                continue
            out, dr, us = migrate_axis(out, axn, d_count, my_idx, ci, p)
            mig_drop = mig_drop + dr
            mig_used = jnp.maximum(mig_used, us)

        live_axes = tuple(axn for _ci, axn, d_count, _b, _p in phases
                          if d_count > 1)
        psum = lambda v: jax.lax.psum(v, live_axes)
        pmax = lambda v: jax.lax.pmax(v, live_axes)
        stats = {k: psum(v) for k, v in counts.items()}
        stats["n_alive"] = psum(jnp.sum(out.alive.astype(jnp.int32)))
        stats["halo_dropped"] = psum(halo_drop)
        stats["halo_used_max"] = pmax(halo_used)
        stats["n_listed_dropped"] = psum(listed_dropped)
        stats["migration_dropped"] = psum(mig_drop)
        stats["migration_used_max"] = pmax(mig_used)
        stats["max_cell_occupancy"] = pmax(max_cell)
        return out, stats

    pspec = P((ax3, ax1, ax2))
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
        return jax.tree.map(lambda arr: jax.device_put(arr, sh), state)

    return step_fn, shard_state


def dest_np(pos, cfg: NBodyConfig, spec: BrickSpec):
    """Owning LINEAR device index per row (host-side numpy) — the brick
    invariant (shard ``(a, b, c)`` = linear ``(a * d1 + b) * d2 + c`` owns
    the particle).  Shared by :func:`distribute` and the driver's
    shard-local validate."""
    import numpy as np

    spec = spec.derive(cfg)
    g = cfg.grid
    p3 = g.grid_dim // spec.d3
    p1 = g.grid_dim // spec.d1
    p2 = g.grid_dim // spec.d2
    half = g.grid_dim // 2
    cs = np.float32(g.cell_size)
    i1 = np.floor(-pos[:, 1] / cs).astype(np.int64) + half
    i2 = np.floor(pos[:, 0] / cs).astype(np.int64) + half
    i3 = np.floor(-pos[:, 2] / cs).astype(np.int64) + half
    a = np.clip(i3 // p3, 0, spec.d3 - 1)
    b = np.clip(i1 // p1, 0, spec.d1 - 1)
    c = np.clip(i2 // p2, 0, spec.d2 - 1)
    return (a * spec.d1 + b) * spec.d2 + c


def distribute(state: ParticleState, cfg: NBodyConfig, spec: BrickSpec
               ) -> Tuple[ParticleState, int]:
    """Reorder a global state so shard (a, b, c) holds exactly its brick's
    particles (the invariant ``make_brick_step`` requires).  Host-side,
    used on a fresh fill.  Returns (reordered state, n_dropped)."""
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
    return (ParticleState(**{k: jnp.asarray(v) for k, v in out.items()}),
            dropped)

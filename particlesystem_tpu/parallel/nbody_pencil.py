"""Multi-chip n-body: 2D pencil decomposition over a (d3, d1) device mesh.

The slab path (``nbody_sharded.py``) shards only the slowest grid axis (i3),
which caps the device count at ``grid_dim`` and ships whole 16x16 boundary
planes every frame.  The reference's ownership scheme is fully 3D — 4x4x4
chunks with face/edge/corner co-ownership (``set_pkg_segments``,
``/root/reference/source/code/inc/app_common.cu:150-232``).  This module is
the middle ground matched to a 2D mesh: device (a, b) of mesh axes
("x", "y") owns the *pencil*

    i3 in [a*P3, (a+1)*P3)   x   i1 in [b*P1, (b+1)*P1)   x   all i2,

so halo traffic shrinks from whole planes to pencil faces and device count
scales to ``(grid_dim/P3) * (grid_dim/P1)``.

Corner (edge-in-3D) co-ownership is handled the standard SPMD way — axis-by-
axis exchange instead of 26-neighbor bookkeeping:

* **Halo**: phase 1 ``ppermute``s the two i3 boundary faces along "x"
  (non-cyclic: the 27-stencil never wraps, reference ``fill_cells`` clipping
  ``app.cu:352-409``); phase 2 sends the two i1 boundary faces of the
  *extended* row set (locals + phase-1 halos) along "y" — the forwarded halo
  rows ARE the corner cells, no special casing.
* **Migration** (cyclic: the torus wrap crosses ring seams,
  ``particleSystem.cpp:1336-1374`` analog): phase 1 routes movers along the
  "x" ring and merges them into free slots; phase 2 re-examines all alive
  locals (including fresh immigrants) and routes along "y".  A corner-
  crossing particle simply takes two hops in one frame.  ``MAX_DX <=
  CELL_SIZE`` bounds motion to one cell per frame, so one hop per axis
  always suffices.

Collision ordering keys on persistent tags (``collision_okey``), so
per-device slot allocation does not perturb physics; only float
accumulation-order noise bounds exact cross-device-count comparison — see
the ``nbody_sharded`` module docstring.  Buffer overflow drops are counted,
never silent, and per-frame high-water marks (``halo_used_max``,
``migration_used_max``) are reported so capacities can be sized from
measured occupancy instead of the worst case.
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
class PencilSpec:
    """(d3, d1) pencil decomposition parameters.

    ``d3`` devices along grid axis i3 (mesh axis "x"), ``d1`` along i1
    (mesh axis "y").  ``d1 = 1`` degenerates to the slab decomposition.
    ``impl``: per-device neighbor pass — "blocks" (cluster-pair Pallas
    kernel) or "dense" (XLA cell-pair pass).
    """

    d3: int
    d1: int
    axes: Tuple[str, str] = ("x", "y")
    halo_capacity: int = 0       # rows per i3-face buffer; 0 -> derived
    halo1_capacity: int = 0      # rows per i1-face buffer; 0 -> derived
    migration_capacity: int = 0  # rows per direction;      0 -> derived
    impl: str = "dense"

    @property
    def n_devices(self) -> int:
        return self.d3 * self.d1

    def derive(self, cfg: NBodyConfig) -> "PencilSpec":
        g = cfg.grid
        for d, nm in ((self.d3, "d3"), (self.d1, "d1")):
            if g.grid_dim % d:
                raise ValueError(f"grid_dim {g.grid_dim} % {nm}={d}")
        if cfg.slots % self.n_devices:
            raise ValueError(f"slots {cfg.slots} % devices {self.n_devices}")
        p3 = g.grid_dim // self.d3
        p1 = g.grid_dim // self.d1
        # worst-case face occupancy; production configs should size these
        # from the reported halo_used_max / migration_used_max high-water
        # marks instead (the buffers are ppermuted every frame)
        face3 = cfg.cell_capacity * g.grid_dim * p1
        face1 = cfg.cell_capacity * g.grid_dim * (p3 + 2)
        halo = self.halo_capacity or face3
        halo1 = self.halo1_capacity or face1
        mig = self.migration_capacity or max(face3, face1)
        return dataclasses.replace(self, halo_capacity=halo,
                                   halo1_capacity=halo1,
                                   migration_capacity=mig)


def make_pencil_step(cfg: NBodyConfig, spec: PencilSpec, mesh: Mesh):
    """Build (step_fn, shard_state_fn) over a 2D mesh.

    ``step_fn(state, frame) -> (state, stats_dict)``; state fields are
    sharded on the leading axis over BOTH mesh axes (device (a, b) holds
    rows [(a*d1+b)*c_local, ...)).  Use :func:`distribute` on a fresh fill
    to establish the pencil invariant.
    """
    spec = spec.derive(cfg)
    g = cfg.grid
    gd = g.grid_dim
    p3 = gd // spec.d3
    p1 = gd // spec.d1
    c_local = cfg.slots // spec.n_devices
    h3 = spec.halo_capacity
    h1 = spec.halo1_capacity
    m = spec.migration_capacity
    ax3, ax1 = spec.axes
    # global ids ride the blocks kernel as int32 BITCAST through an f32 row
    # (ops/neighbor_blocks.py), so any int32 slot count is exact — no 2^24
    # f32 limit applies

    def device_step(state: ParticleState, frame):
        a = jax.lax.axis_index(ax3)
        b = jax.lax.axis_index(ax1)
        d_lin = a * spec.d1 + b
        uvec, fert = frame_fields(cfg, frame, state.tag)
        base3 = a * p3
        base1 = b * p1

        pos_w, coords = wrap_positions(state.pos, g)
        i1 = coords[..., 0]
        i3 = coords[..., 2]

        gids = d_lin * c_local + jnp.arange(c_local, dtype=jnp.int32)

        # ---- halo phase 1: i3 faces along the "x" axis (non-cyclic) ------
        # statically skipped when one device spans i3 (same guard as the
        # size-1 migration axes and slab d=1: packing faces for an
        # empty-perm ppermute costs two whole-shard compactions + 2*h3
        # inert rows through the binning sort — measured 204 -> 75 ms at
        # slab d=1 on chip, NOTES r5)
        if spec.d3 > 1:
            lmask = state.alive & (i3 == base3)
            rmask = state.alive & (i3 == base3 + p3 - 1)
            lpack = _pack_rows(lmask, h3, pos_w, state.age, state.w, gids,
                               state.tag)
            rpack = _pack_rows(rmask, h3, pos_w, state.age, state.w, gids,
                               state.tag)

            fwd3 = [(i, i + 1) for i in range(spec.d3 - 1)]
            bwd3 = [(i, i - 1) for i in range(1, spec.d3)]
            pr3 = lambda x, perm: jax.lax.ppermute(x, ax3, perm)
            halo_from_left = tuple(pr3(x, fwd3) for x in rpack[:-1])
            halo_from_right = tuple(pr3(x, bwd3) for x in lpack[:-1])
            halo_drop = lpack[-1] + rpack[-1]
            halo_used = jnp.maximum(jnp.sum(lmask.astype(jnp.int32)),
                                    jnp.sum(rmask.astype(jnp.int32)))

            ext1_pos = jnp.concatenate([pos_w, halo_from_left[0],
                                        halo_from_right[0]])
            ext1_age = jnp.concatenate([state.age, halo_from_left[1],
                                        halo_from_right[1]])
            ext1_w = jnp.concatenate([state.w, halo_from_left[2],
                                      halo_from_right[2]])
            ext1_gid = jnp.concatenate([gids, halo_from_left[3],
                                        halo_from_right[3]])
            ext1_tag = jnp.concatenate([state.tag, halo_from_left[4],
                                        halo_from_right[4]])
            ext1_valid = jnp.concatenate([state.alive, halo_from_left[5],
                                          halo_from_right[5]])
        else:
            ext1_pos, ext1_age, ext1_w = pos_w, state.age, state.w
            ext1_gid, ext1_tag, ext1_valid = gids, state.tag, state.alive
            halo_drop = jnp.int32(0)
            halo_used = jnp.int32(0)

        # ---- halo phase 2: i1 faces of the EXTENDED set along "y" --------
        # forwarding received i3-halo rows delivers the corner cells
        if spec.d1 > 1:
            c_ext1 = cell_coords(ext1_pos, g)
            e_i1 = c_ext1[:, 0]
            dmask = ext1_valid & (e_i1 == base1)
            umask = ext1_valid & (e_i1 == base1 + p1 - 1)
            dpack = _pack_rows(dmask, h1, ext1_pos, ext1_age, ext1_w,
                               ext1_gid, ext1_tag)
            upack = _pack_rows(umask, h1, ext1_pos, ext1_age, ext1_w,
                               ext1_gid, ext1_tag)
            fwd1 = [(i, i + 1) for i in range(spec.d1 - 1)]
            bwd1 = [(i, i - 1) for i in range(1, spec.d1)]
            pr1 = lambda x, perm: jax.lax.ppermute(x, ax1, perm)
            halo_from_down = tuple(pr1(x, fwd1) for x in upack[:-1])
            halo_from_up = tuple(pr1(x, bwd1) for x in dpack[:-1])
            halo_drop = halo_drop + dpack[-1] + upack[-1]
            halo_used = jnp.maximum(
                halo_used, jnp.maximum(jnp.sum(dmask.astype(jnp.int32)),
                                       jnp.sum(umask.astype(jnp.int32))))
            pos0 = jnp.concatenate([ext1_pos, halo_from_down[0],
                                    halo_from_up[0]])
            age0 = jnp.concatenate([ext1_age, halo_from_down[1],
                                    halo_from_up[1]])
            w0 = jnp.concatenate([ext1_w, halo_from_down[2],
                                  halo_from_up[2]])
            ids0 = jnp.concatenate([ext1_gid, halo_from_down[3],
                                    halo_from_up[3]])
            tags0 = jnp.concatenate([ext1_tag, halo_from_down[4],
                                     halo_from_up[4]])
            valid0 = jnp.concatenate([ext1_valid, halo_from_down[5],
                                      halo_from_up[5]])
        else:
            pos0, age0, w0 = ext1_pos, ext1_age, ext1_w
            ids0, tags0, valid0 = ext1_gid, ext1_tag, ext1_valid

        # ---- extended-pencil binning -------------------------------------
        c_all = cell_coords(pos0, g)
        lp3 = jnp.clip(c_all[:, 2] - (base3 - 1), 0, p3 + 1)
        lp1 = jnp.clip(c_all[:, 0] - (base1 - 1), 0, p1 + 1)
        d1e = p1 + 2
        ext_cell = lp3 * (d1e * gd) + lp1 * gd + c_all[:, 1]
        num_ext = (p3 + 2) * d1e * gd
        ext_dims = (d1e, gd, p3 + 2)

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

        # ---- migration: axis-by-axis rings (cyclic) ----------------------
        def migrate_axis(st: ParticleState, axis_name, d_count, my_idx,
                         dest_of):
            """Route alive locals whose dest index differs along one ring."""
            _, coords_n = wrap_positions(st.pos, g)
            dest = dest_of(coords_n)
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

        # axes of size 1 are statically skipped: their ring would be the
        # identity permute and dest == (idx+1) % 1 would mark every alive
        # particle as both staying and migrating — duplicating it (the d=1
        # slab bug found on-chip in round 5); brick has the same guard
        if spec.d3 > 1:
            out, drop3, used3 = migrate_axis(
                out, ax3, spec.d3, a, lambda c: c[..., 2] // p3)
        else:
            drop3 = jnp.int32(0)
            used3 = jnp.int32(0)
        if spec.d1 > 1:
            out, drop1, used1 = migrate_axis(
                out, ax1, spec.d1, b, lambda c: c[..., 0] // p1)
        else:
            drop1 = jnp.int32(0)
            used1 = jnp.int32(0)

        both = (ax3, ax1)
        psum = lambda v: jax.lax.psum(v, both)
        pmax = lambda v: jax.lax.pmax(v, both)
        stats = {k: psum(v) for k, v in counts.items()}
        stats["n_alive"] = psum(jnp.sum(out.alive.astype(jnp.int32)))
        stats["halo_dropped"] = psum(halo_drop)
        stats["halo_used_max"] = pmax(halo_used)
        stats["n_listed_dropped"] = psum(listed_dropped)
        stats["migration_dropped"] = psum(drop3 + drop1)
        stats["migration_used_max"] = pmax(jnp.maximum(used3, used1))
        stats["max_cell_occupancy"] = pmax(max_cell)
        return out, stats

    pspec = P((ax3, ax1))
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


def dest_np(pos, cfg: NBodyConfig, spec: PencilSpec):
    """Owning LINEAR device index per row (host-side numpy) — the pencil
    invariant (shard ``(a, b)`` = linear ``a * d1 + b`` owns the particle).
    Shared by :func:`distribute` and the driver's shard-local validate."""
    import numpy as np

    spec = spec.derive(cfg)
    g = cfg.grid
    p3 = g.grid_dim // spec.d3
    p1 = g.grid_dim // spec.d1
    half = g.grid_dim // 2
    i1 = (np.floor(-pos[:, 1] / np.float32(g.cell_size)).astype(np.int64)
          + half)
    i3 = (np.floor(-pos[:, 2] / np.float32(g.cell_size)).astype(np.int64)
          + half)
    a = np.clip(i3 // p3, 0, spec.d3 - 1)
    b = np.clip(i1 // p1, 0, spec.d1 - 1)
    return a * spec.d1 + b


def distribute(state: ParticleState, cfg: NBodyConfig, spec: PencilSpec
               ) -> Tuple[ParticleState, int]:
    """Reorder a global state so shard (a, b) holds exactly its pencil's
    particles (the invariant ``make_pencil_step`` requires).  Host-side,
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

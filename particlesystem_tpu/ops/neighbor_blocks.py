"""Cluster-pair neighbor kernel (Pallas, Triton route): sorted particle
blocks against contiguous neighbor ranges.

The dense cell-pair pass (``ops/neighbor.py``) pads every cell to a static
width, so its cost is O(cells * 27 * width^2) regardless of real occupancy.
This kernel works in *sorted particle order* instead (the cluster-pair
design of GPU molecular dynamics):

* particles are sorted by cell id (dead last); a *block* is ``b``
  consecutive sorted rows, one Triton program each — work scales with LIVE
  particles, not cells;
* XLA precomputes, per block, the 9 contiguous row ranges covering its
  stencil: cells with consecutive i2 are adjacent in memory, so each
  (i1 row, i3 plane) offset of the stencil is one contiguous range of
  sorted rows;
* the program loops over its 9 ranges and walks each in ``t``-column
  tiles, computing (b, t) pairwise tiles in registers (Triton pipelines
  the tile loads, ``num_stages``).  The tiles accumulate elementwise into
  (b, t) register accumulators that are reduced over columns once per
  block, not once per tile.  Per-pair cell-delta masks restore exact
  27-stencil semantics (``fill_cells`` dist^2 <= 3 filter,
  ``/root/reference/source/code/inc/app.cu:352-409`` — for integer deltas
  that IS the 3x3x3 cube): collision flags (``bodyBodyCollision``,
  ``app_common.cu:269-301``, larger id survives) and Plummer gravity
  (``bodyBodyInteraction``, ``app_common.cu:236-267``).

The range list has no capacity: a block's 9 ranges cover its stencil
whatever the occupancy, so no interaction is ever dropped.

Snapshot layout: one (9, N + t) f32 array, rows ``X..CG`` below — x, y, z,
i1, i2, i3, w, gid (int32 BITCAST to f32: exact at any slot count; pair
self-exclusion identity), cgid (the collision-ORDER key: ``collision_okey``
of the persistent particle tag, placement-independent — INT32_MIN bits
past ``particle_life``; the kid/dead gates ride the out-of-band
coordinates).  Each snapshot row of a tile is one contiguous load.

**All gating is folded into the snapshot so the kernel's only per-pair
tests are the cell-delta stencil, the id inequality, the range end and the
contact radius:**

* rows that fail the sorted-side validity test (dead, past the per-cell
  cap) AND rows outside the adult gravity window (age < kid_age — kids
  neither exert nor receive gravity, ``bodyBodyInteraction`` gates on
  NEWBORN_TIME, ``app_common.cu:236-267``) get out-of-band cell
  coordinates, so the stencil test ``cd2 <= 3.5`` rejects them with zero
  extra ops.  Coordinates are spaced 2 apart within a band (adjacent
  out-of-band rows must NOT pass the stencil: their REAL positions and
  weights would inject garbage forces into live kid rows) and the
  kid band [-10 - 2^20, -10] is disjoint from the dead band
  [-2^22 - 2^20, -2^22] (a kid/dead coordinate collision would do the
  same; dead rows carry w=0 but OVERFLOW rows do not).  All values stay
  < 2^23 so in-band f32 differences are exact integers.  Axes i1/i3 and
  i2 use COPRIME row moduli (2^19 and 2^19-1): a stencil can reach rows
  a whole cell-plane away (~800k rows at 10M/32^3, past a single 2^19
  wrap), and two distinct rows only collide on BOTH axes if their index
  difference is a multiple of 2^19*(2^19-1) ~ 2^38 — unreachable.
* the collision age window [kid_age, particle_life] rides the cgid
  column: ineligible rows carry INT32_MIN bits and can never win the
  gmax reduction; the MINE-side window is applied after the unsort
  (one elementwise (N,) op fused into the epilogue).

Collision results leave the kernel as ONE reduction: gmax = max int32
order key over colliding neighbors (INT32_MIN if none) — ``kill = gmax >
my_okey`` and ``touch = gmax > INT32_MIN`` are derived per slot after the
unsort.  The order key is the TAG-derived ``collision_okey`` (see
``ops/neighbor.py``): identical on 1 and N devices, so multi-device
kill/survive tie-breaks match the single-device run exactly.

The kernel compiles for CUDA; on the CPU backend (tests) it runs in the
Pallas interpreter.  Any other backend raises rather than interpreting
silently.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.config import NBodyConfig
from .neighbor import collision_okey

# Tile shape, swept on an H100 at the 1M/16^3 and 10M/32^3 plateau states
# (PERF.md): a (b, t) tile holds b*t/(32*NUM_WARPS) elements of every
# per-pair temporary in each thread's registers, and past ~8 the kernel
# spills.
B = 32          # sorted rows per program (power of two)
T = 32          # candidate columns per tile (power of two)
NUM_WARPS = 4
NUM_STAGES = 2
N_RANGES = 9    # one contiguous range per (i1, i3) stencil offset
# snapshot rows
X, Y, Z, I1, I2, I3, W, GID, CG = range(9)
# Python int, NOT jnp.int32: a module-level concrete jax scalar gets its
# aval stamped with the first shard_map manual mesh that eagerly touches it
# (jax 0.9), and `-_BIG` then fails trace under any OTHER mesh in the same
# process ("context mesh should match the aval mesh").  As a literal it
# re-enters each trace fresh.
_BIG = 1 << 30
_IMIN = jnp.iinfo(jnp.int32).min


def _interpret() -> bool:
    """Interpret on the CPU (tests), compile on the GPU; nothing else."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise NotImplementedError(
        f"the cluster-pair kernel runs on 'gpu' (or interpreted on 'cpu'), "
        f"not on {backend!r}; use impl='dense'")


# ---------------------------------------------------------------------------
# XLA-side preparation
# ---------------------------------------------------------------------------


def prepare(pos0, age0, w0, cell, alive, cfg: NBodyConfig, dims=None,
            ids=None, tags=None, b: int = B, t: int = T):
    """Sort by cell and build the kernel inputs.

    ``dims = (d1, d2, d3)`` generalizes to non-cubic grids (cell id =
    i3*(d1*d2) + i1*d2 + i2), e.g. a device slab extended by halo planes;
    ``ids`` supplies global particle ids (int32) when slots are
    device-local (used ONLY for pair self-exclusion — they must be unique
    across every row the kernel sees, halos included).  ``tags`` supplies
    the persistent per-particle identities whose :func:`collision_okey`
    decides kill/survive ordering — placement- and device-count-
    independent (``None`` falls back to ordering on ``ids``).  The row
    count must be a multiple of ``b``; ``t`` is the snapshot's tail pad.

    Returns (snap (9, N+t), ranges (NB, 9, 2) int32 — (first row, row
    count) per stencil offset — order, overflow_s (SORTED-side per-cell-cap
    overflow; ride it through the unsort carry), max_cell_occupancy,
    per-cell counts).
    """
    g = cfg.grid.grid_dim
    d1, d2, d3 = dims or (g, g, g)
    num_cells = d1 * d2 * d3
    row_stride, plane_stride = d2, d1 * d2
    cap = cfg.cell_capacity
    n = cell.shape[0]
    assert n % b == 0, (n, b)

    f = jnp.float32
    iot = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(alive, cell, num_cells).astype(jnp.int32)
    gid_i = iot if ids is None else ids.astype(jnp.int32)
    gid_bits = jax.lax.bitcast_convert_type(gid_i, f)  # exact at ANY count
    # collision-order key: persistent tags (placement-independent total
    # order — identical on 1 and N devices) when given, slot order
    # otherwise.  Gated HERE by the neighbor-side collision age window's
    # upper edge (age <= life); the kid/dead/overflow gates ride the
    # out-of-band coordinates below, so the kernel's stencil test rejects
    # those rows with zero extra ops either way.
    okey_i = (collision_okey(tags) if tags is not None
              else jnp.maximum(gid_i, _IMIN + 1))
    cg_pre = jnp.where(age0 <= jnp.float32(cfg.particle_life), okey_i, _IMIN)
    cg_bits = jax.lax.bitcast_convert_type(cg_pre, f)

    # ONE carrying sort builds the whole sorted snapshot; cell coords are
    # re-derived from the sorted key instead of being carried.
    skey, sx, sy, sz, sgid, sage, sw, scg, order = jax.lax.sort(
        (key, pos0[:, 0], pos0[:, 1], pos0[:, 2], gid_bits, age0, w0,
         cg_bits, iot),
        num_keys=1, is_stable=True)

    starts = jnp.searchsorted(
        skey, jnp.arange(num_cells + 2, dtype=jnp.int32)).astype(jnp.int32)
    counts = jnp.diff(starts)                # (num_cells + 1,)
    # in-cell rank without an (N,)-table gather: distance to the start of
    # the current equal-key run (runs are ascending, so a running max of
    # boundary positions is exactly the run start)
    first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                             skey[1:] != skey[:-1]])
    run_start = jax.lax.cummax(jnp.where(first, iot, 0))
    rank = iot - run_start

    valid_s = (skey < num_cells) & (rank < cap)
    overflow_s = (skey < num_cells) & (rank >= cap)

    # fold the age gates into the snapshot (see module docstring): invalid
    # and kid rows get banded out-of-band coords (stencil rejects them via
    # cd^2 alone), collision eligibility rides a pre-gated gid column.
    kid = jnp.float32(cfg.kid_age)
    coord_ok = valid_s & (sage >= kid)
    base = jnp.where(valid_s, -10.0, -4194304.0)
    bad_a = base - (2 * (iot % (1 << 19))).astype(f)
    bad_b = base - (2 * (iot % ((1 << 19) - 1))).astype(f)
    i3q = skey // plane_stride
    remq = skey % plane_stride
    i1s = jnp.where(coord_ok, (remq // row_stride).astype(f), bad_a)
    i2s = jnp.where(coord_ok, (remq % row_stride).astype(f), bad_b)
    i3s = jnp.where(coord_ok, i3q.astype(f), bad_a)
    snap = jnp.stack([sx, sy, sz, i1s, i2s, i3s, sw, sgid, scg], axis=0)
    snap = jnp.pad(snap, ((0, 0), (0, t)))   # tile loads never go OOB

    # ---- per-block neighbor ranges --------------------------------------
    # Sorted cells in a block are CONTIGUOUS: [cmin, cmax].  For each of the
    # 9 stencil offsets (d1, d3) the needed cells are the contiguous linear
    # range [cmin-1, cmax+1] + d3*G^2 + d1*G: [c-1, c+1] covers a cell's
    # i2 neighbors for every i2 (row-edge spill is rejected by the per-pair
    # cell-delta masks), and the d1/d3 offsets cover the other two axes —
    # so 9 ranges cover ANY block, row/plane crossings included.  Wide
    # blocks (sparse grids) make consecutive ranges overlap, which would
    # double-count genuine neighbors; offsets are ascending, so clipping
    # each range's start past the previous range's end (dedup below)
    # restores pairwise disjointness while keeping the union intact.
    nb = n // b

    def seg(a, init, op):
        a = jnp.where(valid_s, a, init).reshape(nb, b)
        return op(a, axis=1)
    cmin = seg(skey, _BIG, jnp.min)                      # (NB,)
    cmax = seg(skey, -_BIG, jnp.max)
    empty = (cmax - cmin) < 0

    offs = sorted(o3 * plane_stride + o1 * row_stride
                  for o3 in (-1, 0, 1) for o1 in (-1, 0, 1))
    prev_hi = jnp.full_like(cmin, -_BIG)
    r_start, r_count = [], []
    for off in offs:                                      # sequential dedup
        lo_r = jnp.maximum(cmin - 1 + off, prev_hi + 1)
        hi_r = cmax + 1 + off
        prev_hi = jnp.maximum(prev_hi, hi_r)
        s0 = starts[jnp.clip(lo_r, 0, num_cells)]
        s1 = starts[jnp.clip(hi_r + 1, 0, num_cells)]
        r_start.append(s0)
        r_count.append(jnp.where(~empty & (s1 > s0), s1 - s0, 0))
    ranges = jnp.stack([jnp.stack(r_start, axis=1),
                        jnp.stack(r_count, axis=1)], axis=-1)  # (NB, 9, 2)

    max_occ = jnp.max(counts[:num_cells]).astype(jnp.int32)
    return snap, ranges, order, overflow_s, max_occ, counts


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _kernel(cfg: NBodyConfig, b: int, t: int, ranges_ref, snap_ref,
            out_ref):
    r2 = jnp.float32(cfg.collision_radius ** 2)
    eps2 = jnp.float32(cfg.eps2)
    blk = pl.program_id(0)
    mine = pl.ds(blk * b, b)

    def col(r):                              # (b, 1) of this block's rows
        return snap_ref[r, mine][:, None]

    mx, my, mz = col(X), col(Y), col(Z)
    mi1, mi2, mi3 = col(I1), col(I2), col(I3)
    mgid = jax.lax.bitcast_convert_type(col(GID), jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, t), 1)

    def range_body(r, carry):
        start = ranges_ref[blk, r, 0]
        end = start + ranges_ref[blk, r, 1]

        def tile_body(k, carry):
            ax, ay, az, gmax = carry
            c0 = start + k * t
            cols = pl.ds(c0, t)

            def row(q):                      # (1, t) of candidate columns
                return snap_ref[q, cols][None, :]

            dx = row(X) - mx
            dy = row(Y) - my
            dz = row(Z) - mz
            d2 = dx * dx + dy * dy + dz * dz
            e1 = row(I1) - mi1
            e2 = row(I2) - mi2
            e3 = row(I3) - mi3
            cd2 = e1 * e1 + e2 * e2 + e3 * e3
            ngid = jax.lax.bitcast_convert_type(row(GID), jnp.int32)
            # 27-stencil (dist^2 <= 3 on integer cell deltas), self
            # exclusion, and the range's tail
            pg = (cd2 <= 3.5) & (ngid != mgid) & (lane + c0 < end)
            rs = jax.lax.rsqrt(d2 + eps2)
            sw = jnp.where(pg, rs * rs * rs, 0.0) * row(W)
            ncg = jax.lax.bitcast_convert_type(row(CG), jnp.int32)
            gsel = jnp.where(pg & (d2 <= r2), ncg, _IMIN)
            return (ax + dx * sw, ay + dy * sw, az + dz * sw,
                    jnp.maximum(gmax, gsel))

        return jax.lax.fori_loop(0, (end - start + t - 1) // t, tile_body,
                                 carry)

    zero = jnp.zeros((b, t), jnp.float32)
    ax, ay, az, gmax = jax.lax.fori_loop(
        0, N_RANGES, range_body,
        (zero, zero, zero, jnp.full((b, t), _IMIN, jnp.int32)))
    out_ref[0, :] = jnp.sum(ax, axis=1)
    out_ref[1, :] = jnp.sum(ay, axis=1)
    out_ref[2, :] = jnp.sum(az, axis=1)
    out_ref[3, :] = jax.lax.bitcast_convert_type(jnp.max(gmax, axis=1),
                                                 jnp.float32)


def kernel_call(cfg: NBodyConfig, snap, ranges, b: int = B,
                t: int = T) -> jax.Array:
    """Invoke the cluster-pair kernel on prepared inputs; returns the raw
    sorted-order (4, n) output (rows 0-2 acc, row 3 gmax bits)."""
    n = ranges.shape[0] * b
    return pl.pallas_call(
        functools.partial(_kernel, cfg, b, t),
        out_shape=jax.ShapeDtypeStruct((4, n), jnp.float32),
        grid=(n // b,),
        in_specs=[pl.no_block_spec, pl.no_block_spec],
        out_specs=pl.BlockSpec((4, b), lambda i: (0, i)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=_interpret(),
        name="cluster_pair",
    )(ranges, snap)


def unsort_outputs(out, order, overflow_s, ids=None, okeys=None):
    """Apply the inverse permutation to the kernel output by sorting on the
    forward permutation (see :func:`neighbor_pass_blocks`); returns
    (acc (N,3), kill, touch, overflow).  ``okeys`` is the MINE-side
    collision-order key (must match the ``tags`` handed to
    :func:`prepare`); defaults to ``ids``/slot order."""
    n = order.shape[0]
    _, ax, ay, az, gbits, ovf_f = jax.lax.sort(
        (order, out[0], out[1], out[2], out[3],
         overflow_s.astype(jnp.float32)),
        num_keys=1, is_stable=False)
    acc = jnp.stack([ax, ay, az], axis=1)
    overflow = ovf_f > 0
    gmax = jax.lax.bitcast_convert_type(gbits, jnp.int32)
    if okeys is None:
        okeys = (jnp.arange(n, dtype=jnp.int32) if ids is None
                 else ids.astype(jnp.int32))
    kill = gmax > okeys
    touch = gmax > _IMIN
    return acc, kill, touch, overflow


def neighbor_pass_blocks(pos0, age0, w0, cell, alive, cfg: NBodyConfig,
                         dims=None, ids=None, tags=None, b: int = B,
                         t: int = T):
    """Full pass: returns per-row (acc (N,3), kill, touch, overflow,
    max_cell_occupancy, per-cell counts) — same semantics as
    ``ops/neighbor.neighbor_pass`` plus the grid-build byproducts (no cell
    lists are materialized).  ``dims``/``ids``/``tags`` as in
    :func:`prepare`; ``b``/``t`` select the tile shape.  Any row count is
    accepted: rows are padded with dead rows to a multiple of ``b``."""
    n = cell.shape[0]
    pad = (-n) % b
    if pad:
        padf = lambda a, v: jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], v, a.dtype)])
        pos0, age0, w0 = padf(pos0, 0.0), padf(age0, 0.0), padf(w0, 0.0)
        cell, alive = padf(cell, 0), padf(alive, False)
        ids = padf(jnp.arange(n, dtype=jnp.int32) if ids is None else ids,
                   -1)
        tags = None if tags is None else padf(tags, 0)
    snap, ranges, order, overflow_s, max_occ, counts = prepare(
        pos0, age0, w0, cell, alive, cfg, dims=dims, ids=ids, tags=tags,
        b=b, t=t)
    out = kernel_call(cfg, snap, ranges, b=b, t=t)
    # unsort by sorting on the forward permutation (all keys distinct); the
    # sorted-side overflow flag rides along as a free column
    okeys = collision_okey(tags) if tags is not None else None
    acc, kill, touch, overflow = unsort_outputs(out, order, overflow_s,
                                                ids=ids, okeys=okeys)
    # MINE-side collision age window (the neighbor side rides the pre-gated
    # cgid column; see prepare) — one elementwise op fused into the epilogue
    win = (age0 >= jnp.float32(cfg.kid_age)) \
        & (age0 <= jnp.float32(cfg.particle_life))
    kill = kill & win
    touch = touch & win
    return (acc[:n], kill[:n], touch[:n], overflow[:n], max_occ, counts)

"""Fused physics step over separate per-field arrays — the hot path.

State layout: ``fields = (x, y, z, vx, vy, vz, age, life)``, eight separate
contiguous ``(N,)`` f32 arrays.  The step is elementwise streaming, which
XLA's own fusion handles without a hand-written kernel.

Physics semantics identical to ``models/emitter.step_core`` — forces
(gravity/wind/drag), semi-implicit Euler, plane/sphere contact response,
aging, dead-row freeze.

Recycling: ``ring_spawn`` (O(S) ring allocator with a shadow region) and
``refresh_free_list``/``spawn_exact`` (exact dead-slot compaction) — the
data-parallel replacements for the reference's per-segment free-id queues
(``/root/reference/source/code/inc/app_common.cu:305-429``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import EmitterSceneConfig

Fields = Tuple[jax.Array, ...]  # x, y, z, vx, vy, vz, age, life


def zero_fields(n: int) -> Fields:
    return tuple(jnp.zeros((n,), jnp.float32) for _ in range(8))


def integrate6(x, y, z, vx, vy, vz, cfg: EmitterSceneConfig):
    """Forces -> semi-implicit Euler -> plane/sphere response on six bare
    coordinate arrays — the maskless physics core shared by the packed
    (8-field, dead-rows-frozen) and slim (7-field, unconditional) layouts."""
    dt = jnp.float32(cfg.dt)
    gx, gy, gz = (jnp.float32(v) for v in cfg.gravity)
    if cfg.drag:
        k = jnp.float32(cfg.drag)
        wx, wy, wz = (jnp.float32(v) for v in cfg.wind)
        ax, ay, az = gx + (wx - vx) * k, gy + (wy - vy) * k, gz + (wz - vz) * k
    else:
        ax, ay, az = gx, gy, gz

    vx1, vy1, vz1 = vx + ax * dt, vy + ay * dt, vz + az * dt
    x1, y1, z1 = x + vx1 * dt, y + vy1 * dt, z + vz1 * dt

    for pl_ in cfg.planes:
        n = np.asarray(pl_.normal, np.float32)
        n = n / np.linalg.norm(n)
        nx, ny, nz = (jnp.float32(v) for v in n)
        px, py, pz = (jnp.float32(v) for v in pl_.point)
        d = (x1 - px) * nx + (y1 - py) * ny + (z1 - pz) * nz
        contact = d < 0
        x1 = jnp.where(contact, x1 - nx * d, x1)
        y1 = jnp.where(contact, y1 - ny * d, y1)
        z1 = jnp.where(contact, z1 - nz * d, z1)
        vn = vx1 * nx + vy1 * ny + vz1 * nz
        inb = contact & (vn < 0)
        e = jnp.float32(pl_.restitution)
        mu1 = jnp.float32(1.0 - pl_.friction)
        vx1 = jnp.where(inb, (vx1 - nx * vn) * mu1 - nx * vn * e, vx1)
        vy1 = jnp.where(inb, (vy1 - ny * vn) * mu1 - ny * vn * e, vy1)
        vz1 = jnp.where(inb, (vz1 - nz * vn) * mu1 - nz * vn * e, vz1)

    for sp in cfg.spheres:
        cx, cy, cz = (jnp.float32(v) for v in sp.center)
        dxx, dyy, dzz = x1 - cx, y1 - cy, z1 - cz
        dist = jnp.sqrt(dxx * dxx + dyy * dyy + dzz * dzz)
        safe = jnp.maximum(dist, jnp.float32(1e-20))
        nx, ny, nz = dxx / safe, dyy / safe, dzz / safe
        depth = jnp.float32(sp.radius) - dist
        contact = depth > 0
        x1 = jnp.where(contact, x1 + nx * depth, x1)
        y1 = jnp.where(contact, y1 + ny * depth, y1)
        z1 = jnp.where(contact, z1 + nz * depth, z1)
        vn = vx1 * nx + vy1 * ny + vz1 * nz
        inb = contact & (vn < 0)
        e = jnp.float32(sp.restitution)
        mu1 = jnp.float32(1.0 - sp.friction)
        vx1 = jnp.where(inb, (vx1 - nx * vn) * mu1 - nx * vn * e, vx1)
        vy1 = jnp.where(inb, (vy1 - ny * vn) * mu1 - ny * vn * e, vy1)
        vz1 = jnp.where(inb, (vz1 - nz * vn) * mu1 - nz * vn * e, vz1)

    return x1, y1, z1, vx1, vy1, vz1


def physics_step(fields: Fields, cfg: EmitterSceneConfig) -> Fields:
    """One physics frame; dead rows (age > life or life <= 0) are frozen."""
    x, y, z, vx, vy, vz, age, life = fields
    dt = jnp.float32(cfg.dt)
    alive = (age <= life) & (life > 0)
    x1, y1, z1, vx1, vy1, vz1 = integrate6(x, y, z, vx, vy, vz, cfg)
    return (jnp.where(alive, x1, x), jnp.where(alive, y1, y),
            jnp.where(alive, z1, z), jnp.where(alive, vx1, vx),
            jnp.where(alive, vy1, vy), jnp.where(alive, vz1, vz),
            jnp.where(alive, age + dt, age), life)


def physics_step_slim(fields: Tuple[jax.Array, ...],
                      cfg: EmitterSceneConfig) -> Tuple[jax.Array, ...]:
    """Slim-layout physics frame: ``fields = (x, y, z, vx, vy, vz, death)``.

    ``death`` is the absolute frame index at which the slot stops being
    alive (f32, exact below 2^24); liveness is ``frame < death``, derived —
    never read-modified — so the per-frame HBM traffic drops from 15 to 13
    words/particle (6 coordinate arrays read+write + the death read; age/
    life are replaced by a spawn-time constant that physics never rewrites).
    Rows that were never spawned (``death <= 0``) are frozen; EXPIRED rows
    (``0 < death <= frame``) keep integrating — their state is *undefined
    garbage until respawn* and consumers must mask with the liveness test
    (``alive_mask_slim``).  Drag bounds velocities, plane response bounds
    positions, so garbage stays finite; the ring allocator overwrites every
    field at respawn.

    Emitting each output as ``select(mask, new, old)`` (packed8's shape)
    also keeps the step one fusion; a maskless form has been seen to split
    into several fusions that materialize intermediates.
    """
    x, y, z, vx, vy, vz, death = fields
    new = integrate6(x, y, z, vx, vy, vz, cfg)
    m = death > 0
    return (*(jnp.where(m, n, o)
              for n, o in zip(new, (x, y, z, vx, vy, vz))), death)


def alive_mask_slim(death: jax.Array, frame: jax.Array) -> jax.Array:
    """Liveness for the slim layout: spawned with ``death = spawn_frame +
    life/dt`` and alive while the current frame index is below it."""
    return frame.astype(jnp.float32) < death


# ---------------------------------------------------------------------------
# recycling
# ---------------------------------------------------------------------------


def dead_mask(fields: Fields) -> jax.Array:
    age, life = fields[6], fields[7]
    return (age > life) | (life <= 0)


def refresh_free_list(fields: Fields, list_size: int):
    """Extract up to ``list_size`` dead-slot indices, ascending (cumsum
    compaction).  Returns (free_list padded with N, n_free)."""
    n = fields[0].shape[0]
    dead = dead_mask(fields)
    rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
    tgt = jnp.where(dead & (rank < list_size), rank, list_size)
    fl = jnp.full((list_size,), n, jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop", unique_indices=True)
    n_free = jnp.minimum(jnp.sum(dead.astype(jnp.int32)), list_size)
    return fl, n_free


def spawn_exact(fields: Fields, rows: Fields, valid: jax.Array,
                free_list: jax.Array, cursor: jax.Array, n_free: jax.Array):
    """Scatter spawn rows into free-list slots through ``cursor``.  Exact
    dead-slot-ascending semantics (matches ``models/emitter.step_core``)."""
    n = fields[0].shape[0]
    lsize = free_list.shape[0]
    req_rank = jnp.cumsum(valid.astype(jnp.int32)) - 1
    ok = valid & (cursor + req_rank < n_free)
    tgt = free_list[jnp.clip(cursor + req_rank, 0, lsize - 1)]
    tgt = jnp.where(ok, tgt, n)
    out = tuple(f.at[tgt].set(r, mode="drop", unique_indices=True)
                for f, r in zip(fields, rows))
    return out, cursor + jnp.sum(ok.astype(jnp.int32))


def ring_spawn(fields: Fields, rows: Fields, valid: jax.Array,
               cursor: jax.Array, n_real: int):
    """Ring-buffer spawn: O(S) per frame, zero O(N) traffic.

    Each field has ``n_real + S`` entries; the trailing S form a shadow
    scratch region so the contiguous window write never needs a dynamic
    width.  Valid rows are compacted to a prefix (ONE (S, 8) row scatter —
    scatter cost is dominated by per-op overhead at this size, so eight
    per-field scatters cost ~8x one), written at the cursor; the part that
    crossed the end is folded onto the head and the shadow cleared (a stale
    copy would keep ghost particles alive) — but only on the rare
    ring-wrap frames (~once per n_real/spawn_rate frames), behind a
    ``lax.cond``.  Slots are reused in spawn order — oldest spawns are
    replaced when the scene saturates.
    """
    s = rows[0].shape[0]
    assert fields[0].shape[0] == n_real + s, (fields[0].shape, n_real, s)
    rank = jnp.cumsum(valid.astype(jnp.int32)) - 1
    nv = jnp.sum(valid.astype(jnp.int32))
    compact_tgt = jnp.where(valid, rank, s)
    col = jnp.arange(s, dtype=jnp.int32)
    wrapped = cursor + nv - n_real

    rows8 = jnp.stack(rows, axis=1)                      # (S, n_fields)
    rc8 = jnp.zeros((s, len(rows)), jnp.float32).at[compact_tgt].set(
        rows8, mode="drop", unique_indices=True)

    written = []
    for i, f in enumerate(fields):
        window = jax.lax.dynamic_slice(f, (cursor,), (s,))
        window = jnp.where(col < nv, rc8[:, i], window)
        written.append(jax.lax.dynamic_update_slice(f, window, (cursor,)))
    written = tuple(written)

    def fold_wrap(fs):
        out = []
        for f in fs:
            shadow = jax.lax.dynamic_slice(f, (n_real,), (s,))
            head = jax.lax.dynamic_slice(f, (0,), (s,))
            head = jnp.where(col < wrapped, shadow, head)
            f = jax.lax.dynamic_update_slice(f, head, (0,))
            f = jax.lax.dynamic_update_slice(
                f, jnp.zeros((s,), jnp.float32), (n_real,))
            out.append(f)
        return tuple(out)

    written = jax.lax.cond(wrapped > 0, fold_wrap, lambda fs: fs, written)
    return written, (cursor + nv) % n_real


def strided_spawn(fields: Fields, rows: Fields, valid: jax.Array,
                  cursor: jax.Array, n_real: int):
    """Budget-strided ring spawn: the minimal-op allocator.

    The cursor advances by the FULL padded spawn budget ``S`` every frame
    (not by the valid-row count), and ``n_real % S == 0`` is required, so
    the write window never wraps mid-frame: no shadow region, no wrap
    fold, no ``lax.cond``, no compaction cumsum/scatter — per field, one
    ``dynamic_slice`` + ``where(valid, row, resident)`` + one
    ``dynamic_update_slice``.  Invalid budget rows keep the window's
    current residents (they survive until the cursor laps them).

    Trade-off vs ``ring_spawn``: slots recycle after ``n_real / S`` frames
    instead of ``n_real / n_valid`` — a ``S / n_valid`` shorter lap (~1.2x
    at the bench scene's ~81% budget utilization).  Under saturation the
    oldest SLOTS are replaced rather than the oldest spawns; below
    saturation the alive-row multiset is identical to ``ring_spawn``'s
    (verified bitwise in tests/test_slim_engine.py).
    """
    s = rows[0].shape[0]
    assert n_real % s == 0, (n_real, s)
    assert fields[0].shape[0] == n_real, (fields[0].shape, n_real)
    written = []
    for f, r in zip(fields, rows):
        window = jax.lax.dynamic_slice(f, (cursor,), (s,))
        written.append(jax.lax.dynamic_update_slice(
            f, jnp.where(valid, r, window), (cursor,)))
    return tuple(written), jax.lax.rem(cursor + s, jnp.int32(n_real))


def select_spawn(fields: Fields, rows: Fields, valid: jax.Array,
                 cursor: jax.Array, n_real: int):
    """Broadcast-select spawn over natively-2D ``(n_real/W, W)`` fields —
    strided recycling semantics with the write expressed as pure
    elementwise ops so it fuses INTO the physics pass.

    Why not ``dynamic_update_slice``: a DUS of a W-row window into the big
    1-D field arrays can make XLA materialize the physics fusion and then
    re-copy every array, and reshaping to 2-D at the op boundary adds
    layout copies.  Keeping the state 2-D
    makes the write window exactly row ``cursor/W``, so
    ``where(b==lap & valid[j], row[j], physics[b,j])`` — one (B,1) iota
    compare and a (1,W) broadcast of the spawn rows — is all that is left,
    and XLA schedules the whole frame as ONE streaming pass: 0.81 ms/frame
    at 10M vs 0.97 (packed8/ring) / 1.20 (slim/ring).

    Semantics are bitwise-identical to :func:`strided_spawn` (same slots,
    same values, invalid budget rows keep the window's physics-stepped
    residents); the cursor stays a slot offset advancing W per frame.
    """
    w = rows[0].shape[0]
    b_rows, w2 = fields[0].shape
    assert w2 == w and b_rows * w == n_real, (fields[0].shape, w, n_real)
    lap = jax.lax.div(cursor, jnp.int32(w))
    bmask = (jnp.arange(b_rows, dtype=jnp.int32) == lap)[:, None]
    sel = bmask & valid[None, :]                              # (B, W)
    out = tuple(jnp.where(sel, r[None, :], f)
                for f, r in zip(fields, rows))
    return out, jax.lax.rem(cursor + jnp.int32(w), jnp.int32(n_real))


def pack_spawn_rows(spawn) -> Fields:
    """SpawnRows -> 8 per-field (S,) arrays (w is not carried on the packed
    path: emitter-scene forces are per-unit-mass)."""
    s = spawn.pos.shape[0]
    return (spawn.pos[:, 0], spawn.pos[:, 1], spawn.pos[:, 2],
            spawn.vel[:, 0], spawn.vel[:, 1], spawn.vel[:, 2],
            jnp.zeros((s,), jnp.float32), spawn.life)


def pack_spawn_rows_slim(spawn, frame: jax.Array, dt: float):
    """SpawnRows -> 7 slim per-field (S,) arrays; lifetime becomes the
    absolute death frame ``spawn_frame + life/dt`` (exact below 2^24)."""
    death = frame.astype(jnp.float32) + spawn.life / jnp.float32(dt)
    return (spawn.pos[:, 0], spawn.pos[:, 1], spawn.pos[:, 2],
            spawn.vel[:, 0], spawn.vel[:, 1], spawn.vel[:, 2], death)

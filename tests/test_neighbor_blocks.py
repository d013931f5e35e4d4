"""Cluster-pair kernel vs the dense cell-pair pass.

Flags (kill/touch/overflow) must match EXACTLY; accelerations to float
tolerance.  On the CPU the kernel runs in the Pallas interpreter; the
lowering test checks that the same call compiles to a Triton kernel for
CUDA.  Small tiles (b=32, t=32) force multi-tile ranges and blocks that
cross i1-row and i3-plane boundaries — the regression for the
range-construction bug where box-edge particles lost interactions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import particlesystem_tpu.ops.neighbor_blocks as nbk
from particlesystem_tpu import GridSpec, NBodyConfig
from particlesystem_tpu.models import nbody
from particlesystem_tpu.ops.grid import build_bins, coords_to_cell, wrap_positions
from particlesystem_tpu.ops.neighbor import collision_okey, neighbor_pass

CONFIGS = {
    "dense-g4": NBodyConfig(n_fill=1500, capacity=2048,
                            grid=GridSpec(grid_dim=4, chunk_factor=2),
                            max_per_cell=48, seed=3),
    "sparse-g16": NBodyConfig(n_fill=800, capacity=1024,
                              grid=GridSpec(grid_dim=16),
                              particle_life=2.0, seed=7),
    "mid-g8": NBodyConfig(n_fill=6000, capacity=8192,
                          grid=GridSpec(grid_dim=8, chunk_factor=2),
                          seed=13),
}
TILINGS = [(nbk.B, nbk.T), (16, 128), (128, 16)]


def dense_reference(cfg, pos, age, w, cell, alive, ids=None, tags=None,
                    dims=None):
    g = cfg.grid.grid_dim
    dims = dims or (g, g, g)
    bins = build_bins(cell, alive, dims[0] * dims[1] * dims[2],
                      cfg.cell_capacity)
    ids = jnp.arange(pos.shape[0], dtype=jnp.int32) if ids is None else ids
    okeys = None if tags is None else collision_okey(tags)
    acc, kill, touch = neighbor_pass(pos, age, w, ids, bins.cell_list, dims,
                                     cfg, batch_cells=64, okeys=okeys)
    return acc, kill, touch, bins.overflow


def assert_matches(got, want, tol=1e-5):
    acc_b, kill_b, touch_b, ovf_b = got
    acc_d, kill_d, touch_d, ovf_d = want
    np.testing.assert_array_equal(np.asarray(ovf_b), np.asarray(ovf_d))
    np.testing.assert_array_equal(np.asarray(kill_b), np.asarray(kill_d))
    np.testing.assert_array_equal(np.asarray(touch_b), np.asarray(touch_d))
    scale = max(1.0, float(np.abs(np.asarray(acc_d)).max()))
    err = np.abs(np.asarray(acc_b) - np.asarray(acc_d)).max() / scale
    assert err < tol, err


def compare(cfg, frames=2, tol=1e-5, **kernel_kw):
    state = nbody.init_fill(cfg)
    for f in range(frames):
        state, _ = nbody.step(state, jnp.int32(f), cfg)
    pos_w, coords = wrap_positions(state.pos, cfg.grid)
    cell = coords_to_cell(coords, cfg.grid)
    acc_b, kill_b, touch_b, ovf, _, _ = nbk.neighbor_pass_blocks(
        state.pos, state.age, state.w, cell, state.alive, cfg, **kernel_kw)
    assert_matches((acc_b, kill_b, touch_b, ovf),
                   dense_reference(cfg, state.pos, state.age, state.w, cell,
                                   state.alive), tol)


@pytest.mark.parametrize("tiling", TILINGS, ids=lambda bt: f"b{bt[0]}t{bt[1]}")
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_blocks_matches_dense(name, tiling):
    b, t = tiling
    compare(CONFIGS[name], b=b, t=t)


def test_blocks_multichunk_plane_crossings():
    """Small kernel tiles force multi-tile ranges and row/plane-crossing
    blocks at modest particle counts (the box-edge regression)."""
    cfg = NBodyConfig(n_fill=20_000, capacity=32768,
                      grid=GridSpec(grid_dim=16), seed=3)
    compare(cfg, frames=1, b=32, t=32)


def test_dense_cluster_needs_no_budget():
    """Every particle in a 2x2x2 corner of the grid: each block's ranges
    span many tiles, and the per-block range list still covers the whole
    stencil — no interaction is dropped and the frame stat stays 0."""
    cfg = NBodyConfig(n_fill=2048, capacity=2048,
                      grid=GridSpec(grid_dim=4, chunk_factor=2),
                      max_per_cell=512, seed=11)
    st = nbody.init_fill(cfg)
    pos = jnp.asarray(np.random.default_rng(0).uniform(
        -cfg.grid.half_extent, -cfg.grid.half_extent + 2 * cfg.grid.cell_size,
        (st.slots, 3)).astype(np.float32))
    st = dataclasses.replace(st, pos=pos)
    _, coords = wrap_positions(st.pos, cfg.grid)
    cell = coords_to_cell(coords, cfg.grid)
    got = nbk.neighbor_pass_blocks(st.pos, st.age, st.w, cell, st.alive, cfg,
                                   tags=st.tag)
    assert int(got[4]) > 200            # max cell occupancy: truly crowded
    assert_matches(got[:4], dense_reference(cfg, st.pos, st.age, st.w, cell,
                                            st.alive, tags=st.tag))
    uvec, fert = nbody.frame_fields(cfg, jnp.int32(0), st.tag)
    _, stats = nbody.step_fields(st, uvec, fert, jnp.int32(0), cfg, 0,
                                 "blocks")
    assert int(stats.n_listed_dropped) == 0


def test_row_count_padding_matches_dense():
    """The sharded steps hand the pass an extended row set (local slots +
    halo buffers) whose count is no multiple of the block size: rows are
    padded with dead rows to a multiple of ``b`` and sliced back, with
    explicit ids/tags and non-cubic dims as the slab path uses them."""
    cfg = CONFIGS["mid-g8"]
    st = nbody.init_fill(cfg)
    n = 5000                                   # no multiple of B
    assert n % nbk.B
    pos, age, w = st.pos[:n], st.age[:n], st.w[:n]
    alive, tags = st.alive[:n], st.tag[:n]
    ids = jnp.arange(n, dtype=jnp.int32) + 7   # globally unique, not slots
    g = cfg.grid.grid_dim
    dims = (g, g, g)
    _, coords = wrap_positions(pos, cfg.grid)
    cell = coords_to_cell(coords, cfg.grid)
    got = nbk.neighbor_pass_blocks(pos, age, w, cell, alive, cfg, dims=dims,
                                   ids=ids, tags=tags)
    assert got[0].shape == (n, 3) and got[1].shape == (n,)
    assert_matches(got[:4], dense_reference(cfg, pos, age, w, cell, alive,
                                            ids=ids, tags=tags, dims=dims))


def test_kernel_lowers_to_triton_for_cuda(monkeypatch):
    """Without interpret mode the kernel lowers through Pallas's Triton
    route: the CUDA module holds the Triton custom call, no interpreter
    loop over the grid."""
    monkeypatch.setattr(nbk, "_interpret", lambda: False)
    cfg = CONFIGS["sparse-g16"]
    st = nbody.init_fill(cfg)
    _, coords = wrap_positions(st.pos, cfg.grid)
    cell = coords_to_cell(coords, cfg.grid)
    fn = jax.jit(lambda p, a, w, c, al, t: nbk.neighbor_pass_blocks(
        p, a, w, c, al, cfg, tags=t))
    text = fn.trace(st.pos, st.age, st.w, cell, st.alive, st.tag).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "cluster_pair" in text


def test_unsupported_backend_raises(monkeypatch):
    """Only 'gpu' compiles and only 'cpu' interprets: any other backend is
    refused instead of falling back to the interpreter."""
    assert nbk._interpret() is True            # the CPU test backend
    monkeypatch.setattr(nbk.jax, "default_backend", lambda: "gpu")
    assert nbk._interpret() is False
    monkeypatch.setattr(nbk.jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError, match="impl='dense'"):
        nbk._interpret()


def test_out_of_band_coords_unique_past_wrap():
    """Out-of-band (kid/dead/overflow) stencil coordinates must be UNIQUE
    across rows: band values are even-spaced and the bases are even, so any
    coordinate-triple collision gives cd2 = 0 <= 3.5 and injects a garbage
    pair (a live kid row paired with a far-away kid/overflow row's REAL
    position).  A single shared 2^19 row modulus collides at pair distance
    2^19 — reachable at the 10M/32^3 config where a block's stencil spans a
    whole cell plane (~400-800k rows); the per-axis coprime moduli make the
    effective wrap 2^19*(2^19-1).  This builds > 2^19 rows and checks the
    invariant directly on the prepared snapshot."""
    b = 512
    n = (1 << 19) + 4 * b                      # past the single-modulus wrap
    cfg = NBodyConfig(n_fill=16, capacity=n // 2, x_factor=2.0,
                      grid=GridSpec(grid_dim=4, chunk_factor=2), seed=0)
    pos = jnp.zeros((n, 3), jnp.float32)       # all in one cell
    age = jnp.zeros((n,), jnp.float32)         # all kids (< kid_age)
    w = jnp.full((n,), 60.0, jnp.float32)
    cell = jnp.zeros((n,), jnp.int32)
    alive = (jnp.arange(n) % 2 == 0)           # half kid band, half dead band
    snap, *_ = nbk.prepare(pos, age, w, cell, alive, cfg, b=b)
    coords = np.asarray(snap[nbk.I1:nbk.I3 + 1, :n])  # (3, N), out-of-band
    assert coords.max() < 0                    # nothing got in-band coords
    triples = coords.T.copy().view([("a", "f4"), ("b", "f4"), ("c", "f4")])
    assert len(np.unique(triples)) == n
    cfg = CONFIGS["dense-g4"]
    sa = sb = nbody.init_fill(cfg)
    for f in range(6):
        sa, sta = nbody.step(sa, jnp.int32(f), cfg, 0, "dense")
        sb, stb = nbody.step(sb, jnp.int32(f), cfg, 0, "blocks")
        assert int(sta.n_alive) == int(stb.n_alive), f
        assert int(sta.n_collision_kills) == int(stb.n_collision_kills), f
        assert int(sta.n_spawned) == int(stb.n_spawned), f
        np.testing.assert_array_equal(np.asarray(sa.alive),
                                      np.asarray(sb.alive), f)
        np.testing.assert_allclose(np.asarray(sa.pos), np.asarray(sb.pos),
                                   rtol=1e-4, atol=1e-4)

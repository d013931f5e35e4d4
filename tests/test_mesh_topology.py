"""Node-aware mesh construction.

The driver's default meshes must keep per-frame ring collectives (cyclic
migration ``ppermute``) inside one node, reserving the inter-node seam for
ONE block-wise axis — and every impossible-topology path must be LOUD,
never a silent fallthrough.  Multi-process topology is mocked through
``mesh._process_ids`` (the test's CPU devices all belong to process 0).
"""

import numpy as np
import pytest

from particlesystem_tpu.parallel import mesh as meshmod


class _Stub:
    """Stand-in device carrying only a process index (layout tests never
    build a real Mesh from these)."""

    def __init__(self, i, p):
        self.id = i
        self.process = p

    def __repr__(self):
        return f"d{self.id}@p{self.process}"


def _stub_granules(n_procs, per_proc):
    return [[_Stub(p * per_proc + i, p) for i in range(per_proc)]
            for p in range(n_procs)]


def test_block_layout_keeps_ring_axes_intra_slice():
    """Pencil (4, 2) over 2 processes of 4: inter=(2,1), intra=(2,2).  The
    'y' migration ring of every x-index must stay inside one process; the
    'x' ring crosses nodes only at the two block boundaries."""
    arr = meshmod._block_device_array(_stub_granules(2, 4), (2, 2), (2, 1))
    assert arr.shape == (4, 2)
    for i in range(4):
        row_procs = {d.process for d in arr[i, :]}   # the "y" ring
        assert len(row_procs) == 1, f"y-ring of x={i} spans processes"
    col = [d.process for d in arr[:, 0]]             # an "x" ring
    crossings = sum(col[i] != col[(i + 1) % 4] for i in range(4))
    assert crossings == 2  # block boundary + wraparound, never per-hop


def test_brick_layout_keeps_both_ring_axes_intra_slice():
    arr = meshmod._block_device_array(_stub_granules(2, 4), (1, 2, 2),
                                      (2, 1, 1))
    assert arr.shape == (2, 2, 2)
    for a in range(2):
        assert len({d.process for d in arr[a].ravel()}) == 1


def test_default_mesh_routes_through_hybrid_on_slices(monkeypatch):
    """With a mocked 2-process topology over the 8 CPU devices, the default
    pencil mesh must use the granule-block layout: process 0's devices fill
    x-rows 0-1, process 1's fill rows 2-3 (the flat layout would interleave
    them and lay the 'y' rings across nodes)."""
    monkeypatch.setattr(meshmod, "_process_ids",
                        lambda devs: [i // 4 for i in range(len(devs))])
    m = meshmod.default_mesh((4, 2), ("x", "y"))
    ids = np.vectorize(lambda d: d.id)(m.devices)
    assert ids.shape == (4, 2)
    assert set(ids[:2].ravel()) == {0, 1, 2, 3}   # granule 0 block
    assert set(ids[2:].ravel()) == {4, 5, 6, 7}   # granule 1 block


def test_default_mesh_flat_without_slices():
    m = meshmod.default_mesh((8,), ("x",))
    ids = np.vectorize(lambda d: d.id)(m.devices)
    np.testing.assert_array_equal(ids, np.arange(8))


def test_default_mesh_warns_when_topology_cannot_be_honored(monkeypatch):
    """3 uneven processes cannot tile axis 0 of a (4, 2) mesh — the
    fallback must be visible, not silent (it lays rings across nodes)."""
    monkeypatch.setattr(meshmod, "_process_ids",
                        lambda devs: [0, 0, 0, 1, 1, 1, 2, 2][:len(devs)])
    with pytest.warns(RuntimeWarning, match="cannot be honored"):
        m = meshmod.default_mesh((4, 2), ("x", "y"))
    assert m.devices.shape == (4, 2)


def test_hybrid_mesh_warns_on_create_hybrid_rejection(monkeypatch):
    """A requested inter-node split that does not match the processes
    (3 processes, 2 blocks) must warn before falling back to contiguous
    device blocks."""
    monkeypatch.setattr(meshmod, "_process_ids",
                        lambda d: [0, 0, 0, 1, 1, 1, 2, 2][:len(d)])
    with pytest.warns(RuntimeWarning, match="contiguous device blocks"):
        m = meshmod.hybrid_mesh((4,), (2,), ("x",))
    assert m.devices.shape == (8,)

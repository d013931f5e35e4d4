"""Multi-device decompositions and the distributed driver.

* ``mesh`` — 1D/2D/3D meshes, node-aware hybrid meshes, multi-host init
* ``nbody_sharded`` / ``nbody_pencil`` / ``nbody_brick`` — slab / pencil /
  brick spatial decompositions of the n-body scene
* ``emitter_sharded`` — data-parallel emitter engine
* ``driver`` — :class:`DistributedNBodySimulation`, the multi-chip
  ``DoParallelProcess`` equivalent
"""

from .driver import DistributedNBodySimulation
from .mesh import (hybrid_mesh, maybe_init_distributed, mesh_1d, mesh_2d,
                   mesh_3d)
from .nbody_brick import BrickSpec
from .nbody_pencil import PencilSpec
from .nbody_sharded import SlabSpec

__all__ = [
    "BrickSpec", "DistributedNBodySimulation", "PencilSpec", "SlabSpec",
    "hybrid_mesh", "maybe_init_distributed", "mesh_1d", "mesh_2d", "mesh_3d",
]

"""Static simulation configuration.

The reference keeps every tunable as a compile-time ``#define``
(``/root/reference/source/code/inc/common.h:7-70``).  Here the same knobs are
runtime dataclasses: frozen (hashable) so they can be closed over by ``jit``
without retracing churn, and with the derived quantities (cell counts, box
extents, per-cell capacity) exposed as properties instead of macro algebra
(``common.h:20-50``).

Two scene families are configured from here:

* :class:`NBodyConfig` — the reference simulation itself (softened gravity,
  collisions, aging/reproduction on a torus grid).
* :class:`EmitterSceneConfig` — the emitter/force-stack scenes used by the
  benchmark configs in ``BASELINE.md`` (fountain, drag+wind, plane/sphere
  colliders, continuous spawning).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Uniform spatial grid.

    Mirrors ``GRID_DIM``/``CELL_SIZE``/``CHUNK_FACTOR`` from ``common.h:25-30,52``.
    The world is a cube of ``grid_dim`` cells per axis, each ``cell_size`` wide,
    centred on the origin; positions torus-wrap back into the box
    (``app.cu:117-158``).  ``chunk_factor`` partitions the grid into chunks —
    in the reference this drives the per-chunk subtask decomposition; here it
    only drives occupancy statistics and the distributed slab decomposition.
    """

    grid_dim: int = 16
    cell_size: float = 5.0
    chunk_factor: int = 4

    @property
    def num_cells(self) -> int:
        return self.grid_dim ** 3

    @property
    def chunk_dim(self) -> int:
        return self.grid_dim // self.chunk_factor

    @property
    def num_chunks(self) -> int:
        return self.chunk_factor ** 3

    @property
    def half_extent(self) -> float:
        """Half box width; positions nominally live in ``(-half, half]``."""
        return (self.grid_dim / 2) * self.cell_size

    def __post_init__(self):
        if self.grid_dim % self.chunk_factor != 0:
            raise ValueError(
                f"grid_dim={self.grid_dim} not divisible by "
                f"chunk_factor={self.chunk_factor}"
            )


@dataclasses.dataclass(frozen=True)
class NBodyConfig:
    """Configuration of the reference particle simulation.

    Field-by-field source map into ``common.h``:

    * ``n_fill``            — ``MAX_PARTICLES_NUM`` (:12)
    * ``x_factor``          — ``X_FACTOR`` reserve multiplier (:13)
    * ``dt``                — ``DT`` (:69)
    * ``eps2``              — Plummer softening ``EPS2`` (:53)
    * ``collision_radius``  — ``COLLISION_RADIUS`` (:54)
    * ``weight``            — ``PARTICLE_WEIGHT_DEFAULT`` (:55)
    * ``particle_life``     — ``PARTICLE_LIFE = 300*DT`` (:58)
    * lifecycle ages        — ``KID/FERTILITY/ADULT`` ages (:59-63)
    * ``max_dx``/``max_v``  — displacement / velocity clamps (:65-66)
    * ``explosion_speed``   — ``EXPLOSION_SPEED`` (:67)
    * ``seed``              — ``RAND_SEED`` (:56); unlike the reference's host
      path (which reseeds ``std::mt19937`` from ``std::random_device`` on
      every call, ``particleSystem.cpp:944-945`` — nondeterministic), all
      randomness here is counter-based threefry keyed on (seed, frame).
    """

    n_fill: int = 1024 * 1024
    x_factor: int = 2
    grid: GridSpec = dataclasses.field(default_factory=GridSpec)
    capacity: int = 0          # 0 → derived: n_fill * x_factor (rounded)
    max_per_cell: int = 0      # 0 → derived like MAX_PARTICLES_PER_CELL

    dt: float = 0.05
    eps2: float = 0.2
    collision_radius: float = 0.4
    weight: float = 60.0

    particle_life: float = 300 * 0.05
    max_dx: float = 5.0
    max_v: float = 10.0
    explosion_speed: float = 3.0

    seed: int = 1
    spawn_budget: int = 0      # 0 -> derived: max children per frame

    # --- derived lifecycle ages (common.h:59-63) -------------------------
    @property
    def kid_age(self) -> float:
        return self.particle_life / 10.0

    @property
    def min_fertility_age(self) -> float:
        return self.particle_life / 6.0

    @property
    def max_fertility_age(self) -> float:
        return self.particle_life * 2.0

    @property
    def min_adult_age(self) -> float:
        return self.particle_life / 7.0

    @property
    def max_adult_age(self) -> float:
        return self.particle_life / 2.0

    # --- derived capacities ----------------------------------------------
    @property
    def slots(self) -> int:
        """Total particle slots (static array length).

        Replaces ``CONTAINER_SIZE`` (``common.h:32``): the reference reserves
        ~3x via the segmented-container algebra; we reserve ``x_factor``x flat
        and round up to a multiple of 1024.
        """
        if self.capacity:
            return self.capacity
        return _round_up(self.n_fill * self.x_factor, 1024)

    @property
    def max_spawns_per_frame(self) -> int:
        """Static cap on explosion children per frame.  Keeps the spawn
        scatter small (a scatter costs as much as its update rows, however
        few of them actually write).  The reference
        has no such cap, but spawns are bounded by free-slot availability
        there too; the numpy oracle applies the same cap so parity holds."""
        if self.spawn_budget:
            return self.spawn_budget
        return max(1024, self.slots // 32)

    @property
    def cell_capacity(self) -> int:
        """Per-cell particle cap; overflow kills the particle
        (``particleSystem.cpp:1517-1531``).  Formula mirrors
        ``MAX_PARTICLES_PER_CELL = ((N/NUM_CELLS)+1)*X_FACTOR``
        (``common.h:22``), rounded up to a multiple of 8."""
        if self.max_per_cell:
            return self.max_per_cell
        raw = (self.n_fill // self.grid.num_cells + 1) * self.x_factor
        return _round_up(raw, 8)


# ---------------------------------------------------------------------------
# Emitter scenes (BASELINE configs)
# ---------------------------------------------------------------------------


Vec3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Emitter:
    """Continuous particle source.

    The reference's only sources are the initial uniform fill
    (``particleSystem.cpp:962-1048``) and explosion births (:1307-1333);
    the BASELINE configs add rate-based emitters, modelled here.

    Particles spawn at ``pos`` + uniform offset within ``radius``, with
    velocity ``speed * (1 + speed_jitter*u)`` along ``direction`` perturbed
    inside a cone of ``cone_angle`` radians, lifetime uniform in
    ``[life_min, life_max]``.
    """

    pos: Vec3 = (0.0, 0.0, 0.0)
    direction: Vec3 = (0.0, 1.0, 0.0)
    speed: float = 10.0
    speed_jitter: float = 0.1
    cone_angle: float = 0.25
    radius: float = 0.5
    rate: float = 10000.0          # particles per second
    life_min: float = 2.0
    life_max: float = 4.0
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class PlaneCollider:
    """Infinite plane with restitution + tangential friction."""

    point: Vec3 = (0.0, 0.0, 0.0)
    normal: Vec3 = (0.0, 1.0, 0.0)
    restitution: float = 0.5
    friction: float = 0.2


@dataclasses.dataclass(frozen=True)
class SphereCollider:
    center: Vec3 = (0.0, 0.0, 0.0)
    radius: float = 1.0
    restitution: float = 0.5
    friction: float = 0.2


@dataclasses.dataclass(frozen=True)
class EmitterSceneConfig:
    """Emitter/force-stack scene (BASELINE configs 1-5).

    ``capacity`` is the static slot count; dead slots are recycled on device
    by prefix-sum compaction (the data-parallel replacement for the
    reference's per-segment free-id queues, ``app_common.cu:305-429``).
    """

    capacity: int = 1 << 17
    dt: float = 1.0 / 60.0
    gravity: Vec3 = (0.0, -9.8, 0.0)
    wind: Vec3 = (0.0, 0.0, 0.0)
    drag: float = 0.0
    emitters: Tuple[Emitter, ...] = ()
    planes: Tuple[PlaneCollider, ...] = ()
    spheres: Tuple[SphereCollider, ...] = ()
    seed: int = 1

    @property
    def slots(self) -> int:
        return _round_up(self.capacity, 1024)

    @property
    def max_spawn_per_step(self) -> int:
        """Static upper bound on per-frame spawns (shapes must be static)."""
        total = sum(e.rate for e in self.emitters)
        return max(1, _round_up(int(math.ceil(total * self.dt)) + len(self.emitters), 8))

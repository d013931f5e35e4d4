"""Data-parallel emitter engine over a device mesh.

Emitter scenes have no pairwise interactions, so scaling out is pure data
parallelism (SURVEY.md §2.5: the reference's analog is its 64-fragment init
split and 8-subtask waves).  Each device runs an independent shard of the
particle pool with its share of every emitter's rate and a decorrelated
RNG stream (device index folded into the spawn keys); no collectives are
needed inside the step — global stats reduce with ``psum`` on demand.

Capacity and spawn rates scale linearly with the mesh: D chips simulate
D times the particles at the single-chip frame time.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import EmitterSceneConfig
from ..runtime import checkpoint
from ..runtime.engine import EngineState, PackedEngine
from ..utils.timers import PhaseTimers


def _local_cfg(cfg: EmitterSceneConfig, d: int) -> EmitterSceneConfig:
    """Per-device scene: capacity and emitter rates divided by D."""
    emitters = tuple(dataclasses.replace(e, rate=e.rate / d)
                     for e in cfg.emitters)
    return dataclasses.replace(cfg, capacity=cfg.capacity // d,
                               emitters=emitters)


class ShardedEmitterEngine:
    """DP-sharded :class:`PackedEngine`.

    State layout: field arrays are global ``(D * local,)`` sharded on the
    mesh axis; the small per-device bookkeeping (accum, free list, cursor,
    frame) carries an explicit leading device axis.
    """

    def __init__(self, cfg: EmitterSceneConfig, mesh: Mesh,
                 alloc: str = "ring", refresh_interval: int = 1,
                 layout: str = "packed8"):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.d = mesh.devices.size
        self.cfg = cfg
        self.timers = PhaseTimers()
        self.local = PackedEngine(_local_cfg(cfg, self.d), alloc=alloc,
                                  refresh_interval=refresh_interval,
                                  layout=layout)

        ax = self.axis
        state_spec = EngineState(
            fields=tuple([P(ax)] * self.local.n_fields), accum=P(ax),
            free_list=P(ax), cursor=P(ax), n_free=P(ax), frame=P(ax))

        def device_frame(s: EngineState) -> EngineState:
            salt = jax.lax.axis_index(ax)
            local = EngineState(
                fields=s.fields, accum=s.accum[0], free_list=s.free_list[0],
                cursor=s.cursor[0], n_free=s.n_free[0], frame=s.frame[0])
            out = self.local._frame(local, salt)
            return EngineState(
                fields=out.fields, accum=out.accum[None],
                free_list=out.free_list[None], cursor=out.cursor[None],
                n_free=out.n_free[None], frame=out.frame[None])

        self._step = jax.jit(shard_map(
            device_frame, mesh=mesh, in_specs=(state_spec,),
            out_specs=state_spec, check_vma=False), donate_argnums=0)
        self._device_frame = device_frame
        self._state_spec = state_spec
        self._step_many_jits: dict = {}

    def _many_fn(self, k: int):
        """Per-k jit: ``k`` frames in ONE device dispatch — a fori_loop
        (unroll=2, the measured ~25% win of the single-chip ``step_many``,
        runtime/engine.py) around the per-device frame INSIDE the
        shard_map, so the DP engine pays dispatch latency once per batch
        like the single-chip engine."""
        fn = self._step_many_jits.get(k)
        if fn is None:
            body = self._device_frame

            def many(s: EngineState) -> EngineState:
                return jax.lax.fori_loop(0, k, lambda _, x: body(x), s,
                                         unroll=2)

            fn = jax.jit(shard_map(
                many, mesh=self.mesh, in_specs=(self._state_spec,),
                out_specs=self._state_spec, check_vma=False),
                donate_argnums=0)
            self._step_many_jits[k] = fn
        return fn

    def step_many(self, s: EngineState, k: int) -> EngineState:
        """Run ``k`` frames in one dispatch; bitwise-identical to ``k``
        :meth:`step` calls (same per-device frame body)."""
        with self.timers.phase("step"):
            return self._many_fn(k)(s)

    def init(self) -> EngineState:
        d = self.d
        ls = self.local.init()
        rep = lambda a: jnp.broadcast_to(a[None], (d,) + a.shape)
        # fields are (total,) flat, or (b_rows, W) 2-D for alloc='select';
        # either way the global array stacks D local copies along dim 0
        tile = lambda f: jnp.tile(f, (d,) + (1,) * (f.ndim - 1))
        state = EngineState(
            fields=tuple(tile(f) for f in ls.fields),
            accum=rep(ls.accum), free_list=rep(ls.free_list),
            cursor=rep(ls.cursor), n_free=rep(ls.n_free), frame=rep(ls.frame))
        shard = lambda spec: NamedSharding(self.mesh, spec)
        return EngineState(
            fields=tuple(jax.device_put(f, shard(P(self.axis)))
                         for f in state.fields),
            accum=jax.device_put(state.accum, shard(P(self.axis))),
            free_list=jax.device_put(state.free_list, shard(P(self.axis))),
            cursor=jax.device_put(state.cursor, shard(P(self.axis))),
            n_free=jax.device_put(state.n_free, shard(P(self.axis))),
            frame=jax.device_put(state.frame, shard(P(self.axis))),
        )

    def step(self, s: EngineState) -> EngineState:
        with self.timers.phase("step"):
            return self._step(s)

    # -- persistence (facility parity with the n-body drivers).
    # EngineState is a pytree, so the npz checkpoint machinery works
    # as-is; the stored fingerprint pins scene physics AND the sharding
    # shape (d, alloc, layout — a reload under a different mesh width would
    # change per-device rates and RNG decorrelation, so it is refused).
    def _meta(self) -> dict:
        return dict(d=self.d, alloc=self.local.alloc,
                    layout=self.local.layout,
                    **checkpoint.config_fingerprint(self.cfg))

    def save(self, path: str, s: EngineState) -> None:
        with self.timers.phase("save"):
            checkpoint.save(path, s, meta=self._meta())

    def load(self, path: str, s: EngineState) -> EngineState:
        """Resume from :meth:`save`; ``s`` (a state of this engine, e.g.
        ``init()``) provides the pytree template.  The loaded arrays are
        re-placed onto this engine's mesh shardings."""
        with self.timers.phase("load"):
            state, _ = checkpoint.load(path, s, expect_config=self._meta())
            return jax.tree.map(
                lambda tpl, arr: jax.device_put(
                    arr, NamedSharding(self.mesh, P(self.axis))),
                s, state)

    def alive_count(self, s: EngineState) -> int:
        if not hasattr(self, "_alive_count"):
            n_local = self.local.cfg.slots
            total = self.local.total
            d = self.d
            slim = self.local.layout == "slim"

            select = self.local.alloc == "select"

            @jax.jit
            def count(a, b):
                # (D*total,) flat (or (D*b_rows, W) for select) sharded on
                # the device axis -> per-device view; the reshape keeps each
                # device's rows on their owning device so the sum reduces
                # locally and combines with one collective.
                if select:  # (D*b_rows, W): all rows real, no shadow trim
                    a = a.reshape(d, -1)
                else:
                    a = a.reshape(d, total)[:, :n_local]
                if slim:  # a=death, b=per-device frame counters
                    alive = b.reshape(d, 1).astype(jnp.float32) < a
                else:     # a=age, b=life
                    if select:
                        b = b.reshape(d, -1)
                    else:
                        b = b.reshape(d, total)[:, :n_local]
                    alive = (a <= b) & (b > 0)
                return jnp.sum(alive.astype(jnp.int32))

            self._alive_count = count
        if self.local.layout == "slim":
            return int(self._alive_count(s.fields[6], s.frame))
        return int(self._alive_count(s.fields[6], s.fields[7]))

"""Batch-axis sharded rollout engine: one engine replica per mesh device.

The paper's throughput argument scales by *replication*: the spatial
multiplier is a fixed circuit, so more traffic means stamping more copies
of the same structure, never re-synthesizing it.  On GPUs that is data
parallelism with no collective in the hot loop: every device of the
:class:`~repro_torch.launch.mesh.DataMesh` holds one
:class:`~repro_torch.serve.ReservoirEngine` replica — the same
:class:`~repro_torch.plan.ExecutionPlan`, ``w_in`` and ``w_out``, placed
on that device once — and the batch axis is the only thing split.  Each
shard runs its replica's single-device rollout (one B2 launch on the
card) on its contiguous slice of the batch, so the sharded output is
bit-identical per sequence to the single-device engine: rows never mix
through the recurrence, and the CUDA kernels compute every row with the
same arithmetic whatever the batch (on the CPU twins, size the batch to
at least two rows per shard: a one-row CPU product may round another
way, ROADMAP C-port-1).

Shards that share a device share its replica and run one after another on
that device's current stream: a rollout launch is cooperative and sized
to everything the card holds at once, so two cannot run side by side.
Shards on different devices are all enqueued before anything waits.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import make_data_mesh
from repro_torch.parallel.sharding import data_axis_names, data_axis_size
from repro_torch.serve.api import _UNSET
from repro_torch.serve.engine import DENSE_DISPATCH_DENSITY, ReservoirEngine
from repro_torch.serve.stats import ServeStats

__all__ = ["ShardedReservoirEngine"]


class ShardedReservoirEngine(ReservoirEngine):
    """:class:`ReservoirEngine` with the batch dimension split over a mesh.

    Same public API (``submit`` / ``submit_many`` / ``rollout`` /
    ``predictions`` / the ``run_segment`` chunk API) and the same per-shard
    launch; the only new behavior is batch padding up to a multiple of the
    shard count (padded rows are zero sequences riding along in
    otherwise-idle shard capacity, and never leave the engine).

    Pass a ``mesh`` (a :class:`~repro_torch.launch.mesh.DataMesh`, whose
    devices may repeat) or just ``n_shards`` for a mesh over the first N
    CUDA devices.  The engine itself is the replica of its first device
    (the pool's device); every other distinct device gets a
    :class:`ReservoirEngine` built with this engine's resolved schedule,
    passed verbatim.
    """

    def __init__(self, params, *, mesh=None, n_shards: int | None = None,
                 backend: str = "auto", stats: ServeStats | None = None,
                 dense_dispatch_density: float = DENSE_DISPATCH_DENSITY,
                 vmem_budget: int | None = _UNSET,
                 specialize: bool = True, tenant=None,
                 crossover: int | None = None,
                 batch_tile_max: int | None = None, schedule=None):
        self.mesh = mesh if mesh is not None else make_data_mesh(n_shards)
        if not data_axis_names(self.mesh):
            raise ValueError(f"mesh has no data axes: {self.mesh.axis_names}")
        self.n_shards = data_axis_size(self.mesh)
        # kept for elastic rebuilds: a shrink must rebuild the engine with
        # the same dispatch policy, not the default
        self.dense_dispatch_density = dense_dispatch_density
        self._shards = None               # run_segment's shard selection
        # backend="auto" resolves through the plan autotuner in the base
        # constructor; the replicas take the resolved schedule, so every
        # shard serves the tuned launch
        super().__init__(params, backend=backend, stats=stats,
                         dense_dispatch_density=dense_dispatch_density,
                         vmem_budget=vmem_budget, specialize=specialize,
                         tenant=tenant, crossover=crossover,
                         batch_tile_max=batch_tile_max, schedule=schedule,
                         device=self.mesh.devices[0])
        # one replica per distinct device; shards on one device share it
        self._replicas: dict = {self.device: self}
        for dev in self.mesh.devices:
            if dev not in self._replicas:
                self._replicas[dev] = ReservoirEngine(
                    params, backend=self.backend, stats=ServeStats(),
                    dense_dispatch_density=dense_dispatch_density,
                    vmem_budget=self.vmem_budget, specialize=specialize,
                    tenant=tenant, crossover=self.crossover,
                    batch_tile_max=self.batch_tile_max,
                    schedule=self.schedule, device=dev)

    def like(self, params=None, *, mesh=None, stats=None, tenant=None):
        """A sibling engine with this one's dispatch policy.

        Elastic rebuilds (new ``mesh``, same params) and multi-tenant
        routing (new ``params``, same mesh) both need "the same engine,
        but for X" — mesh-mapped engines are built per server, not
        through the global ``engine_for`` LRU, because the mesh is part
        of their identity.  Same params carry this engine's resolved
        schedule verbatim; new params re-resolve through the tuner (a
        different matrix has its own schedule space)."""
        same = params is None or params is self.params
        return ShardedReservoirEngine(
            self.params if params is None else params,
            mesh=self.mesh if mesh is None else mesh,
            backend=self.backend if same else self.requested_backend,
            stats=self.stats if stats is None else stats,
            dense_dispatch_density=self.dense_dispatch_density,
            vmem_budget=self.vmem_budget if same else _UNSET,
            specialize=self.specialize, tenant=tenant,
            crossover=self.crossover if same else None,
            batch_tile_max=self.batch_tile_max if same else None,
            schedule=self.schedule if same else None)

    def run_segment(self, inputs, x0, *, shards=None, **kw):
        """:meth:`ReservoirEngine.run_segment` over the shards named in
        ``shards`` (all by default): the sharded batcher leaves out the
        shards that hold no live slot, so an idle shard makes no launch.
        A left-out shard's rows come back as zero outputs and an
        unchanged carry."""
        self._shards = shards
        try:
            return super().run_segment(inputs, x0, **kw)
        finally:
            self._shards = None

    def _dispatch(self, u, x0b, with_readout: bool, with_final: bool,
                  donate: bool = False):
        """Pad the batch to a multiple of the shard count, run each
        contiguous slice through its replica's single-device dispatch on
        the replica's device, and drop the padded rows.  ``donate`` writes
        every slice's final state into ``x0b`` in place."""
        b, t = u.shape[0], u.shape[1]
        per = -(-b // self.n_shards)
        bpad = per * self.n_shards
        xin = x0b
        if bpad != b:
            u = torch.cat([u, u.new_zeros((bpad - b,) + u.shape[1:])])
            xin = torch.cat([x0b, x0b.new_zeros((bpad - b, x0b.shape[1]))])
        run = (range(self.n_shards) if self._shards is None
               else sorted(set(self._shards)))
        rows = [slice(k * per, (k + 1) * per)
                for k in range(self.n_shards)]
        outs = [None] * self.n_shards
        finals = [xin[r] for r in rows]
        # every shard is enqueued before anything waits: shards on one
        # device run in turn on its stream, devices side by side
        for k in run:
            dev = self.mesh.devices[k]
            outs[k], finals[k] = ReservoirEngine._dispatch(
                self._replicas[dev], u[rows[k]].to(dev),
                xin[rows[k]].to(dev), with_readout, with_final or donate,
                donate)
        if len(run) < self.n_shards:
            width = (self._w_out.shape[1] if with_readout
                     else self.config.reservoir_dim)
            idle = u.new_zeros((per, t, width))
            outs = [idle if o is None else o for o in outs]
        out = (torch.cat([o.to(self.device) for o in outs])
               if self.n_shards > 1 else outs[0])[:b]
        if donate:
            # a slice on the pool's device was written in place; a padded
            # or remote one comes back into the caller's buffer
            for k in run:
                lo, hi = k * per, min((k + 1) * per, b)
                if lo < hi and (finals[k].device != self.device
                                or bpad != b):
                    x0b[lo:hi].copy_(finals[k][: hi - lo])
            return out, (x0b if with_final else None)
        if not with_final:
            return out, None
        xf = (torch.cat([f.to(self.device) for f in finals])
              if self.n_shards > 1 else finals[0])[:b]
        return out, xf

    def _record(self, batch, steps, t0, real_steps, defer=False):
        # account the shard-padding rows as executed-but-padded work, so
        # padding_efficiency stays honest about the sharding overhead
        bpad = -(-batch // self.n_shards) * self.n_shards
        if real_steps is None:
            real_steps = batch * steps
        return super()._record(bpad, steps, t0, real_steps, defer=defer)

    def _sync(self) -> None:
        for dev in self._replicas:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

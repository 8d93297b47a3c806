"""Step builders: train / prefill / decode, mesh-aware.

Each builder returns the function that drives training or serving (the
JAX package's builders return the same functions for ``jax.jit``; eager
PyTorch calls them as they are).  With a mesh (an
:class:`~repro_torch.launch.mesh.LMMesh`) the step runs under the
activation context of ``parallel/act.py``: the parameters and the
optimizer state are DTensors placed by ``parallel/sharding.py`` (e.g.
through ``lm_params_from_numpy(mesh=)``), a plain batch is split over the
data axes on the way in (each rank keeps its own rows of the global batch
every rank holds), and the outputs are DTensors (``.full_tensor()`` reads
one whole).

``lower_cell`` builds one (arch x shape x mesh) cell of the dry run, the
reference's ``jax.jit(...).lower(...)`` on ``ShapeDtypeStruct`` inputs:
the same branches (FSDP at serving time, int8 structs, ZeRO gradient
shardings, the optimizer dtype, train / prefill / decode).  Its
:class:`Lowered` runs the step once on rank 0 of the mesh (a
``fake_world`` of the mesh's size) on ``meta`` tensors (shapes, no data),
where the reference compiles (``.compile()``); the :class:`Compiled` it
returns holds the step's per-device memory and cost
(``launch/hlo_cost.StepTally``).
"""

from __future__ import annotations

import torch

from repro_torch.device import ieee_fp32
from repro_torch.models.common import (tree_leaves,
                                       tree_leaves_with_path,
                                       tree_map)
from repro_torch.models.transformer import LM, ParallelCtx
from repro_torch.optim import adamw
from repro_torch.parallel.act import (activation_mesh, current, data_entry,
                                      is_dtensor, region)
from repro_torch.parallel.sharding import data_axis_names

__all__ = ["Compiled", "Lowered", "lower_cell", "make_ctx",
           "make_train_step", "make_prefill_step", "make_decode_step"]


def make_ctx(mesh, cfg=None) -> ParallelCtx:
    if mesh is None:
        return ParallelCtx()
    daxes = data_axis_names(mesh) or ("data",)
    if cfg is not None and not cfg.use_tp and "model" in mesh.axis_names:
        daxes = daxes + ("model",)  # model axis joins DP/FSDP
    fsdp = cfg.expert_fsdp if cfg is not None else True
    return ParallelCtx(mesh=mesh, data_axes=daxes, fsdp=fsdp)


def _with_act_ctx(fn, mesh, ctx):
    """Run fn under the activation-sharding context, so the in-model
    anchors (``shard_batch``, ``pin``) constrain the DTensors."""
    if mesh is None:
        return fn

    def wrapped(*args, **kw):
        with activation_mesh(mesh, ctx.data_axes, ctx.model_axis):
            return fn(*args, **kw)

    return wrapped


def _place_batch(batch: dict, mesh) -> dict:
    """Each plain tensor of the batch (the same global batch on every rank)
    as a DTensor with its batch dim over the data axes, when it divides;
    DTensors pass as they are."""
    from torch.distributed.tensor import distribute_tensor

    ctx = current()
    out = {}
    for key, x in batch.items():
        if is_dtensor(x) or not isinstance(x, torch.Tensor):
            out[key] = x
            continue
        pl = region(ctx, x.ndim, d0=data_entry(ctx, x.shape[0]))
        out[key] = distribute_tensor(x, mesh.device_mesh, pl,
                                     src_data_rank=None)
    return out


def make_train_step(lm: LM, mesh, opt_cfg: adamw.AdamWConfig | None = None,
                    grad_shardings=None):
    """The train step ``(state, batch) -> (state, metrics)``.

    ``state`` is ``{"params", "opt": {"m", "v", "step"}}``; ``batch`` the
    loss's (``tokens`` (B, S+1) on the device, int64).  With
    ``microbatches = k > 1`` the batch splits into ``k`` slices along B,
    each slice's gradients (``torch.autograd.grad`` of ``lm.loss``) are
    added into an accumulator in ``opt_dtype`` and loss and gradients are
    divided by ``k``; with ``k == 1`` the gradients keep the parameters'
    dtype until the clip casts them, as in the reference.  Then
    ``adamw.apply_updates``; the new parameters and optimizer state are
    written into the state's own tensors (the port's stand-in for the
    reference's ``donate_argnums=0``; a DTensor into a DTensor of the same
    placements), and that state is returned with ``{"loss", "grad_norm",
    "lr"}`` (0-dim device tensors: nothing waits on the host).

    ``grad_shardings``: optional tree of ``NamedSharding`` for the gradient
    accumulator (ZeRO: shard grads even where the weights are kept
    resident, so per-microbatch reductions become reduce-scatters); each
    accumulator and each microbatch's gradients are redistributed to it.
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    ctx = make_ctx(mesh, lm.cfg)
    k = max(lm.cfg.microbatches, 1)
    acc_dtype = (torch.bfloat16 if lm.cfg.opt_dtype == "bfloat16"
                 else torch.float32)
    targets = (None if grad_shardings is None else
               dict(tree_leaves_with_path(grad_shardings)))

    def constrain(flat, params):
        """On a mesh the accumulator takes ``grad_shardings``, else the
        parameters' placements (the reference's accumulator inherits
        them)."""
        if mesh is None:
            return flat
        pls = ([p.placements for p in tree_leaves(params)] if targets is None
               else [targets[path].placements for path in _paths(params)])
        return [g if tuple(g.placements) == tuple(pl) else
                g.redistribute(g.device_mesh, pl)
                for g, pl in zip(flat, pls)]

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        loss = lm.loss(params, batch, ctx)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state, batch):
        # microbatch i is rows [i*m, (i+1)*m) of the global batch, as the
        # reference's reshape makes it; on a mesh each is then split over
        # the data axes
        micro = _split(batch, k) if k > 1 else [batch]
        if mesh is not None:
            micro = [_place_batch(mb, mesh) for mb in micro]
        # differentiable aliases of the parameters (no copy)
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        with ieee_fp32(lm.device):      # the backward's products too
            if k == 1:
                loss, flat = grads_of(params, micro[0])
            else:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=lm.device)
                flat = None
                for mb in micro:
                    mb_loss, g = grads_of(params, mb)
                    loss = loss + mb_loss
                    g = constrain([gi.to(acc_dtype) for gi in g], params)
                    if flat is None:
                        flat = [torch.zeros_like(gi) for gi in g]
                    for a, gi in zip(flat, g):
                        a.add_(gi)
                    del g
                loss = loss / k
                for a in flat:
                    a.div_(k)
        it = iter(flat)
        grads = tree_map(lambda _: next(it), state["params"])
        del flat
        with torch.no_grad():
            new_params, new_opt, metrics = adamw.apply_updates(
                state["params"], grads, state["opt"], opt_cfg)
            del grads
            _write_into(state["params"], new_params)
            _write_into(state["opt"], new_opt)
        return state, {"loss": loss, **metrics}

    return _with_act_ctx(train_step, mesh, ctx)


def _paths(tree, path=()) -> list:
    """The leaves' paths in ``tree_leaves`` order (insertion order)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, path + (k,))]
    return [] if tree is None else [path]


def _split(batch: dict, k: int) -> list:
    """``k`` microbatches: consecutive slices of B (the reference's
    ``reshape((k, B // k) + ...)``), views with no copy (a DTensor batch is
    gathered whole first)."""
    batch = {key: x.full_tensor() if is_dtensor(x) else x
             for key, x in batch.items()}
    b = batch["tokens"].shape[0]
    if b % k:
        raise ValueError(f"batch {b} does not split into {k} microbatches")
    m = b // k
    return [{key: x[i * m:(i + 1) * m] for key, x in batch.items()}
            for i in range(k)]


def _write_into(dst, src) -> None:
    """Every leaf of ``src`` into the tensor at the same path of ``dst``
    (a DTensor into a DTensor: ``src`` redistributed to ``dst``'s
    placements, then shard into shard)."""
    d, s = tree_leaves_with_path(dst), tree_leaves_with_path(src)
    if [p for p, _ in d] != [p for p, _ in s]:
        raise ValueError("the updated state's leaves do not match the "
                         "state's")
    dl, sl = [x for _, x in d], [x for _, x in s]
    for i, (a, b) in enumerate(zip(dl, sl)):
        if is_dtensor(a):
            if tuple(b.placements) != tuple(a.placements):
                b = b.redistribute(a.device_mesh, a.placements)
            dl[i], sl[i] = a.to_local(), b.to_local()
        elif is_dtensor(b):
            sl[i] = b.full_tensor()
    torch._foreach_copy_(dl, sl)


def make_prefill_step(lm: LM, mesh, cache_len: int):
    ctx = make_ctx(mesh, lm.cfg)

    def prefill_step(params, batch):
        if mesh is not None:
            batch = _place_batch(batch, mesh)
        return lm.prefill(params, batch, cache_len=cache_len, ctx=ctx)

    return _with_act_ctx(prefill_step, mesh, ctx)


def make_decode_step(lm: LM, mesh):
    ctx = make_ctx(mesh, lm.cfg)

    def decode_step(params, caches, token):
        if mesh is not None:
            token = _place_batch({"t": token}, mesh)["t"]
        return lm.decode_step(params, caches, token, ctx=ctx)

    return _with_act_ctx(decode_step, mesh, ctx)


# ---------------------------------------------------------------------------
# the dry run: one cell on meta tensors
# ---------------------------------------------------------------------------
def _materialize(tree):
    """ShapeDtypeStruct leaves -> empty ``meta`` tensors (shapes and
    dtypes, no data): a leaf with a sharding of rank >= 1 as a DTensor
    holding rank 0's shard, a 0-dim leaf as a plain tensor (the port keeps
    the optimizer's step and the decode position plain, the same on every
    rank)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import ShapeDtypeStruct

    def one(sds):
        if not isinstance(sds, ShapeDtypeStruct):
            return sds
        if sds.sharding is None or not sds.shape:
            return torch.zeros(sds.shape, dtype=sds.dtype, device="meta")
        mesh = sds.sharding.mesh
        pl = sds.sharding.placements
        local = list(sds.shape)
        for i, p in enumerate(pl):
            if hasattr(p, "dim"):
                local[p.dim] //= mesh.device_mesh.size(i)
        t = torch.empty(local, dtype=sds.dtype, device="meta")
        return DTensor.from_local(t, mesh.device_mesh, pl, run_check=False)

    return tree_map(one, tree)


class Compiled:
    """What one run of a cell's step measured on rank 0 (the reference's
    compiled executable's analyses)."""

    def __init__(self, tally):
        self._tally = tally

    def memory_analysis(self) -> dict:
        """``argument_bytes``, ``output_bytes``, ``temp_bytes``,
        ``alias_bytes``, ``peak_bytes`` per device (``StepTally.memory``)."""
        return self._tally.memory()

    def cost_analysis(self) -> dict:
        """``flops``: the step's DTensor products counted at their global
        shapes (every rank's work; a local region's plain products are not
        in it), the counterpart of XLA's flat count."""
        return {"flops": float(self._tally.global_flops)}

    def walk(self) -> dict:
        """The HLO walker's keys, per device (``StepTally.walk``)."""
        return self._tally.walk()

    def op_table(self) -> str:
        """Per-device FLOPs and collective bytes by kind, one per line,
        then one line per operation (the artefact the dry run saves where
        the reference saves HLO)."""
        w = self.walk()
        lines = [f"dot_flops {w['dot_flops']!r}",
                 f"conv_flops {w['conv_flops']!r}",
                 f"global_flops {self._tally.global_flops!r}",
                 f"local_ops {self._tally.n_ops}"]
        lines += [f"collective {k} {v!r}"
                  for k, v in sorted(w["collective_bytes"].items())]
        lines += [f"memory {k} {v}" for k, v in self.memory_analysis().items()]
        # each operation: kind, op, shapes (a collective's output and its
        # group's size; a global product's DTensors and their placements),
        # how often it ran and its FLOPs or bytes in all
        lines += [f"op {kind} {op} {shapes} n={n} total={amount!r}"
                  for (kind, op, shapes), (n, amount)
                  in sorted(self._tally.ops.items())]
        return "\n".join(lines) + "\n"


class Lowered:
    """A cell's step and its abstract inputs, ready to run on meta tensors:
    ``compile()`` materializes the inputs (rank 0's shards), runs the step
    once under a ``StepTally`` and returns the :class:`Compiled`.  The
    step writes argument ``writes`` in place (the train state, the decode
    caches); unless it is donated the step writes into a copy, which the
    tally counts."""

    def __init__(self, fn, args: tuple, writes=None, donate: bool = True):
        self.fn = fn
        self.args = args
        self.writes = writes
        self.donate = donate

    def compile(self) -> Compiled:
        from repro_torch.launch.hlo_cost import StepTally

        with StepTally() as tally:
            args = [_materialize(a) for a in self.args]
            tally.mark_arguments(args)
            if self.writes is not None and not self.donate:
                args[self.writes] = tree_map(lambda t: t.clone(),
                                             args[self.writes])
            out = self.fn(*args)
            tally.mark_outputs(out)
            del out, args
        return Compiled(tally)


def lower_cell(arch_cfg, shape, mesh, donate: bool = True):
    """Build the step for one (arch x shape x mesh) cell on abstract
    inputs (``launch/specs.py``).

    Returns (lowered, meta) where meta records what was lowered.
    """
    from repro_torch.launch import specs as specs_lib
    from repro_torch.models.quantize import quant_struct_like
    from repro_torch.parallel.sharding import ShapeDtypeStruct

    lm = LM(arch_cfg, device="meta")
    serving = shape.kind != "train"
    fsdp = arch_cfg.fsdp and (arch_cfg.serving_fsdp if serving else True)
    param_structs, _ = specs_lib.params_specs(lm, mesh, fsdp=fsdp)

    if serving and arch_cfg.frozen_sparse_serving:
        # paper technique: serving weights are frozen -> int8 storage
        param_structs = quant_struct_like(param_structs)

    if shape.kind == "train":
        grad_sh = None
        opt_base = param_structs
        if not arch_cfg.expert_fsdp:
            # ZeRO: grads + optimizer states fully sharded even though the
            # expert weights stay EP-resident
            _, grad_sh = specs_lib.params_specs(lm, mesh, fsdp=True,
                                                expert_fsdp=True)
            opt_base = tree_map(
                lambda s, sh: ShapeDtypeStruct(s.shape, s.dtype, sh),
                param_structs, grad_sh)
        opt = specs_lib.opt_state_specs(opt_base, mesh,
                                        dtype=arch_cfg.opt_dtype)
        state = {"params": param_structs, "opt": opt}
        batch = specs_lib.batch_specs(arch_cfg, shape, mesh)
        fn = make_train_step(lm, mesh, grad_shardings=grad_sh)
        lowered = Lowered(fn, (state, batch), 0, donate)
        meta = {"step": "train_step", "donated": "state"}
    elif shape.kind == "prefill":
        batch = specs_lib.batch_specs(arch_cfg, shape, mesh)
        fn = make_prefill_step(lm, mesh, cache_len=shape.seq_len)
        lowered = Lowered(fn, (param_structs, batch))
        meta = {"step": "prefill_step"}
    else:  # decode
        caches = specs_lib.cache_specs(lm, shape, mesh)
        token = specs_lib.token_spec(shape, mesh)
        fn = make_decode_step(lm, mesh)
        lowered = Lowered(fn, (param_structs, caches, token), 1, donate)
        meta = {"step": "serve_step", "donated": "caches"}
    return lowered, meta

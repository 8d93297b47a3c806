"""ShapeDtypeStruct stand-ins for every model input, with shardings.

``batch_specs`` / ``params_specs`` / ``opt_state_specs`` / ``cache_specs``
/ ``token_spec`` produce the exact trees each step function consumes, as
:class:`~repro_torch.parallel.sharding.ShapeDtypeStruct` leaves (shape,
``torch.dtype`` and a ``NamedSharding``) with zero allocation, so the dry
run can run any (arch x shape x mesh) cell on fake tensors
(``launch/steps.lower_cell``).  Shapes, dtypes and specs are the JAX
package's, but for the token ids: int64, the dtype the port's embedding
lookup and cross entropy index with (the reference's are int32).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.common import tree_map
from repro_torch.models.transformer import LM, _map_path, cache_spec
from repro_torch.parallel.sharding import (NamedSharding, ShapeDtypeStruct,
                                           _axis_size, data_axis_names,
                                           param_shardings)

__all__ = ["N_PATCHES", "batch_specs", "cache_specs", "opt_state_specs",
           "params_specs", "token_spec"]

N_PATCHES = 256  # vlm frontend stub: image tokens prepended to the text

TOKEN_DTYPE = torch.int64


def _sds(shape, dtype, sharding=None):
    return ShapeDtypeStruct(shape, dtype, sharding)


def _bspec(mesh, ndim, batchable=True):
    d = data_axis_names(mesh)
    first = (d if len(d) > 1 else d[0]) if (d and batchable) else None
    return NamedSharding(mesh, (first,) + (None,) * (ndim - 1))


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Training/prefill batch structs for one shape cell."""
    b, s = shape.global_batch, shape.seq_len
    nd = _axis_size(mesh, data_axis_names(mesh))
    batchable = b % nd == 0 and b >= nd
    out = {}
    if shape.kind == "train":
        out["tokens"] = _sds((b, s + 1), TOKEN_DTYPE,
                             _bspec(mesh, 2, batchable))
    else:
        out["tokens"] = _sds((b, s), TOKEN_DTYPE, _bspec(mesh, 2, batchable))
    if cfg.frontend == "vision":
        out["patches"] = _sds((b, N_PATCHES, cfg.d_model), torch.bfloat16,
                              _bspec(mesh, 3, batchable))
    if cfg.encoder is not None:
        out["frames"] = _sds((b, cfg.encoder.seq_len, cfg.d_model),
                             torch.bfloat16, _bspec(mesh, 3, batchable))
    return out


def params_specs(lm: LM, mesh, fsdp: bool = True,
                 expert_fsdp: bool | None = None) -> tuple:
    """(param ShapeDtypeStructs with shardings, shardings tree)."""
    pa = LM(lm.cfg, device="meta")._init(torch.Generator(),
                                         torch.device("meta"))
    ef = lm.cfg.expert_fsdp if expert_fsdp is None else expert_fsdp
    shardings = param_shardings(pa.axes, pa.params, mesh, fsdp=fsdp,
                                use_tp=lm.cfg.use_tp, expert_fsdp=ef)
    structs = tree_map(lambda t, sh: _sds(t.shape, t.dtype, sh), pa.params,
                       shardings)
    return structs, shardings


def opt_state_specs(param_structs, mesh, dtype: str = "float32") -> dict:
    """AdamW (m, v, step) structs mirroring the parameter shardings."""
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    moment = lambda sds: _sds(sds.shape, dt, sds.sharding)
    m = tree_map(moment, param_structs)
    v = tree_map(moment, param_structs)
    step = _sds((), torch.int32, NamedSharding(mesh, ()))
    return {"m": m, "v": v, "step": step}


def cache_specs(lm: LM, shape: ShapeSpec, mesh) -> Any:
    """Decode caches as ShapeDtypeStructs for a full-length context, each
    leaf placed by its structural role (``models/transformer.cache_spec``,
    the policy ``init_caches`` places a mesh's caches by)."""
    cfg = lm.cfg
    b = shape.global_batch
    caches = LM(cfg, device="meta").init_caches(b, shape.seq_len)
    if cfg.encoder is not None:
        caches = dict(caches)
        caches["enc"] = torch.empty((b, cfg.encoder.seq_len, cfg.d_model),
                                    dtype=torch.bfloat16, device="meta")

    def leaf(path, t):
        spec = cache_spec(path, tuple(t.shape), cfg, mesh)
        return _sds(t.shape, t.dtype, NamedSharding(mesh, spec))

    return _map_path(leaf, caches)


def token_spec(shape: ShapeSpec, mesh):
    b = shape.global_batch
    nd = _axis_size(mesh, data_axis_names(mesh))
    return _sds((b, 1), TOKEN_DTYPE,
                _bspec(mesh, 2, b % nd == 0 and b >= nd))

"""Frozen-weight int8 specialization for serving — the paper's technique
applied to LM inference.

The paper's core premise: when a matrix is fixed for the lifetime of the
computation, specialize its representation offline.  At LM serving time
all weights are frozen, and decode is memory-roofline-bound (every weight
is re-read per token).  Every large float leaf becomes symmetric int8 with
a per-output-channel float32 scale (the paper's 8-bit signed weights),
expanded back per layer inside the layer loop, as the JAX package does.
Unlike XLA on a TPU, eager PyTorch does not fuse that expansion into the
product: each layer's bf16 copy is written and read again.

Quantization runs one layer slice at a time (the scale reduces within a
slice, so the result is the whole-leaf computation's): a stacked MLP leaf
of a 12 B model holds 2.9 G elements, and a float32 copy of it 11.7 GB.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import tree_map
from repro_torch.parallel.sharding import (NamedSharding, ShapeDtypeStruct,
                                           scale_spec)

MIN_QUANT_SIZE = 1 << 16  # don't quantize norms/biases/small tables

__all__ = ["MIN_QUANT_SIZE", "quantize_tree", "dequant_tree",
           "is_quantized_leaf", "quant_struct_like"]


def _should_quantize(x) -> bool:
    if (not isinstance(x, (torch.Tensor, ShapeDtypeStruct))
            or not x.dtype.is_floating_point):
        return False
    shape = tuple(x.shape)
    if int(np.prod(shape)) < MIN_QUANT_SIZE:
        return False
    # >=3D: a true matrix (possibly layer-stacked).  2D: require both dims
    # large — excludes layer-stacked norm/bias vectors like (layers, d).
    return len(shape) >= 3 or (len(shape) == 2 and min(shape) >= 1024)


def is_quantized_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _quantize(w, red):
    w = w.float()
    amax = w.abs().amax(dim=red, keepdim=True)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its float32 reciprocal, which is not amax / 127
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_tree(params: Any) -> Any:
    """Replace big float leaves with {"q": int8, "scale": f32[last_dim]}
    (``scale`` keeps a layer-stacked leaf's leading dim: (layers, out))."""

    def one(x):
        if not _should_quantize(x):
            return x
        if x.ndim >= 3:
            # scale over (stack dim, out channels): one slice at a time
            red = tuple(range(x.ndim - 2))
            q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
            scale = torch.empty((x.shape[0], x.shape[-1]),
                                dtype=torch.float32, device=x.device)
            for i in range(x.shape[0]):
                qi, si = _quantize(x[i], red)
                q[i] = qi
                scale[i] = si.reshape(-1)
            return {"q": q, "scale": scale}
        q, scale = _quantize(x, (0,))
        return {"q": q, "scale": scale.reshape(-1)}

    return tree_map(one, params)


def dequant_tree(params: Any, dtype=torch.bfloat16) -> Any:
    """Inverse of quantize_tree (no-op on unquantized leaves).  On a mesh
    ``q`` and ``scale`` are DTensors placed by ``scale_spec``: the scale's
    dims are split as the weight's out-channel (and layer) dims, so each
    rank scales its own shard and the product keeps the weight's
    placements, with no collective."""

    def one(x):
        if is_quantized_leaf(x):
            q, scale = x["q"], x["scale"]
            if scale.ndim == 2:    # (layers, out) — a whole stacked leaf
                shape = ((scale.shape[0],) + (1,) * (q.ndim - 2)
                         + (scale.shape[1],))
            else:                  # (out,) — plain or one layer's slice
                shape = (1,) * (q.ndim - 1) + (scale.shape[0],)
            return q.to(dtype) * scale.reshape(shape).to(dtype)
        return x

    return tree_map(one, params, is_leaf=is_quantized_leaf)


def quant_struct_like(struct: Any) -> Any:
    """ShapeDtypeStruct tree -> the quantized-serving struct tree.

    ``q`` inherits the original sharding; ``scale`` (out-channel vector)
    takes the last axis' spec (``scale_spec``).
    """

    def one(sds):
        if not _should_quantize(sds):
            return sds
        sh = sds.sharding
        sc_shape = ((sds.shape[0], sds.shape[-1]) if len(sds.shape) >= 3
                    else (sds.shape[-1],))
        s_sh = (None if sh is None else
                NamedSharding(sh.mesh, scale_spec(sh.spec, len(sds.shape))))
        return {"q": ShapeDtypeStruct(sds.shape, torch.int8, sh),
                "scale": ShapeDtypeStruct(sc_shape, torch.float32, s_sh)}

    return tree_map(one, struct)

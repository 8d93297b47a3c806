"""Gradient compression for bandwidth-thin links (cross-pod axis).

int8 block-quantized all-reduce with error feedback: each participant
quantizes (gradient + residual) to int8 with a per-block f32 scale, reduces
the int8 payload, and keeps the quantization error as residual for the next
step.  Error feedback makes the compressed SGD/Adam trajectory converge to
the uncompressed one (Karimireddy et al., 2019); ~3.5x fewer bytes on the
pod-to-pod hops, which are the slowest links in a 2-pod mesh.

``compressed_psum`` is the reduction over one mesh axis, called on a
rank's local shard inside a local region (the reference's ``shard_map``).
Rounding is ``torch.round`` (half to even, as ``jnp.round``), so the int8
payloads and scales equal the reference's bit for bit.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import tree_map

__all__ = ["quantize_block_int8", "dequantize_block_int8",
           "compressed_psum", "init_residuals", "compress_grads_with_feedback"]

BLOCK = 2048


def quantize_block_int8(x: torch.Tensor, block: int = BLOCK):
    """x (f32, any shape) -> (int8 payload, f32 per-block scales, pad)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its float32 reciprocal, which is not amax / 127
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float(), pad


def dequantize_block_int8(q, scale, pad, shape):
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_psum(x: torch.Tensor, axis_name: str, *, mesh=None):
    """psum of an int8-quantized payload over the mesh axis ``axis_name``
    (``x`` a rank's local shard, as inside ``shard_map``; ``mesh`` defaults
    to the activation context's).  Returns the dequantized contribution
    summed over the axis and the local quantization error (for
    feedback)."""
    import torch.distributed as dist

    from repro_torch.parallel import act

    if mesh is None:
        ctx = act.current()
        if ctx is None:
            raise ValueError("compressed_psum needs a mesh: pass mesh= or "
                             "call it under activation_mesh")
        mesh = ctx["mesh"]
    q, scale, pad = quantize_block_int8(x)
    local = dequantize_block_int8(q, scale, pad, x.shape)
    err = x - local
    # reduce the dequantized-but-quantization-limited payload; the wire
    # format in a real runtime is (int8, scales) -- bytes modeled accordingly.
    total = local.clone()
    dist.all_reduce(total, group=mesh.axis_group(axis_name))
    return total, err


def init_residuals(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_grads_with_feedback(grads: Any, residuals: Any):
    """Quantize (grad + residual) to int8, return (dequantized grads for the
    cross-pod reduce, new residuals).  Pure local transform -- composable
    with any reduction the runtime applies afterwards."""
    def one(g, r):
        x = g.float() + r
        q, scale, pad = quantize_block_int8(x)
        deq = dequantize_block_int8(q, scale, pad, x.shape)
        return deq, x - deq

    out = tree_map(one, grads, residuals)
    comp = tree_map(lambda t: t[0], out)
    res = tree_map(lambda t: t[1], out)
    return comp, res

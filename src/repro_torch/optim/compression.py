"""Gradient compression for bandwidth-thin links (cross-pod axis).

int8 block-quantized all-reduce with error feedback: each participant
quantizes (gradient + residual) to int8 with a per-block f32 scale, reduces
the int8 payload, and keeps the quantization error as residual for the next
step.  Error feedback makes the compressed SGD/Adam trajectory converge to
the uncompressed one (Karimireddy et al., 2019); ~3.5x fewer bytes on the
pod-to-pod hops, which are the slowest links in a 2-pod mesh.

The port has the local transform; the reduction over a mesh axis
(``compressed_psum``) waits for the collectives of ROADMAP A12f2.
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


def compressed_psum(x: torch.Tensor, axis_name: str):
    """The reference's psum of an int8-quantized payload over a mesh axis
    (inside ``shard_map``): a collective, not ported yet."""
    raise NotImplementedError(
        "A12f2: compressed_psum reduces over a device-mesh axis; the "
        "collectives are not ported yet (the local transform is "
        "compress_grads_with_feedback)")


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

"""int8 compression — per-block max-abs scaling.

Quantize to int8 with one fp32 scale per ``block`` elements, which bounds
the elementwise error by ``max|block| / 127``.  Zero blocks round-trip
exactly (scale 0 → payload 0 → dequantized 0).

The device codec (:func:`quantize_int8`, :func:`dequantize_int8`,
:func:`compress_roundtrip_error`) works on tensors on any device, in f32;
``torch.round`` rounds half to even, as ``jnp.round`` does, so its
payloads and scales equal the numpy codec's byte for byte.  The numpy
codec behind the Pack-side ``compress="int8"`` tier
(core/tiers.Int8CompressTier) is a copy of the JAX package's numpy
variants, so both packages encode and decode the same bytes.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

BLOCK = 1024


def quantize_int8(g: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (q int8 ``(n_blocks, block)``, scale fp32 ``(n_blocks,)``) on
    ``g``'s device."""
    flat = g.reshape(-1).float()
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    live = (scale > 0.0)[:, None]
    safe = torch.where(live, scale[:, None], 1.0)
    q = torch.where(live, torch.round(blocks / safe), 0.0)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (drops the block padding)."""
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[: math.prod(shape)].reshape(tuple(shape))


def compress_roundtrip_error(g: torch.Tensor, block: int = BLOCK
                             ) -> torch.Tensor:
    """Relative L2 round-trip error — the metric the compression tier logs
    to decide whether a payload is worth quantizing."""
    q, s = quantize_int8(g, block)
    back = dequantize_int8(q, s, g.shape)
    g32 = g.float()
    denom = torch.clamp(torch.linalg.vector_norm(g32), min=1e-12)
    return torch.linalg.vector_norm(back - g32) / denom


def quantize_int8_np(a: np.ndarray, block: int = BLOCK
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy mirror of the JAX package's ``quantize_int8`` for Pack-side payload
    compression (core/tiers.Int8CompressTier).  Bit-identical semantics:
    per-block max-abs scale, zero blocks round-trip exactly.

    One vectorized max-abs/scale pass over the ``(n_blocks, block)``
    reshape; round/clip run in place on the single quotient temporary
    (the old masked-``where`` formulation materialized three extra
    block-matrix temporaries, which dominated the compressed-store
    overhead benchmark)."""
    flat = np.asarray(a).reshape(-1)
    if flat.dtype != np.float32:
        flat = flat.astype(np.float32)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = np.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = np.abs(blocks).max(axis=1)
    scale /= np.float32(127.0)
    safe = np.where(scale > 0.0, scale, np.float32(1.0))
    q = blocks / safe[:, None]
    np.rint(q, out=q)
    np.clip(q, -127.0, 127.0, out=q)
    # blocks whose scale is 0 (all-zero) or NaN quantize to 0, exactly as
    # the jnp version's where(scale > 0, ..., 0) mask does
    q[~(scale > 0.0)] = 0.0
    return q.astype(np.int8), scale


def dequantize_int8_np(q: np.ndarray, scale: np.ndarray,
                       shape: Sequence[int]) -> np.ndarray:
    """Inverse of :func:`quantize_int8_np` (drops the block padding)."""
    out = q.astype(np.float32)
    out *= np.asarray(scale)[:, None]
    return out.reshape(-1)[: math.prod(shape)].reshape(tuple(shape))

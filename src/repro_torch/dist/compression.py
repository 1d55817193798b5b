"""int8 payload compression — per-block max-abs scaling (host side).

The numpy codec behind the Pack-side ``compress="int8"`` tier
(core/tiers.Int8CompressTier): quantize to int8 with one fp32 scale per
``block`` elements, which bounds the elementwise error by
``max|block| / 127``.  Zero blocks round-trip exactly (scale 0 → payload 0
→ dequantized 0).  A copy of the JAX package's numpy variants, so both
packages encode and decode the same bytes.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

BLOCK = 1024


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

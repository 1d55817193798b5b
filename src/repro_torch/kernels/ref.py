"""Plain PyTorch versions of the checkpoint kernels (and the CPU path).

The hash is a position-salted multiply–xorshift mix (murmur3-finalizer
family) folded with wrapping uint32 addition — commutative, so a kernel
can reduce in any order and still match these versions bit for bit.

u32 words travel in ``torch.int32`` tensors (same bits): ``torch.uint32``
has no ``>>`` and no ``sum`` on the CPU.  The arithmetic runs in int64,
masked to 32 bits after every multiply and add; each 32×32-bit multiply
is split into 16-bit halves so no int64 product overflows.
"""
from __future__ import annotations

import torch

HASH_SALT_A = 0x9E3779B9   # golden-ratio odd constants
HASH_SALT_B = 0x85EBCA6B

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → int64 values in [0, 2³²)."""
    return x.to(torch.int64) & _M32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) → int32 tensor with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for x in [0, 2³²) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over int64 values in [0, 2³²)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def blockhash_ref(blocks_u32: torch.Tensor, salt: int = HASH_SALT_A
                  ) -> torch.Tensor:
    """(n_blocks, elems) u32 words → (n_blocks,) u32 per-block hash.

    hash(b) = Σ_i mix32(x[b,i] ⊕ (i·salt))  (wrapping add — commutative).
    """
    _n, e = blocks_u32.shape
    idx = _mul32(torch.arange(e, dtype=torch.int64,
                              device=blocks_u32.device), salt)
    h = mix32(_u32(blocks_u32) ^ idx[None, :])
    return _as_i32(h.sum(dim=1) & _M32)


def blockhash2_ref(blocks_u32: torch.Tensor) -> torch.Tensor:
    """Two independent 32-bit lanes → (n_blocks, 2) u32 (64-bit digest)."""
    return torch.stack([blockhash_ref(blocks_u32, HASH_SALT_A),
                        blockhash_ref(blocks_u32, HASH_SALT_B)], dim=1)


def diffpack_ref(blocks: torch.Tensor, dirty_idx: torch.Tensor
                 ) -> torch.Tensor:
    """Gather dirty blocks: (n_blocks, e), (n_dirty,) → (n_dirty, e)."""
    return blocks[dirty_idx.to(torch.int64)]


def diffunpack_ref(base: torch.Tensor, packed: torch.Tensor,
                   dirty_idx: torch.Tensor) -> torch.Tensor:
    """Scatter packed blocks into a copy of base: inverse of diffpack."""
    out = base.clone()
    out[dirty_idx.to(torch.int64)] = packed
    return out

"""Public entry points for the kernels, dispatched by device.

A CUDA tensor launches the hand-written Hopper kernel (and raises if it
cannot be built or launched); a CPU tensor takes the plain PyTorch version
in ``ref.py``.  Nothing falls back from one to the other.

Attention (:func:`flash_attention`, :func:`flash_attention_bshd`) is
differentiable: a ``torch.autograd.Function`` whose forward is the kernel
(or, on the CPU, the plain version) and whose backward is the exact
gradient in plain PyTorch (``ref.flash_attention_vjp_ref``).  The JAX
package has no backward kernel either: its Pallas kernel is forward only.

Digest tables and packed blocks are ``torch.int32`` tensors carrying u32
bits; :func:`u32_numpy` turns them into the ``np.uint32`` arrays the JAX
package produces.  The dirty map and the digest fingerprint are computed
on the host from those small tables, as in the JAX package.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import blockhash as bh
from repro_torch.kernels import diffpack as dp
from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import ref

DEFAULT_BLOCK_BYTES = 65_536      # 64 KiB — FTI dCP-scale block granularity


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no checkpoint kernel for device {x.device}")


def as_u32_blocks(x: torch.Tensor, block_bytes: int = DEFAULT_BLOCK_BYTES
                  ) -> Tuple[torch.Tensor, int]:
    """A copy of ``x``'s C-order bytes as ``(n_blocks, block_bytes/4)`` u32
    words (int32 bits), zero-padded → ``(blocks, n_blocks)``.

    The same words as the JAX package's ``as_u32_blocks`` for 1-, 2-, 4-
    and 8-byte dtypes: u16 pairs and u8 quads pack little-endian, an 8-byte
    element splits into its low then high word, and a ragged tail is
    zero-padded.  This is the input of the plain versions; the kernels read
    the leaf's bytes in place instead."""
    if block_bytes <= 0 or block_bytes % 4:
        raise ValueError(f"block_bytes must be a positive multiple of 4, "
                         f"got {block_bytes}")
    raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
    n_blocks = bh.n_blocks_of(raw.numel(), block_bytes)
    padded = torch.zeros(n_blocks * block_bytes, dtype=torch.uint8,
                         device=x.device)
    padded[: raw.numel()] = raw
    return padded.view(torch.int32).reshape(n_blocks, block_bytes // 4), \
        n_blocks


def blockhash(x: torch.Tensor, block_bytes: int = DEFAULT_BLOCK_BYTES
              ) -> torch.Tensor:
    """Tensor → ``(n_blocks, 2)`` int32 digests (64 bits per block), on
    ``x``'s device."""
    _check_device(x)
    if x.is_cuda:
        return bh.blockhash2(x, block_bytes)
    blocks, _ = as_u32_blocks(x, block_bytes)
    return ref.blockhash2_ref(blocks)


def pack_dirty(x: torch.Tensor, dirty_idx: np.ndarray,
               block_bytes: int = DEFAULT_BLOCK_BYTES) -> torch.Tensor:
    """Gather the blocks ``dirty_idx`` (host indices) of ``x`` →
    ``(n_dirty, block_bytes/4)`` int32 (u32 bits), on ``x``'s device.  The
    indices are checked against the leaf's block count here, on the host,
    and then moved to the device as int32, as in the JAX package."""
    _check_device(x)
    idx = np.ascontiguousarray(dirty_idx, dtype=np.int32).reshape(-1)
    n_blocks = bh.n_blocks_of(x.numel() * x.element_size(), block_bytes)
    if idx.size and (idx.min() < 0 or idx.max() >= n_blocks):
        raise IndexError(f"dirty block index outside [0, {n_blocks})")
    idx_t = torch.from_numpy(idx).to(x.device)
    if x.is_cuda:
        return dp.diffpack(x, idx_t, block_bytes)
    blocks, _ = as_u32_blocks(x, block_bytes)
    return ref.diffpack_ref(blocks, idx_t)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32-carried u32 words → host ``np.uint32`` array (a completed
    copy)."""
    return t.detach().to("cpu", copy=True).numpy().view(np.uint32)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, bq, bk):
        if q.is_cuda:
            out = fa.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
        else:
            _check_device(q)
            fa.check_shapes(q, k, v, bq, bk)
            out = ref.flash_attention_ref(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_vjp_ref(q, k, v, dout,
                                                 causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = fa.DEFAULT_BQ,
                    bk: int = fa.DEFAULT_BK) -> torch.Tensor:
    """(BH, S, dh), (BH, Sk, dh) ×2 → (BH, S, dh) in q's dtype, with a
    gradient.  The reference's shape contract holds on both devices."""
    return _FlashAttention.apply(q, k, v, causal, bq, bk)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, bq: int = fa.DEFAULT_BQ,
                         bk: int = fa.DEFAULT_BK) -> torch.Tensor:
    """(B, S, H, dh) layout of :func:`flash_attention` (KV already repeated
    to H heads)."""
    o = flash_attention(fa.to_bh(q), fa.to_bh(k), fa.to_bh(v),
                        causal=causal, bq=bq, bk=bk)
    return fa.from_bh(o, q.shape[0])


def launch_counts() -> dict:
    """Kernel launches so far in this process, by kernel."""
    return {"blockhash2": bh.LAUNCHES.n, "diffpack": dp.LAUNCHES.n,
            "flashattn": fa.LAUNCHES.n}


def reset_launch_counts() -> None:
    bh.LAUNCHES.reset()
    dp.LAUNCHES.reset()
    fa.LAUNCHES.reset()


def dirty_indices(h_new: np.ndarray, h_old: Optional[np.ndarray]
                  ) -> np.ndarray:
    """Host-side dirty map: blocks whose 64-bit digest changed."""
    if h_old is None:
        return np.arange(h_new.shape[0], dtype=np.int32)
    neq = np.any(np.asarray(h_new) != np.asarray(h_old), axis=1)
    return np.nonzero(neq)[0].astype(np.int32)


def digest_fingerprint(digests) -> str:
    """Collapse a per-block digest table into one short hex key (blake2b
    over the raw digest bytes: 16 B per 64 KiB block, microseconds)."""
    raw = np.ascontiguousarray(np.asarray(digests)).tobytes()
    return hashlib.blake2b(raw, digest_size=16).hexdigest()

"""Flash attention forward: the Hopper kernel and its wrappers.

Replaces ``repro/kernels/flashattn.py`` (``_flash_kernel`` via
``flash_attention`` / ``flash_attention_bshd``): causal or full attention
with an online softmax, scores and accumulator in f32, the masked score at
-1e30 and the denominator floored at 1e-30, output in q's dtype.

:func:`flash_attention` launches ``csrc/flashattn.cu`` (CUDA C++ for
sm_90a) on CUDA tensors; the plain PyTorch version is
``ref.flash_attention_ref``.  The signatures mirror the reference's, and
so does its shape contract: with ``bq = min(bq, S)`` and ``bk = min(bk,
Sk)``, S must divide by bq and Sk by bk; any other shape raises rather
than being padded.  The kernel is forward only, like the reference's: the
gradient is ``ops.flash_attention``'s ``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_scale
from repro_torch.kernels.ref import flash_attention_ref  # noqa: F401  (plain version)

DEFAULT_BQ = 128
DEFAULT_BK = 128
HEAD_DIMS = (16, 32, 64)          # one query row per thread, in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p]


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK) -> None:
    """The reference's contract: (BH, S, dh) q, (BH, Sk, dh) k and v of one
    dtype and device, S divisible by ``min(bq, S)`` and Sk by
    ``min(bk, Sk)``.  Raises ``ValueError`` otherwise."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash attention takes (BH, S, dh) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, dh = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != dh:
        raise ValueError(f"k and v must be (BH={bh}, Sk, dh={dh}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype and
            q.device == k.device == v.device):
        raise ValueError("q, k and v must share one dtype and device")
    sk = k.shape[1]
    bq, bk = min(bq, s), min(bk, sk)
    if s == 0 or sk == 0 or s % bq or sk % bk:
        raise ValueError(f"S={s} and Sk={sk} must divide by the tiles "
                         f"bq={bq}, bk={bk}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = DEFAULT_BQ,
                    bk: int = DEFAULT_BK) -> torch.Tensor:
    """CUDA tensors (BH, S, dh), (BH, Sk, dh) ×2 in f32 or bf16, dh in
    :data:`HEAD_DIMS` → (BH, S, dh) in q's dtype.  Launches the kernel on
    the current stream or raises.  ``bq``/``bk`` only set the shape
    contract: the kernel's own tiles (64 query rows, 32 keys) cover any
    S and Sk."""
    check_shapes(q, k, v, bq, bk)
    if not q.is_cuda:
        raise ValueError(f"flash_attention takes CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention takes f32 or bf16, got {q.dtype}")
    bh, s, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    fn = build.function("flashattn", "flashattn_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, s, k.shape[1], dh, _DTYPES[q.dtype], int(causal),
                 attention_scale(dh),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flashattn")
    LAUNCHES.add()
    return out


def to_bh(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) → (B·H, S, dh)."""
    b, s, h, dh = x.shape
    return x.transpose(1, 2).reshape(b * h, s, dh)


def from_bh(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B·H, S, dh) → (B, S, H, dh)."""
    bh, s, dh = x.shape
    return x.reshape(b, bh // b, s, dh).transpose(1, 2)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, bq: int = DEFAULT_BQ,
                         bk: int = DEFAULT_BK) -> torch.Tensor:
    """(B, S, H, dh) wrapper of :func:`flash_attention` (KV already
    repeated to H heads)."""
    o = flash_attention(to_bh(q), to_bh(k), to_bh(v), causal=causal,
                        bq=bq, bk=bk)
    return from_bh(o, q.shape[0])

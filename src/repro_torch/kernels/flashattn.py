"""Flash attention forward: the Hopper kernels and their wrappers.

Replaces ``repro/kernels/flashattn.py`` (``_flash_kernel`` via
``flash_attention`` / ``flash_attention_bshd``): causal or full attention
with an online softmax, scores and accumulator in f32, the masked score at
-1e30 and the denominator floored at 1e-30, output in q's dtype.

``csrc/flashattn.cu`` (CUDA C++ for sm_90a) holds two kernels.  bf16 runs
on the tensor cores (wgmma, TMA) and reads grouped KV heads in place:
:func:`flash_attention_gqa` takes q as (B, S, H, dh) and k, v as (B, Sk,
KV, dh) through their strides, query head h reading KV head h // (H/KV),
head dims :data:`HEAD_DIMS`.  f32 runs on the CUDA cores, one query row per
thread, head dims :data:`F32_HEAD_DIMS`; the training path never takes it.
The plain PyTorch versions are ``ref.flash_attention_ref`` and
``ref.flash_attention_gqa_ref``.

:func:`flash_attention` and :func:`flash_attention_bshd` keep the
reference's signatures and its shape contract: with ``bq = min(bq, S)``
and ``bk = min(bk, Sk)``, S must divide by bq and Sk by bk; any other
shape raises rather than being padded.  Both go through
:func:`flash_attention_gqa`, which alone chooses the kernel.  The kernels
are forward only, like the reference's: the gradient is
``ops.flash_attention_gqa``'s ``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_scale
from repro_torch.kernels.ref import from_bh, to_bh  # noqa: F401  (layouts)
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    flash_attention_gqa_ref,
    flash_attention_ref,
)

DEFAULT_BQ = 128
DEFAULT_BK = 128
HEAD_DIMS = (16, 32, 64, 128)     # bf16: wgmma widths, 128 query rows a CTA
F32_HEAD_DIMS = (16, 32, 64)      # f32: one query row per thread, in registers
_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_GQA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 9
                 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _check_tiles(s: int, sk: int, bq: int, bk: int) -> None:
    bq, bk = min(bq, s), min(bk, sk)
    if s == 0 or sk == 0 or s % bq or sk % bk:
        raise ValueError(f"S={s} and Sk={sk} must divide by the tiles "
                         f"bq={bq}, bk={bk}")


def _check_same(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.dtype == k.dtype == v.dtype and
            q.device == k.device == v.device):
        raise ValueError("q, k and v must share one dtype and device")


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
    _check_same(q, k, v)
    _check_tiles(s, k.shape[1], bq, bk)


def check_shapes_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK) -> None:
    """The same contract in the grouped layout: (B, S, H, dh) q, (B, Sk, KV,
    dh) k and v with H a multiple of KV."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"grouped flash attention takes (B, S, H, dh) q "
                         f"and (B, Sk, KV, dh) k, v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, dh = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh
            or k.shape[2] == 0 or h % k.shape[2]):
        raise ValueError(f"k and v must be (B={b}, Sk, KV, dh={dh}) with "
                         f"H={h} a multiple of KV, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_same(q, k, v)
    _check_tiles(s, k.shape[1], bq, bk)


def check_shapes_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK) -> None:
    """The reference's ``flash_attention_bshd`` contract: the grouped one
    with KV already repeated to H heads."""
    check_shapes_gqa(q, k, v, bq, bk)
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_bshd takes H={q.shape[2]} KV "
                         f"heads, got {k.shape[2]}")


def _check_cuda(q: torch.Tensor) -> None:
    if not q.is_cuda:
        raise ValueError(f"flash attention takes CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention takes f32 or bf16, got {q.dtype}")
    dh = q.shape[-1]
    dims = HEAD_DIMS if q.dtype == torch.bfloat16 else F32_HEAD_DIMS
    if dh not in dims:
        raise ValueError(f"head dim {dh} not in {dims} for {q.dtype}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _tma_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the bf16 kernel reads it in place: a contiguous last dim,
    16-byte aligned, every other stride a positive whole number of 16
    bytes (what a TMA tensor map takes); else a contiguous copy."""
    x = x.detach()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st > 0 and st % 8 == 0 for st in x.stride()[:-1])):
        return x
    return _aligned(x)


def _launch_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> torch.Tensor:
    """f32 (BH, S, dh) through the CUDA-core kernel."""
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bh, s, dh = q.shape
    out = torch.empty_like(q)
    fn = build.function("flashattn", "flashattn_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, s, k.shape[1], dh, int(causal), attention_scale(dh),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flashattn")
    LAUNCHES.add()
    return out


def _launch_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> torch.Tensor:
    """bf16 (B, S, H, dh) q, (B, Sk, KV, dh) k, v through the tensor-core
    kernel → contiguous (B, S, H, dh)."""
    q, k, v = _tma_view(q), _tma_view(k), _tma_view(v)
    b, s, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    fn = build.function("flashattn", "flashattn_gqa_launch", _GQA_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, sk, h, kv, dh, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], int(causal), attention_scale(dh),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flashattn")
    LAUNCHES.add()
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, bq: int = DEFAULT_BQ,
                        bk: int = DEFAULT_BK) -> torch.Tensor:
    """CUDA tensors (B, S, H, dh) q and (B, Sk, KV, dh) k, v → (B, S, H, dh)
    in q's dtype, query head h reading KV head h // (H/KV).  Launches a
    kernel on the current stream or raises: bf16 the tensor-core kernel,
    which reads k and v in place; f32 the CUDA-core one, on k and v
    repeated to H heads.  ``bq``/``bk`` only set the shape contract: the
    kernels' own tiles cover any S and Sk."""
    check_shapes_gqa(q, k, v, bq, bk)
    _check_cuda(q)
    if q.dtype == torch.bfloat16:
        return _launch_tc(q, k, v, causal)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    o = _launch_simt(to_bh(q), to_bh(k), to_bh(v), causal)
    return from_bh(o, q.shape[0]).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = DEFAULT_BQ,
                    bk: int = DEFAULT_BK) -> torch.Tensor:
    """CUDA tensors (BH, S, dh), (BH, Sk, dh) ×2 in f32 or bf16 → (BH, S,
    dh) in q's dtype (the reference's contract): :func:`flash_attention_gqa`
    with each batch·head a batch of one head."""
    check_shapes(q, k, v, bq, bk)
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, bq=bq, bk=bk)[:, :, 0]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, bq: int = DEFAULT_BQ,
                         bk: int = DEFAULT_BK) -> torch.Tensor:
    """(B, S, H, dh) q, k, v (KV already repeated to H heads, the
    reference's contract): :func:`flash_attention_gqa` with KV = H."""
    check_shapes_bshd(q, k, v, bq, bk)
    return flash_attention_gqa(q, k, v, causal=causal, bq=bq, bk=bk)

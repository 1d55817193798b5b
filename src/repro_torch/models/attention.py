"""Attention for training and prefill: GQA (+qkv bias), sliding window.

The PyTorch counterpart of ``repro.models.attention`` for the train/prefill
path.  Tensors are (batch, seq, heads, head_dim); scores and softmax are
f32.  ``REPRO_ATTN_IMPL=flash`` routes GQA without a sliding window through
the flash kernel (``kernels.ops.flash_attention_bshd``: the Hopper kernel
on a CUDA tensor, its plain version on the CPU); the default is the
query-blockwise version below, as in the reference.

The reference's sharding hints are dropped: one device needs none.  MLA
and cross-attention raise; decode (KV caches, ``gqa_decode``, the MLA
cache) belongs to the serving slice (ROADMAP Queue 1, item 3), and the
model zoo's decode entry points raise.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import flash_attention_bshd
from repro_torch.models.layers import apply_rope, dense_init

Params = Dict[str, Any]

_NEG_INF = -1e30
_SERVING = "ROADMAP Queue 1, item 3 (serving)"


def _attn_impl() -> str:
    """"blockwise" (default) or "flash" (the fused kernel; set
    REPRO_ATTN_IMPL=flash)."""
    return os.environ.get("REPRO_ATTN_IMPL", "blockwise")


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,KV,dh) → (B,S,KV·n_rep,dh), each KV head repeated n_rep times
    in place (head h reads KV head h // n_rep)."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None].expand(b, s, kv, n_rep, dh).reshape(
        b, s, kv * n_rep, dh)


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #


def init_gqa(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, h * dh, dtype),
        "wk": dense_init(gen, d, kv * dh, dtype),
        "wv": dense_init(gen, d, kv * dh, dtype),
        "wo": dense_init(gen, h * dh, d, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros((kv * dh,), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros((kv * dh,), dtype=dtype, device=gen.device)
    return p


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    if cfg.attn_kind == "mla":
        raise NotImplementedError(
            f"MLA attention is not ported yet ({_SERVING} brings MLA)")
    return init_gqa(gen, cfg, dtype)


# --------------------------------------------------------------------------- #
# core blockwise attention
# --------------------------------------------------------------------------- #


def _scores_softmax_v(q, k, v, mask, scale):
    """q:(B,Qb,H,dh) k/v:(B,Sk,H,dh) mask:(Qb,Sk) bool → (B,Qb,H,dh)."""
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
    scores = torch.where(mask[None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def blockwise_attention(
    q: torch.Tensor,              # (B, S, H, dh)
    k: torch.Tensor,              # (B, S, H, dh)  (KV pre-repeated to H)
    v: torch.Tensor,              # (B, S, H, dh)
    *,
    causal: bool,
    window: Optional[int] = None,
    q_block: int = 512,
) -> torch.Tensor:
    """Query-block-looped attention, O(q_block·Sk) scores per block.  With
    ``window`` set, each query block attends only to a K/V span of length
    ``window + q_block``."""
    b, s, h, dh = q.shape
    scale = float(1.0 / torch.tensor(float(dh)).sqrt())
    qb = min(q_block, s)
    n_blocks = s // qb
    if s % qb:
        raise ValueError(f"seq {s} not divisible by q_block {qb}")

    use_window = window is not None and causal and (window + qb) < s
    span = (window + qb) if use_window else s
    outs = []
    for i in range(n_blocks):
        qi = q[:, i * qb:(i + 1) * qb]
        q_start = i * qb
        if use_window:
            k_start = min(max(q_start + qb - span, 0), s - span)
            ki = k[:, k_start:k_start + span]
            vi = v[:, k_start:k_start + span]
            k_pos = k_start + torch.arange(span, device=q.device)
        else:
            ki, vi = k, v
            k_pos = torch.arange(s, device=q.device)
        q_pos = q_start + torch.arange(qb, device=q.device)
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask &= k_pos[None, :] > (q_pos[:, None] - window)
        else:
            mask = torch.ones((qb, k_pos.shape[0]), dtype=torch.bool,
                              device=q.device)
        outs.append(_scores_softmax_v(qi, ki, vi, mask, scale))
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------- #
# GQA full layer (train/prefill)
# --------------------------------------------------------------------------- #


def gqa_attention(
    p: Params,
    x: torch.Tensor,              # (B, S, d)
    cfg: ArchConfig,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    use_rope: Optional[bool] = None,             # default: cfg.use_rope
    kv_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if kv_override is not None:
        raise NotImplementedError(
            "cross-attention is not ported yet (the encoder-decoder models "
            "of ROADMAP Queue 1, item 2)")
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)

    if use_rope is None:
        use_rope = cfg.use_rope
    if use_rope:
        pos = positions if positions is not None else \
            torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    k = repeat_kv(k, h // kv)
    v = repeat_kv(v, h // kv)

    if _attn_impl() == "flash" and cfg.sliding_window is None:
        out = flash_attention_bshd(q, k, v, causal=causal)
    else:
        out = blockwise_attention(q, k, v, causal=causal,
                                  window=cfg.sliding_window)
    return out.reshape(b, s, h * dh) @ p["wo"]


# --------------------------------------------------------------------------- #
# dispatch helpers
# --------------------------------------------------------------------------- #


def attention(p, x, cfg: ArchConfig, **kw):
    if cfg.attn_kind == "mla":
        raise NotImplementedError(
            f"MLA attention is not ported yet ({_SERVING} brings MLA)")
    return gqa_attention(p, x, cfg, **kw)

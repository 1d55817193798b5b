"""Attention: GQA (+qkv bias), sliding window, MLA, and one-token decode
with a KV cache or an MLA latent cache.

The PyTorch counterpart of ``repro.models.attention``.  Tensors are
(batch, seq, heads, head_dim); scores and softmax are f32.
``REPRO_ATTN_IMPL=flash`` routes GQA without a sliding window through the
flash kernel (``kernels.ops.flash_attention_gqa``, which reads the KV
heads in place: the Hopper kernel on a CUDA tensor, its plain version on
the CPU); the default is the query-blockwise version below, as in the
reference.

Decode (:func:`gqa_decode`) writes the new K/V row into the cache *in
place* (the reference's ``dynamic_update_slice`` returns a new cache) and
returns the same :class:`KVCache`; a windowed cache (allocated at exactly
the sliding window) rolls, writing slot ``pos % C``.  ``pos`` is a host
integer, so a step slices the cache without waiting on the device.  The
scores cover the cache's valid prefix (``min(pos + 1, C)`` slots: the
slots the reference's mask keeps) and read the grouped KV heads in place,
without repeating them.

MLA (Multi-head Latent Attention) trains and prefills in the naive form
(:func:`mla_attention`: K/V materialized from the latent, q/k of
``qk_nope + qk_rope`` dims and v of ``v_head_dim``, always through
:func:`blockwise_attention`, as in the reference, whatever
``REPRO_ATTN_IMPL`` says) and decodes in the absorbed form
(:func:`mla_decode`): the cache holds the latent ``c_kv`` and the shared
rotary key ``k_rope``, ``W_uk`` is folded into the query and ``W_uv``
applied after the latent average.  Decode writes the new rows in place and
attends over the valid prefix, as :func:`gqa_decode` does.

Cross-attention (the encoder-decoder's, ``models/encdec.py``) is
:func:`gqa_attention` with ``kv_override``: K and V come from the encoder
states (``Sk`` may differ from ``S``), no rope, never causal; and
:func:`gqa_decode` with ``kv_override=(k, v)``, which attends over every
slot of the static cross cache and writes nothing.

The reference's sharding hints are dropped: one device needs none.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import flash_attention_gqa
from repro_torch.kernels.ref import repeat_kv
from repro_torch.models.layers import apply_rope, dense_init

Params = Dict[str, Any]

_NEG_INF = -1e30


def _attn_impl() -> str:
    """"blockwise" (default) or "flash" (the fused kernel; set
    REPRO_ATTN_IMPL=flash)."""
    return os.environ.get("REPRO_ATTN_IMPL", "blockwise")


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


def init_cross_attn(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    return init_gqa(gen, cfg, dtype)


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    m = cfg.mla
    assert m is not None
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "w_dq": dense_init(gen, d, m.q_lora_rank, dtype),
        "w_uq": dense_init(gen, m.q_lora_rank, h * qk, dtype),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank, dtype),
        "w_kr": dense_init(gen, d, m.qk_rope_dim, dtype),
        "w_uk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_dim, dtype),
        "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dtype),
        "wo": dense_init(gen, h * m.v_head_dim, d, dtype),
    }


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    if cfg.attn_kind == "mla":
        return init_mla(gen, cfg, dtype)
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
    ``window + q_block``.  K and V may be longer or shorter than q
    (cross-attention; the reference's version takes only Sk = S)."""
    b, s, h, dh = q.shape
    sk = k.shape[1]
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
            k_pos = torch.arange(sk, device=q.device)
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
    kv_override: Optional[torch.Tensor] = None,  # cross-attn: encoder states
) -> torch.Tensor:
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = kv_override if kv_override is not None else x
    sk = src.shape[1]

    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, sk, kv, dh)
    v = v.reshape(b, sk, kv, dh)

    if use_rope is None:
        use_rope = cfg.use_rope
    if use_rope and kv_override is None:
        pos = positions if positions is not None else \
            torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    is_causal = causal and kv_override is None
    if _attn_impl() == "flash" and cfg.sliding_window is None:
        # the grouped KV heads are read in place: no repeat, no transposes
        out = flash_attention_gqa(q, k, v, causal=is_causal)
    else:
        out = blockwise_attention(q, repeat_kv(k, h // kv),
                                  repeat_kv(v, h // kv), causal=is_causal,
                                  window=cfg.sliding_window)
    return out.reshape(b, s, h * dh) @ p["wo"]


# --------------------------------------------------------------------------- #
# GQA decode (one step, KV cache)
# --------------------------------------------------------------------------- #


class KVCache(NamedTuple):
    k: torch.Tensor              # (B, C, KV, dh)  C = max_len or window
    v: torch.Tensor

    def is_windowed(self, cfg: ArchConfig) -> bool:
        """Rolling cache iff allocated at exactly the sliding window size."""
        return cfg.sliding_window is not None and \
            self.k.shape[1] == cfg.sliding_window


def init_kv_cache(batch: int, cfg: ArchConfig, max_len: int, dtype,
                  device="cuda") -> KVCache:
    w = cfg.sliding_window
    c = w if (w is not None and w < max_len) else max_len
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def gqa_decode(
    p: Params,
    x: torch.Tensor,              # (B, 1, d)
    cache: KVCache,
    pos,                          # int (or 0-d tensor) — current position
    cfg: ArchConfig,
    *,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One token → (out (B, 1, d), the same cache with slot ``pos`` (or
    ``pos % C`` when windowed) written in place).  With ``kv_override``
    (cross-attention: the static (B, T, KV, dh) K and V of the encoder
    states) it attends over all T slots and leaves ``cache`` as it is."""
    pos = int(pos)
    b = x.shape[0]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = float(1.0 / torch.tensor(float(dh)).sqrt())

    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, 1, h, dh)
    if cfg.use_rope:
        pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos_b, cfg.rope_theta)

    if kv_override is not None:                   # cross-attn: static cache
        ck, cv = kv_override
    else:
        knew = x @ p["wk"]
        vnew = x @ p["wv"]
        if cfg.qkv_bias:
            knew = knew + p["bk"]
            vnew = vnew + p["bv"]
        knew = knew.reshape(b, 1, kvh, dh)
        vnew = vnew.reshape(b, 1, kvh, dh)
        if cfg.use_rope:
            knew = apply_rope(knew, pos_b, cfg.rope_theta)
        c = cache.k.shape[1]
        slot = pos % c if cache.is_windowed(cfg) else pos
        cache.k[:, slot] = knew[:, 0]
        cache.v[:, slot] = vnew[:, 0]
        n = min(pos + 1, c)        # the slots the reference's mask keeps
        ck, cv = cache.k[:, :n], cache.v[:, :n]

    # query head h reads KV head h // rep, as repeat_kv would lay them out
    qg = q[:, 0].reshape(b, kvh, h // kvh, dh)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, ck).float() * scale
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, cv).reshape(b, 1, h * dh)
    return out @ p["wo"], cache


# --------------------------------------------------------------------------- #
# MLA (Multi-head Latent Attention)
# --------------------------------------------------------------------------- #


def mla_attention(
    p: Params,
    x: torch.Tensor,              # (B, S, d)
    cfg: ArchConfig,
    *,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Training/prefill MLA in the naive (materialized K/V) form."""
    m = cfg.mla
    assert m is not None
    b, s, _ = x.shape
    h = cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    pos = positions if positions is not None else \
        torch.arange(s, device=x.device)[None, :]

    q = ((x @ p["w_dq"]) @ p["w_uq"]).reshape(b, s, h, qk)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    c_kv = x @ p["w_dkv"]                                   # (B, S, r)
    k_rope = apply_rope((x @ p["w_kr"]).reshape(b, s, 1, m.qk_rope_dim),
                        pos, cfg.rope_theta)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, m.qk_nope_dim)
    vv = (c_kv @ p["w_uv"]).reshape(b, s, h, m.v_head_dim)

    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_dim)],
                       dim=-1)
    out = blockwise_attention(q_full, k_full, vv, causal=True)
    return out.reshape(b, s, h * m.v_head_dim) @ p["wo"]


class MLACache(NamedTuple):
    c_kv: torch.Tensor            # (B, C, r)         latent cache
    k_rope: torch.Tensor          # (B, C, rope_dim)


def init_mla_cache(batch: int, cfg: ArchConfig, max_len: int, dtype,
                   device="cuda") -> MLACache:
    m = cfg.mla
    assert m is not None
    return MLACache(
        torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                    device=device))


def mla_decode(
    p: Params,
    x: torch.Tensor,              # (B, 1, d)
    cache: MLACache,
    pos,                          # int (or 0-d tensor) — current position
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-form MLA decode: attend over the latents with ``W_uk``
    folded into the query → (out (B, 1, d), the same cache with slot
    ``pos`` written in place).  The two score products are added in the
    compute dtype and only then cast to f32, as in the reference."""
    m = cfg.mla
    assert m is not None
    pos = int(pos)
    b = x.shape[0]
    h, r = cfg.n_heads, m.kv_lora_rank
    qk = m.qk_nope_dim + m.qk_rope_dim
    scale = float(1.0 / torch.tensor(float(qk)).sqrt())
    pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)

    q = ((x @ p["w_dq"]) @ p["w_uq"]).reshape(b, 1, h, qk)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, pos_b, cfg.rope_theta)
    # fold W_uk: q_abs[h, r] = q_nope[h, n] · W_uk[r, h, n]
    w_uk = p["w_uk"].reshape(r, h, m.qk_nope_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)   # (B, H, r)

    c_new = x @ p["w_dkv"]                                     # (B, 1, r)
    kr_new = apply_rope((x @ p["w_kr"]).reshape(b, 1, 1, m.qk_rope_dim),
                        pos_b, cfg.rope_theta)
    cache.c_kv[:, pos] = c_new[:, 0]
    cache.k_rope[:, pos] = kr_new[:, 0, 0]
    c_kv = cache.c_kv[:, :pos + 1]      # the slots the reference's mask keeps
    k_rope = cache.k_rope[:, :pos + 1]

    sc = torch.einsum("bhr,bsr->bhs", q_abs, c_kv)
    sc = sc + torch.einsum("bhe,bse->bhs", q_rope[:, 0], k_rope)
    sc = sc.float() * scale
    probs = torch.softmax(sc, dim=-1).to(c_kv.dtype)
    o_lat = torch.einsum("bhs,bsr->bhr", probs, c_kv)          # (B, H, r)
    w_uv = p["w_uv"].reshape(r, h, m.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv).reshape(
        b, 1, h * m.v_head_dim)
    return o @ p["wo"], cache


# --------------------------------------------------------------------------- #
# dispatch helpers
# --------------------------------------------------------------------------- #


def attention(p, x, cfg: ArchConfig, **kw):
    if cfg.attn_kind == "mla":
        kw.pop("causal", None)
        kw.pop("use_rope", None)
        return mla_attention(p, x, cfg, **kw)
    return gqa_attention(p, x, cfg, **kw)


def init_decode_cache(batch: int, cfg: ArchConfig, max_len: int, dtype,
                      device="cuda"):
    if cfg.attn_kind == "mla":
        return init_mla_cache(batch, cfg, max_len, dtype, device)
    return init_kv_cache(batch, cfg, max_len, dtype, device)


def attention_decode(p, x, cache, pos, cfg: ArchConfig):
    if cfg.attn_kind == "mla":
        return mla_decode(p, x, cache, pos, cfg)
    return gqa_decode(p, x, cache, pos, cfg)

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

Sharding: the reference's hints stand where it calls them
(``shard_hint`` on q, k and v; ``shard_decode_kv`` on the decode caches).
On plain tensors, or with no active mesh, they are the identity and the
code below runs as it does on one device.  On ``DTensor`` inputs:

- Flash and blockwise attention run through ``local_map`` on the (batch
  on DATA, heads on MODEL) layout, the gradient in the same layout: each
  rank attends over its local heads (KV heads are repeated to the query
  heads first only where they do not divide the model axis).  A
  ``DTensor`` never reaches the kernel's launch.
- A decode step over a cache sharded along its sequence dim
  (:func:`_gqa_attend_sharded`, :func:`_mla_attend_sharded`) writes the new row on the rank whose
  shard holds the slot, masks the invalid slots instead of slicing the
  valid prefix (a slice would gather the cache), and combines the shards
  with three all-reduces over the sequence's mesh dims: the maximum, the
  sum of exponentials and the weighted values (f32).
"""
from __future__ import annotations

import functools
import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.context import (
    DATA,
    MODEL,
    bounded_placements,
    is_dtensor,
    local_range,
    mesh_dims_sharding,
    shard_decode_kv,
    shard_hint,
    split_last,
    to_placements,
)
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
    fill: Optional["KVCache"] = None,            # prefill: rows [0, S)
) -> torch.Tensor:
    """``fill``: write this pass's K and V (after rope) into the cache's
    slots ``[0, S)`` (a batched prefill, ``transformer.lm_prefill``)."""
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
    q = split_last(q, b, s, h, dh)
    k = split_last(k, b, sk, kv, dh)
    v = split_last(v, b, sk, kv, dh)

    if use_rope is None:
        use_rope = cfg.use_rope
    if use_rope and kv_override is None:
        pos = positions if positions is not None else \
            torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    if fill is not None:
        _write_rows(fill.k, k, 0)
        _write_rows(fill.v, v, 0)
    is_causal = causal and kv_override is None
    flash = _attn_impl() == "flash" and cfg.sliding_window is None
    if not flash:
        k, v = repeat_kv(k, h // kv), repeat_kv(v, h // kv)
    q = shard_hint(q, DATA, None, MODEL, None)
    k = shard_hint(k, DATA, None, MODEL, None)
    v = shard_hint(v, DATA, None, MODEL, None)
    if flash:
        # the grouped KV heads are read in place: no repeat, no transposes
        out = _on_local_heads(functools.partial(
            flash_attention_gqa, causal=is_causal), q, k, v)
    else:
        out = _on_local_heads(functools.partial(
            blockwise_attention, causal=is_causal,
            window=cfg.sliding_window), q, k, v)
    return out.reshape(b, s, h * dh) @ p["wo"]


def _on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` → (B, S, H, dh); on ``DTensor`` inputs it runs on
    each rank's local batch rows and heads (``local_map``), the gradient
    in the same layout.  Query head h reads KV head h // (H/KV) locally as
    globally as long as the KV heads split as the query heads do; where
    they do not, they are repeated to H first."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map
    pl = bounded_placements(q, (0, 2))
    mesh = q.device_mesh
    head_split = math.prod(mesh.size(i) for i, x in enumerate(pl)
                           if getattr(x, "dim", None) == 2)
    if k.shape[2] != q.shape[2] and k.shape[2] % head_split:
        rep = q.shape[2] // k.shape[2]
        k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    q, k, v = (to_placements(t, pl) for t in (q, k, v))
    # one output: its placements as a list (a tuple means one per output)
    return local_map(fn, out_placements=list(pl), in_placements=(pl, pl, pl),
                     in_grad_placements=(pl, pl, pl), device_mesh=mesh)(
        q, k, v)


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
    q = split_last(q, b, 1, h, dh)
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
        knew = split_last(knew, b, 1, kvh, dh)
        vnew = split_last(vnew, b, 1, kvh, dh)
        if cfg.use_rope:
            knew = apply_rope(knew, pos_b, cfg.rope_theta)
        c = cache.k.shape[1]
        slot = pos % c if cache.is_windowed(cfg) else pos
        n = min(pos + 1, c)        # the slots the reference's mask keeps
        if is_dtensor(cache.k):
            _write_rows(cache.k, knew, slot)
            _write_rows(cache.v, vnew, slot)
            ck, cv = cache.k, cache.v              # masked, not sliced
        else:
            cache.k[:, slot] = knew[:, 0]
            cache.v[:, slot] = vnew[:, 0]
            ck, cv = cache.k[:, :n], cache.v[:, :n]

    ck = shard_decode_kv(ck)
    cv = shard_decode_kv(cv)
    if is_dtensor(ck):
        n = n if kv_override is None else ck.shape[1]
        out = _gqa_attend_sharded(q, ck, cv, n, scale)
        return out @ p["wo"], cache
    # query head h reads KV head h // rep, as repeat_kv would lay them out
    qg = q[:, 0].reshape(b, kvh, h // kvh, dh)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, ck).float() * scale
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, cv).reshape(b, 1, h * dh)
    return out @ p["wo"], cache


# --------------------------------------------------------------------------- #
# decode over a DTensor cache (batch, sequence or heads sharded)
# --------------------------------------------------------------------------- #


def _as_dtensor(x, mesh):
    """A plain tensor as a replicated ``DTensor`` on ``mesh`` (every rank
    holds the same value); a ``DTensor`` as it is."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _write_rows(leaf, rows, start: int) -> None:
    """``leaf[:, start:start + n] = rows`` (rows (B, n, ...)) in place; on a
    ``DTensor`` cache each rank writes the part of the slots its shard of
    the sequence dim holds, into its local storage (a decode step's one
    row lands on one rank only)."""
    n = rows.shape[1]
    if not is_dtensor(leaf):
        leaf[:, start:start + n] = rows
        return
    from torch.distributed.tensor import Replicate
    mesh = leaf.device_mesh
    pl = tuple(Replicate() if getattr(x, "dim", None) == 1 else x
               for x in bounded_placements(leaf, (0, 1, 2)))
    rows = to_placements(_as_dtensor(rows, mesh), pl).to_local()
    lo, hi = local_range(leaf, 1)
    a, b = max(lo, start), min(hi, start + n)
    if a < b:
        leaf.to_local()[:, a - lo:b - lo] = rows[:, a - start:b - start]


def _query_placements(cache, q, q_heads: int) -> tuple:
    """q's layout for a decode over ``cache``: the cache's batch shards,
    replicated along the cache's sequence shards, and heads (q's dim
    ``q_heads``) split where the cache splits its heads (dim 2) or, for a
    cache with no heads dim, where q already splits them."""
    from torch.distributed.tensor import Replicate, Shard
    own = bounded_placements(q, (0, q_heads))
    out = []
    for i, c in enumerate(bounded_placements(cache, (0, 1, 2))):
        d = getattr(c, "dim", None)
        if d == 0:
            out.append(Shard(0))
        elif d == 2:
            out.append(Shard(q_heads))
        elif d == 1 or cache.ndim > 3:
            out.append(Replicate())
        else:
            out.append(own[i])
    return tuple(out)


def _all_reduce(x: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    for i in dims:
        x = funcol.all_reduce(x, op, (mesh, i))
    return x


def _softmax_combine(scores: torch.Tensor, values: torch.Tensor, spec: str,
                     mesh, seq_dims) -> torch.Tensor:
    """The softmax-weighted average of ``values`` over the last dim of
    ``scores``, split across the ranks of ``seq_dims``: ``scores`` (...,
    S_local) f32 with the invalid slots at ``_NEG_INF``, ``spec`` the
    einsum of the probabilities and ``values``.  Three all-reduces (max,
    sum of exponentials, weighted values) and no gather.  As on one
    device, the probabilities are rounded to the values' dtype before the
    product; the product is summed in f32 and rounded once → (..., X) in
    the values' dtype."""
    m = _all_reduce(scores.amax(dim=-1, keepdim=True), "max", mesh, seq_dims)
    e = torch.exp(scores - m)
    den = _all_reduce(e.sum(dim=-1, keepdim=True), "sum", mesh, seq_dims)
    probs = (e / den).to(values.dtype)
    out = _all_reduce(torch.einsum(spec, probs.float(), values.float()),
                      "sum", mesh, seq_dims)
    return out.to(values.dtype)


def _valid_slots(lo: int, count: int, n: int, device) -> torch.Tensor:
    return (lo + torch.arange(count, device=device)) < n


def _gqa_attend_sharded(q, ck, cv, n: int, scale: float):
    """q (B, 1, H, dh) against a ``DTensor`` cache (B, C, KV, dh) whose
    first ``n`` slots are valid → (B, 1, H·dh) ``DTensor``."""
    from torch.distributed.tensor import DTensor
    mesh = ck.device_mesh
    cpl = bounded_placements(ck, (0, 1, 2))
    ck, cv = to_placements(ck, cpl), to_placements(cv, cpl)
    qpl = _query_placements(ck, _as_dtensor(q, mesh), 2)
    ql = to_placements(_as_dtensor(q, mesh), qpl).to_local()
    kl, vl = ck.to_local(), cv.to_local()
    bl, cl, kvl, dh = kl.shape
    hl = ql.shape[2]
    qg = ql[:, 0].reshape(bl, kvl, hl // kvl, dh)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, kl).float() * scale
    lo, _ = local_range(ck, 1)
    scores = torch.where(_valid_slots(lo, cl, n, kl.device), scores,
                         _NEG_INF)
    out = _softmax_combine(scores, vl, "bgrs,bsgd->bgrd", mesh,
                           mesh_dims_sharding(ck, 1))
    out = out.reshape(bl, 1, hl * dh)
    return DTensor.from_local(out, mesh, qpl, run_check=False)


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

    q = split_last((x @ p["w_dq"]) @ p["w_uq"], b, s, h, qk)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    c_kv = x @ p["w_dkv"]                                   # (B, S, r)
    k_rope = apply_rope((x @ p["w_kr"]).reshape(b, s, 1, m.qk_rope_dim),
                        pos, cfg.rope_theta)
    k_nope = split_last(c_kv @ p["w_uk"], b, s, h, m.qk_nope_dim)
    vv = split_last(c_kv @ p["w_uv"], b, s, h, m.v_head_dim)

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

    q = split_last((x @ p["w_dq"]) @ p["w_uq"], b, 1, h, qk)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, pos_b, cfg.rope_theta)
    # fold W_uk: q_abs[h, r] = q_nope[h, n] · W_uk[r, h, n]
    w_uk = split_last(p["w_uk"], r, h, m.qk_nope_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)   # (B, H, r)

    c_new = x @ p["w_dkv"]                                     # (B, 1, r)
    kr_new = apply_rope((x @ p["w_kr"]).reshape(b, 1, 1, m.qk_rope_dim),
                        pos_b, cfg.rope_theta)
    if is_dtensor(cache.c_kv):
        _write_rows(cache.c_kv, c_new, pos)
        _write_rows(cache.k_rope, kr_new[:, :, 0], pos)
        c_kv, k_rope = cache.c_kv, cache.k_rope      # masked, not sliced
    else:
        cache.c_kv[:, pos] = c_new[:, 0]
        cache.k_rope[:, pos] = kr_new[:, 0, 0]
        # the slots the reference's mask keeps
        c_kv = cache.c_kv[:, :pos + 1]
        k_rope = cache.k_rope[:, :pos + 1]

    c_kv = shard_decode_kv(c_kv, model_dim=None)
    k_rope = shard_decode_kv(k_rope, model_dim=None)
    if is_dtensor(c_kv):
        o_lat = _mla_attend_sharded(q_abs, q_rope[:, 0], c_kv, k_rope,
                                    pos + 1, scale)
    else:
        o_lat = _mla_attend(q_abs, q_rope[:, 0], c_kv, k_rope, scale)
    w_uv = split_last(p["w_uv"], r, h, m.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv).reshape(
        b, 1, h * m.v_head_dim)
    return o @ p["wo"], cache


def _mla_attend(q_abs, q_rope, c_kv, k_rope, scale: float):
    """The latent average over a plain cache's valid prefix → (B, H, r)."""
    sc = torch.einsum("bhr,bsr->bhs", q_abs, c_kv)
    sc = sc + torch.einsum("bhe,bse->bhs", q_rope, k_rope)
    sc = sc.float() * scale
    probs = torch.softmax(sc, dim=-1).to(c_kv.dtype)
    return torch.einsum("bhs,bsr->bhr", probs, c_kv)


def _mla_attend_sharded(q_abs, q_rope, c_kv, k_rope, n: int, scale: float):
    """:func:`_mla_attend` over a ``DTensor`` latent cache whose first
    ``n`` slots are valid → (B, H, r) ``DTensor`` in the cache's dtype."""
    from torch.distributed.tensor import DTensor
    mesh = c_kv.device_mesh
    cpl = bounded_placements(c_kv, (0, 1))
    c_kv, k_rope = to_placements(c_kv, cpl), to_placements(k_rope, cpl)
    qpl = _query_placements(c_kv, _as_dtensor(q_abs, mesh), 1)
    qa = to_placements(_as_dtensor(q_abs, mesh), qpl).to_local()
    qr = to_placements(_as_dtensor(q_rope, mesh), qpl).to_local()
    cl, krl = c_kv.to_local(), k_rope.to_local()
    sc = torch.einsum("bhr,bsr->bhs", qa, cl)
    sc = (sc + torch.einsum("bhe,bse->bhs", qr, krl)).float() * scale
    lo, _ = local_range(c_kv, 1)
    sc = torch.where(_valid_slots(lo, cl.shape[1], n, cl.device), sc,
                     _NEG_INF)
    o = _softmax_combine(sc, cl, "bhs,bsr->bhr", mesh,
                         mesh_dims_sharding(c_kv, 1))
    return DTensor.from_local(o, mesh, qpl, run_check=False)


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

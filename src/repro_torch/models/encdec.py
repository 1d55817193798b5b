"""Whisper-style encoder-decoder transformer.

The PyTorch counterpart of ``repro.models.encdec``.  The audio conv
frontend is a stub: the encoder consumes precomputed frame embeddings
(B, T_enc, d_model).  Sinusoidal positions are added on both sides (the
reference's stub-equivalent choice); no rope.  Norms are ``rmsnorm``, as
in the reference.

Parameters keep the reference's layout, a dict with ``embed``,
``enc_layers`` and ``dec_layers`` (each leaf stacked along axis 0 over
the layers), ``ln_enc`` and ``ln_f``: 26 leaves whose paths and shapes
are the reference's (``params/dec_layers/cross_attn/wk`` is ``(L, d,
KV·dh)``).  The logits are tied: ``h @ embed.T``.  ``remat=True`` (the
reference's ``jax.checkpoint`` of the scanned layer body) checkpoints
each layer with ``torch.utils.checkpoint`` (non-reentrant).

Decode: the self-attention KV cache grows with the generated tokens and
is written in place; the cross-attention K/V are computed once from the
encoder output (:func:`precompute_cross_kv`) and static thereafter.
:func:`init_encdec_caches` fills them with zeros, as the reference does:
a server that never runs the encoder decodes over zero cross K/V.

Sharding hints stand where the reference calls them (the residual
stream after the positions, in the encoder and in the decoder); on
``DTensor`` parameters and batches the same functions run sharded
(``dist/context.py``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.context import (
    DATA,
    gather_data_shards,
    resolve_partial,
    shard_hint,
    sharded_scope,
)
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    cast_floating,
    embed_init,
    embed_lookup,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
)
from repro_torch.models.transformer import (
    _stack,
    _unstack,
    dtype_of,
    layer_view,
    meta_tree,
)

Params = Dict[str, Any]


def _div_term(d: int) -> torch.Tensor:
    """``exp(arange(0, d, 2) · (−log(10000) / d))`` with every factor an f32
    tensor, as jnp computes it (``math.log`` would give an f64)."""
    rate = -torch.log(torch.tensor(10000.0, dtype=torch.float32)) / d
    return torch.exp(torch.arange(0, d, 2, dtype=torch.float32) * rate)


def sinusoidal_positions(seq: int, d: int) -> torch.Tensor:
    """(seq, d) f32 table on the host: sin on the even columns, cos on the
    odd.  Computed on the host whatever the model's device, so the card
    and the CPU add the same positions."""
    pos = torch.arange(seq, dtype=torch.float32)[:, None]
    div = _div_term(d)
    pe = torch.zeros((seq, d), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _init_enc_layer(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    dev = gen.device
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, dev),
        "attn": attn.init_gqa(gen, cfg, dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, dev),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def _init_dec_layer(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    dev = gen.device
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, dev),
        "self_attn": attn.init_gqa(gen, cfg, dtype),
        "ln_x": init_rmsnorm(cfg.d_model, dtype, dev),
        "cross_attn": attn.init_cross_attn(gen, cfg, dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, dev),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def init_encdec(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Parameters on ``gen.device`` in ``cfg.param_dtype``."""
    dtype = dtype_of(cfg.param_dtype)
    enc = _stack([_init_enc_layer(gen, cfg, dtype)
                  for _ in range(cfg.n_layers)])
    dec = _stack([_init_dec_layer(gen, cfg, dtype)
                  for _ in range(cfg.n_layers)])
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "enc_layers": enc,
        "dec_layers": dec,
        "ln_enc": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "ln_f": init_rmsnorm(cfg.d_model, dtype, gen.device),
    }


def encdec_param_struct(cfg: ArchConfig) -> Params:
    """The parameter tree's shapes and dtypes on the ``meta`` device (no
    memory; traced under a fake-tensor mode)."""
    return meta_tree(init_encdec, cfg)


def _layers(stacked: Params) -> list:
    return _unstack(stacked, stacked["ln1"]["scale"].shape[0])


def _enc_body(h: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    h = h + resolve_partial(attn.gqa_attention(
        p["attn"], rmsnorm(p["ln1"], h, cfg.norm_eps), cfg,
        causal=False, use_rope=False))
    return h + resolve_partial(
        mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps), cfg.act))


def _dec_body(h: torch.Tensor, p: Params, enc_out: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    h = h + resolve_partial(attn.gqa_attention(
        p["self_attn"], rmsnorm(p["ln1"], h, cfg.norm_eps), cfg,
        causal=True, use_rope=False))
    h = h + resolve_partial(attn.gqa_attention(
        p["cross_attn"], rmsnorm(p["ln_x"], h, cfg.norm_eps), cfg,
        kv_override=enc_out))
    return h + resolve_partial(
        mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps), cfg.act))


def encode(params: Params, frames: torch.Tensor, cfg: ArchConfig,
           remat: bool = False) -> torch.Tensor:
    """frames (B, T, d) stub frontend output → encoder states (B, T, d)."""
    cdt = dtype_of(cfg.compute_dtype)
    t, d = frames.shape[1], cfg.d_model
    pe = sinusoidal_positions(t, d).to(device=frames.device, dtype=cdt)
    h = shard_hint(frames.to(cdt) + pe[None], DATA, None, None)
    for p in _layers(params["enc_layers"]):
        if remat:
            h = checkpoint(_enc_body, h, p, cfg, use_reentrant=False)
        else:
            h = _enc_body(h, p, cfg)
    return rmsnorm(params["ln_enc"], h, cfg.norm_eps)


def _tied_logits(params: Params, h: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    return h @ params["embed"].T.to(h.dtype)


def decode_train(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig, remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder pass → logits (B, S, V)."""
    cdt = dtype_of(cfg.compute_dtype)
    s, d = tokens.shape[1], cfg.d_model
    # the gather of the reference's embed[tokens]
    h = embed_lookup(tokens, params["embed"]).to(cdt)
    h = h + sinusoidal_positions(s, d).to(device=h.device, dtype=cdt)[None]
    h = shard_hint(h, DATA, None, None)
    for p in _layers(params["dec_layers"]):
        if remat:
            h = checkpoint(_dec_body, h, p, enc_out, cfg, use_reentrant=False)
        else:
            h = _dec_body(h, p, enc_out, cfg)
    return _tied_logits(params, h, cfg)


def encdec_forward(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
                   cfg: ArchConfig, remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    with sharded_scope(params, frames, tokens):
        params = gather_data_shards(
            cast_floating(params, dtype_of(cfg.compute_dtype)))
        enc_out = encode(params, frames, cfg, remat=remat)
        logits = decode_train(params, tokens, enc_out, cfg, remat=remat)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)


# --------------------------------------------------------------------------- #
# incremental decode
# --------------------------------------------------------------------------- #


class EncDecCache(NamedTuple):
    self_kv: Any                 # stacked (L,) KVCache over decoder positions
    cross_k: torch.Tensor        # (L, B, T_enc, KV, dh) static
    cross_v: torch.Tensor


def init_encdec_caches(batch: int, cfg: ArchConfig, max_len: int,
                       enc_len: int, device="cuda") -> EncDecCache:
    """Zeros in ``cfg.compute_dtype`` on ``device``: the self-KV cache
    ``(L, B, max_len, KV, dh)`` and the cross K/V ``(L, B, enc_len, KV,
    dh)``."""
    cdt = dtype_of(cfg.compute_dtype)
    kv, dh, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    one = attn.init_kv_cache(batch, cfg, max_len, cdt, "meta")
    self_kv = attn.KVCache(*(torch.zeros((n,) + tuple(x.shape), dtype=cdt,
                                         device=device) for x in one))
    shape = (n, batch, enc_len, kv, dh)
    return EncDecCache(self_kv, torch.zeros(shape, dtype=cdt, device=device),
                       torch.zeros(shape, dtype=cdt, device=device))


def encdec_cache_struct(batch: int, cfg: ArchConfig, max_len: int,
                        enc_len: int) -> EncDecCache:
    """The cache tree's shapes and dtypes on the ``meta`` device."""
    return init_encdec_caches(batch, cfg, max_len, enc_len, device="meta")


def precompute_cross_kv(params: Params, enc_out: torch.Tensor,
                        cfg: ArchConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder states (B, T, d) → each decoder layer's cross K and V,
    stacked ``(L, B, T, KV, dh)``."""
    b, t, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    ca = params["dec_layers"]["cross_attn"]
    ks = torch.stack([(enc_out @ w).reshape(b, t, kv, dh)
                      for w in ca["wk"].unbind(0)])
    vs = torch.stack([(enc_out @ w).reshape(b, t, kv, dh)
                      for w in ca["wv"].unbind(0)])
    return ks, vs


def encdec_decode_step(params: Params, token: torch.Tensor,
                       caches: EncDecCache, pos, cfg: ArchConfig
                       ) -> Tuple[torch.Tensor, EncDecCache]:
    """One token (B, 1) → (logits (B, 1, V), the same caches with each
    layer's self-KV row ``pos`` written in place)."""
    with sharded_scope(params, token, caches):
        return _encdec_decode_step(params, token, caches, int(pos), cfg)


def _encdec_decode_step(params: Params, token: torch.Tensor,
                        caches: EncDecCache, pos: int, cfg: ArchConfig
                        ) -> Tuple[torch.Tensor, EncDecCache]:
    cdt = dtype_of(cfg.compute_dtype)
    params = gather_data_shards(cast_floating(params, cdt))
    d = cfg.d_model
    h = resolve_partial(embed_lookup(token, params["embed"]).to(cdt))
    ang = torch.tensor(float(pos), dtype=torch.float32) * _div_term(d)
    pe = torch.zeros((d,), dtype=torch.float32)
    pe[0::2] = torch.sin(ang)
    pe[1::2] = torch.cos(ang)
    h = h + pe.to(device=h.device, dtype=cdt)[None, None]
    for i, p in enumerate(_layers(params["dec_layers"])):
        kvc = attn.KVCache(layer_view(caches.self_kv.k, i),
                           layer_view(caches.self_kv.v, i))
        y, _ = attn.gqa_decode(
            p["self_attn"], rmsnorm(p["ln1"], h, cfg.norm_eps), kvc, pos, cfg)
        h = h + resolve_partial(y)
        y, _ = attn.gqa_decode(
            p["cross_attn"], rmsnorm(p["ln_x"], h, cfg.norm_eps), kvc, pos,
            cfg, kv_override=(layer_view(caches.cross_k, i),
                              layer_view(caches.cross_v, i)))
        h = h + resolve_partial(y)
        h = h + resolve_partial(
            mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps), cfg.act))
    return _tied_logits(params, h, cfg), caches

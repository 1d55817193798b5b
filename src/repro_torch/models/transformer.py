"""Decoder-only LM assembly (dense / MoE / MLA / SSM / hybrid layers).

The PyTorch counterpart of ``repro.models.transformer``.  Parameters keep
the reference's layout, a dict with ``embed``, ``groups`` (one layer dict
per kind of the layer pattern, whose leaves are stacked along axis 0 over
the pattern's repetitions), ``ln_f`` and ``lm_head``, so every leaf path
and shape of a checkpoint is the same in both packages
(``params/groups/0/attn/wq`` is ``(n_groups, d, H·dh)``,
``params/groups/0/moe/moe_w_gate`` ``(n_groups, E, d, f)``,
``params/groups/0/mixer/wk`` of an RWKV6 layer).  Plain functions run over
that dict.  The layer kinds are ``attn`` (GQA or MLA, with a dense or a
Mixture-of-Experts MLP, ``models/moe.py``), ``mamba`` (with an MLP or
MoE) and ``rwkv6`` (whose channel mix is its MLP), ``models/ssm.py``; a
hybrid (jamba) repeats its ``hybrid_pattern``.

The stacked leaves are split into per-layer views with one ``unbind(0)``
per forward: indexing ``w[i]`` once per layer would make each layer's
backward write a full-size zero tensor.  ``remat=True`` (the reference's
``jax.checkpoint`` of the group body) checkpoints each group with
``torch.utils.checkpoint`` (non-reentrant).

Decode keeps the reference's cache layout: ``init_caches`` gives one
state per kind of the pattern, its leaves stacked ``(n_groups, B, …)`` in
the NamedTuple's field order: a
:class:`~repro_torch.models.attention.KVCache` (GQA: ``(n_groups, B, C,
KV, dh)``, ``caches/0/k``), an
:class:`~repro_torch.models.attention.MLACache` (``(n_groups, B, C, r)``
and ``(n_groups, B, C, rope_dim)``, ``caches/0/c_kv``), an
:class:`~repro_torch.models.ssm.RWKVState` (``caches/0/tm_shift``,
``cm_shift``, ``wkv``) or a :class:`~repro_torch.models.ssm.MambaState`
(``conv_x``, ``conv_bc``, ``ssm``), so a serving state's leaf names and
shapes are the reference's.  ``lm_decode_step`` writes each layer's new
cache rows or recurrent state into the stacked leaves in place and
returns the caches it was given.

A MoE layer's router aux loss is summed over the layers, as in the
reference.  The encoder-decoder is ``models/encdec.py``.

Forward signatures:
  ``lm_forward(params, tokens, cfg, extra_embeds=None) → (logits, aux)``
  ``lm_decode_step(params, token, caches, pos, cfg) → (logits, caches)``
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    cast_floating,
    embed_init,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
)

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"float32"``, ``"bfloat16"``) → torch dtype."""
    return getattr(torch, name)


# --------------------------------------------------------------------------- #
# per-layer init/apply
# --------------------------------------------------------------------------- #


def _is_moe_layer(cfg: ArchConfig, idx_in_pattern: int) -> bool:
    if cfg.moe is None:
        return False
    return idx_in_pattern % cfg.moe.every_k_layers == (cfg.moe.every_k_layers - 1) \
        if cfg.moe.every_k_layers > 1 else True


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str,
               moe_layer: bool, dtype) -> Params:
    dev = gen.device
    p: Params = {"ln1": init_rmsnorm(cfg.d_model, dtype, dev)}
    if kind == "attn":
        p["attn"] = attn.init_attention(gen, cfg, dtype)
    elif kind == "mamba":
        p["mixer"] = ssm_mod.init_mamba_layer(gen, cfg, dtype)
    elif kind == "rwkv6":
        p["mixer"] = ssm_mod.init_rwkv6_layer(gen, cfg, dtype)
    else:
        raise ValueError(kind)
    p["ln2"] = init_rmsnorm(cfg.d_model, dtype, dev)
    if kind != "rwkv6":                      # rwkv layer embeds its own ffn
        if moe_layer:
            p["moe"] = moe_mod.init_moe(gen, cfg, dtype)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _ffn(p: Params, h: torch.Tensor, cfg: ArchConfig, moe_layer: bool
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLP or MoE half of an attention or Mamba block → (h, aux)."""
    x = rmsnorm(p["ln2"], h, cfg.norm_eps)
    if moe_layer:
        y, aux = moe_mod.moe_mlp(p["moe"], x, cfg)
    else:
        y = mlp(p["mlp"], x, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux


def apply_layer(p: Params, h: torch.Tensor, cfg: ArchConfig, kind: str,
                moe_layer: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual block → (h, aux_loss)."""
    x = rmsnorm(p["ln1"], h, cfg.norm_eps)
    if kind == "attn":
        h = h + attn.attention(p["attn"], x, cfg)
    elif kind == "mamba":
        h = h + ssm_mod.mamba_block(p["mixer"], x, cfg)
    elif kind == "rwkv6":
        h = h + ssm_mod.rwkv6_time_mix(p["mixer"], x, cfg)
        h = h + ssm_mod.rwkv6_channel_mix(
            p["mixer"], rmsnorm(p["ln2"], h, cfg.norm_eps))
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        raise ValueError(kind)
    return _ffn(p, h, cfg, moe_layer)


# --------------------------------------------------------------------------- #
# full-model init
# --------------------------------------------------------------------------- #


def _pattern(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.hybrid_pattern is not None:
        return cfg.hybrid_pattern
    if cfg.family == "ssm" and cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return ("rwkv6",)
    if cfg.family == "ssm":
        return ("mamba",)
    return ("attn",)


def _stack(trees: List[Any]) -> Any:
    """Per-layer trees → one tree whose leaves are stacked along axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _unstack(tree: Any, n: int) -> List[Any]:
    """Stacked tree → ``n`` per-layer trees of views (one ``unbind`` per
    leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Parameters on ``gen.device`` in ``cfg.param_dtype``."""
    dtype = dtype_of(cfg.param_dtype)
    pattern = _pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    groups = [_stack([init_layer(gen, cfg, kind, _is_moe_layer(cfg, i), dtype)
                      for _ in range(n_groups)])
              for i, kind in enumerate(pattern)]
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "groups": groups,
        "ln_f": init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype)
    return params


# --------------------------------------------------------------------------- #
# forward (train / prefill)
# --------------------------------------------------------------------------- #


def lm_backbone(params: Params, h: torch.Tensor, cfg: ArchConfig,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    pattern = _pattern(cfg)
    n_groups = params["groups"][0]["ln1"]["scale"].shape[0]
    layers = [_unstack(params["groups"][i], n_groups)
              for i in range(len(pattern))]

    def group_body(h, gp):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, kind in enumerate(pattern):
            h, a = apply_layer(gp[i], h, cfg, kind, _is_moe_layer(cfg, i))
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(n_groups):
        gp = [layers[i][g] for i in range(len(pattern))]
        if remat:
            h, a = checkpoint(group_body, h, gp, use_reentrant=False)
        else:
            h, a = group_body(h, gp)
        aux = aux + a
    return h, aux


def lm_logits(params: Params, h: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def lm_forward(
    params: Params,
    tokens: torch.Tensor,                      # (B, S_text) integer
    cfg: ArchConfig,
    *,
    extra_embeds: Optional[torch.Tensor] = None,  # (B, P, d) prepended (vlm)
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    cdt = dtype_of(cfg.compute_dtype)
    params = cast_floating(params, cdt)
    # the gather of the reference's embed[tokens]; F.embedding's backward
    # is deterministic on a card
    h = F.embedding(tokens.long(), params["embed"]).to(cdt)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(cdt), h], dim=1)
    h, aux = lm_backbone(params, h, cfg, remat=remat)
    return lm_logits(params, h, cfg), aux


# --------------------------------------------------------------------------- #
# decode (one token, stacked caches, a loop over groups)
# --------------------------------------------------------------------------- #


class LayerCache(NamedTuple):
    """Per-group cache union; unused fields are shape-(0,) placeholders."""
    attn: Any
    ssm: Any


def init_caches(batch: int, cfg: ArchConfig, max_len: int,
                device="cuda") -> Any:
    """Stacked (n_groups, ...) cache tree in ``cfg.compute_dtype``."""
    cdt = dtype_of(cfg.compute_dtype)
    pattern = _pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    caches = []
    for kind in pattern:
        if kind == "attn":
            one = attn.init_decode_cache(batch, cfg, max_len, cdt, "meta")
        elif kind == "mamba":
            one = ssm_mod.init_mamba_state(batch, cfg, cdt, "meta")
        elif kind == "rwkv6":
            one = ssm_mod.init_rwkv_state(batch, cfg, cdt, "meta")
        else:
            raise ValueError(kind)
        caches.append(type(one)(*(
            torch.zeros((n_groups,) + tuple(x.shape), dtype=x.dtype,
                        device=device) for x in one)))
    return caches


def cache_struct(batch: int, cfg: ArchConfig, max_len: int) -> Any:
    """The cache tree's shapes and dtypes, allocated on the ``meta``
    device (no memory)."""
    return init_caches(batch, cfg, max_len, device="meta")


def cache_protects(selector: str = "**") -> list:
    """Explicit axis metadata for :func:`init_caches` trees, carried as
    ``Protect`` axis clauses: every leaf is stacked ``(n_groups, B, ...)``,
    so batch is dim 1."""
    from repro_torch.core.protect import Protect
    return [Protect(selector, axis={"batch": 1})]


def lm_decode_step(
    params: Params,
    token: torch.Tensor,                       # (B, 1) integer
    caches: Any,
    pos,                                       # int (or 0-d tensor)
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Any]:
    pos = int(pos)
    cdt = dtype_of(cfg.compute_dtype)
    params = cast_floating(params, cdt)
    pattern = _pattern(cfg)
    n_groups = params["groups"][0]["ln1"]["scale"].shape[0]
    layers = [_unstack(params["groups"][i], n_groups)
              for i in range(len(pattern))]
    h = F.embedding(token.long(), params["embed"]).to(cdt)
    for g in range(n_groups):
        for i, kind in enumerate(pattern):
            p = layers[i][g]
            c = caches[i]
            c = type(c)(*(x[g] for x in c))   # views: written in place
            x = rmsnorm(p["ln1"], h, cfg.norm_eps)
            if kind == "attn":
                y, _ = attn.attention_decode(p["attn"], x, c, pos, cfg)
            elif kind == "mamba":
                y, _ = ssm_mod.mamba_decode_step(p["mixer"], x, c, cfg)
            else:
                y, c = ssm_mod.rwkv6_decode_step(p["mixer"], x, c, cfg)
                h = h + y
                y, _ = ssm_mod.rwkv6_channel_mix_decode(
                    p["mixer"], rmsnorm(p["ln2"], h, cfg.norm_eps), c)
                h = h + y
                continue
            h, _ = _ffn(p, h + y, cfg, _is_moe_layer(cfg, i))
    return lm_logits(params, h, cfg), caches

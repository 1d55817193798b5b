"""Decoder-only LM assembly: the ``("attn",)`` layer pattern, dense or MoE.

The PyTorch counterpart of ``repro.models.transformer`` for GQA and MLA
models with a dense or a Mixture-of-Experts MLP (``models/moe.py``).  Parameters
keep the reference's layout, a dict with ``embed``, ``groups`` (a
one-element list of layer dicts whose leaves are stacked along axis 0),
``ln_f`` and ``lm_head``, so every leaf path and shape of a checkpoint is
the same in both packages (``params/groups/0/attn/wq`` is
``(n_layers, d, H·dh)``, ``params/groups/0/moe/moe_w_gate``
``(n_layers, E, d, f)``).  Plain functions run over that dict.

The stacked leaves are split into per-layer views with one ``unbind(0)``
per forward: indexing ``w[i]`` once per layer would make each layer's
backward write a full-size zero tensor.  ``remat=True`` (the reference's
``jax.checkpoint`` of the group body) checkpoints each layer with
``torch.utils.checkpoint`` (non-reentrant).

Decode keeps the reference's cache layout: ``init_caches`` gives one
:class:`~repro_torch.models.attention.KVCache` (GQA: leaves stacked
``(n_groups, B, C, KV, dh)``, ``caches/0/k``) or
:class:`~repro_torch.models.attention.MLACache` (MLA: ``(n_groups, B, C,
r)`` and ``(n_groups, B, C, rope_dim)``, ``caches/0/c_kv``) per layer of
the pattern, so a serving state's leaf names and shapes are the
reference's.  ``lm_decode_step`` writes each layer's new cache rows in
place and returns the caches it was given.

A MoE layer's router aux loss is summed over the layers, as in the
reference.  SSM and hybrid layers are not ported yet and raise.

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
from repro_torch.models.layers import (
    cast_floating,
    embed_init,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
)

Params = Dict[str, Any]

_LATER_ARCHS = ("is not ported yet: SSM and hybrid architectures are "
                "ROADMAP Queue 1, item 2.3 (encoder-decoder, item 2.4, "
                "follows)")


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


def _check_ported(cfg: ArchConfig) -> None:
    for kind in _pattern(cfg):
        if kind != "attn":
            raise NotImplementedError(f"the {kind} layer of {cfg.name} "
                                      f"{_LATER_ARCHS}")


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str,
               moe_layer: bool, dtype) -> Params:
    if kind != "attn":
        raise NotImplementedError(f"the {kind} layer {_LATER_ARCHS}")
    p: Params = {
        "ln1": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": attn.init_attention(gen, cfg, dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if moe_layer:
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def apply_layer(p: Params, h: torch.Tensor, cfg: ArchConfig, kind: str,
                moe_layer: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual block → (h, aux_loss)."""
    if kind != "attn":
        raise NotImplementedError(f"the {kind} layer {_LATER_ARCHS}")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h = h + attn.attention(p["attn"], rmsnorm(p["ln1"], h, cfg.norm_eps), cfg)
    x = rmsnorm(p["ln2"], h, cfg.norm_eps)
    if moe_layer:
        y, aux = moe_mod.moe_mlp(p["moe"], x, cfg)
    else:
        y = mlp(p["mlp"], x, cfg.act)
    return h + y, aux


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
    _check_ported(cfg)
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
    _check_ported(cfg)
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
    _check_ported(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    pattern = _pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    caches = []
    for _kind in pattern:
        one = attn.init_decode_cache(batch, cfg, max_len, cdt, "meta")
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
    _check_ported(cfg)
    pos = int(pos)
    cdt = dtype_of(cfg.compute_dtype)
    params = cast_floating(params, cdt)
    pattern = _pattern(cfg)
    n_groups = params["groups"][0]["ln1"]["scale"].shape[0]
    layers = [_unstack(params["groups"][i], n_groups)
              for i in range(len(pattern))]
    h = F.embedding(token.long(), params["embed"]).to(cdt)
    for g in range(n_groups):
        for i, _kind in enumerate(pattern):
            p = layers[i][g]
            c = caches[i]
            y, _ = attn.attention_decode(
                p["attn"], rmsnorm(p["ln1"], h, cfg.norm_eps),
                type(c)(*(x[g] for x in c)), pos, cfg)
            h = h + y
            x = rmsnorm(p["ln2"], h, cfg.norm_eps)
            if _is_moe_layer(cfg, i):
                y, _ = moe_mod.moe_mlp(p["moe"], x, cfg)
            else:
                y = mlp(p["mlp"], x, cfg.act)
            h = h + y
    return lm_logits(params, h, cfg), caches

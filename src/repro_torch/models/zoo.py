"""Model zoo: uniform entry points over every architecture.

The PyTorch counterpart of ``repro.models.zoo``: decoder-only LMs (GQA
or MLA attention with dense or Mixture-of-Experts MLPs, RWKV6 and Mamba
layers, and hybrid layer patterns: ``family`` ``dense``, ``vlm``,
``moe``, ``ssm``, ``hybrid``) and the encoder-decoder (``encdec``, whose
batch carries ``frames`` beside ``tokens``):

  init(gen)                      → params on ``gen.device``
  forward(params, batch, remat=) → (logits, aux)     batch: dict of tensors
  init_caches(batch, max_len, device="cuda") → caches
  decode_step(params, token, caches, pos) → (logits, caches)

``decode_step`` updates the caches (KV or latent rows, recurrent states)
in place and returns them.  An encoder-decoder's ``init_caches`` takes an
``enc_len`` (default ``max_len``) for its static cross K/V.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as lm_mod


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]                   # (gen) → params
    forward: Callable[..., Any]                # (params, batch, remat=) → (logits, aux)
    init_caches: Callable[..., Any]            # (batch, max_len, device=) → caches
    cache_struct: Callable[..., Any]           # (batch, max_len) → meta caches
    decode_step: Callable[..., Any]            # (params, token, caches, pos)
    cache_protects: Callable[[], Any] = lm_mod.cache_protects
    # () → [Protect]: explicit batch-axis metadata for the cache tree
    # (layers stacked in dim 0, batch in dim 1)


def _lm_forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                remat: bool = False):
    return lm_mod.lm_forward(
        params, batch["tokens"], cfg,
        extra_embeds=batch.get("patch_embeds"), remat=remat)


def _encdec_forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                    remat: bool = False):
    return encdec_mod.encdec_forward(
        params, batch["frames"], batch["tokens"], cfg, remat=remat)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.encdec:
        return Model(
            cfg=cfg,
            init=functools.partial(encdec_mod.init_encdec, cfg=cfg),
            forward=functools.partial(_encdec_forward, cfg=cfg),
            init_caches=functools.partial(_encdec_caches, cfg=cfg),
            cache_struct=functools.partial(_encdec_cache_struct, cfg=cfg),
            decode_step=functools.partial(_encdec_decode, cfg=cfg),
        )
    return Model(
        cfg=cfg,
        init=functools.partial(lm_mod.init_lm, cfg=cfg),
        forward=functools.partial(_lm_forward, cfg=cfg),
        init_caches=functools.partial(_lm_caches, cfg=cfg),
        cache_struct=functools.partial(_lm_cache_struct, cfg=cfg),
        decode_step=functools.partial(_lm_decode, cfg=cfg),
    )


def _lm_caches(batch: int, max_len: int, cfg: ArchConfig, device="cuda"):
    return lm_mod.init_caches(batch, cfg, max_len, device)


def _lm_cache_struct(batch: int, max_len: int, cfg: ArchConfig):
    return lm_mod.cache_struct(batch, cfg, max_len)


def _lm_decode(params, token, caches, pos, cfg: ArchConfig):
    return lm_mod.lm_decode_step(params, token, caches, pos, cfg)


def _encdec_caches(batch: int, max_len: int, cfg: ArchConfig, device="cuda",
                   enc_len: Optional[int] = None):
    return encdec_mod.init_encdec_caches(
        batch, cfg, max_len, enc_len if enc_len is not None else max_len,
        device)


def _encdec_cache_struct(batch: int, max_len: int, cfg: ArchConfig,
                         enc_len: Optional[int] = None):
    return encdec_mod.encdec_cache_struct(
        batch, cfg, max_len, enc_len if enc_len is not None else max_len)


def _encdec_decode(params, token, caches, pos, cfg: ArchConfig):
    return encdec_mod.encdec_decode_step(params, token, caches, pos, cfg)

"""Model zoo: uniform entry points over the ported architectures.

The PyTorch counterpart of ``repro.models.zoo`` for decoder-only LMs:

  init(gen)                      → params on ``gen.device``
  forward(params, batch, remat=) → (logits, aux)     batch: dict of tensors

Encoder-decoder models and decode (``init_caches`` / ``decode_step``) are
later slices and raise.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as lm_mod


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]                   # (gen) → params
    forward: Callable[..., Any]                # (params, batch, remat=) → (logits, aux)
    init_caches: Callable[..., Any]            # serving slice: raises
    decode_step: Callable[..., Any]            # serving slice: raises


def _lm_forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                remat: bool = False):
    return lm_mod.lm_forward(
        params, batch["tokens"], cfg,
        extra_embeds=batch.get("patch_embeds"), remat=remat)


def _decode_pending(*_args, **_kw):
    raise NotImplementedError(
        "decode (KV caches, decode_step) is not ported yet (ROADMAP Queue 1, "
        "item 3: serving)")


def build_model(cfg: ArchConfig) -> Model:
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet (ROADMAP "
            f"Queue 1, item 2: whisper-small)")
    return Model(
        cfg=cfg,
        init=functools.partial(lm_mod.init_lm, cfg=cfg),
        forward=functools.partial(_lm_forward, cfg=cfg),
        init_caches=_decode_pending,
        decode_step=_decode_pending,
    )

"""Model zoo: uniform entry points over every architecture.

The PyTorch counterpart of ``repro.models.zoo``: decoder-only LMs (GQA
or MLA attention with dense or Mixture-of-Experts MLPs, RWKV6 and Mamba
layers, and hybrid layer patterns: ``family`` ``dense``, ``vlm``,
``moe``, ``ssm``, ``hybrid``) and the encoder-decoder (``encdec``, whose
batch carries ``frames`` beside ``tokens``):

  init(gen)                      → params on ``gen.device``
  param_struct()                 → the same tree as ``meta`` tensors
  forward(params, batch, remat=) → (logits, aux)     batch: dict of tensors
  init_caches(batch, max_len, device="cuda") → caches
  decode_step(params, token, caches, pos) → (logits, caches)

and, per architecture, :func:`batch_struct` (one training batch as
``meta`` tensors: the dry-run's input) and :func:`make_dummy_batch`.

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
    param_struct: Callable[[], Any]            # () → meta-tensor tree
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
            param_struct=functools.partial(encdec_mod.encdec_param_struct,
                                           cfg),
            forward=functools.partial(_encdec_forward, cfg=cfg),
            init_caches=functools.partial(_encdec_caches, cfg=cfg),
            cache_struct=functools.partial(_encdec_cache_struct, cfg=cfg),
            decode_step=functools.partial(_encdec_decode, cfg=cfg),
        )
    return Model(
        cfg=cfg,
        init=functools.partial(lm_mod.init_lm, cfg=cfg),
        param_struct=functools.partial(lm_mod.lm_param_struct, cfg),
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


# --------------------------------------------------------------------------- #
# batch construction (real + abstract)
# --------------------------------------------------------------------------- #


def batch_struct(cfg: ArchConfig, global_batch: int, seq_len: int,
                 device="meta") -> Dict[str, torch.Tensor]:
    """One training batch of this architecture as empty tensors on
    ``device`` (``meta`` by default: shapes and dtypes only; the stub
    frontends' inputs included), with the reference's keys, shapes and
    dtypes."""
    f = getattr(torch, cfg.compute_dtype)
    i32 = torch.int32

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    if cfg.encdec:
        return {
            "frames": empty((global_batch, seq_len, cfg.d_model), f),
            "tokens": empty((global_batch, seq_len), i32),
            "labels": empty((global_batch, seq_len), i32),
        }
    if cfg.frontend == "vision_stub":
        p = cfg.n_frontend_tokens
        return {
            "patch_embeds": empty((global_batch, p, cfg.d_model), f),
            "tokens": empty((global_batch, seq_len - p), i32),
            "labels": empty((global_batch, seq_len), i32),
        }
    return {
        "tokens": empty((global_batch, seq_len), i32),
        "labels": empty((global_batch, seq_len), i32),
    }


def make_dummy_batch(cfg: ArchConfig, global_batch: int, seq_len: int,
                     gen: Optional[torch.Generator] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """A batch of :func:`batch_struct`'s shapes: integer leaves uniform in
    ``[0, vocab)``, floating ones normal × 0.02, drawn on the host from
    ``gen`` (seed 0 by default), in the struct's order."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    out = {}
    for name, s in batch_struct(cfg, global_batch, seq_len).items():
        if s.dtype.is_floating_point:
            x = (torch.randn(s.shape, generator=gen) * 0.02).to(s.dtype)
        else:
            x = torch.randint(0, cfg.vocab_size, s.shape, generator=gen,
                              dtype=s.dtype)
        out[name] = x if device is None else x.to(device)
    return out

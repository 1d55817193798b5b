"""Shared model building blocks (plain functions over dicts of tensors).

The PyTorch counterpart of ``repro.models.layers``.  Every layer is a plain
function ``f(params, x, ...) -> y`` over a dict of tensors, created by an
``init_*`` function; layer stacks are stored *stacked along axis 0*, as in
the JAX package, so a checkpoint's leaf paths and shapes are the same in
both packages.  The f32 upcasts sit exactly where the reference has them
(norms, rotary embedding, the loss).

Random initialisation draws from an explicit ``torch.Generator`` whose
device is the parameters' device.  It does not reproduce ``jax.random``'s
bits: parity tests carry weights across with ``from_numpy_named``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.02).to(dtype)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #


def init_rmsnorm(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def init_layernorm(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in f32, cast back to ``x``'s dtype; the
    variance is the population one (``jnp.var``)."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def groupnorm_heads(x: torch.Tensor, n_heads: int, eps: float = 1e-5
                    ) -> torch.Tensor:
    """GroupNorm with one group per head over the last dim (RWKV wkv
    output), in f32; the variance is the population one (``jnp.var``)."""
    dt = x.dtype
    *lead, d = x.shape
    x32 = x.float().reshape(*lead, n_heads, d // n_heads)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.reshape(*lead, d).to(dt)


# --------------------------------------------------------------------------- #
# activations / MLP
# --------------------------------------------------------------------------- #

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "relu": F.relu,
}


def init_mlp(gen: torch.Generator, d: int, f: int, dtype) -> Params:
    return {
        "w_gate": dense_init(gen, d, f, dtype),
        "w_up": dense_init(gen, d, f, dtype),
        "w_down": dense_init(gen, f, d, dtype),
    }


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    a = _ACTS[act]
    h = a(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# --------------------------------------------------------------------------- #
# rotary embedding
# --------------------------------------------------------------------------- #


def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    dt = x.dtype
    dim = x.shape[-1]
    freqs = rope_frequencies(dim, theta, x.device)              # (dim/2,)
    angles = positions[..., :, None].float() * freqs           # (..., S, dim/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (..., S, 1, dim/2)
    sin = torch.sin(angles)[..., :, None, :]
    x32 = x.float()
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #


def cast_floating(tree: Any, dtype) -> Any:
    """Cast floating leaves to ``dtype`` (params stored fp32, computed bf16).
    Under autograd the cast is differentiable: gradients reach the stored
    leaves in their own dtype."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Stable CE; logits (..., V) fp32-promoted, labels int (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - label_logit

"""Mixture-of-Experts MLP — GShard-style grouped capacity dispatch.

The PyTorch counterpart of ``repro.models.moe``, with its two dispatches:

- ``einsum`` (the default): one-hot dispatch/combine einsums (GShard
  [arXiv:2006.16668] / Switch [arXiv:2101.03961]).
- ``scatter``: sort-based token permutation (MegaBlocks-flavoured): the
  dispatch cost moves from FLOPs to gathers and one ``index_add``.

Tokens are processed in groups of ``group_size`` with per-group expert
capacity ``C = ceil(group_size · top_k · capacity_factor / E)`` rounded up
to a multiple of 4 (overflow tokens are dropped by the router: their
residual path passes through).  ``C`` comes from the configured group
size, not the group actually used (``min(group_size, tokens)``), as in the
reference.

The parameters keep the reference's leaf names and shapes: ``router``
(d, E) in f32, ``moe_w_gate`` / ``moe_w_up`` (E, d, f) and ``moe_w_down``
(E, f, d).  Routing runs in f32 on the router's compute-dtype values
(``x.float() @ router.float()``: the reference's promotion of a bf16
router to f32).  One-hot rows are comparisons against ``arange``, as
``jax.nn.one_hot`` computes them: a class at or past the width gives a row
of zeros (``F.one_hot`` raises there, and asserts on a card), and no
scatter runs under deterministic mode.  Masks and positions stay
integers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import _ACTS, dense_init

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    m = cfg.moe
    assert m is not None
    d, f, e = cfg.d_model, cfg.d_ff, m.n_experts

    def normal(*shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=gen.device) * scale).to(dtype)

    return {
        "router": dense_init(gen, d, e, torch.float32),
        "moe_w_gate": normal(e, d, f, scale=1.0 / math.sqrt(d)),
        "moe_w_up": normal(e, d, f, scale=1.0 / math.sqrt(d)),
        "moe_w_down": normal(e, f, d, scale=1.0 / math.sqrt(f)),
    }


def _capacity(m: MoEConfig) -> int:
    c = int(m.group_size * m.top_k * m.capacity_factor / m.n_experts)
    return max(4, (c + 3) // 4 * 4)


def _one_hot(x: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot(x, n, dtype=dtype)``: zeros where ``x`` is outside
    ``[0, n)``."""
    return (x.unsqueeze(-1) == torch.arange(n, dtype=x.dtype,
                                            device=x.device)).to(dtype)


def _router(x_groups: torch.Tensor, p: Params, m: MoEConfig):
    """x_groups (G, gs, d) → gates (G,gs,k), idx (G,gs,k), aux."""
    logits = x_groups.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss on the top-1 assignment
    top1 = _one_hot(idx[..., 0], m.n_experts, torch.float32)
    frac_tokens = top1.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = m.n_experts * torch.sum(frac_tokens * frac_probs)
    return gates, idx, aux


def _expert_ffn(p: Params, h: torch.Tensor, act) -> torch.Tensor:
    """h (E, C', d) → (E, C', d) batched gated MLP."""
    up = act(h @ p["moe_w_gate"]) * (h @ p["moe_w_up"])
    return up @ p["moe_w_down"]


def _moe_einsum(p: Params, xg: torch.Tensor, m: MoEConfig, act
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    g, gs, d = xg.shape
    e, cap = m.n_experts, _capacity(m)
    gates, idx, aux = _router(xg, p, m)

    dispatch = torch.zeros((g, gs, e, cap), dtype=xg.dtype, device=xg.device)
    combine = torch.zeros((g, gs, e, cap), dtype=torch.float32,
                          device=xg.device)
    count = torch.zeros((g, 1, e), dtype=torch.int32, device=xg.device)
    for k in range(m.top_k):
        mask = _one_hot(idx[..., k], e, torch.int32)                 # (G,gs,E)
        pos = torch.cumsum(mask, dim=1, dtype=torch.int32) - mask + count
        keep = (pos < cap) & (mask > 0)
        count = count + mask.sum(dim=1, keepdim=True, dtype=torch.int32)
        pos_oh = _one_hot(pos, cap, xg.dtype) * keep[..., None].to(xg.dtype)
        dispatch = dispatch + pos_oh
        combine = combine + pos_oh.float() * gates[..., k][..., None, None]

    with record_function("moe.dispatch_einsum"):
        expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)     # (E,G,C,d)
    expert_out = _expert_ffn(p, expert_in.reshape(e, g * cap, d), act)
    expert_out = expert_out.reshape(e, g, cap, d)
    with record_function("moe.combine_einsum"):
        out = torch.einsum("gsec,egcd->gsd", combine.to(xg.dtype),
                           expert_out)
    return out, aux


def _moe_scatter(p: Params, xg: torch.Tensor, m: MoEConfig, act
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    g, gs, d = xg.shape
    e = m.n_experts
    gates, idx, aux = _router(xg, p, m)
    x = xg.reshape(g * gs, d)
    n = g * gs
    dev = xg.device

    flat_e = idx.reshape(-1)                                          # (n·k,)
    flat_t = torch.arange(n, device=dev).repeat_interleave(m.top_k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted, t_sorted, g_sorted = flat_e[order], flat_t[order], flat_g[order]
    # rank within expert = index - first index of that expert
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                        torch.cumsum(counts, dim=0)[:-1]])
    ranks = torch.arange(n * m.top_k, device=dev) - starts[e_sorted]
    cap_total = max(4, int(n * m.top_k * m.capacity_factor / e))
    keep = ranks < cap_total
    slot = torch.where(keep, e_sorted * cap_total + ranks,
                       torch.full_like(ranks, e * cap_total))          # drop row

    buf = torch.zeros((e * cap_total + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_put((slot,), x[t_sorted])
    hidden = _expert_ffn(p, buf[:-1].reshape(e, cap_total, d), act)
    hidden = hidden.reshape(e * cap_total, d)
    picked = torch.where(keep[:, None],
                         hidden[torch.clamp(slot, 0, e * cap_total - 1)],
                         torch.zeros((), dtype=hidden.dtype, device=dev))
    out = torch.zeros((n, d), dtype=torch.float32, device=dev).index_add(
        0, t_sorted, picked.float() * g_sorted[:, None])
    return out.to(x.dtype).reshape(g, gs, d), aux


def moe_mlp(p: Params, x: torch.Tensor, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (out (B, S, d), aux_loss scalar)."""
    m = cfg.moe
    assert m is not None
    act = _ACTS[cfg.act]
    b, s, d = x.shape
    n = b * s
    gs = min(m.group_size, n)
    assert n % gs == 0, f"tokens {n} not divisible by group {gs}"
    xg = x.reshape(n // gs, gs, d)
    if m.dispatch == "scatter":
        out, aux = _moe_scatter(p, xg, m, act)
    else:
        out, aux = _moe_einsum(p, xg, m, act)
    return out.reshape(b, s, d), aux

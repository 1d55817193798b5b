"""Plain PyTorch pieces the references share: matrix products, norms,
attention, the loss and AdamW, in float32 with TF32 off.

Nothing here imports the program under test.  The references take the
weights and batches the benchmark made and work out the rest again: the
positions, the rotary angles, the learning rate.

``Precision`` says how what the configuration computes in its compute
type (bfloat16) is held: ``"f32"`` for the reference; ``"bf16"``, the
reference rounded where a bfloat16 program rounds (a witness of what the
stated precision alone costs); or ``"fp8"`` for the control, the reference
one step below the stated precision: every product's operands and result
and the residual stream after each addition rounded to float8 e4m3 with a
scale per tensor (amax / 448), as a bfloat16 program rounds them to
bfloat16; norms, softmax and the loss stay in float32, as in the program.
The rounding passes the gradient through unchanged, so the control's
backward runs on the rounded values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import torch

E4M3_MAX = 448.0


def strict_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Precision:
    products: str = "f32"           # "f32", "bf16" or "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.products == "f32":
            return x
        if self.products == "bf16":
            r = x.detach().to(torch.bfloat16).to(x.dtype)
        elif self.products == "fp8":
            scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
            r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) \
                * scale
        else:
            raise ValueError(f"unknown precision {self.products!r}")
        return x + (r - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(self.q(a) @ self.q(b))

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return self.q(torch.einsum(spec, self.q(a), self.q(b)))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACTS = {"silu": silu}


def gated_mlp(x, w_gate, w_up, w_down, act, pr: Precision):
    return pr.mm(act(pr.mm(x, w_gate)) * pr.mm(x, w_up), w_down)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, pr: Precision) -> torch.Tensor:
    """q (B, S, H, dh), k and v (B, Sk, KV, dh) → (B, S, H, dh); query head
    h reads KV head h // (H / KV); scores scaled by 1/sqrt(dh), softmax in
    float32."""
    b, s, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = pr.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if causal:
        keep = torch.ones(s, sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    return pr.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x (B, S, heads, dh), the two halves of
    the head rotated as pairs (i, i + dh/2)."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Sum over positions of -log softmax(logits)[label]."""
    logits = logits.reshape(-1, logits.shape[-1])
    return torch.nn.functional.cross_entropy(
        logits, labels.reshape(-1).long(), reduction="sum")


# --------------------------------------------------------------------------- #
# AdamW, as the job's optimizer settings state it
# --------------------------------------------------------------------------- #


def learning_rate(opt: Dict, t: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then cosine decay to
    ``min_lr_ratio`` of it at ``total_steps``; ``t`` counts from 1."""
    if t < opt["warmup_steps"]:
        return opt["lr"] * t / max(1.0, opt["warmup_steps"])
    prog = (t - opt["warmup_steps"]) / max(
        1.0, opt["total_steps"] - opt["warmup_steps"])
    prog = min(max(prog, 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """Decoupled weight decay on every leaf of two or more dimensions,
    gradients clipped by their global norm first."""

    def __init__(self, opt: Dict, params: Dict[str, torch.Tensor]):
        self.opt = opt
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Updates ``params`` in place → {leaf: norm of the clipped
        gradient}."""
        o = self.opt
        norm = math.sqrt(sum(float(g.double().pow(2).sum())
                             for g in grads.values()))
        clip = min(1.0, o["grad_clip"] / (norm + 1e-9))
        self.t += 1
        lr = learning_rate(o, self.t)
        b1c, b2c = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        out = {}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * clip
                out[k] = float(g.double().norm())
                self.m[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                self.v[k].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
                upd = (self.m[k] / b1c) / ((self.v[k] / b2c).sqrt() + o["eps"])
                if p.dim() >= 2:
                    upd = upd + o["weight_decay"] * p
                p.sub_(lr * upd)
        return out


def train_steps(forward_blocks, params: Dict[str, torch.Tensor],
                batches: Iterable[Dict[str, torch.Tensor]], opt: Dict
                ) -> Dict[str, List]:
    """The reference's first steps: for each batch, the loss and its
    gradient summed over blocks of rows (``forward_blocks(params, batch)``
    yields each block's share of the loss, with autograd), then AdamW.
    ``params`` (float32 leaves) are updated in place.
    → {"loss": [per step], "grad_norms": [{leaf: norm} per step]}."""
    for p in params.values():
        p.requires_grad_(True)
    adam = AdamW(opt, params)
    out: Dict[str, List] = {"loss": [], "grad_norms": []}
    for batch in batches:
        for p in params.values():
            p.grad = None
        total = 0.0
        for part in forward_blocks(params, batch):
            part.backward()
            total += float(part.detach())
        grads = {k: p.grad for k, p in params.items()}
        out["loss"].append(total)
        out["grad_norms"].append(adam.step(params, grads))
    for p in params.values():
        p.requires_grad_(False)
        p.grad = None
    return out


def leaf(params: Dict[str, torch.Tensor], path: str,
         i: Optional[int] = None) -> torch.Tensor:
    """A parameter by its path in the program's tree, one layer of a leaf
    stacked over layers when ``i`` is given."""
    x = params[path]
    return x if i is None else x[i]

"""AdamW + learning-rate schedule in plain tensor ops.

The PyTorch counterpart of ``repro.train.optimizer``, written to the same
formulas in the same order, f32 throughout.  The update is functional, as
in the reference: ``adamw_update`` returns new parameter and moment
tensors and leaves its inputs unchanged, so a state handed to several runs
(a run and its resume) starts each of them from the same bytes.

``count`` and the learning rate live on the host; the moments live with
the parameters.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    count: torch.Tensor          # scalar int32
    mu: Any                      # first moment (tree, fp32)
    nu: Any                      # second moment (tree, fp32)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts/lists/tuples (and of trees
    of the same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in the reference's order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def adamw_init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        count=torch.zeros((), dtype=torch.int32),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def adamw_update(cfg: AdamWConfig, grads: Any, state: AdamWState,
                 params: Any) -> Tuple[Any, AdamWState, dict]:
    """Returns (new_params, new_state, metrics)."""
    grads = tree_map(lambda g: g.float(), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()

    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g,
                  state.nu, grads)

    def upd(p, m, v):
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:                             # decay matrices only
            step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(count, mu, nu), {"lr": lr,
                                                   "grad_norm": gnorm}

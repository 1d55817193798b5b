"""Train-step factory: loss, grads, microbatch accumulation, optimizer.

The PyTorch counterpart of ``repro.train.step``.  ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over detached views of the parameter
leaves (no copy); the step is functional, like the reference's: it returns
a new ``TrainState`` and leaves the one it was given unchanged.

Bit-exact resume on a card needs deterministic kernels:
:func:`use_deterministic_algorithms` switches PyTorch to them.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.protect import flatten_named, unflatten_named
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.models.zoo import Model
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         adamw_update_, tree_leaves,
                                         tree_map)
from repro_torch.train.state import TrainState, fold_in


def use_deterministic_algorithms() -> None:
    """Make every op of a training step deterministic from run to run on a
    card: ``torch.use_deterministic_algorithms(True)``, and the fixed cuBLAS
    workspace it requires (read when cuBLAS starts, so call this before
    the first matrix product on the card)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


def compute_loss(model: Model, params: Any, batch: Dict[str, torch.Tensor],
                 remat: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = model.forward(params, batch, remat=remat)
    labels = batch["labels"]
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    ce = softmax_cross_entropy(logits, safe)
    ce = torch.sum(ce * valid) / torch.clamp(valid.sum(), min=1).float()
    w = model.cfg.moe.router_aux_weight if model.cfg.moe is not None else 0.0
    loss = ce + w * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    *,
    remat: bool = True,
    num_microbatches: int = 1,
    donate: bool = False,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict]]:
    """Build ``train_step(state, batch) → (state, metrics)``.  With
    ``donate`` the state it is given is updated in place (its tensors are
    the returned state's), so the caller must not reuse it."""

    def grad_fn(params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten_named(params).items()}
        loss, metrics = compute_loss(model, unflatten_named(leaves, params),
                                     batch, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return (unflatten_named(dict(zip(leaves, grads)), params),
                {k: v.detach() for k, v in metrics.items()})

    def microbatched(params, batch):
        mb = num_microbatches
        batches = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                   for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(mb):
            grads, metrics = grad_fn(params, {k: v[i]
                                              for k, v in batches.items()})
            acc = tree_map(lambda a, g: a + g.float() / mb, acc, grads)
        return acc, metrics

    accumulate = grad_fn if num_microbatches == 1 else microbatched

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict]:
        grads, metrics = accumulate(state.params, batch)
        if donate:
            # the list holds the only reference to each gradient, so the
            # update frees it as soon as its leaf is done
            grads = tree_leaves(grads)
            new_params = state.params
            new_opt, opt_metrics = adamw_update_(opt_cfg, grads, state.opt,
                                                 new_params)
        else:
            new_params, new_opt, opt_metrics = adamw_update(
                opt_cfg, grads, state.opt, state.params)
        metrics = dict(metrics, **opt_metrics)
        new_state = TrainState(
            step=state.step + 1,
            params=new_params,
            opt=new_opt,
            rng=fold_in(state.rng, 0),
            data_state=state.data_state,
        )
        return new_state, metrics

    return train_step

"""Train-step factory: loss, grads, microbatch accumulation, optimizer.

The PyTorch counterpart of ``repro.train.step``.  ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over detached views of the parameter
leaves (no copy); the step is functional, like the reference's: it returns
a new ``TrainState`` and leaves the one it was given unchanged.

Bit-exact resume on a card needs deterministic kernels:
:func:`use_deterministic_algorithms` switches PyTorch to them.

Sharded execution: on ``DTensor`` parameters and batches the same step
runs on every rank of the mesh.  DTensor leaves a replicated parameter's
gradient as a ``Partial`` sum over the data axes, and AdamW is not linear
in it, so :func:`reduce_grads` redistributes each gradient once, after
the microbatches are accumulated, to the layout of its optimizer moments:
the parameter's own (the data-parallel all-reduce GSPMD inserts in the
reference) or, under ZeRO-1, the moments' data-sharded one (a
reduce-scatter).  The optimizer then updates each parameter in its
moments' layout and returns it to its own (``train/optimizer.py``).
:func:`make_fused_data_train_step` draws the batch from the state's data
cursor, as the reference's does.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.protect import flatten_named, unflatten_named
from repro_torch.dist.context import is_dtensor, sharded_scope, to_placements
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
        with sharded_scope(params, batch):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in flatten_named(params).items()}
            loss, metrics = compute_loss(
                model, unflatten_named(leaves, params), batch, remat=remat)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return (unflatten_named(dict(zip(leaves, grads)), params),
                {k: v.detach() for k, v in metrics.items()})

    def microbatched(params, batch):
        mb = num_microbatches
        batches = {k: _split_microbatches(v, mb) for k, v in batch.items()}
        acc = None
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(mb):
            grads, metrics = grad_fn(params, {k: v[i]
                                              for k, v in batches.items()})
            if acc is None:
                acc = tree_map(lambda g: torch.zeros_like(
                    g, dtype=torch.float32), grads)
            with sharded_scope(grads):
                acc = tree_map(lambda a, g: a + g.float() / mb, acc, grads)
        return acc, metrics

    accumulate = grad_fn if num_microbatches == 1 else microbatched

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict]:
        grads, metrics = accumulate(state.params, batch)
        grads = reduce_grads(grads, state.opt.mu)
        metrics = {k: _plain(v) for k, v in metrics.items()}
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
        metrics = dict(metrics, **{k: _plain(v)
                                   for k, v in opt_metrics.items()})
        new_state = TrainState(
            step=state.step + 1,
            params=new_params,
            opt=new_opt,
            rng=fold_in(state.rng, 0),
            data_state=state.data_state,
        )
        return new_state, metrics

    return train_step


def reduce_grads(grads: Any, moments: Any) -> Any:
    """Each ``DTensor`` gradient redistributed to its optimizer moment's
    placements: ``Partial`` sums over the data axes become the
    data-parallel all-reduce, or a reduce-scatter where the moments are
    data-sharded (ZeRO-1).  Plain gradients are returned as they are."""
    def one(g, m):
        if not is_dtensor(g):
            return g
        return to_placements(g, m.placements if is_dtensor(m)
                             else g.placements)
    return tree_map(one, grads, moments)


def _split_microbatches(x: torch.Tensor, mb: int) -> torch.Tensor:
    """(B, ...) → (mb, B/mb, ...); a batch-sharded ``DTensor`` splits each
    rank's rows, so microbatch i is every rank's i-th slice."""
    if not is_dtensor(x):
        return x.reshape(mb, x.shape[0] // mb, *x.shape[1:])
    from torch.distributed.tensor import DTensor, Shard
    local = x.to_local()
    local = local.reshape(mb, local.shape[0] // mb, *local.shape[1:])
    pl = [Shard(q.dim + 1) if isinstance(q, Shard) else q
          for q in x.placements]
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False)


def _plain(x: Any) -> Any:
    """A metric as a plain tensor (a ``DTensor`` scalar's global value)."""
    return x.full_tensor() if is_dtensor(x) else x


def make_fused_data_train_step(model: Model, opt_cfg: AdamWConfig,
                               global_batch: int, seq_len: int,
                               remat: bool = True,
                               num_microbatches: int = 1):
    """The reference's dry-run form: the step also advances the state's
    data cursor past the batch it trains on (``next_batch``'s new cursor),
    so a checkpoint of the returned state resumes at the next batch."""
    from repro_torch.data.synthetic import DataState

    step_fn = make_train_step(model, opt_cfg, remat=remat,
                              num_microbatches=num_microbatches)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        new_state, metrics = step_fn(state, batch)
        ds = state.data_state
        return new_state._replace(data_state=DataState(
            ds.seed, ds.position + 1)), metrics

    return train_step

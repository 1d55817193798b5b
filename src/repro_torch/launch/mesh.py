"""Meshes, and how a worker process joins its world.

A ``DeviceMesh`` of N devices is N processes, one per mesh coordinate.
:func:`join_from_env` is what a worker started by ``python -m
torch.distributed.run`` calls first: it reads the rank, the world size,
the local rank and the local world size and the store address that the
launcher put in the environment (the only place in the package that
reads them), binds the process to its device and joins the process
group.  :func:`world_layout` picks both from the hardware:

- each rank of this machine has a card of its own (the local world size
  is at most the cards the process sees): rank ``k`` takes ``cuda:k`` and
  the world is ``cpu:gloo,cuda:nccl``: tensors on the card go over NCCL
  (DTensor's redistributions, the gradient reduce-scatter, ZeRO-1's
  all-gather, the decode combine), host tensors over gloo.  There is no
  fallback: where NCCL cannot start or run, the worker raises;
- the ranks share cards (NCCL refuses two ranks on one GPU), or the
  device is the CPU: the world is gloo, every collective a host round
  trip, and on the card gloo's functional all-gather is routed through
  :func:`gloo_cuda_all_gather`.

Either way the checkpoint path exchanges host bytes only, over gloo
groups of its own (``dist/comm.py``).

Every entry point but :func:`make_host_mesh` (the CPU smoke mesh) works
on the card unless its caller names ``"cpu"``, and raises where no card
is visible: nothing falls back to the CPU.

``make_production_mesh`` and ``make_host_mesh`` are functions (not
module-level constants), so importing this module touches no process
group.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: seconds a collective (and the join itself) may wait for the slowest rank
JOIN_TIMEOUT_S = 600
#: the error of every entry point asked for the card where none is visible
NO_CARD = ("device type cuda, but no card is visible (pass device type "
           "'cpu' for the CPU)")


def _init_device_mesh(device_type: str, shape: Sequence[int],
                      names: Sequence[str]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(int(n) for n in shape),
                            mesh_dim_names=tuple(names))


def _check_device_type(device_type: str, n_cards: int) -> None:
    """Raise where ``device_type`` is not one this module lays out, or is
    ``"cuda"`` with no card visible: nothing falls back to the CPU."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device type {device_type!r}: cuda or cpu")
    if device_type == "cuda" and n_cards < 1:
        raise ValueError(NO_CARD)


def make_mesh(shape: Sequence[int], names: Sequence[str] = ("data", "model"),
              device_type: str = "cuda"):
    """A mesh of the joined world's ranks, row-major over ``shape`` (the
    product of ``shape`` is the world size), on the card unless the caller
    names ``"cpu"``."""
    _check_device_type(device_type, torch.cuda.device_count())
    return _init_device_mesh(device_type, shape, names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cpu"):
    """Single-device mesh for CPU smoke runs (examples/tests): joins a
    one-process world first when the process has none."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("data", "model"), device_type)


#: the override below, kept alive with the process
_GLOO_CUDA_LIB = None


def gloo_cuda_all_gather() -> None:
    """Route the functional all-gather of tensors on the card through
    ``dist.all_gather_into_tensor``.  On a gloo world the functional op
    (``_c10d_functional::all_gather_into_tensor``, which DTensor's
    Shard → Replicate redistributions call) crashes the process with a
    segmentation fault on CUDA tensors (torch 2.11), while the
    ``torch.distributed`` call, the same all-gather, works; the other
    functional collectives DTensor uses (all-reduce, reduce-scatter) work
    as they are.  The gather is synchronous, so the op's ``wait_tensor``
    finds nothing to wait for.  :func:`join` installs it on gloo worlds
    only: on an NCCL world the functional all-gather stays asynchronous,
    as torch ships it."""
    global _GLOO_CUDA_LIB
    if _GLOO_CUDA_LIB is not None:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    import warnings
    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # "overriding a kernel"
        lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _GLOO_CUDA_LIB = lib


#: the process group of a world whose every rank has a card of its own
NCCL = "cpu:gloo,cuda:nccl"


def world_layout(device_type: str, local_rank: int, local_world: int,
                 n_cards: int) -> Tuple[str, torch.device]:
    """→ (the world's backend, this rank's device): a card per local rank
    (``local_world`` at most ``n_cards``) joins over NCCL on
    ``cuda:<local_rank>``; ranks that share cards join over gloo on
    ``cuda:<local_rank mod n_cards>``; the CPU joins over gloo."""
    _check_device_type(device_type, n_cards)
    if device_type == "cpu":
        return "gloo", torch.device("cpu")
    if local_world <= n_cards:
        return NCCL, torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % n_cards)


def join(rank: int, world: int, init_method: str, *,
         device_type: str = "cuda", local_rank: int = 0,
         local_world: Optional[int] = None,
         timeout_s: float = JOIN_TIMEOUT_S) -> Tuple[torch.device, str]:
    """Bind the process to its device and join the process group, as
    :func:`world_layout` lays them out for ``local_world`` ranks on this
    machine (default: every rank of the world) → (device, backend).  On
    the card unless the caller names ``"cpu"``; with no card it raises."""
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    backend, device = world_layout(
        device_type, local_rank, world if local_world is None else local_world,
        n_cards)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
        # NCCL's communicator is made now, on this rank's card
        device_id=device if backend == NCCL else None)
    if device.type == "cuda" and backend == "gloo":
        gloo_cuda_all_gather()
    return device, backend


def join_from_env(device_type: str = "cuda",
                  timeout_s: float = JOIN_TIMEOUT_S
                  ) -> Tuple[int, int, torch.device, str]:
    """A ``torch.distributed.run`` worker joins its world, on the card
    unless the caller names ``"cpu"``: → (rank, world size, device,
    backend)."""
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    device, backend = join(
        rank, world, f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        device_type=device_type, local_rank=int(env.get("LOCAL_RANK", rank)),
        local_world=int(env.get("LOCAL_WORLD_SIZE", world)),
        timeout_s=timeout_s)
    return rank, world, device, backend


def leave() -> None:
    """Leave the process group (every rank, at the end of its work)."""
    if dist.is_initialized():
        dist.destroy_process_group()

"""The inputs a run hands to both sides: the initial weights and a pool of
training batches, made on the device from ``--seed`` in a few large calls.

Weights are drawn by leaf path and shape from one normal draw: a leaf
whose path ends in ``scale`` (a norm's gain) is 1 + 0.05·n, the embedding
0.02·n, every other leaf n / sqrt(fan in), its second-to-last dimension.
The same seed on the same device gives the same bits, so the reference
draws them again after the window instead of keeping a copy.

Batches: ``float`` leaves normal in the compute type, ``tokens`` uniform
over the vocabulary, ``labels`` the same rows one position on (each row
is drawn one longer than it runs).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

#: generator streams, so the weights and the batches of one seed differ
_WEIGHTS, _BATCHES = 0, 1


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (2 * int(seed) + stream) % (1 << 63))


def make_weights(shapes: Dict[str, tuple], seed: int, device,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{path: shape} → {path: tensor} in ``dtype`` on ``device``."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=_generator(seed, _WEIGHTS, device),
                       dtype=torch.float32, device=device)
    out, at = {}, 0
    for path, shape in shapes.items():
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if path.endswith("scale"):
            x = x.mul_(0.05).add_(1.0)
        elif path.split("/")[-1] == "embed":
            x = x.mul_(0.02)
        else:
            x = x.mul_(1.0 / math.sqrt(shape[-2]))
        out[path] = x.to(dtype, copy=True)       # a storage of its own
    del flat
    return out


def make_batches(shapes: Dict[str, tuple], vocab: int, n: int, seed: int,
                 device, float_dtype) -> List[Dict[str, torch.Tensor]]:
    """``n`` batches of ``shapes`` ({key: (shape, kind)}); every row of
    every batch is drawn anew."""
    gen = _generator(seed, _BATCHES, device)
    pool: Dict[str, torch.Tensor] = {}
    for key, (shape, kind) in shapes.items():
        if kind == "float":
            pool[key] = torch.randn((n,) + tuple(shape), generator=gen,
                                    device=device).to(float_dtype)
        elif kind == "tokens":
            b, s = shape
            rows = torch.randint(0, vocab, (n, b, s + 1), generator=gen,
                                 device=device, dtype=torch.int32)
            pool[key] = rows[..., :-1].contiguous()
            pool["labels"] = rows[..., 1:].contiguous()
        elif kind != "labels":
            raise ValueError(f"unknown batch leaf kind {kind!r}")
    return [{k: v[i] for k, v in pool.items()} for i in range(n)]

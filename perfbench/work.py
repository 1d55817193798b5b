"""The operations and bytes of the kernels the benchmark reads a roofline
share of, computed from their shapes, and the least time the card could
take for them (``perfbench/peaks.py``).

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again.  The bound is the larger of operations over
the peak rate and bytes over the memory bandwidth; which of the two sets
it is returned beside it.
"""
from __future__ import annotations

from typing import Tuple

from perfbench.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S


def bound_s(flops: float, nbytes: float,
            flops_per_s: float = BF16_FLOPS_PER_S) -> Tuple[float, str]:
    times = {"operations": flops / flops_per_s,
             "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by], by


def flash_work(b: int, s: int, sk: int, h: int, kv: int, dh: int,
               causal: bool, elem_bytes: int = 2) -> Tuple[float, float]:
    """Flash attention's forward, (FLOPs, bytes): two products of dh
    multiply-adds per (query, key) pair, 4·dh FLOPs; the pairs of the lower
    triangle with its diagonal where causal (S = Sk).  Bytes: q, k and v
    read, the output written (q's size)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * sk)
    flops = 4.0 * dh * pairs
    nbytes = elem_bytes * (2 * b * s * h * dh + 2 * b * sk * kv * dh)
    return flops, nbytes


def flash_bound_s(shape) -> float:
    """The least time of one launch at ``shape`` (B, S, Sk, H, KV, dh,
    causal), bf16."""
    return bound_s(*flash_work(*shape))[0]


def blockhash_bytes(nbytes: int, block_bytes: int = 65_536) -> int:
    """Bytes the block hash must move for a leaf of ``nbytes``: the leaf
    read once and its table of 8-byte digests written once."""
    return nbytes + 8 * max(1, -(-nbytes // block_bytes))

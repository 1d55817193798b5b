"""Per-block checkpoint hashing: the Hopper kernel and its plain version.

Replaces ``repro/kernels/blockhash.py`` (``_hash_kernel`` via
``blockhash2_pallas``).  The differential checkpoint needs a 64-bit digest
per ``block_bytes`` block of every protected leaf; computing it on the card
means only the tiny digest table and the dirty blocks ever cross PCIe.

:func:`blockhash2` launches ``csrc/blockhash2.cu`` (CUDA C++ for sm_90a)
on a CUDA tensor's raw bytes; :func:`blockhash2_ref` (``kernels/ref.py``)
is the plain PyTorch version the CPU path and the checks use.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import blockhash2_ref  # noqa: F401  (plain version)

LAUNCHES = build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_uint,
             ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]


def n_blocks_of(nbytes: int, block_bytes: int) -> int:
    """Hash blocks of a leaf of ``nbytes`` bytes (an empty leaf has one)."""
    return max(1, -(-nbytes // block_bytes))


def blockhash2(x: torch.Tensor, block_bytes: int) -> torch.Tensor:
    """CUDA tensor → ``(n_blocks, 2)`` int32 digests (u32 bits) of its
    C-order bytes, bytes past the end as zero.  Launches the kernel on the
    current stream or raises."""
    if not x.is_cuda:
        raise ValueError(f"blockhash2 takes a CUDA tensor, got {x.device}")
    if block_bytes <= 0 or block_bytes % 4:
        raise ValueError(f"block_bytes must be a positive multiple of 4, "
                         f"got {block_bytes}")
    x = x.detach().contiguous()
    nbytes = x.numel() * x.element_size()
    n_blocks = n_blocks_of(nbytes, block_bytes)
    out = torch.empty((n_blocks, 2), dtype=torch.int32, device=x.device)
    fn = build.function("blockhash2", "blockhash2_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), nbytes, block_bytes, n_blocks, out.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "blockhash2")
    LAUNCHES.add()
    return out

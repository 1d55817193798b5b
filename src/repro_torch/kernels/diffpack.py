"""Dirty-block compaction and its inverse: the Hopper kernels and their
plain versions.

Replaces ``repro/kernels/diffpack.py``: ``_copy_kernel`` via
``diffpack_pallas`` (store side) and ``_scatter_kernel`` via
``diffunpack_pallas`` (restore side).  After the dirty map is known, the
dirty blocks are packed into one dense buffer so a single copy ships them
to the host instead of ``n_dirty`` strided reads; a restart replaying a
DIFF chain onto a leaf that lives on the card copies each delta's packed
blocks to the card and scatters them into the leaf in place.

:func:`diffpack` launches ``csrc/diffpack.cu`` and :func:`diffunpack`
``csrc/diffunpack.cu`` (CUDA C++ for sm_90a) on a CUDA tensor's raw bytes;
:func:`diffpack_ref` and :func:`diffunpack_ref` (``kernels/ref.py``) are
the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.blockhash import n_blocks_of
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    diffpack_ref,
    diffunpack_ref,
)

LAUNCHES = build.LaunchCounter()
UNPACK_LAUNCHES = build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_uint,
             ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_ulonglong,
             ctypes.c_void_p, ctypes.c_void_p]


def diffpack(x: torch.Tensor, dirty_idx: torch.Tensor, block_bytes: int
             ) -> torch.Tensor:
    """CUDA tensor + int32 dirty block indices on the same card →
    ``(n_dirty, block_bytes/4)`` int32 (u32 bits), row k = block
    ``dirty_idx[k]`` of ``x``'s C-order bytes, zero past the end.  The
    indices must lie in ``[0, n_blocks)`` (``ops.pack_dirty`` checks them
    on the host before the copy; the kernel writes a zero row for one
    outside rather than read past the leaf).  Launches the kernel on the
    current stream or raises."""
    if not x.is_cuda:
        raise ValueError(f"diffpack takes a CUDA tensor, got {x.device}")
    if block_bytes <= 0 or block_bytes % 4:
        raise ValueError(f"block_bytes must be a positive multiple of 4, "
                         f"got {block_bytes}")
    if (dirty_idx.device != x.device or dirty_idx.dtype != torch.int32
            or dirty_idx.dim() != 1):
        raise ValueError(f"dirty_idx must be a 1-d int32 tensor on "
                         f"{x.device}, got {dirty_idx.dtype} "
                         f"{tuple(dirty_idx.shape)} on {dirty_idx.device}")
    x = x.detach().contiguous()
    idx = dirty_idx.contiguous()
    nbytes = x.numel() * x.element_size()
    n_blocks = n_blocks_of(nbytes, block_bytes)
    out = torch.empty((idx.numel(), block_bytes // 4), dtype=torch.int32,
                      device=x.device)
    if idx.numel() == 0:
        return out
    fn = build.function("diffpack", "diffpack_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), nbytes, block_bytes, n_blocks, idx.data_ptr(),
                 idx.numel(), out.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "diffpack")
    LAUNCHES.add()
    return out


#: one entry of diffpack_many's table (``Row`` in ``csrc/diffpack.cu``)
ROW_DTYPE = np.dtype([("data", "<u8"), ("nbytes", "<u8"), ("block", "<u4"),
                      ("pad", "<u4")])

_MANY_ARGTYPES = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_uint,
                  ctypes.c_void_p, ctypes.c_void_p]


def diffpack_many(leaves: Sequence[torch.Tensor],
                  dirty_idx: Sequence[np.ndarray], block_bytes: int
                  ) -> torch.Tensor:
    """CUDA tensors on one card, each with its host dirty block indices →
    ``(n_rows, block_bytes/4)`` int32 (u32 bits) on that card: the rows of
    :func:`diffpack` of each leaf, leaf after leaf, from one launch.  The
    indices must lie in ``[0, n_blocks)`` of their leaf (``ops.
    pack_dirty_many`` checks them); the table of (leaf pointer, leaf bytes,
    block) entries is built on the host and crosses in one copy, queued on
    the current stream.  Launches
    the kernel on the current stream or raises."""
    if len(leaves) != len(dirty_idx) or not leaves:
        raise ValueError(f"diffpack_many takes one index array per leaf, "
                         f"and at least one leaf: got {len(leaves)} leaves, "
                         f"{len(dirty_idx)} index arrays")
    device = leaves[0].device
    if device.type != "cuda" or any(x.device != device for x in leaves):
        raise ValueError(f"diffpack_many takes CUDA tensors on one card, got "
                         f"{sorted({str(x.device) for x in leaves})}")
    if block_bytes <= 0 or block_bytes % 4:
        raise ValueError(f"block_bytes must be a positive multiple of 4, "
                         f"got {block_bytes}")
    datas = [x.detach().contiguous() for x in leaves]
    counts = [int(np.asarray(i).size) for i in dirty_idx]
    table = np.zeros(sum(counts), ROW_DTYPE)
    row = 0
    for x, idx, n in zip(datas, dirty_idx, counts):
        table["data"][row:row + n] = x.data_ptr()
        table["nbytes"][row:row + n] = x.numel() * x.element_size()
        table["block"][row:row + n] = np.asarray(idx).reshape(-1)
        row += n
    out = torch.empty((row, block_bytes // 4), dtype=torch.int32,
                      device=device)
    if row == 0:
        return out
    # from pinned memory, so the copy queues on the stream like the launch
    # (the host allocator keeps the buffer until the copy has run)
    table_t = torch.from_numpy(table.view(np.uint8)).pin_memory().to(
        device, non_blocking=True)
    fn = build.function("diffpack", "diffpack_many_launch", _MANY_ARGTYPES)
    with torch.cuda.device(device):
        err = fn(table_t.data_ptr(), row, block_bytes, out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "diffpack_many")
    LAUNCHES.add()
    return out


def check_unpack_args(x: torch.Tensor, packed: torch.Tensor,
                      dirty_idx: torch.Tensor, block_bytes: int) -> None:
    """The arguments of an in-place scatter into ``x``, on either device: a
    contiguous target (a contiguous copy would take the writes and lose
    them), 1-d int32 indices and ``(n_dirty, block_bytes/4)`` int32 rows,
    both on ``x``'s device."""
    if not x.is_contiguous():
        raise ValueError("diffunpack writes in place: the target tensor "
                         "must be contiguous")
    if block_bytes <= 0 or block_bytes % 4:
        raise ValueError(f"block_bytes must be a positive multiple of 4, "
                         f"got {block_bytes}")
    if (dirty_idx.device != x.device or dirty_idx.dtype != torch.int32
            or dirty_idx.dim() != 1):
        raise ValueError(f"dirty_idx must be a 1-d int32 tensor on "
                         f"{x.device}, got {dirty_idx.dtype} "
                         f"{tuple(dirty_idx.shape)} on {dirty_idx.device}")
    n_dirty = dirty_idx.numel()
    if (packed.device != x.device or packed.dtype != torch.int32
            or tuple(packed.shape) != (n_dirty, block_bytes // 4)):
        raise ValueError(f"packed rows must be a ({n_dirty}, "
                         f"{block_bytes // 4}) int32 tensor on {x.device}, "
                         f"got {packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device}")


def diffunpack(x: torch.Tensor, packed: torch.Tensor,
               dirty_idx: torch.Tensor, block_bytes: int) -> torch.Tensor:
    """Write packed row k into block ``dirty_idx[k]`` of a contiguous CUDA
    tensor's C-order bytes, in place, and return ``x``.  Only bytes below
    the leaf's end are written (the reference's zero padding past it is
    dropped on restore anyway).  The arguments are as
    :func:`check_unpack_args` says; the indices must lie in ``[0,
    n_blocks)`` and increase strictly (``ops.unpack_dirty`` checks both on
    the host before the copy).  Launches the kernel on the current stream
    or raises."""
    if not x.is_cuda:
        raise ValueError(f"diffunpack takes a CUDA tensor, got {x.device}")
    check_unpack_args(x, packed, dirty_idx, block_bytes)
    n_dirty = dirty_idx.numel()
    if n_dirty == 0:
        return x
    data = x.detach()
    idx = dirty_idx.contiguous()
    rows = packed.contiguous()
    nbytes = data.numel() * data.element_size()
    fn = build.function("diffunpack", "diffunpack_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(data.data_ptr(), nbytes, block_bytes,
                 n_blocks_of(nbytes, block_bytes), idx.data_ptr(), n_dirty,
                 rows.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "diffunpack")
    UNPACK_LAUNCHES.add()
    return x

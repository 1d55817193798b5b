"""Dirty-block compaction and its inverse over many leaves: the Hopper
kernels and their plain versions.

Replaces ``repro/kernels/diffpack.py``: ``_copy_kernel`` via
``diffpack_pallas`` (store side) and ``_scatter_kernel`` via
``diffunpack_pallas`` (restore side).  After the dirty map is known, the
dirty blocks of every leaf of a DIFF store are packed into one dense
buffer so a single copy ships them to the host; a restart replaying a DIFF
link onto leaves that live on the card copies the link's packed rows to
the card once and scatters them into every leaf in place.

Both directions run from one table with a (leaf pointer, leaf bytes,
block) entry per packed row (:data:`ROW_DTYPE`, ``Row`` in
``csrc/diffrow.cuh``), built on the host and copied to the card in one
H2D: :func:`diffpack_many` launches ``csrc/diffpack.cu`` and
:func:`diffunpack_many` ``csrc/diffunpack.cu`` (CUDA C++ for sm_90a), once
per call, however many leaves; a single leaf is a table of its rows.
:func:`diffpack_ref` and :func:`diffunpack_ref` (``kernels/ref.py``) are
the plain PyTorch versions, one leaf at a time.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    diffpack_ref,
    diffunpack_ref,
)

LAUNCHES = build.LaunchCounter()
UNPACK_LAUNCHES = build.LaunchCounter()

#: one entry of the pack's and the unpack's table (``Row`` in
#: ``csrc/diffrow.cuh``)
ROW_DTYPE = np.dtype([("data", "<u8"), ("nbytes", "<u8"), ("block", "<u4"),
                      ("pad", "<u4")])

_MANY_ARGTYPES = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_uint,
                  ctypes.c_void_p, ctypes.c_void_p]


def check_block_bytes(block_bytes: int) -> None:
    if block_bytes <= 0 or block_bytes % 4:
        raise ValueError(f"block_bytes must be a positive multiple of 4, "
                         f"got {block_bytes}")


def _one_card(what: str, leaves: Sequence[torch.Tensor],
              dirty_idx: Sequence[np.ndarray]) -> torch.device:
    if len(leaves) != len(dirty_idx) or not leaves:
        raise ValueError(f"{what} takes one index array per leaf, and at "
                         f"least one leaf: got {len(leaves)} leaves, "
                         f"{len(dirty_idx)} index arrays")
    device = leaves[0].device
    if device.type != "cuda" or any(x.device != device for x in leaves):
        raise ValueError(f"{what} takes CUDA tensors on one card, got "
                         f"{sorted({str(x.device) for x in leaves})}")
    return device


def _table_on(device: torch.device, leaves: Sequence[torch.Tensor],
              dirty_idx: Sequence[np.ndarray]) -> torch.Tensor:
    """The table of ``leaves`` (contiguous) and their block indices, one
    entry per row, leaf after leaf, on ``device``: built in numpy and
    copied from pinned memory, so the copy queues on the current stream
    like the launch (the host allocator keeps the buffer until it has
    run)."""
    counts = [int(np.asarray(i).size) for i in dirty_idx]
    table = np.zeros(sum(counts), ROW_DTYPE)
    row = 0
    for x, idx, n in zip(leaves, dirty_idx, counts):
        table["data"][row:row + n] = x.data_ptr()
        table["nbytes"][row:row + n] = x.numel() * x.element_size()
        table["block"][row:row + n] = np.asarray(idx).reshape(-1)
        row += n
    return torch.from_numpy(table.view(np.uint8)).pin_memory().to(
        device, non_blocking=True)


def diffpack_many(leaves: Sequence[torch.Tensor],
                  dirty_idx: Sequence[np.ndarray], block_bytes: int
                  ) -> torch.Tensor:
    """CUDA tensors on one card, each with its host dirty block indices →
    ``(n_rows, block_bytes/4)`` int32 (u32 bits) on that card: row k is
    block ``dirty_idx[i][j]`` of leaf i's C-order bytes, leaf after leaf,
    zero past the leaf's end, from one launch.  The indices must lie in
    ``[0, n_blocks)`` of their leaf (``ops.pack_dirty_many`` checks them).
    Launches the kernel on the current stream or raises."""
    device = _one_card("diffpack_many", leaves, dirty_idx)
    check_block_bytes(block_bytes)
    datas = [x.detach().contiguous() for x in leaves]
    n_rows = sum(int(np.asarray(i).size) for i in dirty_idx)
    out = torch.empty((n_rows, block_bytes // 4), dtype=torch.int32,
                      device=device)
    if n_rows == 0:
        return out
    table = _table_on(device, datas, dirty_idx)
    fn = build.function("diffpack", "diffpack_many_launch", _MANY_ARGTYPES)
    with torch.cuda.device(device):
        err = fn(table.data_ptr(), n_rows, block_bytes, out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "diffpack_many")
    LAUNCHES.add()
    return out


def diffunpack_many(leaves: Sequence[torch.Tensor],
                    dirty_idx: Sequence[np.ndarray], rows: torch.Tensor,
                    block_bytes: int) -> None:
    """Write packed row k into its block of its leaf, in place, for every
    row of ``rows`` (``(n_rows, block_bytes/4)`` int32 u32 bits, the rows
    of leaf 0's indices, then leaf 1's, ...), from one launch.  The leaves
    are contiguous CUDA tensors on one card; only bytes below each leaf's
    end are written (the reference's zero padding past it is dropped on
    restore anyway).  The indices must lie in ``[0, n_blocks)`` of their
    leaf and increase strictly (``ops.unpack_dirty_many`` checks both).
    ``rows`` on that card is read in place; rows in host memory cross in
    one copy from pinned memory, queued on the current stream like the
    table's.  Launches the kernel on the current stream or raises."""
    device = _one_card("diffunpack_many", leaves, dirty_idx)
    check_block_bytes(block_bytes)
    if not all(x.is_contiguous() for x in leaves):
        raise ValueError("diffunpack writes in place: the target tensor "
                         "must be contiguous")
    n_rows = sum(int(np.asarray(i).size) for i in dirty_idx)
    if (rows.dtype != torch.int32 or rows.device.type not in ("cpu", "cuda")
            or (rows.is_cuda and rows.device != device)
            or tuple(rows.shape) != (n_rows, block_bytes // 4)):
        raise ValueError(f"packed rows must be a ({n_rows}, "
                         f"{block_bytes // 4}) int32 tensor on {device} or "
                         f"the host, got {rows.dtype} {tuple(rows.shape)} "
                         f"on {rows.device}")
    if n_rows == 0:
        return
    if rows.device != device:
        rows = (rows if rows.is_pinned() else rows.pin_memory()).to(
            device, non_blocking=True)
    rows = rows.contiguous()
    table = _table_on(device, leaves, dirty_idx)
    fn = build.function("diffunpack", "diffunpack_many_launch",
                        _MANY_ARGTYPES)
    with torch.cuda.device(device):
        err = fn(table.data_ptr(), n_rows, block_bytes, rows.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "diffunpack_many")
    UNPACK_LAUNCHES.add()

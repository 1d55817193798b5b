"""Dirty-block compaction: the Hopper kernel and its plain version.

Replaces ``repro/kernels/diffpack.py`` (``_copy_kernel`` via
``diffpack_pallas``).  After the dirty map is known, the dirty blocks are
packed into one dense buffer so a single copy ships them to the host
instead of ``n_dirty`` strided reads.

:func:`diffpack` launches ``csrc/diffpack.cu`` (CUDA C++ for sm_90a) on a
CUDA tensor's raw bytes; :func:`diffpack_ref` (``kernels/ref.py``) is the
plain PyTorch version.  The restore-side scatter (``diffunpack``) is not
on this path: restores replay deltas with numpy on the host, as the JAX
package does; its plain version ``diffunpack_ref`` lives in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.blockhash import n_blocks_of
from repro_torch.kernels.ref import diffpack_ref  # noqa: F401  (plain version)

LAUNCHES = build.LaunchCounter()

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

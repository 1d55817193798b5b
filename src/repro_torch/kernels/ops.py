"""Public entry points for the kernels, dispatched by device.

A CUDA tensor launches the hand-written Hopper kernel (and raises if it
cannot be built or launched); a CPU tensor takes the plain PyTorch version
in ``ref.py``.  Nothing falls back from one to the other.

Attention is differentiable: :func:`flash_attention_gqa` is a
``torch.autograd.Function`` whose forward is the kernel (or, on the CPU,
the plain version) and saves the rows' log-sum-exp.  Its
backward depends only on what the inputs show: bf16 on the card launches
the backward kernel (``flashattn_bwd``); f32 on the card and everything on
the CPU take the exact gradient in plain PyTorch
(``ref.flash_attention_vjp_ref`` on K and V repeated to the query heads,
dk and dv summed over each group).  :func:`flash_attention` and
:func:`flash_attention_bshd` check the reference's shape contract and go
through it.  The JAX package has no backward kernel: its Pallas kernel is
forward only.

Digest tables and packed blocks are ``torch.int32`` tensors carrying u32
bits; :func:`u32_numpy` turns them into the ``np.uint32`` arrays the JAX
package produces.  The dirty map and the digest fingerprint are computed
on the host from those small tables, as in the JAX package.
"""
from __future__ import annotations

import hashlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import blockhash as bh
from repro_torch.kernels import diffpack as dp
from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import ref

DEFAULT_BLOCK_BYTES = 65_536      # 64 KiB — FTI dCP-scale block granularity


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no checkpoint kernel for device {x.device}")


def as_u32_blocks(x: torch.Tensor, block_bytes: int = DEFAULT_BLOCK_BYTES
                  ) -> Tuple[torch.Tensor, int]:
    """A copy of ``x``'s C-order bytes as ``(n_blocks, block_bytes/4)`` u32
    words (int32 bits), zero-padded → ``(blocks, n_blocks)``.

    The same words as the JAX package's ``as_u32_blocks`` for 1-, 2-, 4-
    and 8-byte dtypes: u16 pairs and u8 quads pack little-endian, an 8-byte
    element splits into its low then high word, and a ragged tail is
    zero-padded.  This is the input of the plain versions; the kernels read
    the leaf's bytes in place instead."""
    dp.check_block_bytes(block_bytes)
    flat = x.detach().contiguous().reshape(-1)
    # an empty tensor may carry a stride of 0 (one made from an empty numpy
    # array), which a dtype view refuses; it has no bytes to view anyway
    raw = flat.view(torch.uint8) if flat.numel() else torch.zeros(
        0, dtype=torch.uint8, device=x.device)
    n_blocks = bh.n_blocks_of(raw.numel(), block_bytes)
    padded = torch.zeros(n_blocks * block_bytes, dtype=torch.uint8,
                         device=x.device)
    padded[: raw.numel()] = raw
    return padded.view(torch.int32).reshape(n_blocks, block_bytes // 4), \
        n_blocks


def blockhash(x: torch.Tensor, block_bytes: int = DEFAULT_BLOCK_BYTES
              ) -> torch.Tensor:
    """Tensor → ``(n_blocks, 2)`` int32 digests (64 bits per block), on
    ``x``'s device."""
    _check_device(x)
    if x.is_cuda:
        return bh.blockhash2(x, block_bytes)
    blocks, _ = as_u32_blocks(x, block_bytes)
    return ref.blockhash2_ref(blocks)


def _check_leaves(what: str, leaves: Sequence[torch.Tensor],
                  *per_leaf: Sequence) -> None:
    """At least one leaf, one entry of each of ``per_leaf`` per leaf, and
    every leaf on one device with a checkpoint kernel."""
    counts = [len(p) for p in per_leaf]
    if not leaves or any(n != len(leaves) for n in counts):
        raise ValueError(f"{what} takes one index array per leaf, and at "
                         f"least one leaf: got {len(leaves)} leaves, "
                         f"{' and '.join(map(str, counts))} per-leaf arrays")
    for x in leaves:
        _check_device(x)
        if x.device != leaves[0].device:
            raise ValueError(f"{what} takes leaves on one device, got "
                             f"{x.device} and {leaves[0].device}")


def _n_blocks(x: torch.Tensor, block_bytes: int) -> int:
    return bh.n_blocks_of(x.numel() * x.element_size(), block_bytes)


def pack_dirty_many(leaves: Sequence[torch.Tensor],
                    dirty_list: Sequence[np.ndarray],
                    block_bytes: int = DEFAULT_BLOCK_BYTES) -> torch.Tensor:
    """Gather the blocks ``dirty_list[i]`` (host indices) of every leaf i
    on one device → ``(sum n_dirty, block_bytes/4)`` int32 (u32 bits) on
    that device, leaf after leaf.  The indices are checked against each
    leaf's block count here, on the host, as in the JAX package; on the
    card one launch packs every leaf (``diffpack_many``), on the CPU the
    plain version runs leaf by leaf."""
    _check_leaves("pack_dirty_many", leaves, dirty_list)
    dp.check_block_bytes(block_bytes)
    idxs = []
    for x, i in zip(leaves, dirty_list):
        idx = np.ascontiguousarray(i, dtype=np.int32).reshape(-1)
        n_blocks = _n_blocks(x, block_bytes)
        if idx.size and (idx.min() < 0 or idx.max() >= n_blocks):
            raise IndexError(f"dirty block index outside [0, {n_blocks})")
        idxs.append(idx)
    if leaves[0].is_cuda:
        return dp.diffpack_many(leaves, idxs, block_bytes)
    return torch.cat([ref.diffpack_ref(as_u32_blocks(x, block_bytes)[0],
                                       torch.from_numpy(i))
                      for x, i in zip(leaves, idxs)])


def check_dirty_indices(dirty_idx: np.ndarray, n_blocks: int) -> np.ndarray:
    """Host check of the block indices a scatter writes: integers, each in
    ``[0, n_blocks)``, strictly increasing (a repeated index would race on
    the card).  → the indices as a flat int32 array."""
    idx = np.ascontiguousarray(dirty_idx).reshape(-1)
    if idx.size and not np.issubdtype(idx.dtype, np.integer):
        raise TypeError(f"dirty block indices must be integers, got "
                        f"{idx.dtype}")
    if idx.size and (idx.min() < 0 or idx.max() >= n_blocks):
        raise IndexError(f"dirty block index outside [0, {n_blocks})")
    if idx.size > 1 and not bool(np.all(np.diff(idx) > 0)):
        raise ValueError("dirty block indices must increase strictly")
    return idx.astype(np.int32)


def _words(packed: Any) -> Any:
    """Packed rows as u32 words in int32: a tensor's int32 view, or a host
    array's (``np.uint32``) int32 view, neither copied."""
    if isinstance(packed, torch.Tensor):
        return packed.detach().view(torch.int32)
    return np.ascontiguousarray(packed).view(np.int32)


def _gather_rows(words: Sequence[Any], device: torch.device,
                 row_words: int) -> torch.Tensor:
    """Every leaf's rows in one tensor: on ``device`` when they all lie
    there, else in one pinned host buffer (one copy of each host array),
    for one copy to the card."""
    if all(isinstance(w, torch.Tensor) and w.device == device
           for w in words):
        return words[0] if len(words) == 1 else torch.cat(words)
    out = torch.empty((sum(w.shape[0] for w in words), row_words),
                      dtype=torch.int32, pin_memory=True)
    host = out.numpy()
    row = 0
    for w in words:
        if isinstance(w, torch.Tensor):
            out[row:row + w.shape[0]].copy_(w)
        else:
            host[row:row + w.shape[0]] = w
        row += w.shape[0]
    return out


def unpack_dirty_many(leaves: Sequence[torch.Tensor],
                      dirty_list: Sequence[np.ndarray],
                      packed_list: Sequence[Any],
                      block_bytes: int = DEFAULT_BLOCK_BYTES
                      ) -> List[torch.Tensor]:
    """Scatter packed blocks into every leaf on one device, in place — the
    inverse of :func:`pack_dirty_many` — and return the leaves: block
    ``dirty_list[i][k]`` of leaf i's C-order bytes becomes row k of
    ``packed_list[i]`` (``(n_dirty, block_bytes/4)`` u32 words, host
    ``np.uint32`` or int32 bits), bytes past the leaf's end dropped.  All
    is checked on the host before anything moves to the device: each leaf
    contiguous (the writes land in its own storage), its indices in range
    and strictly increasing (:func:`check_dirty_indices`), its rows of the
    indices' count.  On the card one launch scatters every leaf
    (``diffunpack_many``: the rows and the table cross in one copy each);
    on the CPU the plain version runs leaf by leaf."""
    _check_leaves("unpack_dirty_many", leaves, dirty_list, packed_list)
    dp.check_block_bytes(block_bytes)
    idxs, rows = [], []
    for x, i, p in zip(leaves, dirty_list, packed_list):
        if not x.is_contiguous():
            raise ValueError("diffunpack writes in place: the target tensor "
                             "must be contiguous")
        idx = check_dirty_indices(i, _n_blocks(x, block_bytes))
        w = _words(p)
        if tuple(w.shape) != (idx.size, block_bytes // 4):
            raise ValueError(f"packed rows {tuple(w.shape)} != "
                             f"({idx.size}, {block_bytes // 4})")
        idxs.append(idx)
        rows.append(w)
    if leaves[0].is_cuda:
        dp.diffunpack_many(leaves, idxs, _gather_rows(
            rows, leaves[0].device, block_bytes // 4), block_bytes)
        return list(leaves)
    for x, idx, w in zip(leaves, idxs, rows):
        if x.numel() and idx.size:
            if not isinstance(w, torch.Tensor):
                # rows read straight from a container are read-only
                w = torch.from_numpy(w if w.flags.writeable else w.copy())
            blocks, _ = as_u32_blocks(x, block_bytes)
            out = ref.diffunpack_ref(blocks, w.cpu(), torch.from_numpy(idx))
            raw = x.detach().reshape(-1).view(torch.uint8)
            raw.copy_(out.reshape(-1).view(torch.uint8)[: raw.numel()])
    return list(leaves)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32-carried u32 words → host ``np.uint32`` array (a completed
    copy)."""
    return t.detach().to("cpu", copy=True).numpy().view(np.uint32)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, bq: int, bk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward as an operator of its own → (out, lse (B, H, S)
    f32): the Hopper kernel on a CUDA tensor, the plain version on the CPU,
    and a shape-only fake implementation under a fake-tensor trace (the
    dry-run), so a trace never runs the plain version in the kernel's
    place."""
    if q.is_cuda:
        return fa.flash_attention_gqa_fwd(q, k, v, causal=causal, bq=bq,
                                          bk=bk)
    _check_device(q)
    fa.check_shapes_gqa(q, k, v, bq, bk)
    return ref.flash_attention_gqa_lse_ref(q, k, v, causal=causal)


@_flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, bq, bk):
    fa.check_shapes_gqa(q, k, v, bq, bk)
    b, s, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, s), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lse: torch.Tensor, dout: torch.Tensor, causal: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 flash backward on the card as an operator of its own →
    (dq, dk, dv), with a shape-only fake implementation for a trace."""
    return fa.flash_attention_gqa_bwd(q, k, v, lse, dout, causal=causal)


@_flash_attention_bwd.register_fake
def _flash_attention_bwd_fake(q, k, v, lse, dout, causal):
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                 for x in (q, k, v))


class _FlashAttentionGQA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, bq, bk):
        out, lse = _flash_attention_fwd(q, k, v, causal, bq, bk)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        if q.is_cuda and q.dtype == torch.bfloat16:
            dq, dk, dv = _flash_attention_bwd(q, k, v, lse, dout, ctx.causal)
            return dq, dk, dv, None, None, None
        b, s, h, dh = q.shape
        sk, kv = k.shape[1], k.shape[2]
        rep = h // kv
        dq, dk, dv = ref.flash_attention_vjp_ref(
            ref.to_bh(q), ref.to_bh(ref.repeat_kv(k, rep)),
            ref.to_bh(ref.repeat_kv(v, rep)), ref.to_bh(dout),
            causal=ctx.causal)
        dk = ref.from_bh(dk, b).reshape(b, sk, kv, rep, dh).sum(dim=3)
        dv = ref.from_bh(dv, b).reshape(b, sk, kv, rep, dh).sum(dim=3)
        return ref.from_bh(dq, b), dk, dv, None, None, None


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, bq: int = fa.DEFAULT_BQ,
                        bk: int = fa.DEFAULT_BK) -> torch.Tensor:
    """(B, S, H, dh) q, (B, Sk, KV, dh) k and v → (B, S, H, dh) in q's
    dtype, with a gradient; query head h reads KV head h // (H/KV).  On the
    card the kernel reads k and v in place; the plain version repeats
    them.  It takes local tensors only: a ``DTensor`` goes through
    ``local_map`` first (``models/attention.py``)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention_gqa takes local tensors; run it "
                        "on each rank's shard (local_map)")
    return _FlashAttentionGQA.apply(q, k, v, causal, bq, bk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = fa.DEFAULT_BQ,
                    bk: int = fa.DEFAULT_BK) -> torch.Tensor:
    """(BH, S, dh), (BH, Sk, dh) ×2 → (BH, S, dh) in q's dtype, with a
    gradient: :func:`flash_attention_gqa` with each batch·head a batch of
    one head.  The reference's shape contract holds on both devices."""
    fa.check_shapes(q, k, v, bq, bk)
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, bq=bq, bk=bk)[:, :, 0]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, bq: int = fa.DEFAULT_BQ,
                         bk: int = fa.DEFAULT_BK) -> torch.Tensor:
    """(B, S, H, dh) layout of :func:`flash_attention` (KV already repeated
    to H heads, the reference's contract): :func:`flash_attention_gqa`
    with KV = H."""
    fa.check_shapes_bshd(q, k, v, bq, bk)
    return flash_attention_gqa(q, k, v, causal=causal, bq=bq, bk=bk)


def launch_counts() -> dict:
    """Kernel launches so far in this process, by kernel."""
    return {"blockhash2": bh.LAUNCHES.n, "diffpack": dp.LAUNCHES.n,
            "diffunpack": dp.UNPACK_LAUNCHES.n, "flashattn": fa.LAUNCHES.n,
            "flashattn_bwd": fa.BWD_LAUNCHES.n}


def reset_launch_counts() -> None:
    bh.LAUNCHES.reset()
    dp.LAUNCHES.reset()
    dp.UNPACK_LAUNCHES.reset()
    fa.LAUNCHES.reset()
    fa.BWD_LAUNCHES.reset()


def dirty_indices(h_new: np.ndarray, h_old: Optional[np.ndarray]
                  ) -> np.ndarray:
    """Host-side dirty map: blocks whose 64-bit digest changed."""
    if h_old is None:
        return np.arange(h_new.shape[0], dtype=np.int32)
    neq = np.any(np.asarray(h_new) != np.asarray(h_old), axis=1)
    return np.nonzero(neq)[0].astype(np.int32)


def digest_fingerprint(digests) -> str:
    """Collapse a per-block digest table into one short hex key (blake2b
    over the raw digest bytes: 16 B per 64 KiB block, microseconds)."""
    raw = np.ascontiguousarray(np.asarray(digests)).tobytes()
    return hashlib.blake2b(raw, digest_size=16).hexdigest()

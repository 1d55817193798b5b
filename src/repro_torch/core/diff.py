"""Differential checkpointing engine (paper §4.2.3, FTI dCP semantics).

Per protected leaf, a 64-bit digest per ``block_bytes`` block is kept from
the previous checkpoint.  On a CHK_DIFF store the new digests are computed
on the leaf's device (the blockhash kernel on the card; its plain PyTorch
version on the CPU), the dirty map is diffed on the host (tiny), dirty
blocks are compacted on the device by the diffpack kernel — one launch and
one copy to the host for all dirty leaves of a store, by groups of at most
:data:`MAX_PACK_BYTES` — and only those cross to the host.

No clean-leaf skip.  The JAX package skips hashing a leaf that is the same
object as at the previous store, which is sound only because jax arrays
are immutable.  Torch tensors are updated in place (``add_``, optimizer
steps), and ``Tensor._version`` misses writes made through ``.data`` or
through another tensor sharing the storage — so here every DIFF and FULL
leaf is hashed, every time, and ``DiffStats.skipped_leaves`` stays 0.  On
an H100 that costs one pass over the state at HBM speed (the bound is
about 1.3 ms for 4.4 GB).

All digest-state mutation happens in the pipeline's Plan stage, on the
calling thread in submission order (a failed tail only invalidates) —
which is what lets DIFF stores run on a CP-dedicated thread without
racing the digest chain.

Break-even guard: the paper measures differential checkpointing to pay off
below a ~95 % dirty ratio (Fig. 7).  When the observed ratio exceeds
``promote_threshold`` the engine *promotes* the store to a FULL checkpoint.

Restore: FULL base + ordered DIFF deltas are replayed into flat uint32
buffers on the host with numpy, then bit-cast back to the leaf dtype/shape
(as in the JAX package).  The leaves whose restart template is a tensor
are instead replayed on the template's device (:class:`ChainReplay`):
each decoded base is placed there once, then each DIFF link's dirty
blocks are scattered into every leaf it touches in place, with one
``ops.unpack_dirty_many`` per device and group of at most
:data:`MAX_PACK_BYTES` of rows (the diffunpack kernel on the card, its
plain version on the CPU) — the same bytes, without copying the whole
leaf to the device once per delta.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import numpy_to_tensor, str_to_torch_dtype
from repro_torch.core.formats import str_to_dtype as str_dtype
from repro_torch.core.protect import leaf_dtype_str
from repro_torch.kernels import ops
from repro_torch.kernels.blockhash import n_blocks_of


@dataclass
class LeafDelta:
    path: str
    dtype: str
    shape: List[int]
    n_blocks: int
    dirty_idx: np.ndarray        # (n_dirty,) int32
    payload: np.ndarray          # (n_dirty, block_elems) uint32
    digests: np.ndarray          # (n_blocks, 2) uint32 — post-store state


@dataclass
class DiffStats:
    total_blocks: int = 0
    dirty_blocks: int = 0
    bytes_written: int = 0
    skipped_leaves: int = 0      # always 0 here: every leaf is hashed
    promoted_full: bool = False

    @property
    def dirty_ratio(self) -> float:
        return self.dirty_blocks / max(1, self.total_blocks)


def as_tensor(leaf: Any) -> torch.Tensor:
    """A protected leaf as a tensor (numpy and scalar leaves → CPU)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return numpy_to_tensor(np.asarray(leaf))


#: the most packed rows one group of a DIFF store or of a replayed DIFF
#: link holds on its device
MAX_PACK_BYTES = 256 << 20


def row_groups(items: Sequence[Tuple[Any, int]], cap: int
               ) -> List[List[Tuple[int, int, int]]]:
    """The rows of ``items`` ((device, row count) per leaf, in order) cut
    into groups on one device of at most ``cap`` rows each, device after
    device in order of first appearance, leaves in order within each (a
    leaf's rows may straddle two groups) → per group, (item index, first
    row, end row) per piece.  A leaf with no row is in no group."""
    groups: List[List[Tuple[int, int, int]]] = []
    for device in dict.fromkeys(d for d, _ in items):
        rows = cap
        for i, (d, n) in enumerate(items):
            start = 0
            while d == device and start < n:
                if rows == cap:
                    groups.append([])
                    rows = 0
                take = min(n - start, cap - rows)
                groups[-1].append((i, start, start + take))
                rows += take
                start += take
    return groups


class DiffEngine:
    def __init__(self, block_bytes: int = ops.DEFAULT_BLOCK_BYTES,
                 promote_threshold: float = 0.95):
        self.block_bytes = block_bytes
        self.promote_threshold = promote_threshold
        self._digests: Dict[str, np.ndarray] = {}
        self.epoch = 0       # bumped on invalidate(); DIFF plans check it

    # ------------------------------------------------------------------ #

    def invalidate(self, paths) -> None:
        """Drop digest state for ``paths`` (a store of them failed after the
        chain advanced).  Conservative and safe: the next DIFF sees no base
        for these leaves, marks every block dirty, and the promote guard
        turns that into a FULL — never a delta against phantom data."""
        paths = list(paths)
        for p in paths:
            self._digests.pop(p, None)
        if paths:
            self.epoch += 1

    def digest_key(self, path: str) -> Optional[str]:
        """Compact fingerprint of ``path``'s current block digests, or None
        when no digest chain exists for it (diff-unaware backends,
        never-stored leaves).  Used as a chunk-layout reuse key on the fused
        Pack → upload path: equal fingerprints mean the leaf's bytes are
        unchanged since the digests were recorded, so the chunk stream can
        replay its previous CDC cut layout instead of re-scanning."""
        d = self._digests.get(path)
        if d is None:
            return None
        return ops.digest_fingerprint(d)

    def launch_digests(self, named: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Hash every leaf on its device → ``{path: (n_blocks, 2) tensor}``.
        On the card this only enqueues the kernels on the current stream:
        work queued after it on that stream (a D2H snapshot, or the
        caller's next in-place update) runs after the hash has read the
        bytes."""
        return {path: ops.blockhash(as_tensor(leaf), self.block_bytes)
                for path, leaf in named.items()}

    def commit_digests(self, digests: Dict[str, torch.Tensor]) -> None:
        """Copy launched digests to the host and make them the DIFF base."""
        for path, d in digests.items():
            self._digests[path] = ops.u32_numpy(d)

    def update_digests_full(self, named: Dict[str, Any]) -> None:
        """After a FULL store: record digests so the next DIFF has a base."""
        self.commit_digests(self.launch_digests(named))

    def compute_deltas(self, named: Dict[str, Any]
                       ) -> Tuple[Optional[List[LeafDelta]], DiffStats]:
        """→ (deltas, stats); deltas=None means "promote to FULL".  The
        packed dirty blocks are host copies, complete when this returns:
        one pack launch and one D2H per group of :meth:`_pack_dirty`."""
        stats = DiffStats()
        pending: List[Tuple[str, torch.Tensor, np.ndarray, np.ndarray]] = []
        for path, d in self.launch_digests(named).items():
            h_new = ops.u32_numpy(d)
            dirty = ops.dirty_indices(h_new, self._digests.get(path))
            stats.total_blocks += h_new.shape[0]
            stats.dirty_blocks += int(dirty.shape[0])
            pending.append((path, as_tensor(named[path]), h_new, dirty))

        if stats.dirty_ratio > self.promote_threshold:
            stats.promoted_full = True
            # the promoted FULL store persists exactly these leaves — commit
            # the already-computed digests so the caller need not re-hash
            for path, _leaf, h_new, _dirty in pending:
                self._digests[path] = h_new
            return None, stats

        deltas = []
        packed = self._pack_dirty(pending)
        for path, leaf, h_new, dirty in pending:
            payload = packed.get(path)
            if payload is None:
                payload = np.zeros((0, self.block_bytes // 4), np.uint32)
            stats.bytes_written += payload.nbytes
            deltas.append(LeafDelta(
                path=path,
                dtype=leaf_dtype_str(leaf),
                shape=list(leaf.shape),
                n_blocks=int(h_new.shape[0]),
                dirty_idx=dirty,
                payload=payload,
                digests=h_new,
            ))
        for d in deltas:
            self._digests[d.path] = d.digests
        return deltas, stats


    def _pack_dirty(self, pending) -> Dict[str, np.ndarray]:
        """The dirty blocks of every leaf in ``pending`` ((path, leaf,
        digests, dirty indices), in order) → ``{path: (n_dirty,
        block_bytes/4) uint32}`` on the host, leaves with no dirty block
        left out.  The rows go by :func:`row_groups` of at most
        :data:`MAX_PACK_BYTES`, one ``ops.pack_dirty_many`` and one D2H per
        group: a DIFF just under the promote threshold never holds the
        whole dirty state on the card at once.  A leaf packed in one group
        gets a row slice of that group's host array."""
        cap = max(1, MAX_PACK_BYTES // self.block_bytes)
        groups = row_groups([(leaf.device, dirty.shape[0])
                             for _, leaf, _, dirty in pending], cap)
        pieces: Dict[str, List[np.ndarray]] = {}
        for group in groups:
            host = ops.u32_numpy(ops.pack_dirty_many(
                [pending[i][1] for i, _, _ in group],
                [pending[i][3][a:b] for i, a, b in group], self.block_bytes))
            row = 0
            for i, a, b in group:
                pieces.setdefault(pending[i][0], []).append(
                    host[row:row + b - a])
                row += b - a
        return {path: p[0] if len(p) == 1 else np.concatenate(p)
                for path, p in pieces.items()}


# -------------------------------------------------------------------------- #
# restore-side replay (host, numpy — as in the JAX package)
# -------------------------------------------------------------------------- #


def leaf_to_u32_flat(arr: np.ndarray, block_bytes: int) -> np.ndarray:
    be = block_bytes // 4
    raw = np.ascontiguousarray(arr).tobytes()
    pad = (-len(raw)) % 4
    buf = np.frombuffer(raw + b"\x00" * pad, np.uint32)
    n_blocks = max(1, -(-buf.shape[0] // be))
    out = np.zeros(n_blocks * be, np.uint32)
    out[: buf.shape[0]] = buf
    return out


def u32_flat_to_leaf(buf: np.ndarray, dtype: str, shape: List[int]
                     ) -> np.ndarray:
    dt = str_dtype(dtype)
    n_bytes = int(np.prod(shape)) * dt.itemsize
    return np.frombuffer(buf.tobytes()[:n_bytes], dtype=dt).reshape(shape).copy()


def apply_delta(buf: np.ndarray, dirty_idx: np.ndarray, payload: np.ndarray,
                block_bytes: int) -> np.ndarray:
    be = block_bytes // 4
    blocks = buf.reshape(-1, be)
    if dirty_idx.shape[0]:
        blocks[dirty_idx] = payload
    return blocks.reshape(-1)


class _LeafReplay:
    """One leaf's part of a :class:`ChainReplay`: its FULL base and its
    deltas, each with the position of its link in the chain."""

    def __init__(self, base: np.ndarray, block_bytes: int):
        self.base = np.ascontiguousarray(base)
        # the numpy replay's buffer: the base padded to whole blocks
        self.padded = n_blocks_of(self.base.nbytes, block_bytes) * block_bytes
        self.deltas: List[Tuple[int, np.ndarray, np.ndarray, int]] = []
        self.dtype: Optional[str] = None
        self.shape: List[int] = []
        self.nbytes = 0

    def add(self, link: int, dirty_idx: np.ndarray, payload: np.ndarray,
            block_bytes: int, dtype: str, shape: List[int]) -> None:
        if self.padded % block_bytes:
            raise ValueError(f"block_bytes {block_bytes} does not divide the "
                             f"replay buffer's {self.padded} bytes")
        idx = ops.check_dirty_indices(dirty_idx, self.padded // block_bytes)
        if tuple(payload.shape) != (idx.size, block_bytes // 4):
            raise ValueError(f"packed rows {tuple(payload.shape)} != "
                             f"({idx.size}, {block_bytes // 4})")
        self.deltas.append((link, idx, payload, block_bytes))
        self.dtype, self.shape = dtype, list(shape)

    def finish(self) -> None:
        n = int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1
        self.nbytes = n * str_dtype(self.dtype).itemsize
        if self.nbytes > self.padded:
            raise ValueError(f"leaf of {self.nbytes} B outgrows its replay "
                             f"buffer of {self.padded} B")
        kept = []
        for link, idx, payload, bb in self.deltas:
            keep = idx < n_blocks_of(self.nbytes, bb)
            kept.append((link, idx[keep], payload[keep], bb))
        self.deltas = kept

    def base_on(self, device: Any) -> torch.Tensor:
        """The leaf at its final dtype and shape, a new tensor on
        ``device`` holding the base's bytes (zeros past the base's end)."""
        buf = torch.zeros(self.nbytes, dtype=torch.uint8, device=device)
        raw = self.base.reshape(-1).view(np.uint8)[: self.nbytes]
        if raw.size:
            buf[: raw.size].copy_(torch.from_numpy(
                raw if raw.flags.writeable else raw.copy()))
        return buf.view(str_to_torch_dtype(self.dtype)).view(tuple(self.shape))


class ChainReplay:
    """The leaves of a DIFF chain that a restart places on devices,
    replayed there: planned on the host leaf by leaf (:meth:`start`,
    :meth:`add`, :meth:`drop`, :meth:`finish`), run link by link
    (:meth:`run`).

    It gives the numpy replay's bytes.  That replay scatters whole rows
    into each base's zero-padded u32 buffer and keeps the first bytes, as
    many as the last delta's dtype and shape need.  Here each leaf is made
    once on its device at that final size, from its base's bytes (zeros
    past the base's end); then, for each DIFF link in chain order, the rows
    of every leaf that link touches are scattered in place by one
    ``ops.unpack_dirty_many`` per device and group of at most
    :data:`MAX_PACK_BYTES` of rows — the diffunpack kernel on the card, its
    plain version on the CPU — which writes only bytes below each leaf's
    end, the only bytes the numpy replay keeps.  :meth:`add` and
    :meth:`finish` raise, on the host, where the numpy replay would raise
    on the same data, so :meth:`run` can fail only on the device."""

    def __init__(self) -> None:
        self._leaves: Dict[str, _LeafReplay] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._leaves

    def start(self, name: str, base: np.ndarray, block_bytes: int) -> None:
        """Replay leaf ``name`` from its FULL base."""
        self._leaves[name] = _LeafReplay(base, block_bytes)

    def drop(self, name: str) -> None:
        """Forget leaf ``name`` and its deltas (a later FULL dataset of it
        supersedes them)."""
        self._leaves.pop(name, None)

    def add(self, name: str, link: int, dirty_idx: np.ndarray,
            payload: np.ndarray, block_bytes: int, dtype: str,
            shape: List[int]) -> None:
        """Leaf ``name``'s delta in link ``link`` of the chain, links in
        order; the leaf takes its dtype and shape."""
        self._leaves[name].add(link, dirty_idx, payload, block_bytes, dtype,
                               shape)

    def finish(self) -> None:
        """Check each final leaf against its replay buffer and drop the
        rows that lie wholly past its end."""
        for leaf in self._leaves.values():
            leaf.finish()

    def run(self, devices: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The replayed leaves, new tensors on ``devices[name]``."""
        out = {name: leaf.base_on(devices[name])
               for name, leaf in self._leaves.items()}
        links: Dict[Tuple[int, int], List[Tuple[str, np.ndarray,
                                                np.ndarray]]] = {}
        for name, leaf in self._leaves.items():
            for link, idx, payload, bb in leaf.deltas:
                links.setdefault((link, bb), []).append((name, idx, payload))
        for (_link, bb), entries in sorted(links.items()):
            cap = max(1, MAX_PACK_BYTES // bb)
            for group in row_groups([(out[name].device, idx.size)
                                     for name, idx, _ in entries], cap):
                ops.unpack_dirty_many(
                    [out[entries[i][0]] for i, _, _ in group],
                    [entries[i][1][a:b] for i, a, b in group],
                    [entries[i][2][a:b] for i, a, b in group], bb)
        return out

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

Sharded leaves (``DTensor``, :class:`ShardPart`): the digests and dirty
rows are those of the *global* leaf, bit for bit the JAX package's, so a
DIFF container holds global-block digests and rows whichever mesh wrote
it.  The hash is a wrapping sum over a block's words salted by their
position in the block, so it splits over ranks:

- a box whose contiguous runs of the global bytes start and end on block
  boundaries (a row shard: ``embed`` Shard(0), ``wo``/``w_down`` Shard(1)
  when stacked) is hashed in place; its blocks are global blocks;
- any other box (a column shard cuts every row, so its blocks span ranks)
  is hashed inside a zero buffer of the global leaf's size with only its
  own values set; the global digest of a block is the sum of the owners'
  digests less ``(owners - 1)`` digests of a zero block.

Only the box owners hash (one blockhash launch per owned leaf part), and
only the digest vectors (8 B per block) cross ranks: one ``exchange`` per
store.  A DIFF store then packs each owner's part of the dirty blocks
(the zero-buffer rows of a column shard hold zeros outside the owner's
values, so the owners' rows OR together) in the same ``pack_dirty_many``
as the replicated leaves' rows, and one more ``exchange`` gives every rank
every sharded leaf's delta: every rank's container holds it.

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

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import numpy_to_tensor, str_to_torch_dtype
from repro_torch.core.formats import str_to_dtype as str_dtype
from repro_torch.core.formats import torch_dtype_to_str
from repro_torch.core.protect import leaf_dtype_str
from repro_torch.core.resharding import (
    Gather,
    box_owners,
    box_runs,
    box_slices,
    mesh_boxes,
    sharding_of,
)
from repro_torch.dist.context import Box
from repro_torch.kernels import ops, ref
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


@dataclass
class ShardPart:
    """One sharded (``DTensor``) leaf as this rank sees it for digests and
    packs: the global layout, the writer rank of every distinct box, and
    this rank's box when it writes one."""
    path: str
    dtype: str                          # CHK5 dtype string
    shape: Tuple[int, ...]
    block_bytes: int
    owners: Dict[int, Box]              # writer rank → its box
    local: Optional[torch.Tensor]       # this rank's box, if it writes it
    rank: int
    #: the zero-buffer of a column shard, kept from hash to pack
    padded: Optional[torch.Tensor] = None

    @property
    def n_blocks(self) -> int:
        n = int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1
        return n_blocks_of(n * str_dtype(self.dtype).itemsize,
                           self.block_bytes)

    def _runs_aligned(self, box: Box) -> bool:
        isz = str_dtype(self.dtype).itemsize
        n = int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1
        starts, length = box_runs(box, self.shape)
        if np.any((starts * isz) % self.block_bytes):
            return False
        return (length * isz) % self.block_bytes == 0 or (
            starts.size == 1 and int(starts[0]) + length == n)

    @functools.cached_property
    def aligned(self) -> bool:
        """Every owner's box hashes in place (block-aligned runs)."""
        return all(self._runs_aligned(b) for b in self.owners.values())

    def blocks_of(self, rank: int) -> np.ndarray:
        """Global block index of each block of ``rank``'s box (aligned
        layouts), ascending."""
        isz = str_dtype(self.dtype).itemsize
        starts, length = box_runs(self.owners[rank], self.shape)
        per = -(-length * isz // self.block_bytes)
        first = starts * isz // self.block_bytes
        return (first[:, None] + np.arange(per)[None, :]).reshape(-1)

    def hash_source(self) -> torch.Tensor:
        """What this rank hashes: its box in place, or the zero buffer of
        the global leaf's size with its box set (kept for the pack)."""
        if self.aligned:
            return self.local
        if self.padded is None:
            isz = self.local.element_size()
            buf = torch.zeros(self.n_blocks * self.block_bytes // isz,
                              dtype=self.local.dtype,
                              device=self.local.device)
            n = int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1
            buf[:n].view(self.shape)[box_slices(self.owners[self.rank])] \
                .copy_(self.local)
            self.padded = buf
        return self.padded


def shard_part(path: str, leaf: Any, block_bytes: int) -> ShardPart:
    """The :class:`ShardPart` of a sharded ``DTensor`` leaf on this rank."""
    import torch.distributed as dist
    sh = sharding_of(leaf)
    shape = tuple(int(d) for d in leaf.shape)
    owners = {r: b for b, r in box_owners(
        mesh_boxes(sh.mesh, sh.spec, shape)).items()}
    me = dist.get_rank()
    local = leaf.to_local().contiguous() if me in owners else None
    return ShardPart(path=path, dtype=torch_dtype_to_str(leaf.dtype),
                     shape=shape, block_bytes=block_bytes, owners=owners,
                     local=local, rank=me)


_ZERO_DIGEST: Dict[int, np.ndarray] = {}


def zero_block_digest(block_bytes: int) -> np.ndarray:
    """(2,) u32 digest of a block of zeros (a constant of the hash)."""
    if block_bytes not in _ZERO_DIGEST:
        _ZERO_DIGEST[block_bytes] = ops.u32_numpy(ref.blockhash2_ref(
            torch.zeros((1, block_bytes // 4), dtype=torch.int32)))[0]
    return _ZERO_DIGEST[block_bytes]


def combine_digests(part: ShardPart, got: Dict[int, np.ndarray]
                    ) -> np.ndarray:
    """Every owner's digests of one sharded leaf → the global leaf's
    ``(n_blocks, 2)`` u32 digests."""
    out = np.zeros((part.n_blocks, 2), np.int64)
    if part.aligned:
        for r, d in got.items():
            out[part.blocks_of(r)] = d
    else:
        for d in got.values():
            out += d
        out -= (len(part.owners) - 1) * zero_block_digest(
            part.block_bytes).astype(np.int64)
    return np.mod(out, 1 << 32).astype(np.uint32)


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

    def sharded_digests(self, parts: Dict[str, ShardPart],
                        exchange: Gather) -> Dict[str, np.ndarray]:
        """The global leaf's digests of every sharded leaf in ``parts``:
        each owner hashes its part (one launch per part), and one
        ``exchange`` of the digest vectors gives every rank every
        leaf's."""
        mine = {p: ops.u32_numpy(ops.blockhash(part.hash_source(),
                                               self.block_bytes))
                for p, part in parts.items() if part.local is not None}
        got = exchange(mine)
        return {p: combine_digests(part, {r: g[p] for r, g in enumerate(got)
                                          if p in g})
                for p, part in parts.items()}

    def commit_sharded_digests(self, digests: Dict[str, np.ndarray]) -> None:
        self._digests.update(digests)

    def compute_deltas(self, named: Dict[str, Any],
                       parts: Optional[Dict[str, ShardPart]] = None,
                       exchange: Optional[Gather] = None
                       ) -> Tuple[Optional[List[LeafDelta]], DiffStats]:
        """→ (deltas, stats); deltas=None means "promote to FULL".  The
        packed dirty blocks are host copies, complete when this returns:
        one pack launch and one D2H per group of :meth:`_pack_dirty`.
        ``parts`` are sharded leaves (global digests and rows, through
        ``exchange``)."""
        parts = parts or {}
        stats = DiffStats()
        pending: List[Tuple[str, torch.Tensor, np.ndarray, np.ndarray]] = []
        for path, d in self.launch_digests(named).items():
            h_new = ops.u32_numpy(d)
            dirty = ops.dirty_indices(h_new, self._digests.get(path))
            stats.total_blocks += h_new.shape[0]
            stats.dirty_blocks += int(dirty.shape[0])
            pending.append((path, as_tensor(named[path]), h_new, dirty))
        global_h = self.sharded_digests(parts, exchange) if parts else {}
        sharded: List[Tuple[ShardPart, np.ndarray, np.ndarray]] = []
        for path, part in parts.items():
            h_new = global_h[path]
            dirty = ops.dirty_indices(h_new, self._digests.get(path))
            stats.total_blocks += h_new.shape[0]
            stats.dirty_blocks += int(dirty.shape[0])
            sharded.append((part, h_new, dirty))

        if stats.dirty_ratio > self.promote_threshold:
            stats.promoted_full = True
            # the promoted FULL store persists exactly these leaves — commit
            # the already-computed digests so the caller need not re-hash
            for path, _leaf, h_new, _dirty in pending:
                self._digests[path] = h_new
            self._digests.update(global_h)
            for part in parts.values():
                part.padded = None
            return None, stats

        # this rank's part of each sharded leaf's dirty blocks joins the
        # replicated leaves' rows in one pack
        own = []
        for part, _h, dirty in sharded:
            if part.local is None:
                continue
            if part.aligned:
                blocks = part.blocks_of(part.rank)
                idx = np.searchsorted(blocks, dirty[np.isin(dirty, blocks)])
            else:
                idx = dirty
            own.append((part.path, part.hash_source(), None,
                        idx.astype(np.int32)))
        packed = self._pack_dirty(pending + own)
        for part in parts.values():
            part.padded = None
        got = exchange({p: packed[p] for p, *_ in own if p in packed}) \
            if parts else []

        deltas = []
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
        for part, h_new, dirty in sharded:
            payload = np.zeros((dirty.size, self.block_bytes // 4), np.uint32)
            for r, g in enumerate(got):
                rows = g.get(part.path)
                if rows is None:
                    continue
                if part.aligned:
                    payload[np.isin(dirty, part.blocks_of(r))] = rows
                else:
                    payload |= rows
            stats.bytes_written += payload.nbytes
            deltas.append(LeafDelta(
                path=part.path, dtype=part.dtype, shape=list(part.shape),
                n_blocks=int(h_new.shape[0]), dirty_idx=dirty,
                payload=payload, digests=h_new))
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

    def __len__(self) -> int:
        return len(self._leaves)

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

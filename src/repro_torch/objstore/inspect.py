"""``repro_torch.objstore.inspect`` — the typed catalog-inspection API.

One read of ``catalog.json`` becomes a :class:`CatalogView`: immutable
:class:`EntryInfo`/:class:`FileInfo` records (id, kind, level, epoch,
file set, chunk stats, chunk digests) instead of the raw JSON dicts the
catalog stores.  Every consumer of catalog *contents* goes through this
surface — the ``chkls`` CLI, the CI-lane inventory assertions, and the
serving control plane (``repro_torch.serve.deploy``) — so nothing outside
``repro_torch.objstore`` parses ``catalog.json`` by hand.

The serving-side primitive is :meth:`CatalogView.diff`: the chunk-level
delta between two entries (digests the target references that the base
does not), which is exactly what a deploy subscriber must *pull* to move
a replica from one published checkpoint to the next — content addressing
makes "what changed" a set difference, no byte comparison involved.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.objstore.catalog import Catalog
from repro_torch.objstore.chunks import FileEntry
from repro_torch.objstore.client import ObjectStore


@dataclass(frozen=True)
class FileInfo:
    """One file of a published entry: its size, chunking mode, and the
    ordered ``(digest, offset, nbytes)`` chunk rows that reassemble it."""
    name: str
    size: int
    mode: str
    chunks: Tuple[Tuple[str, int, int], ...]

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def chunk_sizes(self) -> List[int]:
        return [n for _h, _o, n in self.chunks]

    @property
    def digests(self) -> List[str]:
        return [h for h, _o, _n in self.chunks]

    def file_entry(self) -> FileEntry:
        """The fetch-layer :class:`~repro_torch.objstore.chunks.FileEntry` —
        what ``fetch_file``/``fetch_file_delta`` reassemble from."""
        return FileEntry(name=self.name, size=self.size,
                         chunks=list(self.chunks), mode=self.mode)

    @staticmethod
    def from_entry(fe: FileEntry) -> "FileInfo":
        return FileInfo(name=fe.name, size=int(fe.size),
                        mode=fe.mode, chunks=tuple(fe.chunks))


def _chunk_hist(sizes: List[int]) -> Dict[str, int]:
    """Power-of-two size histogram: bucket ``2^k`` counts chunks with
    ``2^(k-1) < nbytes <= 2^k`` — the CDC spread at a glance."""
    hist: Dict[str, int] = {}
    for n in sizes:
        k = max(int(n) - 1, 0).bit_length()
        label = f"2^{k}"
        hist[label] = hist.get(label, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: int(kv[0][2:])))


@dataclass(frozen=True)
class EntryInfo:
    """One published checkpoint: identity, the manifest-derived
    kind/level, the file set, and chunk-level statistics."""
    id: int
    pinned: bool
    kind: Optional[str]
    level: Optional[int]
    wall_time: Optional[float]
    manifest: Mapping[str, Any]
    files: Tuple[FileInfo, ...]
    epoch: int = 0                     # catalog epoch this view was read at

    # -- derived -------------------------------------------------------- #

    def file(self, name: str) -> Optional[FileInfo]:
        for f in self.files:
            if f.name == name:
                return f
        return None

    def rank_files(self, rank: int) -> List[FileInfo]:
        """This rank's file set: its container plus its shard files."""
        return [f for f in self.files
                if f.name == f"rank{rank}.chk5"
                or f.name.startswith(f"rank{rank}.shard")]

    @property
    def total_bytes(self) -> int:
        return sum(f.size for f in self.files)

    @property
    def n_chunks(self) -> int:
        return sum(f.n_chunks for f in self.files)

    @property
    def chunk_digests(self) -> frozenset:
        """Every chunk digest this entry references — the unit the deploy
        delta (:meth:`CatalogView.diff`) is computed over."""
        return frozenset(h for f in self.files for h in f.digests)

    @property
    def chunk_sizes(self) -> List[int]:
        return [n for f in self.files for n in f.chunk_sizes]

    @property
    def chunk_hist(self) -> Dict[str, int]:
        return _chunk_hist(self.chunk_sizes)

    def to_inventory(self) -> Dict[str, Any]:
        """The legacy ``catalog_inventory`` per-entry dict shape (what
        ``chkls --json`` emits and existing CI assertions consume)."""
        sizes = self.chunk_sizes
        return {
            "id": self.id, "pinned": self.pinned,
            "kind": self.kind, "level": self.level,
            "wall_time": self.wall_time,
            "files": {f.name: {"size": f.size, "n_chunks": f.n_chunks,
                               "mode": f.mode}
                      for f in self.files},
            "total_bytes": self.total_bytes, "n_chunks": self.n_chunks,
            "chunk_hist": _chunk_hist(sizes),
            "chunk_bytes_min": min(sizes, default=0),
            "chunk_bytes_max": max(sizes, default=0),
        }

    @staticmethod
    def from_json(entry: Dict[str, Any], key: str, epoch: int) -> "EntryInfo":
        man = entry.get("manifest", {}) or {}
        files = tuple(
            FileInfo.from_entry(fe) for _name, fe in
            sorted(Catalog.file_entries(entry).items()))
        lvl = man.get("level")
        return EntryInfo(
            id=int(entry.get("id", key)), pinned=bool(entry.get("pinned")),
            kind=man.get("kind"),
            level=int(lvl) if lvl is not None else None,
            wall_time=man.get("wall_time"), manifest=man,
            files=files, epoch=epoch)


@dataclass(frozen=True)
class ChunkDelta:
    """The chunk-level pull a move from ``base`` to ``target`` costs: the
    digests the target references that the base does not.  With no base
    (cold replica) the delta is the whole target."""
    base_id: Optional[int]
    target_id: int
    digests: frozenset
    bytes_delta: int                   # bytes of the missing chunks
    bytes_total: int                   # total target chunk bytes
    n_chunks_delta: int
    n_chunks_total: int

    @property
    def ratio(self) -> float:
        """Delta bytes over full weight bytes — the fine-tune-publish
        claim (~dedup ratio of the underlying store) and the CI-gated
        ``serve_swap_delta_ratio`` datapoint."""
        return self.bytes_delta / max(self.bytes_total, 1)


class CatalogView:
    """An immutable snapshot of one catalog read: epoch + typed entries.

    ``stored_chunks`` (the bucket-wide chunk count) is filled only by
    :meth:`from_store` with ``count_chunks=True`` — it costs a bucket
    list, which pure metadata readers should not pay."""

    def __init__(self, epoch: int, entries: Dict[int, EntryInfo],
                 stored_chunks: Optional[int] = None):
        self.epoch = int(epoch)
        self.entries: Dict[int, EntryInfo] = dict(
            sorted(entries.items()))
        self.stored_chunks = stored_chunks

    # -- construction --------------------------------------------------- #

    @staticmethod
    def from_json(cat: Dict[str, Any],
                  stored_chunks: Optional[int] = None) -> "CatalogView":
        epoch = int(cat.get("epoch", 0))
        entries = {
            int(k): EntryInfo.from_json(v, k, epoch)
            for k, v in cat.get("entries", {}).items()}
        return CatalogView(epoch, entries, stored_chunks)

    @staticmethod
    def from_store(store: ObjectStore, *,
                   count_chunks: bool = False) -> "CatalogView":
        cat, _etag = Catalog(store).read()
        stored = len(store.list("chunks/")) if count_chunks else None
        return CatalogView.from_json(cat, stored)

    @staticmethod
    def from_root(root: str, *, count_chunks: bool = False) -> "CatalogView":
        from repro_torch.objstore.client import make_object_store
        return CatalogView.from_store(make_object_store(f"file:{root}"),
                                      count_chunks=count_chunks)

    # -- queries -------------------------------------------------------- #

    def ids(self) -> List[int]:
        return list(self.entries)

    def entry(self, ckpt_id: int) -> Optional[EntryInfo]:
        return self.entries.get(int(ckpt_id))

    def latest(self, *, kind: Optional[str] = None,
               level: Optional[int] = None,
               min_id: Optional[int] = None) -> Optional[EntryInfo]:
        """Newest entry matching the filters — the deploy selector's
        resolution primitive."""
        for i in reversed(self.ids()):
            e = self.entries[i]
            if kind is not None and e.kind != kind:
                continue
            if level is not None and e.level != level:
                continue
            if min_id is not None and e.id < min_id:
                continue
            return e
        return None

    # -- the deploy delta ----------------------------------------------- #

    @staticmethod
    def diff(base: Optional[EntryInfo], target: EntryInfo) -> ChunkDelta:
        """Chunk-level delta ``base → target``: what a replica already
        holding ``base``'s chunks must pull to materialize ``target``.
        Content addressing makes this a digest set difference — two
        entries sharing 97% of their chunks (a fine-tune publish against
        the measured ~0.03 dedup ratio) diff to ~3% of the bytes."""
        have = base.chunk_digests if base is not None else frozenset()
        missing = set()
        bytes_delta = bytes_total = 0
        n_total = 0
        for f in target.files:
            for h, _o, n in f.chunks:
                n_total += 1
                bytes_total += n
                if h not in have and h not in missing:
                    missing.add(h)
                    bytes_delta += n
        return ChunkDelta(
            base_id=base.id if base is not None else None,
            target_id=target.id, digests=frozenset(missing),
            bytes_delta=bytes_delta, bytes_total=bytes_total,
            n_chunks_delta=len(missing), n_chunks_total=n_total)

    # -- legacy inventory shape ----------------------------------------- #

    def to_inventory(self, root: str) -> Dict[str, Any]:
        """The exact dict ``tools.chkls.catalog_inventory`` used to build
        by hand — kept as the machine-readable ``chkls --json`` shape."""
        return {"root": root, "epoch": self.epoch,
                "entries": [e.to_inventory() for e in self.entries.values()],
                "stored_chunks": self.stored_chunks
                if self.stored_chunks is not None else 0}

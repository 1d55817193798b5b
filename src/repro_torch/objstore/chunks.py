"""Content-addressed chunk layer — DIFF semantics at the storage layer.

Checkpoint files (CHK5 containers and their sibling shard files) are
split into chunks; each chunk is stored under its sha256
(``chunks/<h[:2]>/<h>``), so a chunk that already exists in the store is
never uploaded again.  Chunking is **content-defined** by default
(:mod:`repro_torch.objstore.cdc` — gear rolling-hash boundaries with
min/avg/max bounds): boundaries re-synchronize after an insertion, so a
leaf-size change re-uploads only the neighboring chunks instead of the
whole container tail.  ``FileEntry`` records ``(digest, offset,
length)`` per chunk, so variable-size chunks stay randomly addressable
(``ObjectStoreTier.recover`` byte-range verification, region reads).
The pre-CDC fixed-size mode survives as ``mode="fixed"`` — both for
config opt-out and for catalogs written before the change
(:func:`iter_file_chunks` is the legacy splitter/decoder).

Two upload paths share one transfer pool
(``StorageConfig.objstore_transfers``):

- **streaming** (:class:`ChunkStream`, via ``ChunkUploader.open_stream``)
  — the fused Pack path.  CHK5 writers tee every written byte into the
  stream; the moment a CDC boundary lands the chunk's sha256 is taken
  and, when missing from the store, its upload is submitted — packing,
  hashing and transfers overlap, and the staged file is never re-read.
  In-flight chunk bytes are bounded by a semaphore (the stream uploads
  from memory, so backpressure replaces the file-path's pread).
- **file-based** (:meth:`ChunkUploader.submit_file`) — payloads staged
  outside Pack (SCR ``route_file``, incremental ``add``): the file is
  scanned with the *same* chunker (layout-consistent with streamed
  containers) and workers ``pread`` each chunk.

Both return a :class:`PendingFile` at Place; ``result()`` joins at
Commit — submit-at-Place / join-at-Commit ordering is preserved, the
streaming path just starts its transfers earlier (during Pack).

Content addressing is also the resume story: re-running an interrupted
upload re-splits the same bytes and skips every chunk that already
landed — no partial-object state to reconcile.
"""
from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.chaos import inject as chaos
from repro_torch.objstore.cdc import CDCParams, Chunker
from repro_torch.objstore.client import ObjectStore, ObjectStoreError
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace

DEFAULT_CHUNK_BYTES = 1 << 20

#: chunking modes a catalog entry may record
MODE_CDC = "cdc"
MODE_FIXED = "fixed"

#: in-flight streamed chunks per transfer thread (memory backpressure)
_INFLIGHT_PER_TRANSFER = 4


def chunk_key(digest: str) -> str:
    return f"chunks/{digest[:2]}/{digest}"


def iter_file_chunks(path: str, chunk_bytes: int
                     ) -> Iterator[Tuple[str, bytes]]:
    """→ (sha256 hex, chunk bytes) for every fixed-size chunk of ``path``
    — the legacy (pre-CDC) splitter, kept as the ``mode="fixed"`` path
    and the decoder reference for catalogs written before offsets were
    recorded."""
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk_bytes)
            if not data:
                break
            yield hashlib.sha256(data).hexdigest(), data


@dataclass
class FileEntry:
    """One file of a catalog entry: its size, the chunking mode, and the
    ordered chunk list ``(digest, offset, nbytes)`` that reassembles it.

    Legacy 2-tuple ``(digest, nbytes)`` rows (pre-CDC catalogs and old
    callers) normalize to 3-tuples by accumulating offsets — fixed-size
    chunks tile the file contiguously, so the offsets are implied."""
    name: str
    size: int
    chunks: List[Tuple[str, int, int]]
    mode: str = MODE_FIXED

    def __post_init__(self):
        norm, off = [], 0
        for row in self.chunks:
            if len(row) == 2:
                h, n = row
                norm.append((h, off, int(n)))
            else:
                h, o, n = row
                norm.append((h, int(o), int(n)))
            off = norm[-1][1] + norm[-1][2]
        self.chunks = norm

    def to_json(self) -> Dict:
        return {"size": self.size, "mode": self.mode,
                "chunks": [[h, o, n] for h, o, n in self.chunks]}

    @staticmethod
    def from_json(name: str, d: Dict) -> "FileEntry":
        # pre-CDC entries carry [digest, nbytes] rows and no mode key:
        # they were written by the fixed-size splitter
        return FileEntry(name=name, size=int(d["size"]),
                         chunks=[tuple(row) for row in d["chunks"]],
                         mode=d.get("mode", MODE_FIXED))


@dataclass
class PendingFile:
    """An in-flight chunked upload: metadata is final, transfers may not
    be — ``result()`` joins them (raising the first failure).  File-based
    uploads hold the source file open until then (transfer workers
    ``pread`` from it, so the upload survives the stage dir's commit-time
    rename); streamed uploads carry their bytes in the futures."""
    name: str
    size: int
    chunks: List[Tuple[str, int, int]]
    mode: str = MODE_FIXED
    futures: List[Future] = field(default_factory=list)
    _file: object = None

    def result(self) -> FileEntry:
        try:
            for f in self.futures:
                f.result()
        finally:
            if self._file is not None:
                self._file.close()
                self._file = None
        return FileEntry(self.name, self.size, self.chunks, mode=self.mode)


class ChunkUploader:
    """Dedup-aware parallel chunk uploads against one object store.

    ``cdc=None`` keeps the legacy fixed-size layout (``chunk_bytes``);
    passing :class:`~repro_torch.objstore.cdc.CDCParams` switches every path —
    streamed and file-based — to content-defined boundaries."""

    def __init__(self, store: ObjectStore,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES, transfers: int = 4,
                 cdc: Optional[CDCParams] = None):
        self.store = store
        self.chunk_bytes = int(chunk_bytes)
        self.transfers = max(1, int(transfers))
        self.cdc = cdc
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._inflight = threading.BoundedSemaphore(
            self.transfers * _INFLIGHT_PER_TRANSFER)
        # region key → recorded chunk lengths: the device-digest pre-seed
        # cache ChunkStream replays for unchanged leaves (see open_stream)
        self._layouts: "OrderedDict[str, List[int]]" = OrderedDict()
        self._layout_cap = 512
        # digests known present-or-in-flight: atomic check-and-mark, so a
        # chunk repeated within one store (or racing across concurrent
        # shard streams) uploads exactly once instead of racing the
        # exists-check against its own first upload — and repeat digests
        # skip the exists round-trip entirely
        self._known: "OrderedDict[str, bool]" = OrderedDict()
        self._known_cap = 1 << 16
        self.stats: Dict[str, int] = {
            "chunks_uploaded": 0, "chunks_deduped": 0,
            "bytes_uploaded": 0, "bytes_deduped": 0,
            "regions_reused": 0, "bytes_scan_skipped": 0,
        }

    @property
    def mode(self) -> str:
        return MODE_CDC if self.cdc is not None else MODE_FIXED

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.transfers,
                    thread_name_prefix="objstore-up")
            return self._pool

    def close(self) -> None:
        """Join in-flight transfers and shut the pool down.  Optional —
        the pool is lazily recreated by the next submission."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- layout cache (digest pre-seeds) -------------------------------- #

    def cached_layout(self, key: str) -> Optional[List[int]]:
        with self._lock:
            got = self._layouts.get(key)
            if got is not None:
                self._layouts.move_to_end(key)
            return list(got) if got is not None else None

    def remember_layout(self, key: str, lengths: Sequence[int]) -> None:
        with self._lock:
            self._layouts[key] = list(lengths)
            self._layouts.move_to_end(key)
            while len(self._layouts) > self._layout_cap:
                self._layouts.popitem(last=False)

    # -- transfer submission -------------------------------------------- #

    def _put_chunk(self, fd: int, offset: int, nbytes: int,
                   digest: str) -> None:
        # re-read in the worker (os.pread — positionless, thread-safe):
        # capturing the chunk bytes in the executor queue would hold the
        # whole un-deduped payload in RAM at once on a first store
        data = os.pread(fd, nbytes, offset)
        try:
            with ttrace.span("chunk.upload", digest=digest[:12],
                             bytes=nbytes, path="file"):
                self.store.put(chunk_key(digest), data)
        except BaseException:
            self._forget_chunk(digest)
            raise
        self._note_upload(nbytes)

    def _put_stream_chunk(self, digest: str, data: bytes) -> None:
        # streamed chunks upload from memory; the semaphore acquired at
        # submit time bounds how many can sit in the queue at once
        try:
            try:
                with ttrace.span("chunk.upload", digest=digest[:12],
                                 bytes=len(data), path="stream"):
                    self.store.put(chunk_key(digest), data)
            except BaseException:
                self._forget_chunk(digest)
                raise
            self._note_upload(len(data))
        finally:
            self._inflight.release()

    def _note_upload(self, nbytes: int) -> None:
        with self._lock:
            self.stats["chunks_uploaded"] += 1
            self.stats["bytes_uploaded"] += nbytes
        tmetrics.counter("openchk_chunks_uploaded_total").inc()
        tmetrics.counter("openchk_chunk_bytes_uploaded_total").inc(nbytes)

    def _note_dedup(self, nbytes: int) -> None:
        with self._lock:
            self.stats["chunks_deduped"] += 1
            self.stats["bytes_deduped"] += nbytes
        tmetrics.counter("openchk_chunks_deduped_total").inc()
        tmetrics.counter("openchk_chunk_bytes_deduped_total").inc(nbytes)

    def _chunk_known(self, digest: str, nbytes: int) -> bool:
        """Atomic check-and-mark: True ⇒ the chunk is already stored or
        already submitted (counted as dedup, skip the upload); False ⇒
        the caller owns the upload — the digest is marked before the
        exists-check returns, so a second emitter of the same content
        (repeated chunk in one file, concurrent shard streams) dedups
        against the in-flight transfer instead of racing it."""
        with self._lock:
            if digest in self._known:
                self._known.move_to_end(digest)
                hit = True
            else:
                self._known[digest] = True
                while len(self._known) > self._known_cap:
                    self._known.popitem(last=False)
                hit = False
        if hit:
            self._note_dedup(nbytes)
            return True
        try:
            if self.store.exists(chunk_key(digest)):
                self._note_dedup(nbytes)
                return True
        except BaseException:
            self._forget_chunk(digest)
            raise
        return False

    def _forget_chunk(self, digest: str) -> None:
        """Drop a marked digest whose upload never landed (put failed) —
        a later store must retry it, not dedup against a phantom."""
        with self._lock:
            self._known.pop(digest, None)

    # -- file-based path (payloads staged outside Pack) ------------------ #

    def _iter_cuts(self, path: str) -> Iterator[Tuple[str, int, int]]:
        """→ (digest, offset, nbytes) per chunk of ``path``, using the
        uploader's chunking mode.  CDC reads the file in bounded blocks
        through the incremental chunker — same cuts as the streamed
        path for the same bytes."""
        if self.cdc is None:
            off = 0
            for digest, data in iter_file_chunks(path, self.chunk_bytes):
                yield digest, off, len(data)
                off += len(data)
            return
        chunker = Chunker(self.cdc)
        off = 0
        with open(path, "rb") as f:
            while True:
                blk = f.read(self.cdc.max_bytes)
                done = not blk
                pieces = chunker.finish() if done else chunker.push(blk)
                for piece in pieces:
                    yield (hashlib.sha256(piece).hexdigest(), off,
                           len(piece))
                    off += len(piece)
                if done:
                    break

    def submit_file(self, path: str, name: Optional[str] = None
                    ) -> PendingFile:
        """Split ``path`` and submit every *missing* chunk to the transfer
        pool; chunks already in the store are skipped (dedup).  Returns
        immediately — the caller joins via :meth:`PendingFile.result`."""
        pend = PendingFile(name=name or os.path.basename(path),
                           size=os.path.getsize(path), chunks=[],
                           mode=self.mode)
        pend._file = open(path, "rb")
        fd = pend._file.fileno()
        ex = self._executor()
        for digest, offset, nbytes in self._iter_cuts(path):
            pend.chunks.append((digest, offset, nbytes))
            if not self._chunk_known(digest, nbytes):
                pend.futures.append(
                    ex.submit(self._put_chunk, fd, offset, nbytes, digest))
        return pend

    def upload_file(self, path: str, name: Optional[str] = None) -> FileEntry:
        """Synchronous convenience: submit + join."""
        return self.submit_file(path, name).result()

    # -- streaming path (the fused Pack sink) ---------------------------- #

    def open_stream(self, name: str) -> "ChunkStream":
        return ChunkStream(self, name)


class ChunkStream:
    """The Pack-side push sink: a CHK5 writer tees every written byte in
    via :meth:`write`; chunks upload the moment a boundary lands.

    Region hooks carry the device-digest pre-seeds: ``begin_region(key)``
    force-cuts the pending bytes (so the region's chunk layout depends
    only on the region's own bytes) and, when the uploader has a recorded
    layout for ``key`` (same leaf, same Protect spec, same device-side
    blockhash digests ⇒ same encoded bytes), replays the recorded chunk
    lengths verbatim — the CDC boundary scan is skipped for the whole
    region.  Chunk sha256s are still taken from the actual bytes, so a
    replayed layout can never mis-address content: at worst a stale
    layout yields suboptimal cuts, which reassemble correctly regardless
    (every chunk records its own offset/length).  ``end_region`` records
    the fresh layout for the next store.

    ``cut()`` is a soft boundary hint (dataset starts): honored only when
    the pending span already reached ``min_bytes``, so small datasets
    don't shatter into tiny chunks."""

    def __init__(self, uploader: ChunkUploader, name: str):
        self.uploader = uploader
        self.name = name
        self._chunker = (Chunker(uploader.cdc)
                         if uploader.cdc is not None else None)
        self._fixed_buf = bytearray()
        self._offset = 0
        self._chunks: List[Tuple[str, int, int]] = []
        self._futures: List[Future] = []
        self._replay: List[int] = []       # pending replay lengths (hit)
        self._replay_buf = bytearray()     # bytes of the replaying chunk
        self._region_key: Optional[str] = None
        self._region_start = 0             # chunk index the region began at
        self._pending: Optional[PendingFile] = None

    @property
    def finished(self) -> bool:
        return self._pending is not None

    # ------------------------------------------------------------------ #

    def write(self, buf) -> int:
        if self._pending is not None:
            raise ObjectStoreError(f"stream {self.name}: write after finish")
        n = len(buf)
        if not n:
            return 0
        if self._chunker is None:
            self._fixed_buf += buf
            cb = self.uploader.chunk_bytes
            while len(self._fixed_buf) >= cb:
                self._emit(bytes(self._fixed_buf[:cb]))
                del self._fixed_buf[:cb]
        elif self._replay:
            self._write_replay(buf)
        else:
            for piece in self._chunker.push(buf):
                self._emit(piece)
        return n

    def _write_replay(self, buf) -> None:
        """Region-cache hit: split incoming bytes at the recorded lengths
        without scanning (a private buffer, never the chunker — the
        chunker would impose its own cuts).  An exhausted replay falls
        back to the chunker mid-stream — correctness never depends on the
        cache, only layout stability does."""
        up = self.uploader
        pos, n = 0, len(buf)
        while pos < n and self._replay:
            need = self._replay[0] - len(self._replay_buf)
            piece = buf[pos:pos + need]
            self._replay_buf += piece
            pos += len(piece)
            if len(self._replay_buf) == self._replay[0]:
                self._replay.pop(0)
                with up._lock:
                    up.stats["bytes_scan_skipped"] += len(self._replay_buf)
                self._emit(bytes(self._replay_buf))
                self._replay_buf.clear()
        if pos < n:
            for piece in self._chunker.push(buf[pos:]):
                self._emit(piece)

    def cut(self) -> None:
        """Soft boundary hint (dataset start): force a cut only when the
        pending span already satisfies the minimum chunk size."""
        if self._chunker is None or self._replay:
            return
        if self._chunker.pending_bytes >= self._chunker.params.min_bytes:
            for piece in self._chunker.flush():
                self._emit(piece)

    def begin_region(self, key: str) -> None:
        """Start a digest-keyed region: hard cut, then replay the cached
        layout when the key is known (unchanged leaf — no CDC scan)."""
        if self._chunker is None:
            return                         # fixed mode keeps legacy layout
        self.end_region()                  # close any open region first
        for piece in self._chunker.flush():
            self._emit(piece)
        self._region_key = key
        self._region_start = len(self._chunks)
        cached = self.uploader.cached_layout(key)
        if cached:
            self._replay = cached
            with self.uploader._lock:
                self.uploader.stats["regions_reused"] += 1

    def end_region(self) -> None:
        if self._chunker is None or self._region_key is None:
            return
        if self._replay_buf:
            # region ended mid-replay (bytes changed length despite equal
            # digests — defensive): the partial chunk re-enters the chunker
            self._chunker.push(bytes(self._replay_buf))
            self._replay_buf.clear()
        self._replay = []
        for piece in self._chunker.flush():
            self._emit(piece)
        self.uploader.remember_layout(
            self._region_key,
            [n for _h, _o, n in self._chunks[self._region_start:]])
        self._region_key = None

    def finish(self) -> PendingFile:
        """Flush the tail chunk and freeze the metadata.  Idempotent —
        the CHK5 writer calls this at close; the tier reads the result."""
        if self._pending is not None:
            return self._pending
        self.end_region()
        if self._chunker is not None:
            for piece in self._chunker.finish():
                self._emit(piece)
        elif self._fixed_buf:
            self._emit(bytes(self._fixed_buf))
            self._fixed_buf.clear()
        self._pending = PendingFile(
            name=self.name, size=self._offset, chunks=self._chunks,
            mode=self.uploader.mode, futures=self._futures)
        return self._pending

    def pending(self) -> PendingFile:
        if self._pending is None:
            raise ObjectStoreError(
                f"stream {self.name}: not finished (writer crashed before "
                f"close?)")
        return self._pending

    # ------------------------------------------------------------------ #

    def _emit(self, data: bytes) -> None:
        up = self.uploader
        # chaos site at the chunk boundary: error-mode kills the store
        # mid-stream, corrupt-mode flips the bytes BEFORE digesting — the
        # digest then matches the corrupted content, so restore-side
        # integrity (container checksums) is what must catch it
        data = chaos.fire(chaos.SITES.CHUNK_EMIT, exc=ObjectStoreError,
                          data=data, name=self.name,
                          seq=len(self._chunks)).data
        digest = hashlib.sha256(data).hexdigest()
        ttrace.instant("chunk.emit", stream=self.name,
                       seq=len(self._chunks), bytes=len(data))
        self._chunks.append((digest, self._offset, len(data)))
        self._offset += len(data)
        if up._chunk_known(digest, len(data)):
            return
        # bounded in-flight bytes: uploads come from memory here, so the
        # semaphore is the backpressure the file path gets from pread
        up._inflight.acquire()
        try:
            fut = up._executor().submit(up._put_stream_chunk, digest, data)
        except BaseException:
            up._inflight.release()
            raise
        self._futures.append(fut)


def fetch_file(store: ObjectStore, entry: FileEntry, dest: str) -> None:
    """Reassemble ``entry`` at ``dest``, verifying every chunk's digest,
    length and recorded offset (a corrupt or truncated chunk fails the
    fetch, never a silent torn file — the staged ``.part`` only replaces
    ``dest`` when complete)."""
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".part"
    with open(tmp, "wb") as f:
        pos = 0
        for digest, offset, nbytes in entry.chunks:
            if offset != pos:
                raise ObjectStoreError(
                    f"chunk {digest[:12]}… of {entry.name}: recorded "
                    f"offset {offset} does not tile the file (at {pos})")
            data = store.get(chunk_key(digest))
            if len(data) != nbytes or \
                    hashlib.sha256(data).hexdigest() != digest:
                raise ObjectStoreError(
                    f"chunk {digest[:12]}… of {entry.name} is corrupt "
                    f"({len(data)} bytes vs recorded {nbytes})")
            f.write(data)
            pos += nbytes
    if os.path.getsize(tmp) != entry.size:
        raise ObjectStoreError(
            f"{entry.name}: reassembled size {os.path.getsize(tmp)} != "
            f"recorded {entry.size}")
    os.replace(tmp, dest)


class ChunkCache:
    """A node-local content-addressed chunk cache: files named by sha256
    digest under ``root``, so "do I already hold this chunk" is a stat
    and every hit is **re-verified by digest on read** — a cache file
    corrupted on disk is evicted and reads as a miss (forcing a refetch)
    rather than poisoning a reassembled checkpoint.

    This is what makes a deploy swap a *delta*: chunks pulled for entry
    N stay cached, so entry N+1 only fetches the digests it does not
    share with N (the dedup ratio of the underlying store, ~3% on a
    fine-tune publish)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, digest)

    def __contains__(self, digest: str) -> bool:
        return os.path.exists(self._path(digest))

    def get(self, digest: str, nbytes: int) -> Optional[bytes]:
        """→ verified chunk bytes, or ``None`` on miss *or* corruption
        (the corrupt file is removed so the caller's refetch repairs the
        cache)."""
        try:
            with open(self._path(digest), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        if len(data) != nbytes or hashlib.sha256(data).hexdigest() != digest:
            try:
                os.remove(self._path(digest))
            except OSError:
                pass
            return None
        return data

    def put(self, digest: str, data: bytes) -> None:
        """Atomic insert (tmp + rename): a crash mid-put never leaves a
        torn cache file that a later get would have to evict."""
        tmp = self._path(digest) + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._path(digest))


def fetch_file_delta(store: ObjectStore, entry: FileEntry, dest: str,
                     cache: ChunkCache) -> Dict[str, int]:
    """:func:`fetch_file` through a :class:`ChunkCache`: cached chunks
    are read (and digest-re-verified) locally, only absent ones hit the
    object store, and every pulled chunk lands in the cache for the next
    entry's delta.  Same torn-file guarantee — the staged ``.part`` only
    replaces ``dest`` when every chunk verified.

    → transfer stats: ``bytes_fetched``/``chunks_fetched`` (pulled from
    the store), ``bytes_cached``/``chunks_cached`` (served locally), and
    ``chunks_corrupt`` (cache hits that failed digest verify and were
    refetched) — the numerator of the ``serve_swap_delta_ratio`` gate."""
    stats = {"bytes_fetched": 0, "chunks_fetched": 0,
             "bytes_cached": 0, "chunks_cached": 0, "chunks_corrupt": 0}
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".part"
    with open(tmp, "wb") as f:
        pos = 0
        for digest, offset, nbytes in entry.chunks:
            if offset != pos:
                raise ObjectStoreError(
                    f"chunk {digest[:12]}… of {entry.name}: recorded "
                    f"offset {offset} does not tile the file (at {pos})")
            had = digest in cache
            data = cache.get(digest, nbytes)
            if data is None:
                if had:
                    stats["chunks_corrupt"] += 1
                data = store.get(chunk_key(digest))
                if len(data) != nbytes or \
                        hashlib.sha256(data).hexdigest() != digest:
                    raise ObjectStoreError(
                        f"chunk {digest[:12]}… of {entry.name} is corrupt "
                        f"({len(data)} bytes vs recorded {nbytes})")
                cache.put(digest, data)
                stats["bytes_fetched"] += nbytes
                stats["chunks_fetched"] += 1
            else:
                stats["bytes_cached"] += nbytes
                stats["chunks_cached"] += 1
            f.write(data)
            pos += nbytes
    if os.path.getsize(tmp) != entry.size:
        raise ObjectStoreError(
            f"{entry.name}: reassembled size {os.path.getsize(tmp)} != "
            f"recorded {entry.size}")
    os.replace(tmp, dest)
    return stats

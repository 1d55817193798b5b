"""Object-store clients — the key→blob surface the L4 tier talks to.

The abstraction is S3-shaped (put/get/list/delete plus multipart uploads
and conditional writes) so a real S3/GCS client can slot in behind the
same interface later; the two shipped backends are

    ``LocalFSObjectStore``   keys as files under one root directory — the
                             "bucket on a parallel file system" analogue,
                             durable across processes (the restore tests'
                             crash windows run against it)
    ``MemoryObjectStore``    a dict, for unit tests and fault injection

Semantics every backend guarantees:

- **atomic put**: a reader never observes a torn object (LocalFS stages
  to a ``.tmp-`` sibling and ``os.replace``s it in);
- **conditional put**: ``if_match=<etag>`` fails with
  :class:`PreconditionFailed` unless the stored object's etag matches
  (compare-and-swap — the catalog's epoch guard builds on this), and
  ``if_none_match=True`` fails if the key exists at all (create-only);
- **etags are content hashes** (sha256 hex), so CAS survives process
  restarts — no server-side version counter to lose;
- **multipart/resumable put**: ``create_multipart`` → ``upload_part``
  (idempotent per part number; ``list_parts`` tells a restarted uploader
  which parts already landed) → ``complete_multipart`` assembles the
  object atomically, ``abort_multipart`` discards the staging state.
  Nothing is visible under the key until complete.

A real cloud client (``s3:...``) is deliberately *gated*, not faked:
``make_object_store`` raises a clear error naming the missing dependency,
mirroring how ``Protect(format="hdf5")`` gates on h5py.
"""
from __future__ import annotations

import abc
import hashlib
import os
import shutil
import threading
import uuid
from typing import Dict, List, Optional, Tuple

from repro_torch.chaos import inject as chaos


def content_etag(data: bytes) -> str:
    """Etag = sha256 of content (stable across processes and backends)."""
    return hashlib.sha256(data).hexdigest()


class ObjectStoreError(RuntimeError):
    pass


class PreconditionFailed(ObjectStoreError):
    """A conditional put (``if_match`` / ``if_none_match``) lost the race."""


class ObjectStore(abc.ABC):
    """Key→blob store with CAS puts and multipart uploads."""

    # -- whole-object ops ---------------------------------------------- #

    @abc.abstractmethod
    def put(self, key: str, data: bytes, *, if_match: Optional[str] = None,
            if_none_match: bool = False) -> str:
        """Store ``data`` under ``key``; returns the new etag.

        ``if_match``: only overwrite when the current etag equals it
        (``None`` current → fail).  ``if_none_match``: only create —
        fail when the key exists.  Both raise :class:`PreconditionFailed`."""

    @abc.abstractmethod
    def get(self, key: str) -> bytes:
        """Fetch; raises :class:`ObjectStoreError` when absent."""

    @abc.abstractmethod
    def get_with_etag(self, key: str
                      ) -> Tuple[Optional[bytes], Optional[str]]:
        """Fetch data+etag, or ``(None, None)`` when absent (the CAS read)."""

    @abc.abstractmethod
    def exists(self, key: str) -> bool: ...

    @abc.abstractmethod
    def list(self, prefix: str = "") -> List[str]:
        """All keys under ``prefix``, sorted."""

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        """Idempotent delete (absent key is not an error)."""

    # -- multipart / resumable put ------------------------------------- #

    @abc.abstractmethod
    def create_multipart(self, key: str) -> str:
        """Open a multipart upload for ``key`` → upload id."""

    @abc.abstractmethod
    def upload_part(self, key: str, upload_id: str, part_number: int,
                    data: bytes) -> str:
        """Stage one part (1-based part numbers; re-upload overwrites)."""

    @abc.abstractmethod
    def list_parts(self, key: str, upload_id: str) -> List[int]:
        """Part numbers already staged — the resume point after a crash."""

    @abc.abstractmethod
    def complete_multipart(self, key: str, upload_id: str) -> str:
        """Assemble staged parts (in part-number order) into ``key``
        atomically → etag.  The staging state is discarded."""

    @abc.abstractmethod
    def abort_multipart(self, key: str, upload_id: str) -> None: ...


def _check_key(key: str) -> str:
    if not key or key.startswith("/") or ".." in key.split("/"):
        raise ObjectStoreError(f"invalid object key {key!r}")
    return key


class MemoryObjectStore(ObjectStore):
    """In-memory backend for tests (and fault-injection wrappers)."""

    def __init__(self):
        self._objects: Dict[str, bytes] = {}
        self._mpu: Dict[str, Dict[int, bytes]] = {}
        self._lock = threading.RLock()

    def put(self, key, data, *, if_match=None, if_none_match=False):
        _check_key(key)
        data = chaos.fire(chaos.SITES.OBJSTORE_PUT, exc=ObjectStoreError,
                          data=bytes(data), key=key).data
        with self._lock:
            cur = self._objects.get(key)
            self._check_cond(key, cur, if_match, if_none_match)
            self._objects[key] = bytes(data)
            return content_etag(data)

    @staticmethod
    def _check_cond(key, cur, if_match, if_none_match):
        if if_none_match and cur is not None:
            raise PreconditionFailed(f"{key}: already exists")
        if if_match is not None and (
                cur is None or content_etag(cur) != if_match):
            raise PreconditionFailed(f"{key}: etag mismatch")

    def get(self, key):
        with self._lock:
            if key not in self._objects:
                raise ObjectStoreError(f"no such object: {key}")
            blob = self._objects[key]
        return chaos.fire(chaos.SITES.OBJSTORE_GET, exc=ObjectStoreError,
                          data=blob, key=key).data

    def get_with_etag(self, key):
        with self._lock:
            cur = self._objects.get(key)
            return (None, None) if cur is None else (cur, content_etag(cur))

    def exists(self, key):
        with self._lock:
            return key in self._objects

    def list(self, prefix=""):
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key):
        # chaos site: GC sweeps die here mid-delete; "skip" models a
        # delete that silently never lands (orphaned chunk)
        if chaos.fire(chaos.SITES.OBJSTORE_DELETE, exc=ObjectStoreError,
                      key=key).skipped:
            return
        with self._lock:
            self._objects.pop(key, None)

    def create_multipart(self, key):
        _check_key(key)
        uid = uuid.uuid4().hex
        with self._lock:
            self._mpu[uid] = {}
        return uid

    def upload_part(self, key, upload_id, part_number, data):
        with self._lock:
            self._mpu[upload_id][int(part_number)] = bytes(data)
        return content_etag(data)

    def list_parts(self, key, upload_id):
        with self._lock:
            return sorted(self._mpu.get(upload_id, {}))

    def complete_multipart(self, key, upload_id):
        with self._lock:
            parts = self._mpu.pop(upload_id, None)
            if parts is None:
                raise ObjectStoreError(f"no such upload: {upload_id}")
            blob = b"".join(parts[n] for n in sorted(parts))
            self._objects[key] = blob
            return content_etag(blob)

    def abort_multipart(self, key, upload_id):
        with self._lock:
            self._mpu.pop(upload_id, None)


class LocalFSObjectStore(ObjectStore):
    """Keys as files under one root directory.

    Atomicity comes from ``os.replace`` of a staged ``.tmp-`` sibling;
    conditional puts serialize read-compare-write under a process lock
    plus an ``fcntl`` file lock on ``<root>/.cas.lock``, so CAS holds
    across the threads of one process *and* across processes sharing the
    root (the multi-rank catalog merge).  Internal state (multipart
    staging, the lock file) lives under dot-prefixed names that ``list``
    never reports."""

    _MPU_DIR = ".mpu"
    _LOCK_FILE = ".cas.lock"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, _check_key(key))

    def _write_atomic(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = os.path.join(os.path.dirname(path),
                           f".tmp-{uuid.uuid4().hex}-{os.path.basename(path)}")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    class _FileLock:
        def __init__(self, path: str):
            self._path = path

        def __enter__(self):
            self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR)
            try:
                import fcntl
                fcntl.flock(self._fd, fcntl.LOCK_EX)
            except ImportError:          # pragma: no cover (non-posix)
                pass
            return self

        def __exit__(self, *a):
            try:
                import fcntl
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            except ImportError:          # pragma: no cover
                pass
            os.close(self._fd)

    def _cas_lock(self):
        return self._FileLock(os.path.join(self.root, self._LOCK_FILE))

    def put(self, key, data, *, if_match=None, if_none_match=False):
        path = self._path(key)
        data = chaos.fire(chaos.SITES.OBJSTORE_PUT, exc=ObjectStoreError,
                          data=bytes(data), key=key).data
        if if_match is None and not if_none_match:
            self._write_atomic(path, data)
            return content_etag(data)
        with self._lock, self._cas_lock():
            cur = None
            if os.path.exists(path):
                with open(path, "rb") as f:
                    cur = f.read()
            MemoryObjectStore._check_cond(key, cur, if_match, if_none_match)
            self._write_atomic(path, data)
            return content_etag(data)

    def get(self, key):
        try:
            with open(self._path(key), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            raise ObjectStoreError(f"no such object: {key}") from None
        return chaos.fire(chaos.SITES.OBJSTORE_GET, exc=ObjectStoreError,
                          data=blob, key=key).data

    def get_with_etag(self, key):
        try:
            with open(self._path(key), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None, None
        return data, content_etag(data)

    def exists(self, key):
        return os.path.isfile(self._path(key))

    def list(self, prefix=""):
        out = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            dirnames[:] = [d for d in dirnames if not d.startswith(".")]
            for name in filenames:
                if name.startswith("."):
                    continue             # lock file / staged tmp writes
                key = name if rel == "." else f"{rel}/{name}".replace(
                    os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key):
        if chaos.fire(chaos.SITES.OBJSTORE_DELETE, exc=ObjectStoreError,
                      key=key).skipped:
            return
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    # -- multipart ------------------------------------------------------ #

    def _mpu_dir(self, upload_id: str) -> str:
        return os.path.join(self.root, self._MPU_DIR, upload_id)

    def create_multipart(self, key):
        _check_key(key)
        uid = uuid.uuid4().hex
        os.makedirs(self._mpu_dir(uid), exist_ok=True)
        with open(os.path.join(self._mpu_dir(uid), "key"), "w") as f:
            f.write(key)
        return uid

    def upload_part(self, key, upload_id, part_number, data):
        d = self._mpu_dir(upload_id)
        if not os.path.isdir(d):
            raise ObjectStoreError(f"no such upload: {upload_id}")
        self._write_atomic(os.path.join(d, f"part-{int(part_number):08d}"),
                           bytes(data))
        return content_etag(data)

    def list_parts(self, key, upload_id):
        d = self._mpu_dir(upload_id)
        if not os.path.isdir(d):
            return []
        return sorted(int(n[len("part-"):]) for n in os.listdir(d)
                      if n.startswith("part-"))

    def complete_multipart(self, key, upload_id):
        d = self._mpu_dir(upload_id)
        parts = self.list_parts(key, upload_id)
        if not os.path.isdir(d) or not parts:
            raise ObjectStoreError(f"no parts staged for upload {upload_id}")
        blob = b"".join(
            open(os.path.join(d, f"part-{n:08d}"), "rb").read()
            for n in parts)
        self._write_atomic(self._path(key), blob)
        shutil.rmtree(d, ignore_errors=True)
        return content_etag(blob)

    def abort_multipart(self, key, upload_id):
        shutil.rmtree(self._mpu_dir(upload_id), ignore_errors=True)


def make_object_store(url: str) -> ObjectStore:
    """``file:<dir>`` → :class:`LocalFSObjectStore`; ``mem:`` → a fresh
    :class:`MemoryObjectStore`; ``s3:``/``gs:`` are gated on their missing
    client libraries (clear error, not a fake)."""
    if url.startswith("file:"):
        return LocalFSObjectStore(url[len("file:"):])
    if url.startswith("mem:"):
        return MemoryObjectStore()
    if url.startswith(("s3:", "gs:")):
        raise ObjectStoreError(
            f"object store {url!r} needs a cloud client (boto3 / "
            f"google-cloud-storage), which this environment does not ship; "
            f"use file:<dir> — the interface is S3-shaped so a real client "
            f"can slot in behind it")
    # a bare path is a local root
    if url.startswith(("/", "./")) or os.path.isdir(url):
        return LocalFSObjectStore(url)
    raise ObjectStoreError(f"unrecognized object-store url {url!r}")

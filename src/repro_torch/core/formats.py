"""CHK5 — an HDF5-inspired self-describing hierarchical checkpoint container.

The paper's §4.2.4 stores checkpoints in HDF5 so resilience data doubles as
analyzable scientific data. h5py is not available in this container, so we
implement the format from scratch with the same semantics:

- hierarchical **groups** ("/data/params/...", "/delta/...", ...)
- typed **datasets** (dtype, shape, crc32, byte offset) supporting partial
  (byte-range) reads — required for elastic resharding restores
- **attributes** on groups and datasets (JSON-serializable)
- a msgpack **index** at the tail, so a file is readable without scanning

Sharded stores spread one rank payload over a *set* of containers
(core/resharding.py): the main ``rank<r>.chk5`` holds a ``shardidx/<name>``
dataset per sharded leaf (chunk offsets/shapes as data; global shape,
dtype and chunk file/dataset names as attributes) while the shard payloads
live as ``shard/<name>/shard-<k>`` datasets in sibling
``rank<r>.shard<j>.chk5`` files, written in parallel.  Restores read only
the byte ranges overlapping the regions a target device needs
(``read_range``).

Layout::

    [8B magic "CHK5\\x00\\x01\\x00\\x00"]
    [dataset payloads ... raw C-order bytes]
    [msgpack index]
    [8B u64 index length][4B crc32(index)][8B magic tail "5KHC...."]

Writers are append-only; readers are mmap-free (seek+read) so partial
restores touch only the bytes they need. ``python -m repro.tools.chkls``
pretty-prints any CHK5 file (the "use any HDF5 tool" analogue).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, List, Optional

import msgpack
import numpy as np
import torch

MAGIC = b"CHK5\x00\x01\x00\x00"
TAIL = b"5KHC\x00\x01\x00\x00"

try:  # numpy has no native bfloat16; jax ships ml_dtypes
    import ml_dtypes
    _EXTRA_DTYPES = {
        "bfloat16": np.dtype(ml_dtypes.bfloat16),
        "float8_e4m3fn": np.dtype(ml_dtypes.float8_e4m3fn),
        "float8_e5m2": np.dtype(ml_dtypes.float8_e5m2),
    }
except ImportError:  # pragma: no cover
    _EXTRA_DTYPES = {}


def dtype_to_str(dt) -> str:
    dt = np.dtype(dt)
    for name, cand in _EXTRA_DTYPES.items():
        if dt == cand:
            return name
    return dt.str


def str_to_dtype(s: str) -> np.dtype:
    if s in _EXTRA_DTYPES:
        return _EXTRA_DTYPES[s]
    return np.dtype(s)


#: precision clause values → canonical dtype strings (the same table the
#: directive layer validates ``Protect(precision=...)`` against)
PRECISIONS = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f16": "<f2", "fp16": "<f2", "float16": "<f2",
    "f32": "<f4", "fp32": "<f4", "float32": "<f4",
}


def resolve_precision(name: str) -> np.dtype:
    """``Protect(precision=...)`` clause value → numpy dtype.

    Accepts the clause aliases ("bf16", "fp16", "f32", …) and canonical
    dtype strings.  bf16/fp8 need ml_dtypes; a missing dependency
    surfaces as a clear error rather than a silent fallback."""
    canonical = PRECISIONS.get(name, name)
    if canonical == "bfloat16" and "bfloat16" not in _EXTRA_DTYPES:
        raise ValueError(
            "precision='bf16' needs ml_dtypes for a numpy bfloat16; "
            "it is not importable in this environment")
    return str_to_dtype(canonical)


# -------------------------------------------------------------------------- #
# torch ⇄ numpy bridge: identical bytes, dtype and shape
# -------------------------------------------------------------------------- #

#: torch dtypes numpy has no type of its own for → (CHK5 dtype name, the
#: same-width integer types their bytes travel through).  ``Tensor.numpy()``
#: raises for these, so they cross as an integer view.
_VIA_INT = {
    torch.bfloat16: ("bfloat16", torch.int16, np.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8),
}
_VIA_INT_BY_NAME = {v[0]: (k,) + v[1:] for k, v in _VIA_INT.items()}


def _extra_np_dtype(name: str) -> np.dtype:
    if name not in _EXTRA_DTYPES:
        raise ValueError(f"dtype {name} needs ml_dtypes for a numpy "
                         "counterpart; it is not importable here")
    return _EXTRA_DTYPES[name]


def torch_dtype_to_str(dt: torch.dtype) -> str:
    """CHK5 dtype string of a torch dtype (equal to :func:`dtype_to_str` of
    the numpy dtype its host copy gets; needs no ml_dtypes)."""
    if dt in _VIA_INT:
        return _VIA_INT[dt][0]
    return torch.empty(0, dtype=dt).numpy().dtype.str


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a numpy array with the same bytes.  The
    device→host copy has completed when this returns, and a CPU tensor is
    copied too: the result never aliases storage the caller can update."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype not in _VIA_INT:
        return t.numpy()
    name, int_t, _ = _VIA_INT[t.dtype]
    return t.view(int_t).numpy().view(_extra_np_dtype(name))


def numpy_to_tensor(a: np.ndarray, device: Any = "cpu") -> torch.Tensor:
    """A tensor on ``device`` holding ``a``'s bytes, dtype and shape (never
    a view of ``a``)."""
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    name = dtype_to_str(a.dtype)
    if name in _VIA_INT_BY_NAME:
        torch_dt, _, int_np = _VIA_INT_BY_NAME[name]
        a = a.view(int_np)
    else:
        torch_dt = None
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a).to(device, copy=True)
    return t.view(torch_dt) if torch_dt is not None else t


class CHK5Writer:
    def __init__(self, path: str, fsync: bool = True, sink=None):
        """``fsync=False`` defers durability to the caller (multi-file
        shard sets fsync the whole batch once all writers finished — one
        journal settle instead of one per file).

        ``sink`` is an optional streaming byte sink (the fused Pack →
        chunk-stream path, ``repro.objstore.chunks.ChunkStream``): every
        byte written to the file is teed into it in order, dataset starts
        are signaled as boundary hints (``cut``), datasets with an entry
        in :attr:`region_keys` are bracketed as digest-keyed regions
        (``begin_region``/``end_region``), and ``close`` finishes the
        sink — so by the time the staged file is durable, its chunk
        uploads are already in flight and nothing re-reads it."""
        self.path = path
        self._fsync = fsync
        self._sink = sink
        #: dataset name → layout-reuse key (set by the pipeline for FULL
        #: leaves whose device-side digests identify their bytes)
        self.region_keys: Dict[str, str] = {}
        self._f = open(path, "wb")
        self._write(MAGIC)
        self._index: Dict[str, Any] = {"groups": {}, "datasets": {}, "attrs": {}}
        self._closed = False

    def _write(self, payload) -> None:
        self._f.write(payload)
        if self._sink is not None:
            self._sink.write(payload)

    # ------------------------------------------------------------------ #

    def set_attrs(self, group: str, attrs: Dict[str, Any]) -> None:
        self._index["attrs"].setdefault(group, {}).update(attrs)

    def write_dataset(self, name: str, arr: np.ndarray,
                      attrs: Optional[Dict[str, Any]] = None) -> None:
        """``name`` is a slash path, e.g. "data/params/embed"."""
        arr = np.asarray(arr)
        shape = list(arr.shape)              # ascontiguousarray promotes 0-d
        arr = np.ascontiguousarray(arr)
        off = self._f.tell()
        try:
            # zero-copy write path: the array's own buffer feeds both the
            # file write and the crc (a tobytes() copy of a large leaf is
            # pure overhead on the Pack path)
            payload = memoryview(arr).cast("B")
        except (TypeError, ValueError):
            # non-buffer dtypes (ml_dtypes bf16/fp8) fall back to a copy
            payload = arr.tobytes()
        region = self._sink is not None and \
            self.region_keys.get(name.strip("/"))
        if region:
            self._sink.begin_region(region)
        elif self._sink is not None:
            self._sink.cut()
        self._write(payload)
        if region:
            self._sink.end_region()
        parts = name.strip("/").split("/")
        for i in range(1, len(parts)):
            self._index["groups"].setdefault("/".join(parts[:i]), {})
        self._index["datasets"][name.strip("/")] = {
            "offset": off,
            "nbytes": arr.nbytes,
            "dtype": dtype_to_str(arr.dtype),
            "shape": shape,
            "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
            "attrs": attrs or {},
        }

    def write_bytes(self, name: str, payload: bytes,
                    attrs: Optional[Dict[str, Any]] = None) -> None:
        off = self._f.tell()
        if self._sink is not None:
            self._sink.cut()
        self._write(payload)
        self._index["datasets"][name.strip("/")] = {
            "offset": off,
            "nbytes": len(payload),
            "dtype": "bytes",
            "shape": [len(payload)],
            "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
            "attrs": attrs or {},
        }

    def close(self) -> None:
        if self._closed:
            return
        idx = msgpack.packb(self._index, use_bin_type=True)
        self._write(idx)
        self._write(struct.pack("<Q", len(idx)))
        self._write(struct.pack("<I", zlib.crc32(idx) & 0xFFFFFFFF))
        self._write(TAIL)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
        self._f.close()
        self._closed = True
        if self._sink is not None:
            # the file is complete: freeze the stream's chunk metadata
            # (uploads keep draining; Place/Commit collect and join them)
            self._sink.finish()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class CHK5CorruptionError(RuntimeError):
    pass


class CHK5Reader:
    def __init__(self, path, verify: bool = False):
        """``path``: filesystem path or a seekable binary file object."""
        if hasattr(path, "seek"):
            self.path = "<memory>"
            self._f = path
            self._f.seek(0)
        else:
            self.path = path
            self._f = open(path, "rb")
        head = self._f.read(8)
        if head != MAGIC:
            raise CHK5CorruptionError(f"{path}: bad magic {head!r}")
        self._f.seek(-20, os.SEEK_END)
        tail = self._f.read(20)
        idx_len = struct.unpack("<Q", tail[:8])[0]
        idx_crc = struct.unpack("<I", tail[8:12])[0]
        if tail[12:] != TAIL:
            raise CHK5CorruptionError(f"{path}: bad tail magic")
        self._f.seek(-(20 + idx_len), os.SEEK_END)
        idx_raw = self._f.read(idx_len)
        if (zlib.crc32(idx_raw) & 0xFFFFFFFF) != idx_crc:
            raise CHK5CorruptionError(f"{path}: index crc mismatch")
        self._index = msgpack.unpackb(idx_raw, raw=False)
        if verify:
            self.verify_all()

    # ------------------------------------------------------------------ #

    def datasets(self) -> List[str]:
        return sorted(self._index["datasets"])

    def groups(self) -> List[str]:
        return sorted(self._index["groups"])

    def attrs(self, group: str = "") -> Dict[str, Any]:
        return self._index["attrs"].get(group, {})

    def info(self, name: str) -> Dict[str, Any]:
        return self._index["datasets"][name.strip("/")]

    def read_dataset(self, name: str, verify: bool = True) -> np.ndarray:
        m = self.info(name)
        self._f.seek(m["offset"])
        raw = self._f.read(m["nbytes"])
        if verify and (zlib.crc32(raw) & 0xFFFFFFFF) != m["crc32"]:
            raise CHK5CorruptionError(f"{self.path}:{name}: payload crc mismatch")
        if m["dtype"] == "bytes":
            raise TypeError(f"{name} is a raw-bytes dataset; use read_bytes")
        return np.frombuffer(raw, dtype=str_to_dtype(m["dtype"])).reshape(m["shape"])

    def read_bytes(self, name: str, verify: bool = True) -> bytes:
        m = self.info(name)
        self._f.seek(m["offset"])
        raw = self._f.read(m["nbytes"])
        if verify and (zlib.crc32(raw) & 0xFFFFFFFF) != m["crc32"]:
            raise CHK5CorruptionError(f"{self.path}:{name}: payload crc mismatch")
        return raw

    def read_range(self, name: str, start_elem: int, n_elems: int) -> np.ndarray:
        """Partial read of a flattened C-order element range (no crc check —
        used by elastic resharding to touch only required bytes)."""
        m = self.info(name)
        dt = str_to_dtype(m["dtype"])
        self._f.seek(m["offset"] + start_elem * dt.itemsize)
        raw = self._f.read(n_elems * dt.itemsize)
        return np.frombuffer(raw, dtype=dt)

    def verify_all(self) -> None:
        for name, m in self._index["datasets"].items():
            self._f.seek(m["offset"])
            raw = self._f.read(m["nbytes"])
            if (zlib.crc32(raw) & 0xFFFFFFFF) != m["crc32"]:
                raise CHK5CorruptionError(f"{self.path}:{name}: crc mismatch")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

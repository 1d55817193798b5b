"""Shard files and elastic restore: state saved under one world layout,
restored onto another (node-count changes after failures, pod rescale),
with the on-disk layout of the JAX package's ``core/resharding.py``, so
the files of either package read in the other byte for byte.

Write side (the pipeline's Pack stage calls in here):

- A :class:`ShardSnapshot` is the Plan-stage snapshot of one sharded leaf:
  global metadata plus its distinct chunks (:class:`ShardChunk`), each a
  host numpy array or a tensor whose device→host copy completes when Pack
  writes it.
- :func:`write_shard_files` writes the chunks as ``shard-<k>``
  sub-datasets spread over ``rank<r>.shard<j>.chk5`` files (one writer
  thread per file, in parallel) and records the index — global shape,
  chunk offsets, chunk file/dataset names — as a ``shardidx/<name>``
  dataset in the rank's main container.

Read side:

- :class:`ShardedLeafRef` is the lazy handle the restore path hands out
  for a sharded leaf: index metadata + resolved chunk files.  It reads
  arbitrary index boxes by touching only the overlapping byte ranges of
  each chunk file (CHK5 partial reads).  int8-compressed chunks decode
  transparently (:func:`read_chunk_slab`).
- :class:`ElasticLoader` assembles arbitrary regions of the global arrays
  from any number of chunk files: the multi-dim ``shard/<name>/shard-<k>``
  layout and the axis-0 ``shard/<name>`` layout of :func:`save_sharded`
  (the DP/ZeRO rank-file path).

Every read returns host numpy arrays; :func:`load_named_onto` and TCL put
them on the target device.  Shard-local snapshots of ``DTensor`` leaves
(``split_sharded`` finds none yet: every leaf gathers), assembly onto a
``DeviceMesh`` and the mesh helpers are ROADMAP Queue 1, item 5.
"""
from __future__ import annotations

import glob
import os
import re
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import (
    CHK5CorruptionError,
    CHK5Reader,
    CHK5Writer,
    as_numpy,
    numpy_to_tensor,
    resolve_precision,
    str_to_dtype,
)


# -------------------------------------------------------------------------- #
# shard-local snapshots (write side)
# -------------------------------------------------------------------------- #


def _normalize_index(index, shape: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """A shard index (tuple of slices, possibly ``slice(None)``) →
    canonical ((start, stop), ...) per dim."""
    out = []
    for dim, sl in zip(shape, index):
        start = 0 if sl.start is None else int(sl.start)
        stop = int(dim) if sl.stop is None else int(sl.stop)
        out.append((start, stop))
    return tuple(out)


@dataclass
class ShardChunk:
    """One owned shard of one leaf: its global placement plus the data — a
    tensor until :meth:`materialize` copies it to the host, an
    ``np.ndarray`` afterwards."""
    offset: Tuple[int, ...]
    shape: Tuple[int, ...]
    data: Any

    def materialize(self) -> np.ndarray:
        if not isinstance(self.data, np.ndarray):
            self.data = as_numpy(self.data)
        return self.data

    @property
    def nbytes(self) -> int:
        if isinstance(self.data, torch.Tensor):
            itemsize = self.data.element_size()
        else:
            itemsize = np.dtype(self.data.dtype).itemsize
        return int(np.prod(self.shape)) * itemsize


@dataclass
class ShardSnapshot:
    """The Plan-stage snapshot of one sharded leaf: global metadata plus
    the distinct owned chunks."""
    dtype: str
    global_shape: Tuple[int, ...]
    chunks: List[ShardChunk]

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)


def split_sharded(named: Dict[str, Any]
                  ) -> Tuple[Dict[str, Any], Dict[str, ShardSnapshot]]:
    """Partition protected leaves into (gather-snapshot leaves, shard-local
    snapshots).  Every leaf gathers here: the port has no sharded tensors
    yet (ROADMAP Queue 1, item 5)."""
    return dict(named), {}


# -------------------------------------------------------------------------- #
# sharded CHK5 layout (Pack side)
# -------------------------------------------------------------------------- #

_SHARD_FILE_RE = re.compile(r"^rank(\d+)\.shard(\d+)\.chk5$")

#: side-channel group for shard-chunk codec state (int8 block scales) —
#: same convention as the gathered-leaf ``codecaux/`` group in core/tiers
_CHUNK_AUX = "codecaux"


def shard_file_name(prefix: str, j: int) -> str:
    return f"{prefix}.shard{j}.chk5"


def _chunk_dataset(name: str, k: int) -> str:
    return f"shard/{name}/shard-{k}"


def _chunk_scale_dataset(ds: str) -> str:
    return f"{_CHUNK_AUX}/{ds}/scale"


def _precision_dtype(spec, arr_dtype) -> Optional[np.dtype]:
    """The store-side dtype a ``precision`` clause asks for, or None when
    it does not apply (no clause / non-float leaf)."""
    if spec is None or spec.precision is None:
        return None
    if not np.issubdtype(np.dtype(arr_dtype), np.floating):
        return None
    return resolve_precision(spec.precision)


def write_shard_files(stage_dir: str, prefix: str, index_writer: CHK5Writer,
                      sharded: Dict[str, ShardSnapshot],
                      specs: Optional[Dict[str, Any]] = None,
                      default_kind: str = "FULL",
                      max_writers: int = 4,
                      sink_factory=None) -> List[str]:
    """Write every owned chunk as a ``shard-<k>`` sub-dataset spread over
    ``<prefix>.shard<j>.chk5`` files in ``stage_dir`` — one writer thread
    per file, running in parallel — and record each leaf's shard index in
    ``index_writer`` (the rank's main container) as a ``shardidx/<name>``
    dataset:

    - the dataset itself is an int64 ``(n_chunks, 2·ndim)`` table of
      ``offset ‖ shape`` rows;
    - attributes carry ``global_shape``, the original ``dtype``,
      ``n_chunks`` and the per-chunk ``files``/``datasets`` names, plus
      the governing clause attrs.

    Chunks materialize (completing their device→host copy) immediately
    before their dataset write.  Returns the shard file paths; all files
    land in the staging dir, so the multi-file set commits (or vanishes)
    atomically with the container.

    A governing ``compress="int8"`` clause applies per chunk (float
    leaves only): the chunk ships as a flat quantized payload + block
    scales (``codecaux/…/scale`` in the same shard file) with a
    dequantized crc32 recorded for the load-side verify; a chunk whose
    roundtrip error exceeds ``max_error`` falls back to raw on its own
    (``codec_fallback`` attr).

    ``sink_factory(basename)`` (optional) supplies a streaming chunk sink
    per shard file (the fused Pack → upload path): sinks are created here
    on the caller's thread — registration mutates tier state — and each
    writer thread only feeds its own sink through ``CHK5Writer``.
    """
    from repro_torch.core.tiers import clause_attrs, int8_encode_array
    specs = specs or {}
    work: List[Tuple[str, int, ShardChunk, Optional[np.dtype], Any, bool]] = []
    for name in sorted(sharded):
        snap = sharded[name]
        spec = specs.get(name)
        cast = _precision_dtype(spec, str_to_dtype(snap.dtype))
        codec = (spec is not None and getattr(spec, "compress", None) == "int8"
                 and np.issubdtype(str_to_dtype(snap.dtype), np.floating))
        for k, chunk in enumerate(snap.chunks):
            work.append((name, k, chunk, cast, spec, codec))

    n_files = max(1, min(int(max_writers), len(work)))
    paths = [os.path.join(stage_dir, shard_file_name(prefix, j))
             for j in range(n_files)]
    assignment: Dict[Tuple[str, int], int] = {
        (name, k): i % n_files for i, (name, k, *_rest) in enumerate(work)}
    sinks = [sink_factory(os.path.basename(p)) if sink_factory else None
             for p in paths]

    def write_one(j: int) -> None:
        # durability is batched below: all shard files fsync back-to-back
        # after every writer finished (one journal settle, not one per file)
        with CHK5Writer(paths[j], fsync=False, sink=sinks[j]) as w:
            w.set_attrs("", {"shard_file": True,
                             "of": f"{prefix}.chk5"})
            for i, (name, k, chunk, cast, spec, codec) in enumerate(work):
                if i % n_files != j:
                    continue
                orig = chunk.materialize()
                arr = orig
                if cast is not None and arr.dtype != cast:
                    arr = arr.astype(cast)
                ds = _chunk_dataset(name, k)
                attrs = {
                    "offset": [int(x) for x in chunk.offset],
                    "global_shape": [int(x) for x in
                                     sharded[name].global_shape],
                    "dtype": sharded[name].dtype,
                }
                if codec:
                    q, scale, cattrs = int8_encode_array(
                        arr, orig, getattr(spec, "max_error", None))
                    attrs.update(cattrs)
                    if q is not None:
                        # flat int8 payload: element e of the chunk is
                        # element e of q, so region reads stay element-
                        # range reads (scales decoded per block)
                        attrs["shape"] = [int(x) for x in chunk.shape]
                        w.write_dataset(ds, q.reshape(-1), attrs)
                        w.write_dataset(_chunk_scale_dataset(ds), scale)
                        continue
                w.write_dataset(ds, arr, attrs)

    # the file count (the on-disk layout) is deterministic; only the thread
    # count adapts to the machine's cores
    n_workers = max(1, min(n_files, os.cpu_count() or 1))
    if n_workers == 1:
        for j in range(n_files):
            write_one(j)
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            for f in [ex.submit(write_one, j) for j in range(n_files)]:
                f.result()              # propagate the first writer failure
    for p in paths:                     # batched durability (see write_one)
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    for name in sorted(sharded):
        snap = sharded[name]
        spec = specs.get(name)
        ndim = len(snap.global_shape)
        table = np.zeros((len(snap.chunks), 2 * max(ndim, 1)), np.int64)
        for k, chunk in enumerate(snap.chunks):
            table[k, :ndim] = chunk.offset
            table[k, ndim:2 * ndim] = chunk.shape
        attrs = dict(clause_attrs(spec, default_kind),
                     global_shape=[int(x) for x in snap.global_shape],
                     dtype=snap.dtype,
                     n_chunks=len(snap.chunks),
                     files=[os.path.basename(
                         paths[assignment[(name, k)]])
                         for k in range(len(snap.chunks))],
                     datasets=[_chunk_dataset(name, k)
                               for k in range(len(snap.chunks))])
        if spec is not None and getattr(spec, "compress", None):
            if np.issubdtype(str_to_dtype(snap.dtype), np.floating):
                # informational on the index: the per-chunk attrs are
                # authoritative (a chunk may have fallen back on its own)
                attrs["codec"] = spec.compress
            else:
                attrs["codec_fallback"] = (
                    f"{spec.compress}: non-float leaf ({snap.dtype})")
        if spec is not None and spec.precision is not None and \
                _precision_dtype(spec, str_to_dtype(snap.dtype)) is None:
            attrs.pop("precision", None)
            attrs["precision_fallback"] = (
                f"{spec.precision}: non-float leaf ({snap.dtype})")
        index_writer.write_dataset(f"shardidx/{name}", table, attrs)
    return paths


# -------------------------------------------------------------------------- #
# lazy sharded-leaf restore (read side)
# -------------------------------------------------------------------------- #


@dataclass
class _ChunkRef:
    path: str
    dataset: str
    offset: Tuple[int, ...]
    shape: Tuple[int, ...]


def read_chunk_slab(rd: CHK5Reader, ds: str, chunk_shape: Sequence[int],
                    r_lo: int, r_hi: int) -> np.ndarray:
    """Read leading-dim rows [r_lo, r_hi) of one shard chunk dataset,
    decoding the chunk codec when present — the one slab reader behind
    ``ShardedLeafRef.read_index`` and ``ElasticLoader.read_region``.

    int8 chunks hold a flat quantized payload plus per-block scales in a
    ``codecaux/.../scale`` sibling dataset; a partial read touches only the
    overlapping q elements and the covering scale blocks.  A read that
    covers the whole chunk also verifies the recorded dequantized crc32
    (partial reads skip crc like every ``read_range``)."""
    chunk_shape = tuple(int(x) for x in chunk_shape)
    row_elems = int(np.prod(chunk_shape[1:])) if len(chunk_shape) > 1 else 1
    e_lo, n = r_lo * row_elems, (r_hi - r_lo) * row_elems
    attrs = rd.info(ds).get("attrs", {})
    if attrs.get("codec") != "int8":
        return rd.read_range(ds, e_lo, n)
    block = int(attrs.get("codec_block", 1024))
    out = rd.read_range(ds, e_lo, n).astype(np.float32)
    if n:
        b_lo = e_lo // block
        b_hi = (e_lo + n - 1) // block + 1
        scale = np.asarray(rd.read_range(_chunk_scale_dataset(ds),
                                         b_lo, b_hi - b_lo), np.float32)
        out *= scale[(e_lo + np.arange(n)) // block - b_lo]
    rows = chunk_shape[0] if chunk_shape else 1
    if r_lo == 0 and r_hi == rows and "roundtrip_crc32" in attrs:
        back = out.reshape(chunk_shape).astype(str_to_dtype(attrs["dtype"]))
        got = zlib.crc32(np.ascontiguousarray(back).tobytes()) & 0xFFFFFFFF
        if got != attrs["roundtrip_crc32"]:
            raise CHK5CorruptionError(
                f"{rd.path}:{ds}: int8 chunk roundtrip mismatch "
                f"(crc {got:#x} != recorded {attrs['roundtrip_crc32']:#x})")
        return back
    return out


def _clip_box(box, offset, shape):
    """Intersect a chunk (offset/shape) with a requested box → (selector
    into the output, selector into the chunk), or None when disjoint."""
    sel_out: List[slice] = []
    sel_chunk: List[slice] = []
    for (lo, hi), off, dim in zip(box, offset, shape):
        t_lo, t_hi = max(lo, off), min(hi, off + dim)
        if t_lo >= t_hi:
            return None
        sel_out.append(slice(t_lo - lo, t_hi - lo))
        sel_chunk.append(slice(t_lo - off, t_hi - off))
    return tuple(sel_out), tuple(sel_chunk)


def _assemble_box(box, dtype, chunks, read_slab, label: str,
                  exc_cls=ValueError) -> np.ndarray:
    """Assemble global box ``box`` from overlapping chunk reads.

    ``chunks`` yields ``(offset, shape, handle)``; ``read_slab(handle,
    r_lo, r_hi)`` returns the chunk's leading-dim rows [r_lo, r_hi) as a
    flat array (shards are C-order, so a dim-0 range is one contiguous
    byte range).  Chunks may *overlap* (replicated shards appearing in
    several merged rank files — each copy holds the same values); a fill
    mask verifies complete coverage, so overlaps neither double-count nor
    mask a hole."""
    out_shape = tuple(hi - lo for lo, hi in box)
    out = np.empty(out_shape, dtype)
    filled = np.zeros(out_shape, np.bool_)
    for offset, shape, handle in chunks:
        hit = _clip_box(box, offset, shape)
        if hit is None:
            continue
        sel_out, sel_chunk = hit
        r_lo = sel_chunk[0].start if sel_chunk else 0
        r_hi = sel_chunk[0].stop if sel_chunk else 1
        slab = read_slab(handle, r_lo, r_hi)
        slab = slab.reshape((r_hi - r_lo,) + tuple(shape[1:]))
        piece = slab[(slice(None),) + sel_chunk[1:]]
        if piece.dtype != dtype:
            piece = piece.astype(dtype)       # precision cast-back
        out[sel_out] = piece
        filled[sel_out] = True
    if not filled.all():
        missing = int(filled.size - np.count_nonzero(filled))
        raise exc_cls(
            f"{label}: box {box} not fully covered "
            f"({missing} of {filled.size} elements missing)")
    return out


class ShardedLeafRef:
    """Lazy handle to one sharded leaf of a committed checkpoint: the
    shard index plus resolved chunk files.  ``read_index`` assembles any
    index box touching only the overlapping leading-dim slabs of each
    chunk file; ``materialize`` assembles the full global array."""

    def __init__(self, name: str, dtype: str, shape: Sequence[int],
                 chunks: List[_ChunkRef],
                 precision: Optional[str] = None):
        self.name = name
        self.dtype = str_to_dtype(dtype)          # restore target dtype
        self.shape = tuple(int(x) for x in shape)
        self.chunks = chunks
        self.precision = precision                # stored-cast marker

    def __repr__(self) -> str:
        return (f"ShardedLeafRef({self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype.str}, chunks={len(self.chunks)})")

    def _box(self, index) -> Tuple[Tuple[int, int], ...]:
        if index is None:
            return tuple((0, d) for d in self.shape)
        return _normalize_index(index, self.shape)

    def read_index(self, index=None,
                   _readers: Optional[Dict[str, CHK5Reader]] = None
                   ) -> np.ndarray:
        """Assemble global box ``index`` (tuple of slices; None → all)
        from the overlapping chunks, reading only overlapping slabs."""
        readers = {} if _readers is None else _readers

        def read_slab(c: _ChunkRef, r_lo: int, r_hi: int) -> np.ndarray:
            rd = readers.get(c.path)
            if rd is None:
                rd = readers[c.path] = CHK5Reader(c.path)
            return read_chunk_slab(rd, c.dataset, c.shape, r_lo, r_hi)

        try:
            return _assemble_box(
                self._box(index), self.dtype,
                ((c.offset, c.shape, c) for c in self.chunks),
                read_slab, self.name, exc_cls=CHK5CorruptionError)
        finally:
            if _readers is None:
                for rd in readers.values():
                    rd.close()

    def materialize(self) -> np.ndarray:
        """The full global array on the host."""
        return self.read_index(None)


def resolve_shard_refs(rd, dirs: Sequence[str], rank: int
                       ) -> Optional[Dict[str, ShardedLeafRef]]:
    """Resolve every ``shardidx/<name>`` dataset of a rank container into
    a :class:`ShardedLeafRef`, locating each chunk file across the
    candidate checkpoint dirs (the file itself, or a partner replica
    ``rank<h>.partner<rank>.shard<j>.chk5``).  Returns None when any
    chunk file is missing or fails CHK5 validation — an incomplete shard
    set makes the whole checkpoint non-restorable (the caller falls back
    to an older id or another tier)."""
    idx_datasets = [ds for ds in rd.datasets() if ds.startswith("shardidx/")]
    if not idx_datasets:
        return {}
    out: Dict[str, ShardedLeafRef] = {}
    resolved: Dict[str, Optional[str]] = {}
    valid: Dict[str, bool] = {}

    def find(basename: str) -> Optional[str]:
        if basename in resolved:
            return resolved[basename]
        path = None
        m = _SHARD_FILE_RE.match(basename)
        for d in dirs:
            p = os.path.join(d, basename)
            if os.path.exists(p):
                path = p
                break
            if m is not None:
                hits = glob.glob(os.path.join(
                    d, f"rank*.partner{m.group(1)}.shard{m.group(2)}.chk5"))
                if hits:
                    path = sorted(hits)[0]
                    break
        resolved[basename] = path
        return path

    def ok(path: str) -> bool:
        if path not in valid:
            try:
                CHK5Reader(path).close()
                valid[path] = True
            except (OSError, CHK5CorruptionError):
                valid[path] = False
        return valid[path]

    for ds in idx_datasets:
        name = ds[len("shardidx/"):]
        meta = rd.info(ds)["attrs"]
        table = rd.read_dataset(ds)
        gshape = [int(x) for x in meta["global_shape"]]
        ndim = len(gshape)
        chunks: List[_ChunkRef] = []
        for k in range(int(meta["n_chunks"])):
            path = find(meta["files"][k])
            if path is None or not ok(path):
                return None
            row = table[k]
            chunks.append(_ChunkRef(
                path=path, dataset=meta["datasets"][k],
                offset=tuple(int(x) for x in row[:ndim]),
                shape=tuple(int(x) for x in row[ndim:2 * ndim])))
        out[name] = ShardedLeafRef(
            name, meta["dtype"], gshape, chunks,
            precision=meta.get("precision"))
    return out


# -------------------------------------------------------------------------- #
# rank-file elastic restore (multi-process DP/ZeRO layout)
# -------------------------------------------------------------------------- #


def shard_bounds(n_rows: int, world: int, rank: int) -> Tuple[int, int]:
    """Even axis-0 partition with remainder spread over the first ranks."""
    base, rem = divmod(n_rows, world)
    lo = rank * base + min(rank, rem)
    hi = lo + base + (1 if rank < rem else 0)
    return lo, hi


def save_sharded(path: str, named_global_slices: Dict[str, Any],
                 offsets: Dict[str, int], global_shapes: Dict[str, List[int]],
                 meta: Optional[Dict[str, Any]] = None) -> None:
    """Write this rank's axis-0 chunks (+ index metadata) into one CHK5
    file (the per-rank layout; the pipeline's store path emits the
    multi-dim ``shard-<k>`` layout via :func:`write_shard_files`).  A
    tensor slice is copied to the host as it is written."""
    with CHK5Writer(path) as w:
        w.set_attrs("", dict(meta or {}, sharded=True))
        for name, arr in named_global_slices.items():
            w.write_dataset(f"shard/{name}", as_numpy(arr), {
                "row_offset": int(offsets[name]),
                "global_shape": [int(x) for x in global_shapes[name]],
            })


class ElasticLoader:
    """Assemble arbitrary regions of the global arrays from chunk files.

    Understands both shard layouts:

    - ``shard/<name>/shard-<k>`` datasets with an ``offset`` attr (the
      pipeline's multi-dim shard files), and
    - ``shard/<name>`` datasets with a ``row_offset`` attr (axis-0
      chunking from :func:`save_sharded`).
    """

    def __init__(self, files: List[str]):
        self.readers = [CHK5Reader(f) for f in files]
        self._paths = list(files)
        # name → [(reader, dataset, offset tuple, shape tuple, dtype, gshape)]
        self.chunks: Dict[str, List[tuple]] = {}
        for rd, path in zip(self.readers, self._paths):
            for ds in rd.datasets():
                if not ds.startswith("shard/"):
                    continue
                m = rd.info(ds)
                a = m["attrs"]
                if "offset" in a:                   # multi-dim chunk
                    name = ds[len("shard/"):].rsplit("/", 1)[0]
                    offset = tuple(int(x) for x in a["offset"])
                elif "row_offset" in a:             # axis-0 chunk
                    name = ds[len("shard/"):]
                    offset = (int(a["row_offset"]),) + \
                        (0,) * (len(m["shape"]) - 1)
                else:
                    continue
                gshape = [int(x) for x in a["global_shape"]]
                # codec chunks store a flat quantized payload; the logical
                # chunk shape rides the attrs
                shp = tuple(int(x) for x in a.get("shape", m["shape"]))
                self.chunks.setdefault(name, []).append(
                    (rd, ds, offset, shp,
                     a.get("dtype", m["dtype"]), gshape))
        for v in self.chunks.values():
            v.sort(key=lambda c: c[2])

    def names(self) -> List[str]:
        return sorted(self.chunks)

    def global_shape(self, name: str) -> List[int]:
        return self.chunks[name][0][5]

    def dtype(self, name: str) -> np.dtype:
        return str_to_dtype(self.chunks[name][0][4])

    def read_region(self, name: str, index) -> np.ndarray:
        """Assemble global box ``index`` (tuple of slices; None → all) of
        ``name`` from overlapping chunks, reading only overlapping slabs.
        Overlapping chunk files are handled — coverage is mask-verified."""
        gshape = self.global_shape(name)
        box = tuple((0, int(d)) for d in gshape) if index is None else \
            _normalize_index(index, gshape)

        def read_slab(handle, r_lo: int, r_hi: int) -> np.ndarray:
            rd, ds, shp = handle
            return read_chunk_slab(rd, ds, shp, r_lo, r_hi)

        return _assemble_box(
            box, self.dtype(name),
            ((off, shp, (rd, ds, shp))
             for rd, ds, off, shp, _dt, _gs in self.chunks[name]),
            read_slab, name)

    def read_rows(self, name: str, lo: int, hi: int) -> np.ndarray:
        """Assemble global rows [lo, hi) of ``name`` (axis-0 range)."""
        gshape = self.global_shape(name)
        index = (slice(lo, hi),) + tuple(slice(0, d) for d in gshape[1:])
        return self.read_region(name, index)

    def read_for_rank(self, name: str, world: int, rank: int) -> np.ndarray:
        g = self.global_shape(name)
        lo, hi = shard_bounds(g[0] if g else 1, world, rank)
        return self.read_rows(name, lo, hi)

    def close(self):
        for r in self.readers:
            r.close()


def load_named_onto(container: str, dirs: Sequence[str], rank: int,
                    devices: Mapping[str, Any]) -> Dict[str, Any]:
    """Load every leaf of a committed rank container onto its device — the
    serve-side loader.

    ``devices`` maps ``name → torch.device`` (missing names stay host numpy
    arrays); it stands in for the reference's shardings, and a device is
    the one-device case of its ``assemble_onto``.  Sharded leaves
    (``shardidx/``) resolve their chunk files across ``dirs`` and assemble
    through :meth:`ShardedLeafRef.read_index`; plain ``data/`` leaves
    decode through the tier codec dispatch (int8 etc.).  Raises
    :class:`CHK5CorruptionError` when the shard set is incomplete — a torn
    load must fail loudly, the deploy path never installs a partial tree."""
    from repro_torch.core.tiers import decode_leaf   # tiers ⇄ resharding

    def place(name: str, arr: np.ndarray):
        dev = devices.get(name)
        return arr if dev is None else numpy_to_tensor(arr, dev)

    named: Dict[str, Any] = {}
    rd = CHK5Reader(container)
    try:
        refs = resolve_shard_refs(rd, dirs, rank)
        if refs is None:
            raise CHK5CorruptionError(
                f"{container}: incomplete shard set across {list(dirs)} — "
                f"refusing a partial load")
        for name, ref in refs.items():
            named[name] = place(name, ref.read_index(None))
        for ds in rd.datasets():
            if not ds.startswith("data/"):
                continue
            name = ds[len("data/"):]
            named[name] = place(name, decode_leaf(rd, ds))
    finally:
        rd.close()
    return named


def elastic_restore(ckpt_dir_path: str, new_world: int, new_rank: int
                    ) -> Dict[str, np.ndarray]:
    """Restore this new rank's slice of every sharded array in a committed
    checkpoint directory (any number of original rank/shard files)."""
    files = [os.path.join(ckpt_dir_path, f) for f in os.listdir(ckpt_dir_path)
             if f.endswith(".chk5") and f.startswith("rank")
             and ".partner" not in f]
    loader = ElasticLoader(sorted(files))
    out = {}
    for name in loader.names():
        out[name] = loader.read_for_rank(name, new_world, new_rank)
    loader.close()
    return out

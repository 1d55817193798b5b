"""Shard-local snapshots, shard files and elastic restore: state saved
under one mesh or world, restored onto another (node-count changes after
failures, pod rescale, DP/TP-width change), with the on-disk layout of the
JAX package's ``core/resharding.py``, so the files of either package read
in the other byte for byte.

A sharded leaf is a ``DTensor``: each rank of its ``DeviceMesh`` holds the
index box its mesh coordinate owns (``dist/context.shard_box``).

Write side (the pipeline's Plan/Pack stages call in here):

- :func:`snapshot_shards` snapshots **only the box this rank owns** of a
  sharded leaf.  Ownership: of the ranks that hold the same box (the
  replicas along a data axis), the lowest rank writes it; the others
  contribute no chunk.  The snapshot is a completed host copy when Plan
  returns (torch tensors are updated in place).  No host buffer of the
  global leaf size is ever allocated.
- :func:`write_shard_files` writes the owned chunks as ``shard-<k>``
  sub-datasets spread over ``rank<r>.shard<j>.chk5`` files (one writer
  thread per file, in parallel) and records the index — global shape,
  chunk offsets, chunk file/dataset names — as a ``shardidx/<name>``
  dataset in the rank's main container.  With a communicator, every
  owner's index reaches every rank (the cross-rank index), so each rank's
  container lists the whole mesh's chunks: ``rank0.chk5`` with the files
  it names is a complete checkpoint.

Read side:

- :class:`ShardedLeafRef` is the lazy handle the restore path hands out
  for a sharded leaf: index metadata + resolved chunk files, plus the
  DIFF links to replay over it.  It reads arbitrary index boxes by
  touching only the overlapping byte ranges of each chunk file (CHK5
  partial reads) and replays each link's dirty blocks inside the box
  alone.  int8-compressed chunks decode transparently
  (:func:`read_chunk_slab`).
- :func:`assemble_onto` builds a ``DTensor`` for a target sharding from
  this rank's box alone (``DTensor.from_local``, no collective) — store on
  2×2, restore on 1×4 or on two ranks, no global host array in between.
- :class:`ElasticLoader` assembles arbitrary regions of the global arrays
  from any number of chunk files: the multi-dim ``shard/<name>/shard-<k>``
  layout and the axis-0 ``shard/<name>`` layout of :func:`save_sharded`
  (the DP/ZeRO rank-file path).

Mesh-level helpers (``reshard_tree`` / ``gather_tree``) build restart
templates and bit-exact global views for tests.
"""
from __future__ import annotations

import glob
import os
import re
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.chaos import inject as chaos
from repro_torch.core.formats import (
    CHK5CorruptionError,
    CHK5Reader,
    CHK5Writer,
    as_numpy,
    numpy_to_tensor,
    resolve_precision,
    str_to_dtype,
    torch_dtype_to_str,
)
from repro_torch.dist.context import (
    Box,
    NamedSharding,
    PartitionSpec,
    mesh_coords,
    placements_to_spec,
    shard_box,
    spec_to_placements,
)

#: ``allgather``-like callable: this rank's object → every rank's, in order
Gather = Callable[[Any], List[Any]]


# -------------------------------------------------------------------------- #
# DTensor layouts
# -------------------------------------------------------------------------- #


def is_dtensor(x: Any) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_device(mesh: Any) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def sharding_of(leaf: Any) -> NamedSharding:
    """A ``DTensor``'s layout as a per-dim :class:`NamedSharding`."""
    return NamedSharding(leaf.device_mesh, placements_to_spec(
        leaf.device_mesh, leaf.placements, leaf.ndim))


def mesh_boxes(mesh: Any, spec: PartitionSpec,
               shape: Sequence[int]) -> Dict[int, Box]:
    """Rank → the box its mesh coordinate holds."""
    return {r: shard_box(shape, mesh, spec, c)
            for r, c in mesh_coords(mesh).items()}


def box_owners(boxes: Mapping[int, Box]) -> Dict[Box, int]:
    """Distinct non-empty box → the lowest rank holding it (its writer)."""
    out: Dict[Box, int] = {}
    for r in sorted(boxes):
        b = boxes[r]
        if all(hi > lo for lo, hi in b) and b not in out:
            out[b] = r
    return out


def box_slices(box: Box) -> Tuple[slice, ...]:
    return tuple(slice(lo, hi) for lo, hi in box)


def _c_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """Element strides of a C-order array of ``shape``."""
    return tuple(int(np.prod(shape[i + 1:], dtype=np.int64))
                 for i in range(len(shape)))


def box_runs(box: Box, shape: Sequence[int]) -> Tuple[np.ndarray, int]:
    """The contiguous runs of the global C-order flat array that ``box``
    covers → (their start elements, ascending; their common length).  The
    box's own C-order flat array is these runs back to back."""
    shape = tuple(int(n) for n in shape)
    nd = len(shape)
    if nd == 0:
        return np.zeros(1, np.int64), 1
    k = nd - 1
    while k > 0 and box[k] == (0, shape[k]):
        k -= 1
    strides = _c_strides(shape)
    inner = strides[k]
    starts = np.array([box[k][0] * strides[k]], np.int64)
    for i in range(k - 1, -1, -1):
        lo, hi = box[i]
        starts = (np.arange(lo, hi, dtype=np.int64)[:, None] * strides[i]
                  + starts[None, :]).reshape(-1)
    return starts, (box[k][1] - box[k][0]) * inner


def shardable(leaf: Any) -> bool:
    """Should Plan snapshot this leaf shard-locally?  True for a
    ``DTensor`` with any placement that is not ``Replicate`` (a fully
    replicated leaf holds the global array on every rank, so the plain
    host snapshot is already shard-local)."""
    if not is_dtensor(leaf):
        return False
    from torch.distributed.tensor import Replicate
    return any(not isinstance(p, Replicate) for p in leaf.placements)


def local_value(leaf: Any) -> Any:
    """A replicated ``DTensor`` → its local tensor (the global value); any
    other leaf as it is."""
    if is_dtensor(leaf) and not shardable(leaf):
        return leaf.to_local()
    return leaf


def reshard_tree(tree: Any, shardings: Any) -> Any:
    """Place every leaf of ``tree`` per ``shardings`` (a matching tree of
    :class:`NamedSharding` — e.g. ``dist.sharding.param_shardings`` under a
    target mesh).  A plain tensor (the global value, the same on every
    rank) becomes a ``DTensor``: each rank slices its own box and calls
    ``DTensor.from_local``, with no collective.  A ``DTensor`` is
    redistributed on its mesh.  This is how a restart template declares
    the layout a checkpoint should restore onto."""
    from repro_torch.core.protect import flatten_named, unflatten_named
    named = flatten_named(tree)
    sh = flatten_named(shardings)
    return unflatten_named({p: _place(x, sh[p]) for p, x in named.items()},
                           tree)


def _place(x: Any, sharding: NamedSharding) -> Any:
    from torch.distributed.tensor import DTensor
    placements = spec_to_placements(sharding.mesh, sharding.spec)
    if is_dtensor(x):
        return x.redistribute(sharding.mesh, placements)
    if not isinstance(x, torch.Tensor):
        x = numpy_to_tensor(np.asarray(x), mesh_device(sharding.mesh))
    box = shard_box(x.shape, sharding.mesh, sharding.spec,
                    sharding.mesh.get_coordinate())
    local = x[box_slices(box)].clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sharding.mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=_c_strides(x.shape))


def zeros_onto(struct: Any, shardings: Any) -> Any:
    """A tree of zero ``DTensor`` leaves shaped like ``struct`` (tensors or
    ``meta`` tensors: ``Model.param_struct()``) and laid out per
    ``shardings``: each rank allocates only its own box — a restart
    template that costs no global array anywhere."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core.protect import flatten_named, unflatten_named
    sh = flatten_named(shardings)

    def zero(path: str, leaf: Any) -> Any:
        s = sh[path]
        shape = tuple(int(d) for d in leaf.shape)
        box = shard_box(shape, s.mesh, s.spec, s.mesh.get_coordinate())
        local = torch.zeros(tuple(hi - lo for lo, hi in box),
                            dtype=leaf.dtype, device=mesh_device(s.mesh))
        return DTensor.from_local(local, s.mesh,
                                  spec_to_placements(s.mesh, s.spec),
                                  run_check=False, shape=shape,
                                  stride=_c_strides(shape))

    return unflatten_named({p: zero(p, x) for p, x in
                            flatten_named(struct).items()}, struct)


def gather_leaf(leaf: Any, gather: Gather) -> np.ndarray:
    """The bit-exact global value of a ``DTensor`` on the host: every
    box's owner sends its local bytes through ``gather`` (host copies; no
    collective on the device)."""
    if not shardable(leaf):
        return as_numpy(local_value(leaf))
    sh = sharding_of(leaf)
    boxes = mesh_boxes(sh.mesh, sh.spec, leaf.shape)
    me = torch.distributed.get_rank()
    mine = boxes[me]
    piece = (mine, as_numpy(leaf.to_local())) \
        if box_owners(boxes).get(mine) == me else None
    out = np.empty(tuple(leaf.shape),
                   str_to_dtype(torch_dtype_to_str(leaf.dtype)))
    for got in gather(piece):
        if got is not None:
            out[box_slices(got[0])] = got[1]
    return out


def gather_tree(tree: Any, gather: Optional[Gather] = None) -> Any:
    """Every leaf's bit-exact global value on the host (a
    ``np.ndarray``), independent of the mesh it lived on.  Every rank must
    call it.  ``gather`` defaults to an object allgather over the world
    group."""
    from repro_torch.core.protect import flatten_named, unflatten_named
    if gather is None:
        def gather(obj):
            out = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(out, obj)
            return out
    named = flatten_named(tree)
    return unflatten_named({p: gather_leaf(x, gather)
                            if isinstance(x, torch.Tensor)
                            else np.asarray(x) for p, x in named.items()},
                           tree)


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


def snapshot_shards(leaf: Any) -> ShardSnapshot:
    """Snapshot the box this rank owns of a sharded ``DTensor`` (none when
    a lower rank holds the same box — shard-box ownership), as a completed
    host copy."""
    sh = sharding_of(leaf)
    shape = tuple(int(d) for d in leaf.shape)
    boxes = mesh_boxes(sh.mesh, sh.spec, shape)
    me = torch.distributed.get_rank()
    mine = boxes[me]
    chunks: List[ShardChunk] = []
    if box_owners(boxes).get(mine) == me:
        chunks.append(ShardChunk(
            offset=tuple(lo for lo, _ in mine),
            shape=tuple(hi - lo for lo, hi in mine),
            data=as_numpy(leaf.to_local())))
    return ShardSnapshot(dtype=torch_dtype_to_str(leaf.dtype),
                         global_shape=shape, chunks=chunks)


def split_sharded(named: Dict[str, Any], enabled: bool = True,
                  gather: Optional[Gather] = None
                  ) -> Tuple[Dict[str, Any], Dict[str, ShardSnapshot]]:
    """Partition protected leaves into (gather-snapshot leaves, shard-local
    snapshots) — the Plan-stage split.  Replicated ``DTensor`` leaves join
    the gather side as their local tensor.  With ``enabled=False`` a
    sharded leaf is gathered to its global value on the host through
    ``gather`` (host copies) instead."""
    sharded: Dict[str, ShardSnapshot] = {}
    host: Dict[str, Any] = {}
    for p, v in named.items():
        if not shardable(v):
            host[p] = local_value(v)
        elif enabled:
            sharded[p] = snapshot_shards(v)
        elif gather is None:
            raise ValueError(f"{p}: a sharded leaf gathered to the host "
                             "needs a communicator")
        else:
            host[p] = gather_leaf(v, gather)
    return host, sharded


# -------------------------------------------------------------------------- #
# sharded CHK5 layout (Pack side)
# -------------------------------------------------------------------------- #

_SHARD_FILE_RE = re.compile(r"^rank(\d+)\.shard(\d+)\.chk5$")

#: the chaos site hit after each shard file is written
SHARD_FILE_SITE = "shard.file"

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
                      sink_factory=None,
                      gather_index: Optional[Gather] = None) -> List[str]:
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

    ``gather_index`` (the communicator's ``allgather``, on a multi-process
    mesh) carries every rank's chunk index to every rank: each rank's
    ``shardidx/<name>`` then lists the chunks of every owner, in rank
    order, whoever wrote them — a rank that owns no box of a leaf writes
    no shard file for it, and its container still indexes the leaf.
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

    n_files = min(max(1, int(max_writers)), len(work))
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
        # a fault site after each shard file (not in chaos.SITES, which
        # stays the reference's list): ctx stage, file
        chaos.fire(SHARD_FILE_SITE, stage=os.path.basename(stage_dir),
                   file=os.path.basename(paths[j]))

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

    # this rank's chunk index → every rank's (the cross-rank index)
    index = {name: [(tuple(c.offset), tuple(c.shape),
                     os.path.basename(paths[assignment[(name, k)]]),
                     _chunk_dataset(name, k))
                    for k, c in enumerate(sharded[name].chunks)]
             for name in sorted(sharded)}
    if gather_index is not None:
        every = gather_index(index)
        index = {name: [c for got in every for c in got.get(name, ())]
                 for name in index}
    for name in sorted(sharded):
        snap = sharded[name]
        spec = specs.get(name)
        ndim = len(snap.global_shape)
        chunks = index[name]
        table = np.zeros((len(chunks), 2 * max(ndim, 1)), np.int64)
        for k, (offset, shape, _f, _ds) in enumerate(chunks):
            table[k, :ndim] = offset
            table[k, ndim:2 * ndim] = shape
        attrs = dict(clause_attrs(spec, default_kind),
                     global_shape=[int(x) for x in snap.global_shape],
                     dtype=snap.dtype,
                     n_chunks=len(chunks),
                     files=[f for _o, _s, f, _ds in chunks],
                     datasets=[ds for _o, _s, _f, ds in chunks])
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
    shard index plus resolved chunk files, and the DIFF links of the
    restore chain that touch it (:meth:`add_delta`).  ``read_index``
    assembles any index box touching only the overlapping leading-dim
    slabs of each chunk file, then replays each link's dirty blocks inside
    the box; ``materialize`` assembles the full global array."""

    def __init__(self, name: str, dtype: str, shape: Sequence[int],
                 chunks: List[_ChunkRef],
                 precision: Optional[str] = None):
        self.name = name
        self.dtype = str_to_dtype(dtype)          # restore target dtype
        self.shape = tuple(int(x) for x in shape)
        self.chunks = chunks
        self.precision = precision                # stored-cast marker
        #: (dirty block indices, (n_dirty, block_bytes/4) u32 rows,
        #: block_bytes) per DIFF link, oldest first
        self.deltas: List[Tuple[np.ndarray, np.ndarray, int]] = []

    def __repr__(self) -> str:
        return (f"ShardedLeafRef({self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype.str}, chunks={len(self.chunks)}, "
                f"deltas={len(self.deltas)})")

    def add_delta(self, dirty_idx: np.ndarray, payload: np.ndarray,
                  block_bytes: int) -> None:
        """Queue one DIFF link's dirty blocks of this leaf (global block
        indices over its C-order bytes) for every later read."""
        self.deltas.append((np.asarray(dirty_idx, np.int64),
                            np.ascontiguousarray(payload), int(block_bytes)))

    def _box(self, index) -> Tuple[Tuple[int, int], ...]:
        if index is None:
            return tuple((0, d) for d in self.shape)
        return _normalize_index(index, self.shape)

    def read_index(self, index=None,
                   _readers: Optional[Dict[str, CHK5Reader]] = None
                   ) -> np.ndarray:
        """Assemble global box ``index`` (tuple of slices; None → all)
        from the overlapping chunks, reading only overlapping slabs, and
        replay the queued DIFF links inside it."""
        readers = {} if _readers is None else _readers

        def read_slab(c: _ChunkRef, r_lo: int, r_hi: int) -> np.ndarray:
            rd = readers.get(c.path)
            if rd is None:
                rd = readers[c.path] = CHK5Reader(c.path)
            return read_chunk_slab(rd, c.dataset, c.shape, r_lo, r_hi)

        box = self._box(index)
        try:
            out = _assemble_box(
                box, self.dtype,
                ((c.offset, c.shape, c) for c in self.chunks),
                read_slab, self.name, exc_cls=CHK5CorruptionError)
        finally:
            if _readers is None:
                for rd in readers.values():
                    rd.close()
        for dirty, payload, bb in self.deltas:
            replay_box(out, box, self.shape, dirty, payload, bb)
        return out

    def materialize(self) -> np.ndarray:
        """The full global array on the host."""
        return self.read_index(None)


def replay_box(out: np.ndarray, box: Box, shape: Sequence[int],
               dirty: np.ndarray, payload: np.ndarray,
               block_bytes: int) -> None:
    """Write the parts of one DIFF link's dirty blocks (global block
    indices over the leaf's C-order bytes, ``payload`` their rows) that
    fall inside ``box`` into ``out``, the box's values, in place — the
    host replay of a delta over one rank's box, as ``apply_delta`` over
    the whole leaf."""
    if not len(dirty):
        return
    flat = out.reshape(-1)
    per = block_bytes // out.itemsize                  # elements per block
    rows = np.ascontiguousarray(payload).view(out.dtype).reshape(-1, per)
    starts, length = box_runs(box, shape)
    ends = starts + length
    for b, row in zip(dirty.tolist(), rows):
        g0, g1 = b * per, (b + 1) * per
        j0 = int(np.searchsorted(ends, g0, side="right"))
        j1 = int(np.searchsorted(starts, g1, side="left"))
        for j in range(j0, j1):
            lo, hi = max(g0, int(starts[j])), min(g1, int(ends[j]))
            at = j * length + lo - int(starts[j])
            flat[at:at + hi - lo] = row[lo - g0:hi - g0]


def indexed_shard_files(container: str) -> List[str]:
    """Every shard file the ``shardidx/`` datasets of a rank container
    name (the cross-rank index of a multi-process store names other
    ranks' files too)."""
    rd = CHK5Reader(container)
    try:
        return sorted({f for ds in rd.datasets() if ds.startswith("shardidx/")
                       for f in rd.info(ds)["attrs"]["files"]})
    finally:
        rd.close()


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


def assemble_onto(ref: Any, sharding: NamedSharding) -> Any:
    """Build a ``DTensor`` laid out per ``sharding`` from this rank's box
    alone: the box is read from the shard files (``ShardedLeafRef``, its
    DIFF links replayed inside it) or sliced from a host array, placed on
    this rank's device of the mesh, and wrapped by ``DTensor.from_local``
    — no collective, and the global array never exists on the host."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    shape = tuple(int(d) for d in ref.shape)
    box = shard_box(shape, mesh, sharding.spec, mesh.get_coordinate())
    if isinstance(ref, ShardedLeafRef):
        host = ref.read_index(box_slices(box))
    else:
        host = np.ascontiguousarray(np.asarray(ref)[box_slices(box)])
    local = numpy_to_tensor(host, mesh_device(mesh))
    return DTensor.from_local(local, mesh,
                              spec_to_placements(mesh, sharding.spec),
                              run_check=False, shape=shape,
                              stride=_c_strides(shape))


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
                    devices: Optional[Mapping[str, Any]] = None, *,
                    shardings: Any = None) -> Dict[str, Any]:
    """Load every leaf of a committed rank container onto its target — the
    serve-side loader.

    ``shardings`` maps ``name → NamedSharding`` (or is one sharding for
    every leaf): such a leaf lands as a ``DTensor`` of that layout through
    :func:`assemble_onto`, this rank reading only its box — a checkpoint
    stored from a 2×2 training mesh lands on a 1×4 serving mesh without
    either side seeing the full tree.  ``devices`` maps ``name →
    torch.device`` for a leaf that lands whole on one device (the
    one-device case).  Names in neither stay host numpy arrays.  Sharded
    leaves (``shardidx/``) resolve their chunk files across ``dirs``;
    plain ``data/`` leaves decode through the tier codec dispatch (int8
    etc.).  Raises :class:`CHK5CorruptionError` when the shard set is
    incomplete — a torn load must fail loudly, the deploy path never
    installs a partial tree."""
    from repro_torch.core.tiers import decode_leaf   # tiers ⇄ resharding
    devices = devices or {}

    def sharding_for(name: str):
        if shardings is None or isinstance(shardings, NamedSharding):
            return shardings
        return shardings.get(name)

    def place(name: str, leaf: Any):
        sh = sharding_for(name)
        if sh is not None:
            return assemble_onto(leaf, sh)
        if isinstance(leaf, ShardedLeafRef):
            leaf = leaf.materialize()
        dev = devices.get(name)
        return leaf if dev is None else numpy_to_tensor(leaf, dev)

    named: Dict[str, Any] = {}
    rd = CHK5Reader(container)
    try:
        refs = resolve_shard_refs(rd, dirs, rank)
        if refs is None:
            raise CHK5CorruptionError(
                f"{container}: incomplete shard set across {list(dirs)} — "
                f"refusing a partial load")
        for name, ref in refs.items():
            named[name] = place(name, ref)
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

"""Storage tiers — the *Place* stage's pluggable backends (FTI's L1–L4
ladder as first-class objects).

A :class:`Tier` owns one rung of the checkpoint ladder, for **both**
directions:

    write side   ``place()``    — apply the tier's redundancy/copy scheme to
                                  a packed payload sitting in a staging dir
    read side    ``recover()``  — produce a rank's payload bytes from
                                  whatever this tier persisted

The four built-ins mirror the paper (§4.2.1) / FTI semantics:

    ``LocalTier``     L1  node-local write (RAM-disk / NVMe analogue)
    ``PartnerTier``   L2  partner copy on a different node
    ``ErasureTier``   L3  Reed–Solomon (or XOR) parity across the node group
    ``GlobalTier``    L4  parallel-file-system write (global directory)

plus the object-store rung (``repro_torch.objstore.tier.ObjectStoreTier``,
composed into the L4 stack when ``StorageConfig.objstore`` is on):
content-addressed chunk uploads at Place, an atomically-published
checkpoint catalog at Commit, and a catalog-driven restore path that
survives every checkpoint directory being wiped.

Write stacks compose tiers (L2 = local + partner, L3 = local + erasure,
L4 = global + objstore); the recovery ladder tries every tier in level
order L1 → L2 → L3 → L4 → objstore.  Tiers participate in two more
pipeline moments besides ``place``/``recover``: ``commit`` (after the
local atomic rename — where the objstore tier publishes its catalog
entry) and ``list_ids`` (checkpoint discovery beyond directory scans —
how a wiped run finds what the catalog still holds).
Backends select/compose stacks via ``Backend.compose_tiers`` — adding a new
tier (compression, object store, multi-node batching) means subclassing
``Tier`` and composing it into a stack; nothing in the pipeline changes.

A :class:`PackTier` is the Pack-stage analogue: it encodes one planned
leaf into container datasets according to the leaf's ``Protect`` clauses
(core/protect.py) and decodes it back on restore.  Two built-ins consume
the clause system:

    ``Int8CompressTier``   ``compress="int8"`` — per-block max-abs int8
                           quantization (dist/compression.py), roundtrip
                           computed at pack time and crc-verified on load
    ``CHK5FormatTier``     the always-on format tier: plain CHK5 dataset
                           write, clause attrs recorded as dataset
                           attributes, ``precision`` casts applied

Pack tiers are *per-leaf* and self-describing: decode dispatches on the
``codec`` dataset attribute, so a reader needs no Protect specs — any
CHK5 container (and ``chkls --json``) shows exactly how each dataset was
encoded.  Backends compose them via ``Backend.compose_pack_tiers``.
"""
from __future__ import annotations

import abc
import json
import os
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import manifest as mf
from repro_torch.core.comm import Communicator
from repro_torch.core.formats import (
    CHK5CorruptionError,
    CHK5Reader,
    CHK5Writer,
    dtype_to_str,
    resolve_precision,
    str_to_dtype,
)
from repro_torch.core.protect import CHK_FULL, Protect
from repro_torch.redundancy import erasure
from repro_torch.redundancy.groups import Topology
from repro_torch.redundancy.partner import (
    find_partner_copy,
    replicate,
    store_partner_copy,
)


class TierContext:
    """Shared services a tier needs: config, communicator, topology, and
    directory resolution across the local/global roots and reachable peers."""

    def __init__(self, cfg, comm: Communicator, topo: Topology):
        self.cfg = cfg
        self.comm = comm
        self.topo = topo
        # roots owned by catalog-backed tiers (the objstore restore
        # cache): listed in recovery_dirs so shard files resolve there,
        # but the owning tier is the only one that answers payload reads
        # from them — it digest-verifies the cache against its catalog,
        # which the byte-oblivious directory tiers cannot
        self.catalog_roots: set = set()

    @property
    def local_root(self) -> str:
        return os.path.join(self.comm.node_local_dir, "ckpts")

    @property
    def global_root(self) -> str:
        return self.cfg.global_root

    def peer_ranks(self) -> List[int]:
        """Ranks whose node-local storage recovery may read: the world's,
        plus those of an earlier, larger world on this host when the
        communicator knows them (``ProcessGroupComm.peer_ranks``)."""
        return list(getattr(self.comm, "peer_ranks", range(self.comm.world)))

    def peer_ckpt_dirs(self, ckpt_id: int) -> List[str]:
        """The local-tier checkpoint dir on every reachable node (recovery
        pulls partner replicas / parity from surviving nodes' storage)."""
        dirs = []
        for r in self.peer_ranks():
            if r == self.comm.rank:
                base = self.local_root
            else:
                peer = self.comm.peer_local_dir(r)
                if peer is None:
                    continue
                base = os.path.join(peer, "ckpts")
            d = mf.ckpt_dir(base, ckpt_id)
            if os.path.isdir(d):
                dirs.append(d)
        return dirs

    def peer_ckpt_dir_for_write(self, rank: int, ckpt_id: int
                                ) -> Optional[str]:
        """Resolve where a shard for ``rank`` should land (its local tier
        dir, committed or in-flight)."""
        if rank == self.comm.rank:
            base = self.local_root
        else:
            peer = self.comm.peer_local_dir(rank)
            if peer is None:
                return None
            base = os.path.join(peer, "ckpts")
        final = mf.ckpt_dir(base, ckpt_id)
        tmp = mf.ckpt_dir(base, ckpt_id, tmp=True)
        return final if os.path.isdir(final) else (
            tmp if os.path.isdir(tmp) else None)

    def recovery_dirs(self, root: str, ckpt_id: int) -> List[str]:
        """Candidate dirs holding pieces of ``ckpt_id`` under ``root``:
        the root's own dir, plus (for node-local roots) reachable peers'."""
        search = [mf.ckpt_dir(root, ckpt_id)]
        if root != self.global_root:
            search += [d for d in self.peer_ckpt_dirs(ckpt_id)
                       if d not in search]
        return search


def _valid_payload(path: str) -> Optional[bytes]:
    """Read a CHK5 payload, rejecting corrupt containers."""
    if not os.path.exists(path):
        return None
    try:
        CHK5Reader(path).close()
    except CHK5CorruptionError:
        return None
    return open(path, "rb").read()


class Tier(abc.ABC):
    """One rung of the checkpoint ladder (write + recovery)."""

    name: str = "?"
    level: int = 0                     # ladder rung this tier implements

    def __init__(self, ctx: TierContext):
        self.ctx = ctx

    @property
    def root(self) -> str:
        """Where payloads (and the manifest) for this tier land."""
        return self.ctx.local_root

    def pack_sink(self, ckpt_id: int, basename: str):
        """Pack-stage streaming hook: return a byte sink (an object with
        ``write``/``cut``/``begin_region``/``end_region``/``finish``, see
        ``repro_torch.objstore.chunks.ChunkStream``) for the staged file
        ``basename`` of checkpoint ``ckpt_id``, or None when this tier
        consumes whole staged files.  A CHK5 writer tees every written
        byte into the sink, so a sink tier overlaps its transfers with
        packing instead of re-reading the file at Place."""
        return None

    def place(self, ckpt_id: int, stage_dir: str, payload_path: str,
              extra_files: Sequence[str] = ()) -> None:
        """Write-side: apply this tier's scheme to the packed payload.
        ``stage_dir`` is the uncommitted ``.tmp`` checkpoint dir;
        ``extra_files`` are the payload's sibling shard files (sharded
        stores stage a multi-file set)."""

    def commit(self, ckpt_id: int, manifest: Dict) -> None:
        """Post-commit hook: runs after the checkpoint's atomic ``.tmp`` →
        final rename, with the committed manifest.  The objstore tier
        publishes its catalog entry here — so the catalog only ever
        advertises checkpoints whose local commit succeeded."""

    def list_ids(self) -> List[Tuple[int, str]]:
        """Checkpoint ids this tier can produce beyond the pipeline's
        directory scans → ``[(ckpt_id, root)]`` (the catalog-discovery
        hook; default none)."""
        return []

    @abc.abstractmethod
    def recover(self, ckpt_id: int, rank: int, root: str,
                manifest: Dict, dirs: List[str]) -> Optional[bytes]:
        """Read-side: return ``rank``'s payload bytes, or None if this tier
        cannot produce it.  ``dirs`` is the candidate dir list for this
        (root, ckpt_id) — computed once per ladder walk by the pipeline
        (``TierContext.recovery_dirs``), not per tier."""


class LocalTier(Tier):
    """L1 — the payload itself on node-local storage (written by Pack;
    place is a no-op)."""

    name = "local"
    level = 1

    def recover(self, ckpt_id, rank, root, manifest, dirs):
        for d in dirs:
            if d.startswith(self.ctx.global_root):
                continue               # global payloads are GlobalTier's rung
            if any(d.startswith(r) for r in self.ctx.catalog_roots):
                continue               # objstore cache: its tier verifies
            blob = _valid_payload(os.path.join(d, f"rank{rank}.chk5"))
            if blob is not None:
                return blob
        return None


class PartnerTier(Tier):
    """L2 — replicate the payload to the ring partner on another node."""

    name = "partner"
    level = 2

    def place(self, ckpt_id, stage_dir, payload_path, extra_files=()):
        payload = open(payload_path, "rb").read()
        extra = {os.path.basename(p): open(p, "rb").read()
                 for p in extra_files}
        replicate(self.ctx.comm, self.ctx.topo, ckpt_id, payload,
                  extra=extra or None)
        self.ctx.comm.barrier()
        store_partner_copy(self.ctx.comm, self.ctx.topo, ckpt_id, stage_dir)

    def recover(self, ckpt_id, rank, root, manifest, dirs):
        for d in dirs:
            pc = find_partner_copy(self.ctx.topo, d, rank)
            if pc:
                return open(pc, "rb").read()
        return None


class ErasureTier(Tier):
    """L3 — RS/XOR parity across the node group, shards scattered so one
    node loss never takes a payload and its covering parity together."""

    name = "erasure"
    level = 3

    def place(self, ckpt_id, stage_dir, payload_path, extra_files=()):
        # parity covers the rank container only: shard files of a sharded
        # L3 store are not erasure-encoded, so losing a node that held
        # them makes that checkpoint non-restorable — the restore walk
        # detects the incomplete shard set and falls back safely (older
        # id / global tier) rather than reconstructing a partial payload
        ctx = self.ctx
        group = ctx.topo.erasure_group(ctx.comm.rank)
        g = ctx.topo.group_index(ctx.comm.rank)
        payload = open(payload_path, "rb").read()
        for r in group:
            if r != ctx.comm.rank:
                ctx.comm.post(f"er:{ckpt_id}", r, payload)
        ctx.comm.barrier()
        blobs = [
            payload if r == ctx.comm.rank
            else ctx.comm.collect(f"er:{ckpt_id}", r)
            for r in group
        ]
        if any(b is None for b in blobs):
            return                  # not complete yet (an earlier member)
        lengths = [len(b) for b in blobs]
        if ctx.cfg.erasure_scheme == "xor":
            parities = [erasure.encode_xor(blobs)]
        else:
            parities = erasure.encode_rs(
                blobs, min(ctx.cfg.rs_parity, len(group)))
        meta = json.dumps({"lengths": lengths, "group": group})
        for j, par in enumerate(parities):
            # parity placement: on the NEXT group's nodes (ring) so a single
            # node loss never takes a payload and its covering parity
            # together; single-group worlds fall back to in-group rotation
            # (then XOR needs rs/m ≥ 2 to survive a parity-holder loss)
            if ctx.comm.world > len(group):
                holder = (group[-1] + 1 + j) % ctx.comm.world
            else:
                holder = group[(j + 1) % len(group)]
            hd = stage_dir if holder == ctx.comm.rank else \
                ctx.peer_ckpt_dir_for_write(holder, ckpt_id)
            if hd is None:
                hd = stage_dir      # fall back: keep shard locally
            with open(os.path.join(hd, f"parity.g{g}.p{j}.bin"), "wb") as f:
                f.write(par)
            with open(os.path.join(hd, f"parity.g{g}.meta"), "w") as f:
                f.write(meta)
        with open(os.path.join(stage_dir, f"parity.g{g}.meta"), "w") as f:
            f.write(meta)

    def recover(self, ckpt_id, rank, root, manifest, dirs):
        if manifest.get("level") != 3:
            return None
        ctx = self.ctx
        group = ctx.topo.erasure_group(rank)
        g = ctx.topo.group_index(rank)

        def find(name: str) -> Optional[str]:
            for d in dirs:
                p = os.path.join(d, name)
                if os.path.exists(p):
                    return p
            return None

        meta_p = find(f"parity.g{g}.meta")
        if meta_p is None:
            return None
        meta = json.loads(open(meta_p).read())
        lengths = meta["lengths"]
        survivors: Dict[int, bytes] = {}
        for j, r in enumerate(group):
            p = find(f"rank{r}.chk5")
            if p:
                survivors[j] = open(p, "rb").read()
        parities: Dict[int, bytes] = {}
        for j in range(len(group)):        # collect every surviving shard
            p = find(f"parity.g{g}.p{j}.bin")
            if p is not None:
                parities[j] = open(p, "rb").read()
        try:
            if ctx.cfg.erasure_scheme == "xor":
                blobs = erasure.decode_xor(survivors, parities[0], len(group),
                                           lengths)
            else:
                blobs = erasure.decode_rs(survivors, parities, len(group),
                                          lengths)
        except Exception:
            return None
        return blobs[group.index(rank)]


class GlobalTier(Tier):
    """L4 — the payload on the parallel file system (shared directory)."""

    name = "global"
    level = 4

    @property
    def root(self) -> str:
        return self.ctx.global_root

    def recover(self, ckpt_id, rank, root, manifest, dirs):
        if root != self.ctx.global_root:
            return None
        p = os.path.join(mf.ckpt_dir(root, ckpt_id), f"rank{rank}.chk5")
        return _valid_payload(p)


def default_tier_stacks(ctx: TierContext) -> Dict[int, List[Tier]]:
    """The FTI ladder: L2/L3 stack a redundancy tier on the local write;
    L4 stacks the content-addressed object store on the global-directory
    write (``StorageConfig.objstore`` gates it — the survivable rung the
    recovery ladder falls back to when every directory is gone)."""
    local = LocalTier(ctx)
    l4: List[Tier] = [GlobalTier(ctx)]
    if getattr(ctx.cfg, "objstore", True):
        # lazy import: objstore.tier subclasses Tier from this module
        from repro_torch.objstore.tier import ObjectStoreTier
        l4.append(ObjectStoreTier(ctx))
    return {
        1: [local],
        2: [local, PartnerTier(ctx)],
        3: [local, ErasureTier(ctx)],
        4: l4,
    }


def recovery_ladder(stacks: Dict[int, List[Tier]]) -> List[Tier]:
    """Deduplicated tiers of every stack, in ladder order L1 → L4."""
    seen: Dict[str, Tier] = {}
    for lvl in sorted(stacks):
        for t in stacks[lvl]:
            seen.setdefault(t.name, t)
    return sorted(seen.values(), key=lambda t: t.level)


# -------------------------------------------------------------------------- #
# Pack-side tiers — per-leaf encoders driven by Protect clauses
# -------------------------------------------------------------------------- #

_AUX_GROUP = "codecaux"          # side-channel datasets (e.g. int8 scales)


def clause_attrs(spec: Optional[Protect], eff_kind: str) -> Dict[str, Any]:
    """The dataset attributes the CHK5 format tier records for one leaf:
    the *effective* kind plus every clause the governing spec carried.
    ``compress`` is recorded as ``codec`` only by the codec tier itself
    (on success), so the attr always reflects what is actually on disk."""
    attrs: Dict[str, Any] = {"kind": eff_kind}
    if spec is not None:
        attrs["selector"] = spec.selector
        for k, v in spec.clauses().items():
            if k in ("kind", "compress"):
                continue
            attrs[k] = v
    return attrs


class PackTier(abc.ABC):
    """One Pack-stage encoder: leaf + Protect spec → container datasets."""

    name: str = "?"

    @abc.abstractmethod
    def wants(self, spec: Optional[Protect]) -> bool:
        """Does this tier handle a leaf governed by ``spec``?"""

    @abc.abstractmethod
    def encode(self, w: CHK5Writer, name: str, arr: np.ndarray,
               spec: Optional[Protect], attrs: Dict[str, Any]) -> None:
        """Write ``data/<name>`` (plus any aux datasets) into ``w``."""


class CHK5FormatTier(PackTier):
    """The always-on format tier (paper §4.2.4: checkpoints double as
    analyzable datasets).  Records the leaf's clause attrs as dataset
    attributes and applies the ``precision`` cast (restore casts back to
    the recorded original dtype)."""

    name = "chk5"

    def wants(self, spec: Optional[Protect]) -> bool:
        return True

    def encode(self, w, name, arr, spec, attrs):
        arr = np.asarray(arr)
        attrs = dict(attrs, dtype=dtype_to_str(arr.dtype))
        if spec is not None and spec.precision is not None:
            target = resolve_precision(spec.precision)
            if not np.issubdtype(arr.dtype, np.floating):
                # ints/bools keep their bits; record why the cast was skipped
                attrs.pop("precision", None)
                attrs["precision_fallback"] = (
                    f"{spec.precision}: non-float leaf "
                    f"({dtype_to_str(arr.dtype)})")
            elif arr.dtype != target:
                arr = arr.astype(target)
            # already at target precision: the clause is honored as-is —
            # keep the attr, nothing to cast
        w.write_dataset(f"data/{name}", arr, attrs)


def int8_encode_array(arr: np.ndarray, orig: np.ndarray,
                      max_error: Optional[float]):
    """The one int8 payload encoder behind both the gathered-leaf
    ``Int8CompressTier`` and the shard-chunk codec
    (core/resharding.write_shard_files): quantize ``arr`` (the
    precision-limited values), measure the roundtrip against ``orig``
    (the original values, whose dtype the restore must reproduce).

    → ``(q, scale, attrs)`` on success — ``attrs`` carries
    ``codec``/``codec_block``/``codec_error``/``roundtrip_crc32`` so the
    read side can dispatch and verify — or ``(None, None, attrs)`` with a
    ``codec_fallback`` reason when ``max_error`` is exceeded."""
    from repro_torch.dist.compression import (
        BLOCK, dequantize_int8_np, quantize_int8_np)
    q, scale = quantize_int8_np(arr)
    back = dequantize_int8_np(q, scale, arr.shape).astype(orig.dtype)
    # relative-L2 roundtrip error in f32 (the f64 casts dominated the
    # compressed-store overhead); an overflow degrades to inf, which
    # simply trips the max_error fallback — never a silent accept
    d = (back.astype(np.float32, copy=False)
         - orig.astype(np.float32, copy=False)).reshape(-1)
    a32 = orig.astype(np.float32, copy=False).reshape(-1)
    err = float(np.sqrt(np.dot(d, d))
                / max(float(np.sqrt(np.dot(a32, a32))), 1e-12))
    if max_error is not None and err > max_error:
        return None, None, {"codec_fallback": (
            f"int8: roundtrip error {err:.3e} > max_error {max_error:.3e}")}
    attrs = {"codec": Int8CompressTier.codec, "codec_block": BLOCK,
             "codec_error": err,
             "roundtrip_crc32": zlib.crc32(back.tobytes()) & 0xFFFFFFFF}
    return q, scale, attrs


class Int8CompressTier(PackTier):
    """``compress="int8"`` — per-block max-abs int8 quantization of the
    packed payload (dist/compression.py), the ROADMAP's compressed-payload
    tier.  Lossy by construction (elementwise error ≤ max|block|/127), so:

    - the *dequantized* payload is computed at pack time and its crc32
      recorded — load dequantizes and verifies against it, making the
      restore path roundtrip-verified end to end;
    - a spec ``max_error`` bound makes the tier fall back to an
      uncompressed write when the observed relative-L2 roundtrip error
      exceeds it (recorded in ``codec_fallback``);
    - non-float leaves always fall back (quantizing step counters or bit
      payloads is meaningless).
    """

    name = "int8"
    codec = "int8"

    def wants(self, spec: Optional[Protect]) -> bool:
        return spec is not None and spec.compress == self.codec

    def encode(self, w, name, arr, spec, attrs):
        arr = np.asarray(arr)
        if not np.issubdtype(arr.dtype, np.floating):
            CHK5FormatTier().encode(w, name, arr, spec, dict(
                attrs, codec_fallback=(
                    f"int8: non-float leaf ({dtype_to_str(arr.dtype)})")))
            return
        orig = arr
        if spec.precision is not None:
            # the precision clause composes with the codec: quantize the
            # precision-limited values (same store-side cast the format
            # tier applies), restore still casts back to the original
            target = resolve_precision(spec.precision)
            if arr.dtype != target:
                arr = arr.astype(target)
        q, scale, codec_attrs = int8_encode_array(arr, orig, spec.max_error)
        if q is None:
            CHK5FormatTier().encode(w, name, orig, spec,
                                    dict(attrs, **codec_attrs))
            return
        attrs = dict(attrs, **codec_attrs, dtype=dtype_to_str(orig.dtype),
                     shape=[int(x) for x in orig.shape])
        w.write_dataset(f"data/{name}", q, attrs)
        w.write_dataset(f"{_AUX_GROUP}/{name}/scale", scale)


def default_pack_tiers() -> List[PackTier]:
    """Clause-priority order: codecs first, the format tier as fallback."""
    return [Int8CompressTier(), CHK5FormatTier()]


def pack_named(w: CHK5Writer, named_host: Dict[str, np.ndarray],
               specs: Optional[Dict[str, Optional[Protect]]],
               pack_tiers: Optional[List[PackTier]] = None,
               default_kind: str = CHK_FULL) -> None:
    """Run the Pack-tier chain over every leaf (first tier that ``wants``
    the governing spec encodes it)."""
    tiers = pack_tiers if pack_tiers is not None else default_pack_tiers()
    specs = specs or {}
    for name, arr in named_host.items():
        spec = specs.get(name)
        attrs = clause_attrs(spec, default_kind)
        for tier in tiers:
            if tier.wants(spec):
                tier.encode(w, name, np.asarray(arr), spec, attrs)
                break
        else:
            # a silently dropped leaf would only surface at restore time;
            # fail the store where the misconfiguration is
            raise RuntimeError(
                f"no pack tier accepted leaf {name!r} (spec {spec!r}) — "
                f"compose_pack_tiers chains must end with a catch-all "
                f"(CHK5FormatTier)")


def decode_leaf(rd: CHK5Reader, ds_name: str) -> np.ndarray:
    """Decode one ``data/...`` dataset, dispatching on its ``codec`` attr
    (self-describing — no Protect specs needed at restore)."""
    meta = rd.info(ds_name)
    attrs = meta.get("attrs", {})
    codec = attrs.get("codec")
    if codec == Int8CompressTier.codec:
        from repro_torch.dist.compression import dequantize_int8_np
        name = ds_name[len("data/"):]
        q = rd.read_dataset(ds_name)
        scale = rd.read_dataset(f"{_AUX_GROUP}/{name}/scale")
        arr = dequantize_int8_np(q, scale, attrs["shape"]).astype(
            str_to_dtype(attrs["dtype"]))
        got = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
        if got != attrs["roundtrip_crc32"]:
            raise CHK5CorruptionError(
                f"{rd.path}:{ds_name}: int8 codec roundtrip mismatch "
                f"(crc {got:#x} != recorded {attrs['roundtrip_crc32']:#x})")
        return arr
    if codec is not None:
        raise CHK5CorruptionError(
            f"{rd.path}:{ds_name}: unknown payload codec {codec!r}")
    arr = rd.read_dataset(ds_name)
    if "precision" in attrs and "dtype" in attrs:
        arr = arr.astype(str_to_dtype(attrs["dtype"]))
    return arr


def unpack_named(rd: CHK5Reader) -> Dict[str, np.ndarray]:
    """Decode every ``data/...`` dataset of a container → {path: array}."""
    out: Dict[str, np.ndarray] = {}
    for ds in rd.datasets():
        if ds.startswith("data/"):
            out[ds[len("data/"):]] = decode_leaf(rd, ds)
    return out

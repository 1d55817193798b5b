"""``ObjectStoreTier`` — the object store as the real L4 rung.

Write side (composes with :class:`~repro_torch.core.tiers.GlobalTier` in the
level-4 stack):

    Place    every staged file of the checkpoint (the rank container plus
             its sibling shard files) is split into content-addressed
             chunks and the *missing* chunks are submitted to the
             transfer-thread pool — uploads overlap the rest of the store
             tail (and, on a CP-dedicated-thread backend, training);
             chunks shared with previous checkpoints upload nothing.
    Commit   runs after the local atomic rename: joins the transfers
             (surfacing the first failure), then CAS-publishes the
             catalog entry (manifest + file→chunk map).  A crash anywhere
             before the publish leaves the previous catalog entry
             authoritative — the store never advertises a checkpoint
             whose chunks are not all durable.  Retention + GC
             (``keep_last``/``keep_every``) run after a successful
             publish.

Read side: the tier answers the recovery ladder *below* ``global`` — it
resolves the catalog entry, reassembles this rank's file set (manifest,
container, shard files) into a node-local cache directory
(``<node-local>/objstore-cache/ckpt-<id>/``), and returns the rank
payload.  The whole file set is materialized in a directory the
pipeline's recovery-dir scan includes, so a run restores from the object
store alone with L1–L3 (and even the L4 global directory) wiped.  (Shard
files are fetched too; restoring sharded leaves comes with the port's
distributed slice.)

Known limitation (ROADMAP): dedup's exists-check and GC's sweep are not
transactional against each other across *concurrent* writers — a real
multi-writer deployment needs upload pinning (grace-period leases on
young chunks) before GC can run concurrently with stores.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Tuple

from repro_torch.core import manifest as mf
from repro_torch.core.formats import CHK5CorruptionError, CHK5Reader
from repro_torch.core.resharding import indexed_shard_files
from repro_torch.core.tiers import Tier, TierContext
from repro_torch.objstore import gc as objgc
from repro_torch.objstore.catalog import Catalog
from repro_torch.objstore.cdc import CDCParams
from repro_torch.objstore.chunks import (
    ChunkCache,
    ChunkUploader,
    PendingFile,
    fetch_file_delta,
)
from repro_torch.objstore.client import ObjectStoreError, make_object_store


def default_objstore_url(root: str) -> str:
    return "file:" + os.path.join(root, "objstore")


def _cache_matches(path: str, entry) -> bool:
    """Is the cached file byte-identical to the catalog entry?  Verified
    by re-chunking at the entry's recorded (offset, nbytes) ranges and
    comparing digests — size alone would silently reuse a stale cache
    (e.g. a checkpoint id re-stored after its old entry was retired) or
    keep returning a corrupt file instead of refetching the healthy
    bucket.  Offsets make this layout-independent: fixed and CDC entries
    verify identically."""
    try:
        if os.path.getsize(path) != entry.size:
            return False
        with open(path, "rb") as f:
            for digest, offset, nbytes in entry.chunks:
                f.seek(offset)
                data = f.read(nbytes)
                if len(data) != nbytes or \
                        hashlib.sha256(data).hexdigest() != digest:
                    return False
        return True
    except OSError:
        return False


class ObjectStoreTier(Tier):
    """L4 via a content-addressed object store + checkpoint catalog."""

    name = "objstore"
    level = 5                      # last rung of the recovery ladder

    def __init__(self, ctx: TierContext):
        super().__init__(ctx)
        cfg = ctx.cfg
        url = getattr(cfg, "objstore_url", None) or \
            default_objstore_url(cfg.root)
        self.store = make_object_store(url)
        self.catalog = Catalog(self.store)
        cdc = None
        if getattr(cfg, "objstore_chunking", "cdc") == "cdc":
            cdc = CDCParams(
                min_bytes=getattr(cfg, "objstore_cdc_min_bytes", 256 << 10),
                avg_bytes=getattr(cfg, "objstore_cdc_avg_bytes", 1 << 20),
                max_bytes=getattr(cfg, "objstore_cdc_max_bytes", 4 << 20))
        self.uploader = ChunkUploader(
            self.store,
            chunk_bytes=getattr(cfg, "objstore_chunk_bytes", 1 << 20),
            transfers=getattr(cfg, "objstore_transfers", 4),
            cdc=cdc)
        self.keep_last = getattr(cfg, "objstore_keep_last", None)
        self.keep_every = getattr(cfg, "objstore_keep_every", None)
        self._pending: Dict[int, List[PendingFile]] = {}
        #: ckpt_id → basename → in-flight ChunkStream (the fused Pack path)
        self._streams: Dict[int, Dict[str, object]] = {}
        self.stats: Dict[str, int] = {"stores": 0, "restores": 0,
                                      "gc_deleted": 0, "bytes_fetched": 0,
                                      "bytes_cached": 0}
        # payload reads from the cache go through this tier's digest
        # verification, not the byte-oblivious LocalTier
        ctx.catalog_roots.add(self.root)

    # ------------------------------------------------------------------ #

    @property
    def root(self) -> str:
        """The node-local cache dir restored file sets land in (NOT a
        write-path root — Pack never stages here)."""
        return os.path.join(self.ctx.comm.node_local_dir, "objstore-cache")

    # -- write side ----------------------------------------------------- #

    def pack_sink(self, ckpt_id: int, basename: str):
        """Hand Pack a streaming chunk sink for the staged file
        ``basename``: CHK5 writers tee every byte into it, so chunking,
        digesting and the missing-chunk uploads all overlap container
        writing — Place then only *collects* the streams instead of
        re-reading staged files from disk.

        Stores are serialized per pipeline, so a registration for a new
        checkpoint id drops any stale stream set (a store whose tail
        failed between pack and commit)."""
        if ckpt_id not in self._streams:
            self._streams = {ckpt_id: {}}
        stream = self.uploader.open_stream(basename)
        self._streams[ckpt_id][basename] = stream
        return stream

    def place(self, ckpt_id, stage_dir, payload_path, extra_files=()):
        """Collect the Pack-time chunk streams (uploads already in
        flight); fall back to reading + chunking the staged file for any
        payload Pack did not stream (e.g. externally produced files
        entering at Place).  Commit joins.

        Stores are serialized per pipeline (the CP queue), so only one
        upload set is ever in flight: dropping any stale pending entry
        here frees the file handles of a store whose tail failed between
        Place and the commit hook."""
        streams = self._streams.pop(ckpt_id, {})
        self._streams = {}
        pend = []
        for p in (payload_path, *extra_files):
            s = streams.get(os.path.basename(p))
            if s is not None and s.finished:
                pend.append(s.pending())
            else:
                pend.append(self.uploader.submit_file(p))
        self._pending = {ckpt_id: pend}

    def commit(self, ckpt_id: int, manifest: Dict) -> None:
        """After the local atomic rename: join uploads, publish the
        catalog entry, then apply retention + GC."""
        pend = self._pending.pop(ckpt_id, [])
        if not pend:
            return
        files = {p.name: p.result() for p in pend}   # raises on failed put
        self.catalog.publish(ckpt_id, manifest, files)
        self.stats["stores"] += 1
        if self.keep_last is not None or self.keep_every is not None:
            # "retired" sweep: condemn only chunks the retired entries
            # referenced — never a chunk a peer rank of an in-flight
            # coordinated store has uploaded but not yet published, and
            # O(retired) instead of a full bucket walk per store.
            # Orphans from crashed uploads are reclaimed by the offline
            # pass (objstore.gc.collect(..., sweep="bucket")).
            got = objgc.collect(self.store, self.catalog,
                                keep_last=self.keep_last,
                                keep_every=self.keep_every,
                                sweep="retired")
            self.stats["gc_deleted"] += got["deleted"] + \
                got["resumed_deleted"]

    # -- read side ------------------------------------------------------ #

    def list_ids(self) -> List[Tuple[int, str]]:
        """Catalog checkpoint ids, rooted at the cache dir (a wiped run
        discovers its checkpoints from the catalog, not a directory
        scan)."""
        try:
            return [(i, self.root) for i in self.catalog.ids()]
        except (ObjectStoreError, ValueError, KeyError):
            return []

    def recover(self, ckpt_id, rank, root, manifest, dirs):
        if root != self.root:
            return None                  # only answer for the catalog root
        try:
            entry = self.catalog.entry(ckpt_id)
        except (ObjectStoreError, ValueError, KeyError):
            return None
        if entry is None:
            return None
        files = Catalog.file_entries(entry)
        container = f"rank{rank}.chk5"
        if container not in files:
            return None
        d = mf.ckpt_dir(self.root, ckpt_id)
        os.makedirs(d, exist_ok=True)
        try:
            # chunk-level cache shared across entries: recovering entry
            # N+1 after N pulls only the chunks the two do not share
            cache = ChunkCache(os.path.join(self.root, "chunks"))
            mine = [n for n in files
                    if n == container or n.startswith(f"rank{rank}.shard")]

            def fetch(names) -> None:
                for name in names:
                    dest = os.path.join(d, name)
                    if _cache_matches(dest, files[name]):
                        continue         # already materialized, verified
                    got = fetch_file_delta(self.store, files[name], dest,
                                           cache)
                    self.stats["bytes_fetched"] += got["bytes_fetched"]
                    self.stats["bytes_cached"] += got["bytes_cached"]

            fetch(mine)
            # other ranks' shard files the container's cross-rank index
            # names (a multi-process store)
            fetch(sorted(set(indexed_shard_files(os.path.join(d, container)))
                         & set(files) - set(mine)))
        except ObjectStoreError:
            return None
        # the manifest rides the catalog entry; materializing it makes the
        # cache dir a normal committed checkpoint dir for the restore
        # walk.  Always rewritten: the cache may hold a stale manifest
        # from an earlier entry that reused this checkpoint id.
        man_path = os.path.join(d, mf.MANIFEST)
        tmp = man_path + ".part"
        with open(tmp, "w") as f:
            json.dump(entry.get("manifest", {}), f, indent=1,
                      sort_keys=True)
        os.replace(tmp, man_path)
        path = os.path.join(d, container)
        try:
            CHK5Reader(path).close()
        except (OSError, CHK5CorruptionError):
            return None
        self.stats["restores"] += 1
        with open(path, "rb") as f:
            return f.read()

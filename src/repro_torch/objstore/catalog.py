"""The checkpoint catalog — the object store's source of truth.

One JSON document (``catalog/catalog.json``) records every checkpoint
the store holds: checkpoint id → the committed manifest, the file set
(each file's ordered chunk list — :class:`~repro_torch.objstore.chunks.FileEntry`),
and a pin flag retention honors.  Publication is **atomic and last**:
chunks land first (Place), the local commit renames, and only then does
the catalog entry appear — a crash anywhere mid-upload leaves the
previous catalog state authoritative, so a reader can always trust what
the catalog lists (the "libraries must become more fault tolerant"
requirement: the storage layer survives its own partial failures).

Concurrent writers (the per-rank tiers of a coordinated store, GC)
serialize through a **compare-and-swap epoch guard**: every write carries
``epoch = read_epoch + 1`` and is applied with ``if_match=<etag of the
read state>`` — a lost race surfaces as ``PreconditionFailed`` and the
writer re-reads and retries, so merges never drop another rank's files
and a stale writer can never roll the catalog back.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.objstore.chunks import FileEntry
from repro_torch.objstore.client import (
    ObjectStore,
    ObjectStoreError,
    PreconditionFailed,
)

CATALOG_KEY = "catalog/catalog.json"
_EMPTY = {"version": 1, "epoch": 0, "entries": {}}


class CatalogConflictError(ObjectStoreError):
    """CAS retries exhausted — another writer kept winning the epoch."""


class Catalog:
    def __init__(self, store: ObjectStore, key: str = CATALOG_KEY):
        self.store = store
        self.key = key

    # -- reads ---------------------------------------------------------- #

    def read(self) -> Tuple[Dict[str, Any], Optional[str]]:
        """→ (catalog dict, etag) — etag ``None`` means "not created yet"
        (the CAS token for the first publish)."""
        data, etag = self.store.get_with_etag(self.key)
        if data is None:
            return json.loads(json.dumps(_EMPTY)), None
        return json.loads(data.decode()), etag

    def entries(self) -> Dict[int, Dict[str, Any]]:
        cat, _ = self.read()
        return {int(k): v for k, v in cat["entries"].items()}

    def ids(self) -> List[int]:
        return sorted(self.entries())

    def entry(self, ckpt_id: int) -> Optional[Dict[str, Any]]:
        return self.entries().get(int(ckpt_id))

    def epoch(self) -> int:
        return int(self.read()[0]["epoch"])

    def read_if_newer(self, last_epoch: int
                      ) -> Optional[Tuple[Dict[str, Any], int]]:
        """Epoch watch: one catalog read, ``None`` when nothing was
        published since ``last_epoch`` — the subscriber's poll primitive.
        Every catalog mutation bumps the epoch (CAS guard), so a single
        integer comparison decides "anything new?" without parsing
        entries.  → ``(catalog dict, epoch)`` only when newer."""
        cat, _etag = self.read()
        epoch = int(cat["epoch"])
        if epoch <= int(last_epoch):
            return None
        return cat, epoch

    @staticmethod
    def file_entries(entry: Dict[str, Any]) -> Dict[str, FileEntry]:
        return {name: FileEntry.from_json(name, d)
                for name, d in entry.get("files", {}).items()}

    @staticmethod
    def entry_chunks(entry: Dict[str, Any]) -> List[str]:
        """Every chunk digest an entry references.  Rows are
        ``[digest, offset, nbytes]`` (CDC entries) or the legacy
        ``[digest, nbytes]`` — the digest leads in both."""
        out = []
        for d in entry.get("files", {}).values():
            out.extend(row[0] for row in d.get("chunks", []))
        return out

    # -- CAS writes ----------------------------------------------------- #

    def _cas_update(self, mutate, retries: int = 16) -> Dict[str, Any]:
        """Read → ``mutate(catalog)`` → epoch+1 → conditional write; retry
        on a lost race.  ``mutate`` returns False to abort (no write)."""
        for _ in range(retries):
            cat, etag = self.read()
            if mutate(cat) is False:
                return cat
            cat["epoch"] = int(cat["epoch"]) + 1
            try:
                if etag is None:
                    self.store.put(self.key,
                                   json.dumps(cat, sort_keys=True).encode(),
                                   if_none_match=True)
                else:
                    self.store.put(self.key,
                                   json.dumps(cat, sort_keys=True).encode(),
                                   if_match=etag)
                return cat
            except PreconditionFailed:
                continue
        raise CatalogConflictError(
            f"catalog CAS lost {retries} races on {self.key}")

    def publish(self, ckpt_id: int, manifest: Dict[str, Any],
                files: Dict[str, FileEntry], pinned: bool = False
                ) -> Dict[str, Any]:
        """Publish (or merge into) the entry for ``ckpt_id``.

        Ranks of a coordinated store each publish their own file set under
        the same id; the merge unions ``files`` so the entry converges on
        the full multi-rank set regardless of commit order."""
        def mutate(cat):
            e = cat["entries"].setdefault(str(int(ckpt_id)), {
                "id": int(ckpt_id), "files": {}, "pinned": bool(pinned)})
            e["manifest"] = manifest
            e["pinned"] = bool(e.get("pinned", False) or pinned)
            for name, fe in files.items():
                e["files"][name] = fe.to_json()
        return self._cas_update(mutate)

    def remove(self, ckpt_ids) -> Dict[str, Any]:
        """Drop entries (retention retirement).  Pinned entries survive."""
        ids = {str(int(i)) for i in ckpt_ids}

        def mutate(cat):
            hit = False
            for i in list(cat["entries"]):
                if i in ids and not cat["entries"][i].get("pinned"):
                    del cat["entries"][i]
                    hit = True
            if not hit:
                return False
        return self._cas_update(mutate)

    def pin(self, ckpt_id: int, pinned: bool = True) -> Dict[str, Any]:
        def mutate(cat):
            e = cat["entries"].get(str(int(ckpt_id)))
            if e is None:
                return False
            e["pinned"] = bool(pinned)
        return self._cas_update(mutate)

    def live_chunks(self) -> set:
        """Every chunk digest referenced by any published entry — the GC
        live set."""
        live = set()
        for e in self.entries().values():
            live.update(self.entry_chunks(e))
        return live

"""Retention + crash-safe garbage collection of unreferenced chunks.

Policy (``CheckpointConfig.keep_last`` / ``keep_every``):

    keep_last=N     the newest N catalog entries stay published
    keep_every=K    additionally, every checkpoint whose id is a multiple
                    of K stays forever (the "archive one per epoch" knob)
    pinned entries  always stay (manual pin via ``Catalog.pin``)

The sweep is **mark-then-delete** so a crash at any point never loses a
live chunk:

    1. retire entries from the catalog (CAS — the entry disappears
       *first*, so no reader can restore a checkpoint whose chunks are
       about to vanish);
    2. recompute the live set from the *published* catalog and stage the
       condemned-chunk list as ``gc/mark.json`` — before any delete;
    3. delete the marked chunks;
    4. clear the mark.

A crash between 2 and 4 leaves the mark behind; the next collection
**re-verifies** every marked chunk against the current live set before
finishing the sweep (a chunk re-referenced by a newer checkpoint since
the mark was staged is spared), so resuming is safe even if uploads
happened in between.  Invariant tested in tests/test_objstore.py: no
chunk referenced by a published catalog entry is ever deleted.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.objstore.catalog import Catalog
from repro_torch.objstore.chunks import chunk_key
from repro_torch.objstore.client import ObjectStore

GC_MARK_KEY = "gc/mark.json"


def retention_split(ids: Sequence[int], keep_last: Optional[int],
                    keep_every: Optional[int],
                    pinned: Set[int] = frozenset()
                    ) -> Tuple[List[int], List[int]]:
    """→ (keep, retire), both sorted.  ``None`` policy values keep all."""
    ids = sorted(int(i) for i in ids)
    if keep_last is None and keep_every is None:
        return ids, []
    keep = set(pinned)
    if keep_last is not None and keep_last > 0:
        keep.update(ids[-int(keep_last):])
    if keep_every is not None and keep_every > 0:
        keep.update(i for i in ids if i % int(keep_every) == 0)
    return ([i for i in ids if i in keep],
            [i for i in ids if i not in keep])


def _digest_of_key(key: str) -> str:
    return key.rsplit("/", 1)[-1]


def _resume_mark(store: ObjectStore, live: Set[str]) -> int:
    """Finish a crashed sweep: delete marked chunks that are *still*
    unreferenced, spare any the live set reclaimed, then clear the mark."""
    data, _ = store.get_with_etag(GC_MARK_KEY)
    if data is None:
        return 0
    mark = json.loads(data.decode())
    deleted = 0
    for key in mark.get("condemned", []):
        if _digest_of_key(key) in live:
            continue                      # re-referenced since the mark
        store.delete(key)
        deleted += 1
    store.delete(GC_MARK_KEY)
    return deleted


def collect(store: ObjectStore, catalog: Catalog,
            keep_last: Optional[int] = None,
            keep_every: Optional[int] = None,
            sweep: str = "bucket") -> Dict[str, int]:
    """One retention + sweep pass.  Idempotent; safe to re-run after any
    crash (it first resumes a stale mark, re-verified).

    ``sweep`` picks what may be condemned:

    - ``"bucket"`` (default — the offline/admin pass): everything under
      ``chunks/`` not referenced by the published catalog, which also
      reclaims orphans from crashed uploads;
    - ``"retired"`` (what the pipeline's per-store GC uses): only chunks
      the just-retired entries referenced.  This never touches a chunk
      some *other* rank of an in-flight coordinated store has uploaded
      but not yet published — an unpublished chunk was never in a
      retired entry — and costs O(retired), not O(bucket).
    """
    if sweep not in ("bucket", "retired"):
        raise ValueError(f"unknown sweep mode {sweep!r}")
    entries = catalog.entries()
    pinned = {i for i, e in entries.items() if e.get("pinned")}
    _keep, retire = retention_split(list(entries), keep_last, keep_every,
                                    pinned)
    retired_chunks: Set[str] = set()
    if retire:
        for i in retire:
            retired_chunks.update(Catalog.entry_chunks(entries[i]))
        catalog.remove(retire)

    # live set from the *published* catalog — recomputed after retirement
    live = catalog.live_chunks()
    resumed = _resume_mark(store, live)

    if sweep == "bucket":
        candidates = store.list("chunks/")
    else:
        candidates = sorted(chunk_key(h) for h in retired_chunks)
    condemned = [k for k in candidates if _digest_of_key(k) not in live]
    deleted = 0
    if condemned:
        # the mark stages the full condemned list BEFORE any delete: a
        # kill mid-sweep leaves either nothing deleted or a resumable,
        # re-verifiable mark — never an unaccounted half-sweep
        store.put(GC_MARK_KEY, json.dumps(
            {"condemned": condemned}, sort_keys=True).encode())
        for key in condemned:
            store.delete(key)
            deleted += 1
        store.delete(GC_MARK_KEY)
    return {"retired": len(retire), "deleted": deleted,
            "resumed_deleted": resumed, "live": len(live)}

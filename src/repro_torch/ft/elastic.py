"""Elastic rescale-on-restart: resume a run on a different world size.

Combines the manifest search (storage), elastic resharding (core/resharding)
and the data-cursor semantics (data/synthetic): the restarted job reads each
new rank's slice of the saved global state, so a 16-host job can resume on
12 hosts after losing a rack — the paper's restart semantics generalized to
changing topology (future-work direction made concrete).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import manifest as mf
from repro_torch.core.resharding import elastic_restore

_RANK_FILE_RE = re.compile(r"^rank(\d+)\.")


def _materialize_catalog_ckpt(tier, ckpt_id: int) -> bool:
    """Pull every rank's file set of *ckpt_id* out of a catalog-backed
    tier into its cache dir, so ``elastic_restore`` can assemble slices
    from a run whose directory tiers are gone.  The rank set comes from
    the catalog entry's file names (the old world need not be known)."""
    from repro_torch.objstore.catalog import Catalog
    from repro_torch.objstore.client import ObjectStoreError

    try:
        entry = tier.catalog.entry(ckpt_id)
        if entry is None:
            return False
        ranks = sorted({
            int(m.group(1))
            for name in Catalog.file_entries(entry)
            if (m := _RANK_FILE_RE.match(name))})
        ok = False
        for r in ranks:
            got = tier.recover(ckpt_id, r, tier.root,
                               entry.get("manifest", {}), {})
            ok = ok or got is not None
        return ok
    except (AttributeError, ObjectStoreError, ValueError, KeyError):
        return False


def find_latest_sharded(roots, tiers=()) -> Optional[Tuple[str, int]]:
    """Newest committed checkpoint dir across tier roots → (dir, id).

    ``tiers`` extends discovery to catalog-backed tiers (the objstore L4):
    their ids come from ``tier.list_ids()``, and a winning catalog id is
    materialized into the tier's cache dir before it is returned — a run
    whose directory tiers were wiped still rescales from the bucket."""
    best: Optional[Tuple[int, str, object]] = None
    for root in roots:
        for i in mf.list_committed(root):
            if best is None or i > best[0]:
                best = (i, mf.ckpt_dir(root, i), None)
    for tier in tiers:
        for i, root in tier.list_ids():
            if best is None or i > best[0]:
                best = (i, mf.ckpt_dir(root, i), tier)
    if best is None:
        return None
    ckpt_id, d, tier = best
    if tier is not None and not _materialize_catalog_ckpt(tier, ckpt_id):
        # catalog id unusable (outage / missing files): fall back to the
        # best directory-backed checkpoint
        return find_latest_sharded(roots)
    return d, ckpt_id


def rescale_restore(roots, new_world: int, new_rank: int, tiers=()
                    ) -> Optional[Tuple[Dict[str, np.ndarray], int]]:
    got = find_latest_sharded(roots, tiers)
    if got is None:
        return None
    d, ckpt_id = got
    return elastic_restore(d, new_world, new_rank), ckpt_id

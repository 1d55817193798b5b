"""Checkpoint directory layout, manifests, atomic commit, retention.

Layout (one tree per storage tier)::

    <tier_root>/
      ckpt-<id>/                 (committed — atomic os.replace from .tmp)
        manifest.json            (written last inside .tmp, so a committed
                                  dir always has a complete manifest)
        rank<k>.chk5             per-rank payload (shard index for sharded
                                  stores)
        rank<k>.shard<j>.chk5    shard payload files of a sharded store
        rank<k>.partner<j>.chk5  partner replica of rank j held by rank k (L2)
        rank<k>.partner<j>.shard<s>.chk5  partner replica of a shard file
        parity.group<g>.chk5     erasure parity for node-group g (L3)
      latest                     text file: id of newest committed checkpoint

The object-store tier (repro.objstore) adds two trees outside this
layout: the bucket itself (``<root>/objstore/`` under the default
file: backend — content-addressed ``chunks/``, ``catalog/catalog.json``,
``gc/``) and a node-local restore cache
(``<node-local>/objstore-cache/ckpt-<id>/``) where catalog entries are
materialized back into exactly this per-checkpoint dir shape, manifest
included, so the recovery walk treats them like any committed dir.

Commit protocol (coordinated checkpointing, §4.2.1): every rank writes its
payload into ``ckpt-<id>.tmp``; rank 0 writes the manifest after an
allgather of per-rank status; the .tmp → final rename is the commit point.
Multi-file shard sets stage into the same ``.tmp`` dir and each rank's
status lists its full file set, so the rename commits (or a crash loses)
the set atomically — no partial shard set is ever restorable
(``missing_files`` detects post-commit losses; the restore walk refuses
them).  A checkpoint with a quorum of rank payloads + partner copies
covering the stragglers is still restorable (straggler mitigation —
ft/straggler.py).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

MANIFEST = "manifest.json"
LATEST = "latest"


def ckpt_dir(root: str, ckpt_id: int, tmp: bool = False) -> str:
    return os.path.join(root, f"ckpt-{ckpt_id}" + (".tmp" if tmp else ""))


def rank_file(root: str, ckpt_id: int, rank: int, tmp: bool = False) -> str:
    return os.path.join(ckpt_dir(root, ckpt_id, tmp), f"rank{rank}.chk5")


def begin(root: str, ckpt_id: int) -> str:
    d = ckpt_dir(root, ckpt_id, tmp=True)
    os.makedirs(d, exist_ok=True)
    return d


def write_manifest(root: str, ckpt_id: int, meta: Dict[str, Any]) -> None:
    d = ckpt_dir(root, ckpt_id, tmp=True)
    meta = dict(meta, id=ckpt_id, wall_time=time.time())
    tmp = os.path.join(d, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(d, MANIFEST))


def commit(root: str, ckpt_id: int, keep_last: int = 2) -> str:
    """Atomic rename; updates ``latest``; prunes old checkpoints.

    If the destination already exists (coordinated store on a *shared* tier:
    another rank committed first), the commit merges — per-rank files are
    disjoint, so files are moved in and the manifest is refreshed."""
    src = ckpt_dir(root, ckpt_id, tmp=True)
    dst = ckpt_dir(root, ckpt_id)
    if not os.path.exists(os.path.join(src, MANIFEST)):
        raise RuntimeError(f"commit without manifest: {src}")
    if os.path.exists(dst):
        for name in os.listdir(src):
            os.replace(os.path.join(src, name), os.path.join(dst, name))
        shutil.rmtree(src, ignore_errors=True)
    else:
        os.replace(src, dst)
    # durable 'latest' pointer
    tmp = os.path.join(root, LATEST + ".tmp")
    with open(tmp, "w") as f:
        f.write(str(ckpt_id))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, LATEST))
    prune(root, keep_last)
    return dst


def abort(root: str, ckpt_id: int) -> None:
    src = ckpt_dir(root, ckpt_id, tmp=True)
    if os.path.isdir(src):
        shutil.rmtree(src)


def list_committed(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for n in os.listdir(root):
        if n.startswith("ckpt-") and not n.endswith(".tmp"):
            if os.path.exists(os.path.join(root, n, MANIFEST)):
                try:
                    out.append(int(n[5:]))
                except ValueError:
                    pass
    return sorted(out)


def latest_id(root: str) -> Optional[int]:
    """Newest committed id — trusts ``latest`` but falls back to scanning
    (the pointer write could be lost in a crash; the data is still there)."""
    ids = list_committed(root)
    if not ids:
        return None
    p = os.path.join(root, LATEST)
    if os.path.exists(p):
        try:
            cand = int(open(p).read().strip())
            if cand in ids:
                return cand
        except ValueError:
            pass
    return ids[-1]


def read_manifest(root: str, ckpt_id: int) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir(root, ckpt_id), MANIFEST)) as f:
        return json.load(f)


def try_read_manifest(root: str, ckpt_id: int) -> Optional[Dict[str, Any]]:
    """``read_manifest`` or None — for roots that may not exist yet (the
    objstore cache dir is materialized *during* recovery, so the manifest
    appears only after the catalog tier ran)."""
    try:
        return read_manifest(root, ckpt_id)
    except (OSError, json.JSONDecodeError):
        return None


def manifest_files(meta: Dict[str, Any]) -> List[str]:
    """Every payload file the manifest covers (per-rank containers plus
    their shard files — the multi-file commit surface)."""
    out: List[str] = []
    for st in meta.get("ranks") or []:
        if not st:
            continue
        files = st.get("files")
        if files:
            out.extend(files)
        elif "file" in st:              # pre-shard manifests
            out.append(st["file"])
    return out


def missing_files(root: str, ckpt_id: int) -> List[str]:
    """Manifest-covered files absent from a committed checkpoint dir — a
    non-empty result means the (multi-file) payload set is incomplete and
    the checkpoint must not be treated as restorable."""
    d = ckpt_dir(root, ckpt_id)
    meta = read_manifest(root, ckpt_id)
    return [f for f in manifest_files(meta)
            if not os.path.exists(os.path.join(d, f))]


def prune(root: str, keep_last: int) -> None:
    ids = list_committed(root)
    for i in ids[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(ckpt_dir(root, i), ignore_errors=True)

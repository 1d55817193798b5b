"""Sharded snapshots and the serve-side loader — the parts of the JAX
package's ``core/resharding.py`` that this port supports so far.

The port has no sharded tensors yet: every protected leaf takes the
gather path (one host snapshot per leaf), and :func:`load_named_onto`
loads plain ``data/`` leaves only.  Shard-local snapshots of ``DTensor``
leaves, parallel shard files, the ``shardidx/`` readers and elastic
restores are ROADMAP Queue 1, items 4–5.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

from repro_torch.core.formats import CHK5Reader, numpy_to_tensor


def split_sharded(named: Dict[str, Any]
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition protected leaves into (gather-snapshot leaves, shard-local
    snapshots).  Every leaf gathers here."""
    return dict(named), {}


def load_named_onto(container: str, dirs: Sequence[str], rank: int,
                    devices: Mapping[str, Any]) -> Dict[str, Any]:
    """Load every leaf of a committed rank container onto its device — the
    serve-side loader.

    Plain ``data/`` leaves decode through the tier codec dispatch (int8
    etc.) and are placed per ``devices``, a mapping ``name →
    torch.device`` (missing names stay host numpy arrays) that stands in
    for the reference's shardings.  A container with
    sharded leaves (``shardidx/``) raises ``NotImplementedError``: their
    shard files live in ``dirs`` and are read by the distributed part of
    the port, which this one does not have; it never loads a partial tree
    onto the host instead."""
    from repro_torch.core.tiers import decode_leaf   # tiers ⇄ resharding

    named: Dict[str, Any] = {}
    rd = CHK5Reader(container)
    try:
        sharded = [ds for ds in rd.datasets() if ds.startswith("shardidx/")]
        if sharded:
            raise NotImplementedError(
                f"{container}: {len(sharded)} sharded leaves (rank {rank}, "
                f"shard files in {list(dirs)}); loading shard files is "
                f"ROADMAP Queue 1, items 4–5")
        for ds in rd.datasets():
            if not ds.startswith("data/"):
                continue
            name = ds[len("data/"):]
            arr = decode_leaf(rd, ds)
            dev = devices.get(name)
            named[name] = arr if dev is None else numpy_to_tensor(arr, dev)
    finally:
        rd.close()
    return named

"""Sharded snapshots — the part of the JAX package's ``core/resharding.py``
that the pipeline imports, reduced to what this port supports.

The port has no sharded tensors yet: every protected leaf takes the
gather path (one host snapshot per leaf).  Shard-local snapshots of
``DTensor`` leaves, parallel shard files and elastic restores come with
the distributed part of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple


def split_sharded(named: Dict[str, Any]
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition protected leaves into (gather-snapshot leaves, shard-local
    snapshots).  Every leaf gathers here."""
    return dict(named), {}

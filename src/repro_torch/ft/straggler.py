"""Straggler mitigation for coordinated checkpoints.

Two mechanisms (DESIGN.md §4):

1. **CP-dedicated threads** (core/async_engine.py) keep slow I/O off the
   step path entirely — a slow disk delays the *next* checkpoint, not the
   training step.
2. **Quorum commit**: an L2 checkpoint is restorable when, for every rank,
   either its own payload or its partner's replica exists. The commit
   validator below implements that rule, so a straggler (or dead) writer
   does not block the commit — its partner's copy covers it.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core import manifest as mf
from repro_torch.redundancy.groups import Topology

_SHARD_RE = re.compile(r"^rank(\d+)\.shard(\d+)\.chk5$")
_PARTNER_SHARD_RE = re.compile(r"^rank(\d+)\.partner(\d+)\.shard(\d+)\.chk5$")


@dataclass
class QuorumReport:
    restorable: bool
    present: List[int]
    covered_by_partner: List[int]
    lost: List[int]
    #: (rank, shard) pairs whose own shard file is gone but whose partner
    #: replica covers them — multi-file shard sets enter the quorum
    #: rule piecewise, not just the main container
    shards_covered: List[Tuple[int, int]] = field(default_factory=list)


def _shard_inventory(ckpt_dir_path: str
                     ) -> Tuple[Dict[int, Set[int]], Dict[int, Set[int]]]:
    """(own, partner) maps: rank → shard indices present for it.

    Partner shard replicas are discovered by name (any holder counts —
    the file's existence is the coverage, whoever stored it)."""
    own: Dict[int, Set[int]] = {}
    partner: Dict[int, Set[int]] = {}
    try:
        names = os.listdir(ckpt_dir_path)
    except OSError:
        return own, partner
    for name in names:
        m = _SHARD_RE.match(name)
        if m:
            own.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
            continue
        m = _PARTNER_SHARD_RE.match(name)
        if m:
            partner.setdefault(int(m.group(2)), set()).add(int(m.group(3)))
    return own, partner


def validate_quorum(ckpt_dir_path: str, topo: Topology) -> QuorumReport:
    """Is this (possibly incomplete) checkpoint restorable for all ranks?

    A rank is restorable when its container AND every shard file of its
    set is present either as the rank's own write or as a partner
    replica.  The expected shard set is the union of what the rank wrote
    and what its partner holds for it — a shard lost on the straggler's
    disk is covered by ``rank<h>.partner<r>.shard<j>.chk5``."""
    present, covered, lost = [], [], []
    shards_covered: List[Tuple[int, int]] = []
    own_shards, partner_shards = _shard_inventory(ckpt_dir_path)
    for r in range(topo.world):
        own = os.path.join(ckpt_dir_path, f"rank{r}.chk5")
        holder = topo.partner_of(r)
        rep = os.path.join(ckpt_dir_path, f"rank{holder}.partner{r}.chk5")
        container_own = os.path.exists(own)
        container_covered = os.path.exists(rep)
        if not container_own and not container_covered:
            lost.append(r)
            continue
        mine = own_shards.get(r, set())
        held = partner_shards.get(r, set())
        # contiguity check: shard files are numbered 0..n-1, so a hole in
        # the union (own ∪ partner) is a shard nobody holds — lost
        expected = range(len(mine | held))
        if any(j not in mine and j not in held for j in expected):
            lost.append(r)
        elif container_own and not (held - mine):
            present.append(r)
        else:
            covered.append(r)
            shards_covered.extend((r, j) for j in sorted(held - mine))
    return QuorumReport(not lost, present, covered, lost, shards_covered)


def commit_if_quorum(root: str, ckpt_id: int, topo: Topology,
                     extra_meta: Optional[dict] = None) -> bool:
    """Commit a .tmp checkpoint when the quorum rule holds (straggler-safe
    commit path used by the training loop's watchdog)."""
    d = mf.ckpt_dir(root, ckpt_id, tmp=True)
    if not os.path.isdir(d):
        return False
    rep = validate_quorum(d, topo)
    if not rep.restorable:
        return False
    mf.write_manifest(root, ckpt_id, dict(
        extra_meta or {}, kind="FULL", level=2, world=topo.world,
        quorum={"present": rep.present, "partner": rep.covered_by_partner}))
    mf.commit(root, ckpt_id)
    return True

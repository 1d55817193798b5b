"""L2 partner-copy replication (FTI/SCR PARTNER scheme).

Each rank ships its checkpoint payload to its ring partner, which stores it
next to its own (``rank<k>.partner<j>.chk5``). A lost node's state is then
recovered from its partner's node-local storage — no PFS round-trip.

Sharded stores replicate their whole multi-file set: each sibling shard
file ``rank<j>.shard<s>.chk5`` ships under its own tag and lands on the
partner as ``rank<k>.partner<j>.shard<s>.chk5`` (the shard-file resolver in
core/resharding.py knows both names).
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

from repro_torch.core.comm import Communicator
from repro_torch.redundancy.groups import Topology

_SHARD_RE = re.compile(r"^rank(\d+)\.shard(\d+)\.chk5$")


def partner_tag(ckpt_id: int, fname: Optional[str] = None) -> str:
    return f"partner:{ckpt_id}" + (f":{fname}" if fname else "")


def replicate(comm: Communicator, topo: Topology, ckpt_id: int,
              payload: bytes,
              extra: Optional[Dict[str, bytes]] = None) -> int:
    """Send my payload (and any sibling shard files, by basename) to my
    partner; returns the partner rank."""
    partner = topo.partner_of(comm.rank)
    comm.post(partner_tag(ckpt_id), partner, payload)
    names = sorted(extra) if extra else []
    comm.post(partner_tag(ckpt_id, "__files__"), partner,
              json.dumps(names).encode())
    for n in names:
        comm.post(partner_tag(ckpt_id, n), partner, extra[n])
    return partner


def _write(path: str, payload: bytes) -> str:
    with open(path, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    return path


def store_partner_copy(comm: Communicator, topo: Topology, ckpt_id: int,
                       tier_dir: str) -> Optional[str]:
    """Collect the replica set posted *to me* and persist it locally."""
    # whoever has me as partner:
    src = next((r for r in range(comm.world) if topo.partner_of(r) == comm.rank),
               None)
    if src is None:
        return None
    payload = comm.collect(partner_tag(ckpt_id), src)
    if payload is None:
        return None
    os.makedirs(tier_dir, exist_ok=True)
    path = _write(os.path.join(tier_dir, f"rank{comm.rank}.partner{src}.chk5"),
                  payload)
    raw = comm.collect(partner_tag(ckpt_id, "__files__"), src)
    for fname in (json.loads(raw) if raw else []):
        m = _SHARD_RE.match(fname)
        blob = comm.collect(partner_tag(ckpt_id, fname), src)
        if m is None or blob is None:
            continue
        _write(os.path.join(
            tier_dir,
            f"rank{comm.rank}.partner{m.group(1)}.shard{m.group(2)}.chk5"),
            blob)
    return path


def find_partner_copy(topo: Topology, ckpt_dir_path: str, lost_rank: int
                      ) -> Optional[str]:
    """Locate the replica of ``lost_rank`` inside a checkpoint directory."""
    holder = topo.partner_of(lost_rank)
    path = os.path.join(ckpt_dir_path, f"rank{holder}.partner{lost_rank}.chk5")
    return path if os.path.exists(path) else None

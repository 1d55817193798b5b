"""The process-group binding of the checkpoint library's communicator —
the ``comm(...)`` clause of ``chk init`` over ``torch.distributed``.

A ``DeviceMesh`` of N devices is N processes, so a checkpoint of sharded
state needs ranks that agree: the commit's status allgather, the tiers'
barriers, the cross-rank shard index, and the digest exchange of a DIFF
store of a sharded leaf.  :class:`ProcessGroupComm` gives the interface of
``core/comm.py`` over gloo groups of every rank of the joined world:

- two groups of the library's own (``new_group``), never the group
  ``DTensor`` uses: one for the CP-dedicated thread (the commit's
  ``allgather``, the tiers' ``barrier``, the Pack stage's shard index) and
  one for the calling thread (:meth:`exchange`: Plan's digests and dirty
  blocks).  Collectives on one group from two threads deadlock or
  mismatch, and a store's tail may run on the CP thread while the next
  store plans;
- ``post`` / ``collect`` through the world's key-value store (partner
  copies, parity shipping);
- ``peer_local_dir``: the node-local directories of the ranks on this
  host, siblings ``<root>/rank<k>`` of this rank's own.

Every payload is host bytes or host (numpy) objects: a tensor on the card
never enters a gloo collective here — the one place the checkpoint path
copies to the host for the transport is the caller's ``tensor → numpy``.
So the groups are gloo whatever the world's default group is: beside an
NCCL world (``launch/mesh.py``: a card per rank) they carry the same
bytes as on one card, and the CP thread, which launches nothing on the
card, never waits on NCCL's stream, nor the training step's NCCL
collectives on the CP thread's exchange.
"""
from __future__ import annotations

import datetime
import os
import pickle
import re
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.comm import Communicator

_RANK_DIR = re.compile(r"^rank(\d+)$")


def _allgather_pickled(obj: Any, group, world: int) -> Tuple[List[Any], int]:
    """Every rank's ``obj`` (pickled once, gathered as host bytes padded to
    the longest) → (the objects in rank order, this rank's byte count)."""
    buf = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([len(buf)], dtype=torch.int64),
                    group=group)
    longest = max(int(n) for n in sizes)
    mine = torch.zeros(longest, dtype=torch.uint8)
    if buf:
        mine[:len(buf)] = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    outs = [torch.empty(longest, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(outs, mine, group=group)
    return ([pickle.loads(o[:int(n)].numpy().tobytes())
             for o, n in zip(outs, sizes)], len(buf))


class ProcessGroupComm(Communicator):
    """Rank and world of the joined ``torch.distributed`` world; node-local
    storage under ``<local_root>/rank<rank>``."""

    #: ranks run at once (not one after another as in ``SimulatedCluster``):
    #: a directory every rank shares is committed by rank 0 alone
    concurrent = True

    def __init__(self, local_root: str, timeout_s: float = 600.0):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs a joined process "
                               "group (repro_torch.launch.mesh.join)")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.local_root = local_root
        self.node_local_dir = os.path.join(local_root, f"rank{self.rank}")
        os.makedirs(self.node_local_dir, exist_ok=True)
        timeout = datetime.timedelta(seconds=timeout_s)
        # created in the same order on every rank (new_group is collective),
        # gloo beside a gloo or an NCCL default group
        self._group = dist.new_group(backend="gloo", timeout=timeout)
        self._plan_group = dist.new_group(backend="gloo", timeout=timeout)
        self._store = dist.PrefixStore(
            "openchk/mail/", dist.distributed_c10d._get_default_store())
        #: bytes this rank sent through :meth:`exchange` (digests, rows)
        self.exchanged_bytes = 0

    def barrier(self) -> None:
        dist.barrier(group=self._group)

    def allgather(self, obj: Any) -> List[Any]:
        return _allgather_pickled(obj, self._group, self.world)[0]

    def exchange(self, obj: Any) -> List[Any]:
        """``allgather`` for the calling thread (the Plan stage), on a group
        of its own."""
        out, sent = _allgather_pickled(obj, self._plan_group, self.world)
        self.exchanged_bytes += sent
        return out

    def post(self, tag: str, to_rank: int, payload: bytes) -> None:
        key = f"{tag}/{self.rank}/{to_rank}"
        self._store.set(key, payload)
        # a store client's set is not acknowledged; a request on the same
        # connection is answered after it, so once this returns the post
        # is visible to every rank (a barrier then orders it before any
        # collect)
        self._store.check([key])

    def collect(self, tag: str, from_rank: int) -> Optional[bytes]:
        key = f"{tag}/{from_rank}/{self.rank}"
        if not self._store.check([key]):
            return None
        payload = self._store.get(key)
        self._store.delete_key(key)
        return payload

    def peer_local_dir(self, rank: int) -> Optional[str]:
        d = os.path.join(self.local_root, f"rank{rank}")
        return d if os.path.isdir(d) else None

    @property
    def peer_ranks(self) -> List[int]:
        """Every rank with a node-local directory on this host — ranks of
        an earlier, larger world included (a restore on fewer ranks reads
        the shard files they wrote)."""
        found = {int(m.group(1)) for m in map(
            _RANK_DIR.match, os.listdir(self.local_root)) if m}
        return sorted(found | set(range(self.world)))

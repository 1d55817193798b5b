"""Communicator abstraction — the ``comm(...)`` clause of ``chk init``.

Production binding is the jax.distributed process group (rank = process
index over the pod mesh). For this container (1 process) and for unit tests,
``SimulatedCluster`` runs k ranks *in one process* against an in-memory
exchange, so partner-copy and erasure-group logic is exercised for real:
each rank has its own node-local directory; "network" transfers are posts
into the shared exchange.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional



class Communicator:
    """Interface: rank/world + the few collective ops CR needs."""

    rank: int
    world: int
    node_local_dir: str

    def barrier(self) -> None:
        raise NotImplementedError

    def allgather(self, obj: Any) -> List[Any]:
        raise NotImplementedError

    def post(self, tag: str, to_rank: int, payload: bytes) -> None:
        """Asynchronous byte send (partner copies, parity shipping)."""
        raise NotImplementedError

    def collect(self, tag: str, from_rank: int) -> Optional[bytes]:
        raise NotImplementedError

    def peer_local_dir(self, rank: int) -> Optional[str]:
        """Another rank's node-local storage, when reachable (recovery pulls
        partner replicas / parity shards from surviving nodes)."""
        return None


class LocalComm(Communicator):
    """Single-process binding (rank 0 of N=1). In production this is replaced
    by a jax.distributed-backed communicator with identical semantics."""

    def __init__(self, local_dir: str, rank: int = 0, world: int = 1):
        self.rank = rank
        self.world = world
        self.node_local_dir = local_dir
        os.makedirs(local_dir, exist_ok=True)
        self._mailbox: Dict[tuple, bytes] = {}

    def barrier(self) -> None:
        # single process: all local jax work must be flushed before I/O
        pass

    def allgather(self, obj: Any) -> List[Any]:
        return [obj]

    def post(self, tag: str, to_rank: int, payload: bytes) -> None:
        self._mailbox[(tag, self.rank, to_rank)] = payload

    def collect(self, tag: str, from_rank: int) -> Optional[bytes]:
        return self._mailbox.get((tag, from_rank, self.rank))


class _Exchange:
    def __init__(self):
        self.mail: Dict[tuple, bytes] = {}
        self.gathers: Dict[str, Dict[int, Any]] = {}
        self.lock = threading.Lock()


class SimComm(Communicator):
    def __init__(self, exchange: _Exchange, rank: int, world: int,
                 local_dir: str, ranks_per_node: int = 1):
        self._x = exchange
        self.rank = rank
        self.world = world
        self.ranks_per_node = ranks_per_node
        self.node_local_dir = local_dir
        os.makedirs(local_dir, exist_ok=True)

    @property
    def node_id(self) -> int:
        return self.rank // self.ranks_per_node

    def barrier(self) -> None:
        pass  # ranks execute sequentially in tests

    def allgather(self, obj: Any) -> List[Any]:
        """Sequential-test semantics: ranks run one after another, so early
        ranks see partial views (None for absent). Only the *last* rank's
        result is complete — which is the rank whose manifest write survives
        (commit is idempotent/merging), matching coordinated-store usage."""
        with self._x.lock:
            slot = self._x.gathers.setdefault("ag", {})
            slot[self.rank] = obj
            return [slot.get(r) for r in range(self.world)]

    def post(self, tag: str, to_rank: int, payload: bytes) -> None:
        with self._x.lock:
            self._x.mail[(tag, self.rank, to_rank)] = payload

    def collect(self, tag: str, from_rank: int) -> Optional[bytes]:
        with self._x.lock:
            return self._x.mail.get((tag, from_rank, self.rank))

    def peer_local_dir(self, rank: int) -> Optional[str]:
        base = os.path.dirname(self.node_local_dir)
        d = os.path.join(base, f"rank{rank}")
        return d if os.path.isdir(d) else None


class SimulatedCluster:
    """k ranks in one process; rank i's node-local storage lives under
    ``root/nodes/rank<i>``. Tests drive ranks sequentially (for_each_rank)."""

    def __init__(self, root: str, world: int, ranks_per_node: int = 1):
        self.root = root
        self.world = world
        self._x = _Exchange()
        self.comms = [
            SimComm(self._x, r, world, os.path.join(root, "nodes", f"rank{r}"),
                    ranks_per_node)
            for r in range(world)
        ]

    def kill_node(self, rank: int) -> None:
        """Simulate node loss: wipe that rank's node-local storage."""
        import shutil
        d = self.comms[rank].node_local_dir
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.makedirs(d, exist_ok=True)

    def for_each_rank(self, fn: Callable[[Communicator], Any]) -> List[Any]:
        return [fn(c) for c in self.comms]

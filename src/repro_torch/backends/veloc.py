"""VeloC-like backend: memory-mode protect + asynchronous persist.

Mirrors VeloC's API: ``mem_protect / checkpoint(name, version) /
checkpoint_wait / restart_test / restart``. Async by design (the paper's
§4.2.2 is supported here and in FTI); **no checkpoint kinds** — a CHK_DIFF
request falls back to FULL and is counted in stats (paper §3: "VeloC is
still missing some features ... e.g. different checkpointing types").
Two tiers: scratch (node-local, level ≤3) and persistent (level 4); both
are the shared pipeline's tier stacks — VeloC adds no placement code.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.backends.base import Backend
from repro_torch.core.comm import Communicator
from repro_torch.core.storage import CHK_FULL, StorageConfig, StoreRequest

VELOC_SUCCESS = 0
VELOC_FAILURE = -1


class VeloCBackend(Backend):
    name = "veloc"
    supports_diff = False
    supports_dedicated_thread = True
    supports_incremental = True
    max_level = 4

    def __init__(self, cfg: StorageConfig, comm: Communicator,
                 mode: str = "memory",
                 dedicated_thread: bool = True):
        super().__init__(cfg, comm, dedicated_thread=dedicated_thread)
        assert mode in ("memory", "file")
        self.mode = mode
        self._protected: Dict[int, Tuple[str, np.ndarray]] = {}

    # ----------------------- native VeloC-style API -------------------- #

    def mem_protect(self, pid: int, arr, name: str = "region") -> int:
        self._protected[pid] = (name, arr)
        return VELOC_SUCCESS

    def checkpoint(self, name: str, version: int) -> int:
        named = {f"p{pid}/{n}": a
                 for pid, (n, a) in self._protected.items()}
        level = 1 if self.mode == "memory" else 4
        self.tcl_store(StoreRequest(named=named, ckpt_id=version,
                                    level=level, kind=CHK_FULL))
        return VELOC_SUCCESS

    def checkpoint_wait(self) -> int:
        self.tcl_wait()
        return VELOC_SUCCESS

    def restart_test(self, name: str, version: int = 0) -> int:
        self.checkpoint_wait()
        ids = self.engine.available_ids()
        return ids[-1][0] if ids else VELOC_FAILURE

    def restart(self, name: str, version: int) -> int:
        got = self.engine.load_latest()
        if got is None:
            return VELOC_FAILURE
        named, _ = got
        for pid, (n, _a) in self._protected.items():
            key = f"p{pid}/{n}"
            if key not in named:
                return VELOC_FAILURE
            self._protected[pid] = (n, named[key])
        self.stats["loads"] += 1
        return VELOC_SUCCESS

    def recovered(self, pid: int) -> np.ndarray:
        return self._protected[pid][1]

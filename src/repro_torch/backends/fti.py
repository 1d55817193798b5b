"""FTI-like backend: memory-mode, multi-level L1–L4, differential
checkpointing, CP-dedicated threads (the feature superset — §3 of the paper).

Native API mirrors FTI: ``protect / status / recover / checkpoint /
finalize``. Protect registers (id, name, array); checkpoint writes all
protected regions; recover returns them by id after a restart.

The heavy lifting is the shared pipeline (Plan → Pack → Place → Commit);
this class only translates FTI's protect-registry call protocol onto it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.backends.base import Backend
from repro_torch.core.comm import Communicator
from repro_torch.core.storage import (
    CHK_DIFF,
    CHK_FULL,
    StorageConfig,
    StoreReport,
    StoreRequest,
)


class FTIBackend(Backend):
    name = "fti"
    supports_diff = True
    supports_dedicated_thread = True
    supports_incremental = True
    max_level = 4

    def __init__(self, cfg: StorageConfig, comm: Communicator,
                 dedicated_thread: bool = True):
        super().__init__(cfg, comm, dedicated_thread=dedicated_thread)
        self._protected: Dict[int, Tuple[str, np.ndarray]] = {}

    # ----------------------- native FTI-style API ---------------------- #

    def protect(self, pid: int, name: str, arr) -> None:
        self._protected[pid] = (name, arr)

    def status(self) -> bool:
        """FTI_Status: is there anything to recover?"""
        self.tcl_wait()
        return self.engine.load_latest() is not None

    def recover(self) -> Dict[int, np.ndarray]:
        """FTI_Recover: refill protected regions from the newest checkpoint."""
        self.tcl_wait()
        got = self.engine.load_latest()
        if got is None:
            raise RuntimeError("FTI: no checkpoint to recover")
        named, _ = got
        out: Dict[int, np.ndarray] = {}
        for pid, (name, _old) in self._protected.items():
            key = f"p{pid}/{name}"
            if key not in named:
                raise RuntimeError(f"FTI: protected id {pid} ({name}) missing")
            out[pid] = named[key]
        self.stats["loads"] += 1
        return out

    def checkpoint(self, ckpt_id: int, level: int,
                   differential: bool = False) -> Optional[StoreReport]:
        # protected regions ride as they are (tensors stay on their
        # device: Plan hashes and snapshots them there)
        named = {f"p{pid}/{name}": arr
                 for pid, (name, arr) in self._protected.items()}
        return self.tcl_store(StoreRequest(
            named=named, ckpt_id=ckpt_id, level=level,
            kind=CHK_DIFF if differential else CHK_FULL))

    def checkpoint_wait(self) -> None:
        self.tcl_wait()

    def finalize(self) -> None:
        self.tcl_finalize()

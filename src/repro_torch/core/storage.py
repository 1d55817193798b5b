"""Multi-level checkpoint storage engine — a thin facade over the staged
checkpoint pipeline (core/pipeline.py: Plan → Pack → Place → Commit) and
the tier ladder (core/tiers.py: Local/Partner/Erasure/Global).

Levels (paper §4.2.1 / FTI semantics):
  L1  node-local write (RAM-disk / NVMe analogue)
  L2  L1 + partner copy on a different node
  L3  L1 + Reed–Solomon (or XOR) parity across the node group
  L4  parallel-file-system write (global directory)

Restart search order: L1 → L2 (partner) → L3 (erasure reconstruct) → L4,
newest checkpoint id first — exactly FTI's recovery ladder.

All writes go through the manifest commit protocol (atomic rename); payloads
are CHK5 containers, so every checkpoint is also an analyzable dataset
(§4.2.4).

``StorageEngine`` keeps the historical call surface (``store`` /
``load_latest`` / ``available_ids``) for tests, tools and benchmarks;
backends drive the pipeline stages directly (backends/base.py) so that
async, DIFF and incremental stores all compose through the same path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.comm import Communicator
from repro_torch.core.pipeline import (           # re-exported for compatibility
    CHK_DIFF,
    CHK_FULL,
    CheckpointPipeline,
    LoadRequest,
    Packed,
    Plan,
    StorageConfig,
    StoreReport,
    StoreRequest,
)
from repro_torch.core.protect import Protect      # noqa: F401  (re-export)

__all__ = ["CHK_FULL", "CHK_DIFF", "CheckpointPipeline", "LoadRequest",
           "Packed", "Plan", "Protect", "StorageConfig", "StoreReport",
           "StoreRequest", "StorageEngine"]


class StorageEngine:
    """Facade: one object exposing the pipeline's write/read path."""

    def __init__(self, cfg: StorageConfig, comm: Communicator,
                 compose=None, pack_compose=None):
        self.cfg = cfg
        self.comm = comm
        self.pipeline = CheckpointPipeline(cfg, comm, compose=compose,
                                           pack_compose=pack_compose)
        self.topo = self.pipeline.topo
        self.diff = self.pipeline.diff

    # ------------------------------------------------------------------ #

    @property
    def local_root(self) -> str:
        return self.pipeline.local_root

    # ------------------------------------------------------------------ #
    # write path — Plan → Pack → Place → Commit, run synchronously
    # ------------------------------------------------------------------ #

    def store(self, named_host: Dict[str, np.ndarray], ckpt_id: int,
              level: int, kind: str = CHK_FULL,
              extra_meta: Optional[Dict[str, Any]] = None,
              diff_supported: bool = True) -> StoreReport:
        """Coordinated store of this rank's protected data."""
        return self.pipeline.store(StoreRequest(
            named=named_host, ckpt_id=ckpt_id, level=level, kind=kind,
            extra_meta=extra_meta, diff_supported=diff_supported))

    # ------------------------------------------------------------------ #
    # read path — the tier recovery ladder
    # ------------------------------------------------------------------ #

    def available_ids(self) -> List[Tuple[int, str]]:
        return self.pipeline.available_ids()

    def load_latest(self, rank: Optional[int] = None
                    ) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, Any]]]:
        return self.pipeline.load_latest(rank)

    def objstore_tier(self):
        """The composed L4 object-store tier, or None.  This port has no
        object store yet, so this is always None."""
        return None

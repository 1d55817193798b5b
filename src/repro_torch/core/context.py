"""The OpenCHK programming model — directives as a PyTorch API (paper §4).

The four directives and their clauses map 1:1::

    #pragma chk init comm(C)          ctx = CheckpointContext(comm=C, cfg=...)
                                      (or: with CheckpointContext(...) as ctx)
    #pragma chk load(data) if(c)      state = ctx.load(state, if_=c)
    #pragma chk store(data) id(i)     ctx.store(state, id=i, level=l,
            level(l) kind(k) if(c)              kind=k, if_=c)
    #pragma chk shutdown              ctx.shutdown()

Semantics preserved from the paper:
- **transparent restart**: ``load`` returns the restored state if any
  checkpoint is recoverable, else the input unchanged — the program flow is
  never modified to test for restarts;
- ``id`` is mandatory on store (progress identification; the training step
  number is the natural id), ``level`` is mandatory, ``kind`` defaults FULL;
- ``if_`` is the switch-off clause (checkpoint frequency lives here);
- serialization/deserialization is entirely the model's job (TCL + pytree
  flattening);
- the backend is selected by config/env — the same program runs on FTI,
  SCR, or VeloC (portability).

Self-iterative data expressions (§5.2) appear as ``protect`` specs — each
a selector **plus the paper's per-data clauses**::

    ctx.protect(Protect("params/**", kind=CHK_DIFF, compress="int8"),
                Protect("opt/**", format="chk5", precision="bf16"),
                Protect("step"))

``kind`` maps the paper's ``kind(DIFF)`` clause per subtree (mixed-kind
stores fall out: DIFF params + FULL optimizer in one checkpoint),
``compress``/``format``/``precision`` drive the Pack-side tiers
(core/tiers.py), ``axis`` carries explicit sharding-axis metadata
(dist/sharding.py).  Plain selector strings remain accepted (deprecated)
and convert to clause-less specs.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Union

from repro_torch.core.comm import Communicator, LocalComm
from repro_torch.core.pipeline import LoadRequest, StoreRequest
from repro_torch.core.protect import Protect, normalize_protects
from repro_torch.core.storage import CHK_DIFF, CHK_FULL, StorageConfig, StoreReport
from repro_torch.core.tcl import TCL

__all__ = ["CheckpointContext", "CheckpointConfig", "CHK_FULL", "CHK_DIFF",
           "Protect"]


@dataclass
class CheckpointConfig:
    """User-facing config (the paper's per-system configuration file)."""

    dir: str                                   # checkpoint root
    backend: Optional[str] = None              # None → $OPENCHK_BACKEND → fti
    block_bytes: int = 65_536                  # dCP block granularity
    keep_last_full: int = 2
    group_size: int = 4
    erasure_scheme: str = "rs"
    rs_parity: int = 2
    promote_threshold: float = 0.95
    dedicated_thread: bool = True              # CP-dedicated threads (§4.2.2)
    # object-store L4 (repro_torch.objstore): content-addressed uploads + catalog
    objstore: bool = True
    objstore_url: Optional[str] = None         # None → file:<dir>/objstore
    objstore_chunk_bytes: int = 1 << 20        # fixed-mode chunk size
    objstore_chunking: str = "cdc"             # "cdc" | "fixed"
    objstore_cdc_min_bytes: int = 256 << 10    # CDC lower cut bound
    objstore_cdc_avg_bytes: int = 1 << 20      # CDC target average
    objstore_cdc_max_bytes: int = 4 << 20      # CDC forced-cut bound
    objstore_transfers: int = 4                # parallel transfer threads
    # retention clauses over the objstore catalog: keep the newest
    # ``keep_last`` checkpoints plus every ``keep_every``-th id; GC sweeps
    # the chunks nothing references (both None → keep everything)
    keep_last: Optional[int] = None
    keep_every: Optional[int] = None

    def storage(self) -> StorageConfig:
        return StorageConfig(
            root=self.dir,
            block_bytes=self.block_bytes,
            keep_last_full=self.keep_last_full,
            group_size=self.group_size,
            erasure_scheme=self.erasure_scheme,
            rs_parity=self.rs_parity,
            promote_threshold=self.promote_threshold,
            objstore=self.objstore,
            objstore_url=self.objstore_url,
            objstore_chunk_bytes=self.objstore_chunk_bytes,
            objstore_chunking=self.objstore_chunking,
            objstore_cdc_min_bytes=self.objstore_cdc_min_bytes,
            objstore_cdc_avg_bytes=self.objstore_cdc_avg_bytes,
            objstore_cdc_max_bytes=self.objstore_cdc_max_bytes,
            objstore_transfers=self.objstore_transfers,
            objstore_keep_last=self.keep_last,
            objstore_keep_every=self.keep_every,
        )


class CheckpointContext:
    """``chk init`` … ``chk shutdown`` — a checkpoint context."""

    def __init__(self, cfg: CheckpointConfig,
                 comm: Optional[Communicator] = None):
        # the comm clause is mandatory in the paper; default to the
        # single-process communicator with node-local storage under cfg.dir
        self.comm = comm if comm is not None else LocalComm(
            os.path.join(cfg.dir, "node-local"))
        backend_kw = {}
        # every backend accepts the CP-thread switch (base Backend ANDs it
        # with the declared capability, so it is a no-op where unsupported)
        if not cfg.dedicated_thread:
            backend_kw["dedicated_thread"] = False
        self.tcl = TCL(cfg.storage(), self.comm, cfg.backend, **backend_kw)
        self.cfg = cfg
        self._protects: Optional[List[Protect]] = None
        self._open = True
        self.last_report: Optional[StoreReport] = None
        self.restarted: bool = False

    # ------------------------------------------------------------------ #
    # directives
    # ------------------------------------------------------------------ #

    def observe_store_reports(self, cb) -> "CheckpointContext":
        """Register *cb* to receive every committed
        :class:`~repro_torch.core.pipeline.StoreReport` (async tails included) —
        the cadence controller's store-cost feed
        (``repro_torch.chaos.cadence.CadenceController.note_report``)."""
        self.tcl.backend.pipeline.on_report = cb
        return self

    def protect(self, *specs: Union[str, Protect]) -> "CheckpointContext":
        """Declare the protected subtrees with their per-subtree clauses
        (self-iterative data expressions + the paper's data clauses):
        ``Protect(selector, kind=..., compress=..., format=...,
        precision=..., axis=...)``.  Plain selector strings are the
        deprecated clause-less form.  No arguments → protect everything."""
        self._protects = normalize_protects(specs)
        return self

    def load(self, state: Any, if_: bool = True) -> Any:
        """``chk load`` — transparent restart. Never changes program flow:
        returns the restored state, or ``state`` unchanged."""
        self._check_open()
        if not if_:
            return state
        restored = self.tcl.load(LoadRequest(
            template=state, protects=self._protects))
        if restored is None:
            return state
        self.restarted = True
        return restored

    def store(self, state: Any, *, id: int, level: int,
              kind: str = CHK_FULL, if_: bool = True) -> Optional[StoreReport]:
        """``chk store`` — id and level are mandatory clauses (paper §4.1).
        ``kind`` is the store-level default; a ``Protect(kind=...)`` clause
        overrides it per subtree (mixed-kind stores)."""
        self._check_open()
        if not if_:
            return None
        self.last_report = self.tcl.store(StoreRequest(
            tree=state, ckpt_id=int(id), level=int(level), kind=kind,
            protects=self._protects))
        return self.last_report

    def store_begin(self, *, id: int, level: int,
                    if_: bool = True):
        """Incremental checkpointing (paper §8 Future Work): open a
        checkpoint and ``add`` parts as they become ready; ``commit``
        finalizes (manifest + redundancy) through the pipeline's
        Place → Commit stages — asynchronously when the backend has a
        CP-dedicated thread (no fence against in-flight stores: the CP
        queue serializes commits, and parts stage into a private ``.tmp``
        dir). Returns None when ``if_`` is false (switch-off clause)."""
        self._check_open()
        if not if_:
            return None
        return self.tcl.store_begin(int(id), int(level))

    def wait(self) -> None:
        """Fence any CP-dedicated-thread work (surfaces deferred errors)."""
        self.tcl.wait()

    def shutdown(self) -> None:
        """``chk shutdown``."""
        if self._open:
            self.tcl.finalize()
            self._open = False

    # ------------------------------------------------------------------ #

    @property
    def stats(self):
        return self.tcl.backend.stats

    def _check_open(self) -> None:
        if not self._open:
            raise RuntimeError("checkpoint context is shut down")

    def __enter__(self) -> "CheckpointContext":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

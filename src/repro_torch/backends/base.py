"""Backend base: the "native library" surface each backend exposes, plus
the *uniform* pipeline driving that all of them share.

Each backend mirrors the real library's API shape (names, call protocol,
quirks) — that is what the paper's SLOC/programmability comparison is
about: using these *directly* is verbose; using them through the OpenCHK
directives is five lines (benchmarks/bench_sloc.py reproduces Tables 4–6).

What a backend *declares* (capabilities):

    supports_diff               checkpoint kinds (CHK_DIFF) available?
    supports_dedicated_thread   CP-dedicated thread (§4.2.2) available?
    supports_incremental        §8 incremental stores available?
    max_level                   deepest ladder rung

What a backend *composes* (``compose_tiers``): the level → tier-stack map
the pipeline places with.  No backend re-implements placement, redundancy
or commit — those are pipeline stages (core/pipeline.py).

Asynchrony is uniform: Plan always runs on the calling thread (device
snapshot / on-device diff kernels, digest ordering); when the backend has a
CP-dedicated thread, the Pack → Place → Commit tail is submitted to it —
for FULL, DIFF *and* incremental stores alike.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.core.async_engine import CPDedicatedThread
from repro_torch.core.comm import Communicator
from repro_torch.core.storage import (
    CHK_FULL,
    LoadRequest,
    StorageConfig,
    StorageEngine,
    StoreReport,
    StoreRequest,
)


class Backend(abc.ABC):
    """Capabilities + the uniform entry points TCL drives."""

    name: str = "?"
    supports_diff: bool = False
    supports_dedicated_thread: bool = False
    supports_incremental: bool = True
    max_level: int = 4

    def __init__(self, cfg: StorageConfig, comm: Communicator,
                 dedicated_thread: Optional[bool] = None):
        self.cfg = cfg
        self.comm = comm
        self.engine = StorageEngine(cfg, comm, compose=self.compose_tiers(),
                                    pack_compose=self.compose_pack_tiers())
        self.pipeline = self.engine.pipeline
        use_cp = (self.supports_dedicated_thread if dedicated_thread is None
                  else dedicated_thread and self.supports_dedicated_thread)
        self._cp: Optional[CPDedicatedThread] = (
            CPDedicatedThread(name=f"openchk-cp-{self.name}")
            if use_cp else None)
        self.stats: Dict[str, Any] = {"stores": 0, "loads": 0,
                                      "diff_fallbacks": 0, "bytes": 0}

    # --- declaration hooks -------------------------------------------- #

    def compose_tiers(self) -> Optional[Callable]:
        """Return a ``TierContext → {level: [Tier, ...]}`` composer, or None
        for the default FTI ladder (core/tiers.default_tier_stacks).
        Override to plug in custom tiers without touching the pipeline."""
        return None

    def compose_pack_tiers(self) -> Optional[Callable]:
        """Return a ``() → [PackTier, ...]`` composer for the Pack-stage
        encoder chain (clause-consuming: compression codecs first, the CHK5
        format tier as fallback — core/tiers.default_pack_tiers), or None
        for the default.  Override to add codecs without touching Pack."""
        return None

    def capabilities(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "diff": self.supports_diff,
            "dedicated_thread": self.supports_dedicated_thread,
            "incremental": self.supports_incremental,
            "max_level": self.max_level,
            # the object-store L4 rung rides the shared pipeline stacks,
            # so every backend gains it from config, not from backend code
            "objstore": self.engine.objstore_tier() is not None,
        }

    # --- uniform surface driven by TCL -------------------------------- #

    @staticmethod
    def as_request(named_or_req, ckpt_id=None, level=None,
                   kind=None) -> StoreRequest:
        """Normalize the TCL call protocol: the single ``StoreRequest``
        object carries everything; the old positional form
        ``(named, ckpt_id, level, kind)`` converts to a clause-less one."""
        if isinstance(named_or_req, StoreRequest):
            return named_or_req
        return StoreRequest(named=named_or_req, ckpt_id=int(ckpt_id),
                            level=int(level), kind=kind or CHK_FULL)

    def tcl_store(self, req: Any, ckpt_id: Optional[int] = None,
                  level: Optional[int] = None,
                  kind: Optional[str] = None) -> Optional[StoreReport]:
        """Plan on the calling thread; finish sync or on the CP thread.
        Returns None when the store was handed to the CP thread (errors
        surface at the next directive, FTI-style).

        ``req`` is a :class:`StoreRequest` (clause specs included); the
        legacy positional protocol is accepted via :meth:`as_request`."""
        req = self.as_request(req, ckpt_id, level, kind)
        if self._cp is not None:
            # surface deferred failures BEFORE plan() touches the digest
            # chain — otherwise a dropped store leaves digests pointing at
            # data no committed checkpoint holds
            self._cp.check_errors()
        if req.wants_diff and not self.supports_diff:
            self.stats["diff_fallbacks"] += 1
        req.level = min(req.level, self.max_level)
        req.diff_supported = self.supports_diff
        plan = self.pipeline.plan(req)
        if self._cp is not None:
            try:
                self._cp.submit(req.ckpt_id, lambda: self._finish(plan))
            except BaseException:
                # the tail will never run — drop the digests Plan
                # committed for this store
                self.pipeline.abort_plan(plan)
                raise
            return None
        return self._finish(plan)

    def _finish(self, plan) -> StoreReport:
        rep = self.pipeline.finish(plan)
        self.stats["stores"] += 1
        self.stats["bytes"] += rep.bytes_payload
        return rep

    def tcl_load(self, req: Optional[LoadRequest] = None
                 ) -> Optional[Dict[str, np.ndarray]]:
        """Restore the newest restorable checkpoint's named leaves (codec
        datasets are decoded and roundtrip-verified by the Pack tiers'
        read side).  ``req`` carries the load-side clause specs; backends
        that restore whole containers don't need it, but it rides the
        uniform protocol so subclasses can consume it.

        Leaves come back as host numpy arrays; TCL puts each on its
        template leaf's device."""
        self.tcl_wait()
        got = self.engine.load_latest()
        if got is None:
            return None
        self.stats["loads"] += 1
        return got[0]

    def tcl_store_begin(self, ckpt_id: int, level: int,
                        extra_meta: Optional[Dict[str, Any]] = None):
        """Open an incremental store.  ``core/incremental.py`` is not
        ported to this package yet, so this raises."""
        if not self.supports_incremental:
            raise NotImplementedError(
                f"backend {self.name!r} has no incremental stores")
        raise NotImplementedError(
            "incremental stores (core/incremental.py) are not ported to "
            "repro_torch yet; they come with the next slice of the port")

    def tcl_wait(self) -> None:
        """Fence asynchronous work (no-op for synchronous backends)."""
        if self._cp is not None:
            self._cp.wait()
            self._cp.check_errors()

    def tcl_finalize(self) -> None:
        if self._cp is not None:
            self._cp.wait()
            try:
                # a failure in the very last async store must not vanish:
                # shutdown is the final directive that can surface it
                self._cp.check_errors()
            finally:
                self._cp.shutdown()
        else:
            self.tcl_wait()

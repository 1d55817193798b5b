"""SCR-like backend: file-mode with ``route_file`` semantics and SCR's
start/complete checkpoint-phase protocol + custom redundancy groups.

The user (or TCL) is handed a *path* to write; SCR decides where that path
lives (which tier), and on ``complete_checkpoint`` enters the shared
pipeline at the Place stage — redundancy and the manifest commit are
pipeline code, not SCR code.  Restart discovery (`have_restart` →
`start_restart` → route → complete) reads through the same recovery ladder.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from repro_torch.backends.base import Backend
from repro_torch.core import manifest as mf
from repro_torch.core.comm import Communicator
from repro_torch.core.formats import CHK5Writer
from repro_torch.core.protect import to_host
from repro_torch.core.resharding import split_sharded
from repro_torch.core.storage import CHK_FULL, StorageConfig, StoreReport
from repro_torch.core.tiers import pack_named


class SCRBackend(Backend):
    name = "scr"
    supports_diff = False            # SCR has no checkpoint kinds
    supports_dedicated_thread = False
    supports_incremental = True
    max_level = 4

    def __init__(self, cfg: StorageConfig, comm: Communicator,
                 checkpoint_interval: int = 1,
                 dedicated_thread: Optional[bool] = None):
        # dedicated_thread accepted for a uniform construction surface;
        # SCR declares no CP-thread support, so it can only stay False
        super().__init__(cfg, comm, dedicated_thread=dedicated_thread)
        self._phase: Optional[str] = None
        self._cur_id: Optional[int] = None
        self._cur_level: int = 2
        self._routed: Dict[str, str] = {}
        self._since_ckpt = 0
        self._interval = checkpoint_interval

    # ----------------------- native SCR-style API ---------------------- #

    def need_checkpoint(self) -> bool:
        self._since_ckpt += 1
        return self._since_ckpt >= self._interval

    def start_checkpoint(self, ckpt_id: int, level: int = 2) -> None:
        assert self._phase is None, "nested SCR checkpoint phase"
        self._phase = "ckpt"
        self._cur_id = ckpt_id
        self._cur_level = level
        mf.begin(self.pipeline.tier_root(level), ckpt_id)
        self._routed.clear()
        self._since_ckpt = 0

    def route_file(self, name: str) -> str:
        """SCR_Route_file: where should this rank write ``name``?"""
        assert self._phase in ("ckpt", "restart"), "route_file outside phase"
        if self._phase == "ckpt":
            root = self.pipeline.tier_root(self._cur_level)
            d = mf.ckpt_dir(root, self._cur_id, tmp=True)
            path = os.path.join(d, f"rank{self.comm.rank}.chk5")
            self._routed[name] = path
            return path
        root, cid = self._restart_src
        return os.path.join(mf.ckpt_dir(root, cid), f"rank{self.comm.rank}.chk5")

    def complete_checkpoint(self, valid: bool) -> Optional[StoreReport]:
        assert self._phase == "ckpt"
        self._phase = None
        ckpt_id, level = self._cur_id, self._cur_level
        plan = self.pipeline.plan_external(ckpt_id, level,
                                           extra_meta={"file_mode": True})
        if not valid:
            mf.abort(plan.root, ckpt_id)
            return None
        d = mf.ckpt_dir(plan.root, ckpt_id, tmp=True)
        nbytes = sum(os.path.getsize(p) for p in
                     (os.path.join(d, f) for f in os.listdir(d))
                     if os.path.isfile(p))
        payload = next(iter(self._routed.values()), os.path.join(
            d, f"rank{self.comm.rank}.chk5"))
        rep = self.pipeline.finish_external(plan, payload, nbytes)
        self.stats["stores"] += 1
        self.stats["bytes"] += nbytes
        return rep

    def have_restart(self) -> Optional[int]:
        ids = self.engine.available_ids()
        return ids[-1][0] if ids else None

    def start_restart(self) -> Optional[int]:
        ids = self.engine.available_ids()
        if not ids:
            return None
        cid, root = ids[-1]
        self._phase = "restart"
        self._restart_src = (root, cid)
        return cid

    def complete_restart(self, ok: bool) -> None:
        assert self._phase == "restart"
        self._phase = None
        if ok:
            self.stats["loads"] += 1

    # ----------------------- TCL uniform surface ----------------------- #

    def tcl_store(self, req, ckpt_id=None, level=None,
                  kind=None) -> Optional[StoreReport]:
        """File-mode store: SCR routes the path and writes the container
        itself, but leaf encoding still runs the shared Pack-tier chain —
        clause specs (compression codec, format attrs, precision) apply
        identically on all backends.  Kind clauses fall back to FULL (SCR
        has no checkpoint kinds)."""
        req = self.as_request(req, ckpt_id, level, kind)
        if req.wants_diff:
            self.stats["diff_fallbacks"] += 1      # SCR: kinds unsupported
        self.start_checkpoint(req.ckpt_id, min(req.level, self.max_level))
        path = self.route_file("openchk.chk5")
        # every leaf gathers to one host snapshot in this port (no sharded
        # tensors yet: core/resharding.py), so no shard files are written
        gather, _sharded = split_sharded(req.named)
        named_host = to_host(gather)
        with CHK5Writer(path) as w:
            w.set_attrs("", {"kind": CHK_FULL, "id": req.ckpt_id})
            pack_named(w, named_host, req.specs,
                       self.pipeline.pack_tiers)
        return self.complete_checkpoint(valid=True)

    def tcl_load(self, req=None):
        cid = self.start_restart()
        if cid is None:
            return None
        self.route_file("openchk.chk5")
        # read through the shared recovery ladder: codec datasets decode
        # roundtrip-verified (the native route-file restart path is
        # unchanged).  SCR stores no DIFF links, so every leaf comes back
        # as a host array or a lazy sharded ref for TCL to place
        got = self.engine.load_latest(
            devices=req.devices if req is not None else None,
            lazy_sharded=True)
        if got is None:
            self.complete_restart(False)
            return None
        self.complete_restart(True)
        return got[0]
    # tcl_wait / tcl_finalize: inherited no-op fence (no CP thread)

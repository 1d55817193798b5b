"""Incremental checkpointing — the paper's §8 Future Work, implemented.

    "a checkpoint is not fully written at one time, but incrementally
     built in several separated write operations that are performed as
     soon as the data is ready […] forces, then velocities, then the
     positions. Overall, all the variables are checkpointed, but the
     write operations are separated in time, to decrease storage
     congestion and maximize parallelization."

The training-loop analogue: gradients→optimizer-moments→params become
valid at different points inside a step (and per layer under pipelining);
each part ships as soon as it is ready instead of as one burst.

API (directive-style)::

    inc = ctx.store_begin(id=step, level=2)     # opens the checkpoint
    inc.add(grads_part,  prefix="opt")          # as soon as it's ready
    inc.add(new_params,  prefix="params")
    inc.commit()                                 # manifest + redundancy

An incremental store is a pipeline store whose Pack stage is spread over
time by the caller: ``add`` appends parts to the staged container, and
``commit`` runs the ordinary Place → Commit tail — so level-2/3
incremental checkpoints get exactly the same partner/erasure redundancy as
monolithic ones, and on a backend with a CP-dedicated thread the tail runs
asynchronously (``commit`` then returns None; errors surface at the next
directive, like any async store).

The container stays uncommitted (``.tmp``) until ``commit``; a crash
mid-build leaves no restorable-but-partial checkpoint (same atomicity as
regular stores).

Digests for later DIFF stores: ``add`` launches each part's block hash on
the part's device *before* its device→host snapshot (the blockhash kernel
on the card, on the current stream, so both read the same bytes even if
the caller updates the tensors in place right after ``add`` returns), and
``commit`` makes them the DIFF base — as a FULL store's Plan does.  (The
JAX package hashes the host copies at commit; here that would run the
plain hash on the CPU.)
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import manifest as mf
from repro_torch.core.formats import CHK5Writer, dtype_to_str
from repro_torch.core.protect import flatten_named, to_host
from repro_torch.core.storage import CHK_FULL, StorageEngine, StoreReport


class IncrementalStore:
    def __init__(self, engine: StorageEngine, ckpt_id: int, level: int,
                 extra_meta: Optional[Dict[str, Any]] = None,
                 cp=None, stats: Optional[Dict[str, Any]] = None):
        self.engine = engine
        self.pipeline = engine.pipeline
        self.ckpt_id = ckpt_id
        self.extra_meta = dict(extra_meta or {})
        self._cp = cp                       # backend's CP-dedicated thread
        self._stats = stats
        self._t0 = time.time()
        self._plan = self.pipeline.plan_external(
            ckpt_id, level, extra_meta=dict(self.extra_meta,
                                            incremental=True))
        self.level = self._plan.level
        d = mf.begin(self._plan.root, ckpt_id)
        self._path = os.path.join(d, f"rank{engine.comm.rank}.chk5")
        self._writer = CHK5Writer(self._path)
        self._writer.set_attrs("", dict(self.extra_meta, kind=CHK_FULL,
                                        incremental=True))
        self._names: List[str] = []
        self._digests: Dict[str, torch.Tensor] = {}   # launched in add
        self._committed = False

    def add(self, subtree: Any, prefix: str = "") -> "IncrementalStore":
        """Write one part now: launch its digests on its device, take the
        device→host snapshot, append it to the container."""
        assert not self._committed, "incremental store already committed"
        named = {f"{prefix}/{name}" if prefix else name: leaf
                 for name, leaf in flatten_named(subtree).items()}
        for full in named:
            if full in self._digests:
                raise ValueError(f"part {full!r} written twice")
        self._digests.update(self.pipeline.diff.launch_digests(named))
        host = to_host(named)
        for full, arr in host.items():
            self._writer.write_dataset(
                f"data/{full}", np.asarray(arr),
                {"dtype": dtype_to_str(arr.dtype),
                 "part_time": time.time() - self._t0})
            self._names.append(full)
        return self

    def abort(self) -> None:
        if not self._committed:
            self._writer.close()
            mf.abort(self._plan.root, self.ckpt_id)
            self._committed = True

    def commit(self) -> Optional[StoreReport]:
        """Close the container, then run the pipeline's Place → Commit tail
        (level redundancy + atomic manifest commit).

        Synchronous backend: returns the StoreReport.  With a CP-dedicated
        thread the tail runs asynchronously and commit returns None."""
        assert not self._committed
        if self._cp is not None:
            # surface deferred failures BEFORE closing the writer or
            # touching the digest chain: on raise, this store stays
            # uncommitted and commit() can be retried
            self._cp.check_errors()
        self._writer.close()
        self._committed = True
        nbytes = os.path.getsize(self._path)
        # digest coherence for subsequent CHK_DIFF stores — on the calling
        # thread, so an immediately following DIFF plan sees this base
        self.pipeline.diff.commit_digests(self._digests)
        plan = self._plan
        plan.extra["parts"] = list(self._names)
        # report seconds = build time (begin→commit) + tail work, but not
        # time spent waiting in the CP queue behind other stores
        plan.plan_seconds = time.time() - self._t0

        def tail() -> StoreReport:
            rep = self.pipeline.finish_external(plan, self._path, nbytes)
            if self._stats is not None:
                self._stats["stores"] += 1
                self._stats["bytes"] += rep.bytes_payload
            return rep

        if self._cp is not None:
            self._cp.submit(self.ckpt_id, tail)
            return None
        return tail()

"""TCL — the Transparent Checkpoint Library layer (paper §5.3).

TCL sits between the directives (context.py) and the backends: it owns
serialization (state tree ⇄ named tensors — the work Mercurium + TCL share
in the paper), resolves the directive's ``Protect`` clause specs over the
flattened tree, and forwards one :class:`StoreRequest` /
:class:`LoadRequest` object to the selected backend.

TCL hands the backend the protected tensors where they live; the
pipeline's Plan stage (core/pipeline.py) then runs the hash/pack kernels
on their device and takes the device→host snapshot on this thread, in
submission order — the synchronous cost the paper budgets for §4.2.2 —
before the Pack → Place → Commit tail goes to a CP-dedicated thread when
the backend has one.

On restore, every leaf lands on the template leaf's device with the
template's dtype (a dtype that differs from the checkpoint's is an error,
as in the JAX package).  Numpy and scalar template leaves restore as
numpy arrays.  TCL hands the pipeline each plain tensor leaf's device
(``LoadRequest.devices``), so a DIFF chain replays there; such a leaf
comes back already on its device and is taken as it is.  A sharded leaf
(a ``ShardedLeafRef`` from a shard-file checkpoint) passes the same shape
and dtype checks against the template, is read once into host memory and
placed on the template leaf's device.

Mesh-change restart: a template leaf that is a ``DTensor`` is the
*target* layout (``core/resharding.reshard_tree`` builds such templates).
Its value is built by ``assemble_onto`` on the template's mesh and
placements: this rank reads only its box from the shard files (or slices
it from a gathered leaf) and replays the DIFF links inside it — store on
2×2, restore on 1×4 or on another number of processes, without the
global array on any host.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.backends.base import Backend
from repro_torch.backends.registry import make_backend
from repro_torch.core.comm import Communicator
from repro_torch.core.formats import dtype_to_str, numpy_to_tensor
from repro_torch.core.pipeline import LoadRequest, StoreRequest
from repro_torch.core.protect import (
    flatten_named,
    leaf_dtype_str,
    normalize_protects,
    resolve_specs,
    unflatten_named,
)
from repro_torch.core.resharding import (
    ShardedLeafRef,
    assemble_onto,
    is_dtensor,
    sharding_of,
)
from repro_torch.core.storage import CHK_FULL, StorageConfig, StoreReport
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace


class TCL:
    def __init__(self, cfg: StorageConfig, comm: Communicator,
                 backend: Optional[str] = None, **backend_kw):
        self.backend: Backend = make_backend(cfg, comm, backend, **backend_kw)
        self.comm = comm

    # ------------------------------------------------------------------ #

    def store(self, req: Any, ckpt_id: Optional[int] = None,
              level: Optional[int] = None, kind: str = CHK_FULL,
              selectors: Optional[List[str]] = None
              ) -> Optional[StoreReport]:
        """Resolve the request's clause specs over the flattened tree and
        forward the one request object to the backend.

        Leaves stay on their device here: the pipeline's Plan stage
        performs the snapshot (and, for CHK_DIFF subtrees, the on-device
        hash/pack) synchronously; everything after may be asynchronous."""
        if not isinstance(req, StoreRequest):    # legacy positional protocol
            req = StoreRequest(tree=req, ckpt_id=int(ckpt_id),
                               level=int(level), kind=kind,
                               protects=normalize_protects(selectors))
        if req.named is None:
            named_all = flatten_named(req.tree)
            req.specs = resolve_specs(named_all, req.protects)
            req.named = {p: named_all[p] for p in req.specs}
        return self.backend.tcl_store(req)

    def store_begin(self, ckpt_id: int, level: int):
        """Open an incremental store (§8) on the backend's pipeline — parts
        are added as they become ready; commit may be asynchronous."""
        return self.backend.tcl_store_begin(ckpt_id, level)

    def load(self, req: Any,
             selectors: Optional[List[str]] = None) -> Optional[Any]:
        """Transparent restart: returns a tree shaped like the request's
        template with restored leaves, or None when no checkpoint exists."""
        if not isinstance(req, LoadRequest):     # legacy positional protocol
            req = LoadRequest(template=req,
                              protects=normalize_protects(selectors))
        named_t = flatten_named(req.template)
        req.specs = resolve_specs(named_t, req.protects)
        req.devices = {p: named_t[p].device for p in req.specs
                       if isinstance(named_t[p], torch.Tensor)
                       and not is_dtensor(named_t[p])}
        restored = self.backend.tcl_load(req)
        if restored is None:
            return None
        merged: Dict[str, Any] = {}
        placed = 0                  # bytes of host arrays put on a device
        with ttrace.span("restore.h2d", memory="pageable") as sp:
            for path, leaf in named_t.items():
                if path not in req.specs:
                    merged[path] = leaf
                    continue
                if path not in restored:
                    raise KeyError(
                        f"checkpoint missing protected leaf {path!r}")
                arr = restored[path]
                if list(arr.shape) != list(np.shape(leaf)):
                    raise ValueError(
                        f"{path}: checkpoint shape {arr.shape} != "
                        f"template {tuple(np.shape(leaf))} "
                        "(use elastic restore)")
                got_dt = (dtype_to_str(arr.dtype)
                          if isinstance(arr, ShardedLeafRef)
                          else leaf_dtype_str(arr))
                if got_dt != leaf_dtype_str(leaf):
                    raise TypeError(
                        f"{path}: checkpoint dtype {got_dt} != "
                        f"template {leaf_dtype_str(leaf)}")
                if is_dtensor(leaf):
                    # the template's layout is the target: this rank's box
                    merged[path] = assemble_onto(arr, sharding_of(leaf))
                    continue
                if isinstance(arr, ShardedLeafRef):
                    arr = arr.materialize()      # one read into host memory
                # the counterpart of jax.device_put(arr, template sharding):
                # the template leaf's device is the target
                if isinstance(arr, torch.Tensor):
                    # replayed on the template's device: already in place
                    merged[path] = arr.to(leaf.device)
                elif isinstance(leaf, torch.Tensor):
                    merged[path] = numpy_to_tensor(arr, leaf.device)
                    placed += arr.nbytes
                else:
                    merged[path] = arr
            if placed:
                tmetrics.counter("openchk_h2d_bytes_total",
                                 memory="pageable").inc(placed)
            sp.set(bytes=placed)
        return unflatten_named(merged, req.template)

    def wait(self) -> None:
        self.backend.tcl_wait()

    def finalize(self) -> None:
        self.backend.tcl_finalize()

"""Checkpoint-as-deployment: rolling chunk-delta hot-swap for a serving
fleet.

The PyTorch counterpart of ``repro.serve.deploy``: the same control loop,
rollout invariants, chaos site, spans and counters, over
``torch.Tensor`` params.

The training run publishes checkpoints into the content-addressed object
store; a serving fleet *follows the catalog* instead of receiving pushed
weight files.  :class:`FleetDeployer` composes three pieces:

- the **subscriber** (``repro_torch.objstore.subscriber``): one epoch-integer
  poll decides "anything new?", the typed
  :class:`~repro_torch.objstore.inspect.CatalogView` decides "which entry";
- the **puller** (:class:`EntryPuller`): materializes the entry's rank
  file set into the replica's node-local ``objstore-cache`` with
  chunk-level delta fetches — only digests absent from the replica's
  :class:`~repro_torch.objstore.chunks.ChunkCache` hit the store, every chunk
  digest-verified (a fine-tune publish ships ~3% of the weight bytes,
  the CI-gated ``serve_swap_delta_ratio``);
- the **loader** (:func:`repro_torch.core.resharding.load_named_onto`):
  each leaf lands on the layout the replica serves it with — a
  ``DTensor`` leaf of the serving mesh as a ``DTensor`` of the same
  placements, this rank reading only its box of the shard files (a
  checkpoint trained on a 2×2 mesh installs on a 1×4 serving mesh), any
  other leaf on its device.

Rolling-swap invariants (the "libraries must become more fault
tolerant" discipline applied to deployment):

1. **One replica at a time.**  A replica must pull, assemble, flip and
   report readiness before the next replica starts — a bad publish
   stops at the canary with the rest of the fleet untouched.
2. **The flip is atomic and late.**  The new tree is fully assembled
   and validated *before* ``set_weights`` — a replica never serves a
   torn tree; in-flight ``generate()`` batches finish on the handle
   they captured.
3. **Failure pins, never tears.**  A failed pull (missing chunk, digest
   mismatch, objstore outage, killed replica) leaves that replica
   serving its current epoch; the deployer backs off and retries, and
   the rollout does not advance past the failure.

Failure matrix (exercised in tests/test_torch_serve_deploy.py):

====================  =============================================
fault                 observable behaviour
====================  =============================================
replica dies mid-pull fleet keeps serving the old epoch; the revived
                      replica re-pulls (cache survives) and converges
corrupt cached chunk  ChunkCache digest-verify evicts + refetches;
                      the swap completes with one extra chunk pulled
objstore outage       subscriber/puller raise ObjectStoreError; the
                      replica pins its epoch and retries with backoff
partial shard set     load_named_onto raises — no flip happens
====================  =============================================
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.chaos import inject as chaos
from repro_torch.core import manifest as mf
from repro_torch.ft.backoff import backoff_delay
from repro_torch.core.formats import CHK5CorruptionError, CHK5Reader
from repro_torch.core.protect import flatten_named, unflatten_named
from repro_torch.core.resharding import (
    indexed_shard_files,
    is_dtensor,
    load_named_onto,
    sharding_of,
)
from repro_torch.objstore.chunks import ChunkCache, fetch_file_delta
from repro_torch.objstore.client import ObjectStore, ObjectStoreError
from repro_torch.objstore.inspect import EntryInfo
from repro_torch.objstore.subscriber import CatalogSubscriber, DeploySelector
from repro_torch.serve.engine import ServingEngine, WeightsHandle
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry.health import HealthState


class EntryPuller:
    """Materializes one catalog entry's rank file set into a node-local
    cache directory with chunk-delta fetches.

    The chunk cache persists across entries — pulling entry N+1 after N
    only fetches the digests the two do not share.  Every file lands via
    staged ``.part`` + rename and every container is CHK5-validated, so
    a crash mid-pull leaves no half-written file a later pull would
    trust."""

    def __init__(self, store: ObjectStore, cache_root: str, rank: int = 0):
        self.store = store
        self.cache_root = cache_root
        self.rank = rank
        self.cache = ChunkCache(os.path.join(cache_root, "chunks"))

    def pull(self, entry: EntryInfo) -> Dict[str, Any]:
        """Fetch ``entry``'s files for this rank → ``{"dir", "container",
        "bytes_fetched", "bytes_cached", "chunks_corrupt"}``.  Raises
        ``ObjectStoreError`` on any missing/corrupt chunk — the caller
        treats the pull as failed, nothing was installed."""
        files = entry.rank_files(self.rank)
        container = f"rank{self.rank}.chk5"
        if not any(f.name == container for f in files):
            raise ObjectStoreError(
                f"entry {entry.id} has no {container} — not deployable "
                f"for rank {self.rank}")
        d = mf.ckpt_dir(self.cache_root, entry.id)
        os.makedirs(d, exist_ok=True)
        stats = {"dir": d, "container": os.path.join(d, container),
                 "bytes_fetched": 0, "bytes_cached": 0, "chunks_corrupt": 0}

        def fetch(batch) -> None:
            for f in batch:
                got = fetch_file_delta(self.store, f.file_entry(),
                                       os.path.join(d, f.name), self.cache)
                for k in ("bytes_fetched", "bytes_cached", "chunks_corrupt"):
                    stats[k] += got[k]

        fetch(files)
        # shard files of other ranks the container's index names (the
        # cross-rank index of a multi-process store)
        fetched = {f.name for f in files}
        named = set(indexed_shard_files(stats["container"])) - fetched
        fetch([f for f in entry.files if f.name in named])
        # the manifest rides the catalog entry; materializing it makes
        # the cache dir a normal committed checkpoint dir
        man_path = os.path.join(d, mf.MANIFEST)
        tmp = man_path + ".part"
        with open(tmp, "w") as fh:
            json.dump(dict(entry.manifest), fh, indent=1, sort_keys=True)
        os.replace(tmp, man_path)
        try:
            CHK5Reader(stats["container"]).close()
        except (OSError, CHK5CorruptionError) as e:
            raise ObjectStoreError(
                f"entry {entry.id}: pulled container failed CHK5 "
                f"validation: {e}") from e
        return stats


@dataclass
class Replica:
    """One serving engine the deployer manages, plus its pull-side state.
    ``cache_root`` is the replica's node-local objstore-cache (each
    replica pulls independently — a dead replica never blocks a peer's
    chunks)."""
    name: str
    engine: ServingEngine
    cache_root: str
    rank: int = 0
    prefix: Optional[str] = None      # checkpoint namespace of the params
    failures: int = 0
    next_retry_t: float = 0.0
    last_error: Optional[str] = None
    #: optional live readiness for this replica (telemetry/health.py):
    #: the deployer drops it for the pull window and re-asserts it after
    #: the flip (or after a failed pull — the old epoch is still serving),
    #: so a rolling swap is observable from /readyz outside the process
    health: Optional[HealthState] = None
    _puller: Optional[EntryPuller] = field(default=None, repr=False)

    def puller(self, store: ObjectStore) -> EntryPuller:
        if self._puller is None:
            self._puller = EntryPuller(store, self.cache_root, self.rank)
        return self._puller


class FleetDeployer:
    """Drives the rolling hot-swap of a replica fleet off the catalog.

    ``poll()`` is the whole control loop, designed to be called from a
    timer/serve loop: it advances the rollout by **at most one replica
    swap** per call (invariant 1), so readiness between swaps is exactly
    "the previous poll returned with the replica converged".  Failures
    never raise out of ``poll()`` — they pin the failing replica
    (invariant 3), stamp a backoff deadline, and the rollout resumes
    from that replica on a later poll.  ``time_fn`` is injectable so
    tests drive backoff deterministically."""

    def __init__(self, store: ObjectStore, replicas: List[Replica],
                 selector: DeploySelector = DeploySelector(),
                 backoff_s: float = 1.0, max_backoff_s: float = 30.0,
                 time_fn=time.monotonic):
        self.store = store
        self.replicas = list(replicas)
        self.subscriber = CatalogSubscriber(store, selector)
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.time_fn = time_fn
        self.target: Optional[EntryInfo] = None
        self._next = 0                 # rollout cursor into self.replicas
        self._watch_retry_t = 0.0      # backoff for catalog-poll outages
        self.stats = {"swaps": 0, "rollouts": 0, "pulls_failed": 0,
                      "bytes_fetched": 0, "bytes_cached": 0}
        # the fleet's epoch/entry view lives on the telemetry gauges from
        # here on (fleet_epochs() is a shim over them): stamp each
        # engine's telemetry label with its fleet name and seed the
        # gauges from the weights it currently serves
        for r in self.replicas:
            r.engine.name = r.name
            h = r.engine.weights
            tmetrics.gauge("openchk_serve_epoch",
                           replica=r.name).set(h.epoch)
            tmetrics.gauge("openchk_fleet_entry_id", replica=r.name).set(
                -1 if h.entry_id is None else h.entry_id)

    # -- one control-loop step ------------------------------------------ #

    def poll(self) -> Dict[str, Any]:
        """One deploy step → a status dict: ``action`` is one of
        ``idle`` / ``watching`` (outage backoff) / ``started`` /
        ``swapped`` / ``pinned`` (replica failed, epoch kept) /
        ``waiting`` (backoff not yet elapsed) / ``converged``."""
        now = self.time_fn()
        if self.target is None:
            if now < self._watch_retry_t:
                return {"action": "watching", "retry_at": self._watch_retry_t}
            try:
                target = self.subscriber.poll()
            except ObjectStoreError as e:
                # catalog unreachable: the fleet keeps serving what it
                # serves; watch again after backoff
                self._watch_retry_t = now + self.backoff_s
                return {"action": "watching", "error": str(e),
                        "retry_at": self._watch_retry_t}
            if target is None:
                return {"action": "idle", "epoch": self.subscriber.last_epoch}
            self.target = target
            self._next = 0
            self.stats["rollouts"] += 1
            for r in self.replicas:
                r.failures = 0
                r.next_retry_t = 0.0
            return {"action": "started", "entry": target.id,
                    "delta": self.subscriber.delta(target)}
        if self._next >= len(self.replicas):
            done = self.target
            self.subscriber.mark_deployed(done)
            self.target = None
            return {"action": "converged", "entry": done.id}
        r = self.replicas[self._next]
        if now < r.next_retry_t:
            return {"action": "waiting", "replica": r.name,
                    "retry_at": r.next_retry_t}
        try:
            swap = self._swap_one(r, self.target)
        except (ObjectStoreError, CHK5CorruptionError, OSError,
                KeyError) as e:
            # invariant 3: the replica keeps its current epoch — nothing
            # was installed — and the rollout holds at this replica
            r.failures += 1
            r.last_error = f"{type(e).__name__}: {e}"
            r.next_retry_t = now + backoff_delay(
                r.failures, self.backoff_s, self.max_backoff_s)
            self.stats["pulls_failed"] += 1
            tmetrics.counter("openchk_deploy_pulls_failed_total",
                             replica=r.name).inc()
            ttrace.instant("deploy.pinned", replica=r.name,
                           entry=self.target.id, error=r.last_error)
            return {"action": "pinned", "replica": r.name,
                    "epoch": r.engine.weights.epoch,
                    "error": r.last_error, "retry_at": r.next_retry_t}
        self._next += 1
        self.stats["swaps"] += 1
        tmetrics.counter("openchk_deploy_swaps_total", replica=r.name).inc()
        r.failures = 0
        r.last_error = None
        return dict(swap, action="swapped", replica=r.name,
                    remaining=len(self.replicas) - self._next)

    def run_until_converged(self, max_polls: int = 10_000,
                            sleep_fn=None) -> Dict[str, Any]:
        """Poll until the fleet converges on the current target (tests /
        one-shot deploys).  Honors backoff via ``sleep_fn`` (defaults to
        busy-advancing an injectable clock is the caller's job)."""
        last: Dict[str, Any] = {"action": "idle"}
        for _ in range(max_polls):
            last = self.poll()
            if last["action"] in ("converged", "idle"):
                return last
            if last["action"] in ("waiting", "watching", "pinned") \
                    and sleep_fn is not None:
                sleep_fn(self.backoff_s)
        return last

    # -- the swap ------------------------------------------------------- #

    def _swap_one(self, r: Replica, entry: EntryInfo) -> Dict[str, Any]:
        """Pull + assemble + atomic flip for one replica.  Everything up
        to ``set_weights`` is side-effect-free for the serving path —
        any exception leaves the old handle serving.

        Readiness (when the replica carries a HealthState) drops for the
        pull/assemble window and is re-asserted on both exits: after the
        flip via the engine's swap hook, and after a failure because the
        old epoch never stopped serving."""
        # chaos site: an error-mode spec here exercises invariant 3 end to
        # end — poll() must pin the replica, never tear the fleet
        chaos.fire(chaos.SITES.DEPLOY_POLL, exc=ObjectStoreError,
                   replica=r.name, entry=entry.id)
        if r.health is not None:
            r.health.set_ready(False, reason="pulling",
                               target_entry=entry.id)
        try:
            with ttrace.span("deploy.swap", replica=r.name, entry=entry.id):
                return self._pull_and_flip(r, entry)
        except BaseException:
            if r.health is not None:
                r.health.set_ready(True, reason="pull failed; "
                                   "serving previous epoch")
            raise

    def _pull_and_flip(self, r: Replica, entry: EntryInfo) -> Dict[str, Any]:
        with ttrace.span("deploy.pull", replica=r.name, entry=entry.id):
            pulled = r.puller(self.store).pull(entry)
        self.stats["bytes_fetched"] += pulled["bytes_fetched"]
        self.stats["bytes_cached"] += pulled["bytes_cached"]
        tmetrics.counter("openchk_deploy_bytes_fetched_total").inc(
            pulled["bytes_fetched"])

        cur_named = flatten_named(r.engine.params)
        prefix = (r.prefix + "/") if r.prefix else ""
        shardings = {prefix + name: sharding_of(leaf)
                     for name, leaf in cur_named.items() if is_dtensor(leaf)}
        devices = {prefix + name: getattr(leaf, "device", None)
                   for name, leaf in cur_named.items()
                   if not is_dtensor(leaf)}
        named = load_named_onto(pulled["container"], [pulled["dir"]],
                                rank=r.rank, devices=devices,
                                shardings=shardings)
        # select this engine's namespace; a missing leaf fails the swap
        # (KeyError → pinned) before any mutation
        new_named = {}
        for name in cur_named:
            key = prefix + name
            if key not in named:
                raise KeyError(
                    f"entry {entry.id} is missing leaf {key!r} — not a "
                    f"deployable params tree for replica {r.name}")
            new_named[name] = named[key]
        new_params = unflatten_named(new_named, r.engine.params)
        handle = r.engine.set_weights(WeightsHandle(
            params=new_params, entry_id=entry.id))
        if r.health is not None:
            # idempotent with attach_engine's swap hook — covers health
            # states not chained onto the engine
            r.health.set_ready(True, epoch=int(handle.epoch),
                               entry_id=handle.entry_id, reason="swapped")
        return {"entry": entry.id, "epoch": handle.epoch,
                "bytes_fetched": pulled["bytes_fetched"],
                "bytes_cached": pulled["bytes_cached"],
                "chunks_corrupt": pulled["chunks_corrupt"]}

    # -- observability --------------------------------------------------- #

    def fleet_epochs(self) -> Dict[str, Optional[int]]:
        """replica name → catalog entry id currently served (the torn-
        fleet check: mid-rollout at most two distinct values, old and
        new).  Thin shim over the ``openchk_fleet_entry_id`` telemetry
        gauges every swap maintains (-1 encodes "local params, no
        catalog entry")."""
        out: Dict[str, Optional[int]] = {}
        for r in self.replicas:
            v = tmetrics.gauge("openchk_fleet_entry_id",
                               replica=r.name).value
            out[r.name] = None if v < 0 else int(v)
        return out

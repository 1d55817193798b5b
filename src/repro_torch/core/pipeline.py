"""The staged checkpoint pipeline: Plan → Pack → Place → Commit.

Every store — synchronous or CP-dedicated-thread, FULL, DIFF or
incremental, any backend — flows through the same four stages:

    Plan    kind/level resolution, the diff→full promote decision, and the
            only work that must stay on the calling thread: the device→host
            snapshot and (for CHK_DIFF) the on-device blockhash/diffpack
            kernels.  Runs in submission order, so back-to-back asynchronous
            DIFF stores see a consistent digest chain.  FULL stores on
            diff-capable backends owe digest bookkeeping too: Plan launches
            the blockhash kernel on the current stream *before* the
            snapshot's D2H copy, so both read the same bytes, and commits
            the digests as soon as the snapshot is on the host.

            Torch tensors are updated in place, so nothing of the caller's
            state may be read after Plan returns: the FULL snapshot, its
            digests and the DIFF payload are completed host copies by then.
            (The JAX package defers the FULL's hashing to the tail, behind
            a fence, which is sound only because jax arrays are immutable.)
    Pack    serialization of the planned payload into the staging dir
            (``ckpt-<id>.tmp``) as a CHK5 container.
    Place   the tier stack for the level applies redundancy
            (partner replica, erasure parity, …) — see core/tiers.py.
    Commit  per-rank status allgather, manifest write, atomic ``.tmp`` →
            final rename, diff-chain-aware retention pruning.

``plan()`` is cheap and synchronous; ``finish()`` (= pack + place + commit)
is the asynchronous tail a CP-dedicated thread runs.  File-mode backends
(SCR ``route_file``) and incremental stores that produced their payload
outside Pack enter at Place via ``finish_external()`` — so *no* caller
re-implements placement or commit.

Restart search order: L1 → L2 (partner) → L3 (erasure reconstruct) → L4,
newest checkpoint id first — exactly FTI's recovery ladder, now expressed
as iteration over the tier ladder (the tier that produced the payload is
reported as ``recovered_via`` in the restored metadata).

DIFF replay follows the restart template: a leaf whose template is a
tensor has its FULL base placed on the template's device once and every
later delta scattered into it there, one DIFF link at a time for all such
leaves (``diff.ChainReplay``: the diffunpack kernel on the card); every
other leaf replays with numpy on the host, as in the JAX package.  Both
give the same bytes.  The chain is read, verified and planned first,
inside the walk's fallback; the replay on the device runs after it, so a
device error is raised, never taken for a bad checkpoint.
"""
from __future__ import annotations

import io
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.chaos import inject as chaos
from repro_torch.core import manifest as mf
from repro_torch.core.comm import Communicator
from repro_torch.core.diff import (
    DiffEngine,
    ChainReplay,
    LeafDelta,
    apply_delta,
    leaf_to_u32_flat,
    u32_flat_to_leaf,
)
from repro_torch.core.formats import CHK5Reader, CHK5Writer
from repro_torch.core.protect import CHK_DIFF, CHK_FULL, Protect, to_host
from repro_torch.core.resharding import (
    ShardedLeafRef,
    ShardSnapshot,
    resolve_shard_refs,
    split_sharded,
    write_shard_files,
)
from repro_torch.core.tiers import (
    PackTier,
    Tier,
    TierContext,
    clause_attrs,
    decode_leaf,
    default_pack_tiers,
    default_tier_stacks,
    pack_named,
    recovery_ladder,
)
from repro_torch.redundancy.groups import Topology
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace


@dataclass
class StorageConfig:
    root: str                                  # base dir for this run
    block_bytes: int = 65_536
    keep_last_full: int = 2
    group_size: int = 4
    erasure_scheme: str = "rs"                 # "rs" | "xor"
    rs_parity: int = 2
    promote_threshold: float = 0.95            # diff→full break-even (Fig. 7)
    ranks_per_node: int = 1
    custom_groups: Optional[dict] = None       # SCR-style group overrides
    shard_writers: int = 4                     # parallel shard-file writers
    # --- object-store L4 (repro_torch.objstore) ---------------------- #
    objstore: bool = True                      # compose ObjectStoreTier at L4
    objstore_url: Optional[str] = None         # None → file:<root>/objstore
    objstore_chunk_bytes: int = 1 << 20        # fixed-mode chunk size
    objstore_chunking: str = "cdc"             # "cdc" | "fixed"
    objstore_cdc_min_bytes: int = 256 << 10    # CDC lower cut bound
    objstore_cdc_avg_bytes: int = 1 << 20      # CDC target average
    objstore_cdc_max_bytes: int = 4 << 20      # CDC forced-cut bound
    objstore_transfers: int = 4                # parallel upload threads
    objstore_keep_last: Optional[int] = None   # retention: newest N entries
    objstore_keep_every: Optional[int] = None  # retention: pin id % K == 0

    @property
    def global_root(self) -> str:
        return os.path.join(self.root, "global")


@dataclass
class StoreReport:
    ckpt_id: int
    level: int
    kind: str
    bytes_payload: int
    seconds: float
    dirty_ratio: Optional[float] = None
    promoted_full: bool = False
    #: id of the ``pipeline.store`` span that produced this report (None
    #: when tracing is disabled) — lets chktrace join goodput accounting
    #: back onto the timeline
    span_id: Optional[int] = None
    #: seconds the calling thread spent in Plan (hash/pack kernels and the
    #: completed device→host copies) — the store's synchronous cost
    plan_seconds: float = 0.0


@dataclass
class StoreRequest:
    """What the caller wants checkpointed — the one object that rides the
    whole stack (directive → TCL → backend → Plan) in place of the old
    positional protocols.

    The directive layer fills ``tree`` + ``protects``; TCL resolves them
    into ``named`` (selected leaves) + ``specs`` (path → governing
    ``Protect``); the backend stamps ``level``/``diff_supported``; Plan
    consumes the result.  Callers below the directive layer may also build
    one directly with ``named`` (tensors on any device, or host arrays)."""
    named: Optional[Dict[str, Any]] = None     # tensors or host arrays
    ckpt_id: int = 0
    level: int = 1
    kind: str = CHK_FULL
    extra_meta: Optional[Dict[str, Any]] = None
    diff_supported: bool = True
    tree: Any = None                           # unflattened state (directive)
    protects: Optional[List[Protect]] = None   # clause specs (directive)
    specs: Optional[Dict[str, Optional[Protect]]] = None  # resolved by TCL

    @property
    def wants_diff(self) -> bool:
        """Does any part of this request ask for a DIFF checkpoint?  (The
        capability/fallback accounting backends do — paper §3.)"""
        if self.kind == CHK_DIFF:
            return True
        for s in (self.specs or {}).values():
            if s is not None and s.kind == CHK_DIFF:
                return True
        return any(s.kind == CHK_DIFF for s in (self.protects or []))


@dataclass
class LoadRequest:
    """What the caller wants restored (transparent-restart input): the
    template tree plus the protection specs restricting which leaves the
    checkpoint must supply.  ``devices`` (filled by TCL from the template)
    maps each protected leaf whose template is a tensor to that tensor's
    device: the restore replays the leaf's DIFF chain there."""
    template: Any = None
    protects: Optional[List[Protect]] = None
    specs: Optional[Dict[str, Optional[Protect]]] = None  # resolved by TCL
    devices: Optional[Dict[str, torch.device]] = None     # filled by TCL


@dataclass
class Plan:
    """Resolved store decision (output of Plan, input to Pack/Place/Commit).

    After ``plan()`` returns, the checkpoint content is frozen host-side
    (FULL: host snapshot; DIFF: compacted dirty blocks) — the remaining
    stages touch none of the caller's state and may run on a CP-dedicated
    thread."""
    ckpt_id: int
    level: int
    kind: str
    tiers: List[Tier]
    root: str
    attrs: Dict[str, Any]                      # payload container attrs
    extra: Dict[str, Any]                      # caller meta → manifest
    named_host: Optional[Dict[str, np.ndarray]] = None   # FULL payload
    sharded: Optional[Dict[str, ShardSnapshot]] = None   # shard-local FULL
    deltas: Optional[List[LeafDelta]] = None             # DIFF payload
    specs: Optional[Dict[str, Optional[Protect]]] = None  # clause specs
    dirty_ratio: Optional[float] = None
    promoted_full: bool = False
    #: dataset name → layout-reuse key for the fused Pack → chunk-stream
    #: path (digest-derived; set by Plan once the FULL leaves' digests
    #: describe the snapshot, consumed by CHK5Writer.region_keys)
    reuse_keys: Optional[Dict[str, str]] = None
    t0: float = field(default_factory=time.time)
    plan_seconds: float = 0.0          # time spent in plan() itself
    digest_epoch: int = -1             # DIFF only: chain epoch at plan time


@dataclass
class Packed:
    """A serialized payload sitting in the staging dir (output of Pack).
    ``shard_files`` lists the sibling shard files of a sharded store —
    the multi-file set commits atomically with the container."""
    stage_dir: str
    path: str
    nbytes: int
    shard_files: List[str] = field(default_factory=list)


class CheckpointPipeline:
    def __init__(self, cfg: StorageConfig, comm: Communicator,
                 compose=None, pack_compose=None):
        self.cfg = cfg
        self.comm = comm
        self.topo = Topology(
            world=comm.world,
            ranks_per_node=cfg.ranks_per_node,
            group_size=min(cfg.group_size, comm.world),
            custom_groups=cfg.custom_groups,
        )
        self.ctx = TierContext(cfg, comm, self.topo)
        self.diff = DiffEngine(cfg.block_bytes, cfg.promote_threshold)
        self.stacks: Dict[int, List[Tier]] = (
            compose or default_tier_stacks)(self.ctx)
        self.ladder: List[Tier] = recovery_ladder(self.stacks)
        self.pack_tiers: List[PackTier] = (
            pack_compose or default_pack_tiers)()
        # observer hook: called with every committed StoreReport (the
        # cadence controller's store-cost feed — chaos/cadence.py)
        self.on_report = None
        os.makedirs(self.ctx.local_root, exist_ok=True)
        os.makedirs(cfg.global_root, exist_ok=True)

    # ------------------------------------------------------------------ #

    @property
    def local_root(self) -> str:
        return self.ctx.local_root

    def clamp_level(self, level: int) -> int:
        """Snap to the nearest level a stack exists for (custom composers
        may register non-contiguous levels): the deepest available level
        not above the request, else the shallowest available."""
        if level in self.stacks:
            return level
        below = [k for k in self.stacks if k <= level]
        return max(below) if below else min(self.stacks)

    def tier_stack(self, level: int) -> List[Tier]:
        return self.stacks[self.clamp_level(level)]

    def tier_root(self, level: int) -> str:
        return self.tier_stack(level)[0].root

    # ------------------------------------------------------------------ #
    # stage 1: Plan
    # ------------------------------------------------------------------ #

    def plan(self, req: StoreRequest) -> Plan:
        """Span-wrapped Plan (the only stage on the calling thread — its
        span lands on the training thread's track, not the CP thread's)."""
        with ttrace.span("pipeline.plan", ckpt_id=req.ckpt_id,
                         level=req.level, kind=req.kind):
            return self._plan_impl(req)

    def _plan_impl(self, req: StoreRequest) -> Plan:
        """Resolve kind/level, run the on-device diff kernels, snapshot to
        host.  The only pipeline stage that runs on the calling thread.

        Kind resolution is **per leaf**: a ``Protect(kind=...)`` clause on
        the governing spec overrides the store-level kind, so one store can
        carry DIFF params and a FULL optimizer (mixed-kind).  The container
        kind is DIFF when any delta is present (the restore walk then keeps
        searching for the FULL base of the delta'd leaves)."""
        t_plan = time.time()
        level = self.clamp_level(req.level)
        tiers = self.tier_stack(level)
        extra = dict(req.extra_meta or {})
        attrs: Dict[str, Any] = dict(extra)
        specs = req.specs or {}
        deltas = None
        dirty_ratio = None
        promoted = False

        def eff_kind(path: str) -> str:
            spec = specs.get(path)
            return spec.kind if (spec is not None and spec.kind) else req.kind

        diff_paths = [p for p in req.named if eff_kind(p) == CHK_DIFF]
        if diff_paths and not req.diff_supported:
            diff_paths = []                 # VeloC/SCR: no checkpoint kinds
            attrs["diff_fallback"] = True
        diff_set = set(diff_paths)
        full_paths = [p for p in req.named if p not in diff_set]

        # epoch read BEFORE delta computation: an invalidate() racing in
        # from a CP-thread failure mid-plan must make finish() refuse this
        # delta, not slip past the guard
        epoch = self.diff.epoch
        promoted_paths: List[str] = []
        if diff_paths:
            deltas, stats = self.diff.compute_deltas(
                {p: req.named[p] for p in diff_paths})
            dirty_ratio = stats.dirty_ratio
            if deltas is None:              # above break-even: promote
                promoted = True
                promoted_paths = diff_paths
                full_paths = list(req.named)
            else:
                attrs["base_required"] = True
        kind = CHK_DIFF if deltas is not None else CHK_FULL

        named_host = None
        if full_paths:
            # every leaf takes the gather path in this port (no sharded
            # tensors yet: core/resharding.py)
            gather, _sharded = split_sharded(
                {p: req.named[p] for p in full_paths})
            # digest bookkeeping is skipped when the backend can never
            # consume it (no checkpoint kinds) and for leaves the promote
            # path just hashed.  Otherwise it is owed: the kernels are
            # launched here, on the current stream and BEFORE the D2H
            # snapshot below, so the digests describe exactly the bytes
            # the snapshot holds even if the caller updates the tensors in
            # place the moment plan() returns.  They are committed once the
            # snapshot is on the host, as a DIFF plan commits its own; a
            # failed tail invalidates them (finish()).
            promoted_set = set(promoted_paths)
            owed = [p for p in full_paths if p not in promoted_set]
            digests = None
            if req.diff_supported and owed:
                digests = self.diff.launch_digests(
                    {p: req.named[p] for p in owed})
            named_host = to_host(gather) if gather else {}
            if digests is not None:
                self.diff.commit_digests(digests)

        plan = Plan(ckpt_id=req.ckpt_id, level=level, kind=kind, tiers=tiers,
                    root=tiers[0].root, attrs=attrs, extra=extra,
                    named_host=named_host, deltas=deltas,
                    specs=dict(specs) if specs else None,
                    dirty_ratio=dirty_ratio, promoted_full=promoted,
                    digest_epoch=epoch if kind == CHK_DIFF else -1)
        # here, not in the tail: the digests describe exactly the snapshot
        # now, and a later plan may advance them before this tail runs
        self._compute_reuse_keys(plan)
        plan.plan_seconds = time.time() - t_plan
        return plan

    def abort_plan(self, plan: Plan) -> None:
        """A planned store will never reach finish() (e.g. the CP submit
        itself raised).  Plan already advanced the digest chain to it, so
        drop its leaves' digests, as a failed tail does: the next DIFF of
        them promotes to FULL instead of diffing against a store that
        never happened."""
        self.diff.invalidate(self._plan_leaf_paths(plan))

    def plan_external(self, ckpt_id: int, level: int,
                      extra_meta: Optional[Dict[str, Any]] = None) -> Plan:
        """Plan for a payload produced outside Pack (file-mode backends,
        incremental stores).  Kind is FULL: the container holds a complete
        restorable snapshot of whatever was routed/added."""
        level = self.clamp_level(level)
        tiers = self.tier_stack(level)
        extra = dict(extra_meta or {})
        return Plan(ckpt_id=ckpt_id, level=level, kind=CHK_FULL, tiers=tiers,
                    root=tiers[0].root, attrs=dict(extra), extra=extra)

    # ------------------------------------------------------------------ #
    # stage 2: Pack
    # ------------------------------------------------------------------ #

    def pack(self, plan: Plan) -> Packed:
        """Span-wrapped Pack (runs on the CP thread for async stores)."""
        with ttrace.span("pipeline.pack", ckpt_id=plan.ckpt_id,
                         level=plan.level, kind=plan.kind):
            return self._pack_impl(plan)

    def _pack_impl(self, plan: Plan) -> Packed:
        """Serialize the planned payload into the staging dir: the Pack-tier
        chain encodes FULL leaves per their clauses (compression, format
        attrs, precision); DIFF deltas ship as compacted dirty blocks.  A
        mixed-kind plan writes both sections into one container.

        Sharded leaves (``plan.sharded``) write their chunks as
        ``shard-<k>`` sub-datasets spread over sibling
        ``rank<r>.shard<j>.chk5`` files (parallel writers) and the shard
        index into the main container — everything inside the same
        ``.tmp`` staging dir, so the whole multi-file set commits
        atomically.

        When a tier offers a Pack-stage chunk sink (``tier.pack_sink``),
        every container byte is teed into it as it is produced."""
        d = mf.begin(plan.root, plan.ckpt_id)
        path = os.path.join(d, f"rank{self.comm.rank}.chk5")
        attrs = dict(plan.attrs, level=plan.level, rank=self.comm.rank,
                     world=self.comm.world)
        sink = self._pack_sink(plan, os.path.basename(path))
        shard_files: List[str] = []
        with CHK5Writer(path, sink=sink) as w:
            if plan.reuse_keys:
                w.region_keys = dict(plan.reuse_keys)
            root_attrs = dict(attrs, kind=plan.kind)
            if plan.sharded:
                root_attrs["sharded"] = True
            w.set_attrs("", root_attrs)
            if plan.sharded:
                shard_files = write_shard_files(
                    d, f"rank{self.comm.rank}", w, plan.sharded, plan.specs,
                    default_kind=CHK_FULL,
                    max_writers=self.cfg.shard_writers,
                    sink_factory=lambda bn: self._pack_sink(plan, bn))
            if plan.named_host:
                pack_named(w, plan.named_host, plan.specs, self.pack_tiers)
            if plan.deltas:
                self._serialize_deltas(w, plan.deltas, plan.specs)
        nbytes = os.path.getsize(path) + sum(
            os.path.getsize(p) for p in shard_files)
        return Packed(stage_dir=d, path=path, nbytes=nbytes,
                      shard_files=shard_files)

    def _pack_sink(self, plan: Plan, basename: str):
        """First streaming chunk sink any tier of this plan's stack offers
        for the staged file ``basename`` (None → the tier consumes whole
        staged files and Place falls back to re-reading them)."""
        for tier in plan.tiers:
            s = tier.pack_sink(plan.ckpt_id, basename)
            if s is not None:
                return s
        return None

    def _serialize_deltas(self, w: CHK5Writer, deltas: List[LeafDelta],
                          specs: Optional[Dict[str, Optional[Protect]]]
                          ) -> None:
        specs = specs or {}
        for d in deltas:
            g = f"delta/{d.path}"
            w.write_dataset(f"{g}/idx", d.dirty_idx)
            w.write_dataset(f"{g}/blocks", d.payload)
            # clause attrs ride the digest dataset (kind/selector/…); delta
            # payloads are raw dirty blocks — codecs apply to FULL leaves
            w.write_dataset(
                f"{g}/digest", d.digests,
                dict(clause_attrs(specs.get(d.path), CHK_DIFF),
                     dtype=d.dtype, shape=d.shape, n_blocks=d.n_blocks))

    # ------------------------------------------------------------------ #
    # stage 3: Place
    # ------------------------------------------------------------------ #

    def place(self, plan: Plan, packed: Packed) -> None:
        """Run the tier stack's redundancy over the packed payload (the
        rank container plus any sibling shard files)."""
        for tier in plan.tiers:
            chaos.fire(chaos.SITES.TIER_PLACE, tier=tier.name,
                       level=plan.level, ckpt_id=plan.ckpt_id,
                       rank=self.comm.rank)
            with ttrace.span("pipeline.place", tier=tier.name,
                             level=plan.level, ckpt_id=plan.ckpt_id):
                tier.place(plan.ckpt_id, packed.stage_dir, packed.path,
                           extra_files=packed.shard_files)

    # ------------------------------------------------------------------ #
    # stage 4: Commit
    # ------------------------------------------------------------------ #

    def commit(self, plan: Plan, packed: Packed) -> StoreReport:
        """Span-wrapped Commit; also the single metrics feed point (every
        store path — sync or CP-thread — converges here)."""
        with ttrace.span("pipeline.commit", ckpt_id=plan.ckpt_id,
                         level=plan.level, kind=plan.kind,
                         bytes=packed.nbytes):
            return self._commit_impl(plan, packed)

    def _commit_impl(self, plan: Plan, packed: Packed) -> StoreReport:
        """Status allgather + manifest + atomic rename + retention.

        (Rank0-equivalent; every rank writes the same manifest data in the
        single-process container, and commit merges idempotently.)"""
        statuses = self.comm.allgather(
            {"rank": self.comm.rank, "ok": True,
             "file": os.path.basename(packed.path), "nbytes": packed.nbytes,
             # the full multi-file set this rank staged — the manifest
             # covers shard files atomically (a partial set is detectable,
             # and the restore path refuses it)
             "files": [os.path.basename(packed.path)]
             + [os.path.basename(p) for p in packed.shard_files]})
        mf.write_manifest(plan.root, plan.ckpt_id, {
            "kind": plan.kind, "level": plan.level, "world": self.comm.world,
            "group_size": self.topo.group_size,
            "erasure": self.cfg.erasure_scheme,
            "block_bytes": self.cfg.block_bytes,
            "ranks": statuses,
            **plan.extra,
        })
        mf.commit(plan.root, plan.ckpt_id, keep_last=0)  # pruning below
        self.prune_chains(plan.root)
        # post-commit tier hooks, after the atomic rename: the objstore
        # tier joins its chunk uploads and publishes the catalog entry
        # here — a crash before this point leaves the previous catalog
        # entry authoritative (chunks already uploaded are unreferenced
        # garbage the next GC sweeps)
        committed = mf.read_manifest(plan.root, plan.ckpt_id)
        for tier in plan.tiers:
            chaos.fire(chaos.SITES.TIER_COMMIT, tier=tier.name,
                       level=plan.level, ckpt_id=plan.ckpt_id,
                       rank=self.comm.rank)
            with ttrace.span("pipeline.commit.tier", tier=tier.name,
                             level=plan.level, ckpt_id=plan.ckpt_id):
                tier.commit(plan.ckpt_id, committed)
        # seconds = store work only (plan + tail), not CP-queue waiting
        report = StoreReport(plan.ckpt_id, plan.level, plan.kind,
                             packed.nbytes,
                             plan.plan_seconds + (time.time() - plan.t0),
                             plan.dirty_ratio, plan.promoted_full,
                             plan_seconds=plan.plan_seconds)
        # canonical store metrics fed here, at the single convergence
        # point; the single-slot on_report hook stays free for user
        # observers (the cadence controller's store-cost feed)
        tmetrics.note_store_report(report)
        if self.on_report is not None:
            self.on_report(report)
        return report

    # ------------------------------------------------------------------ #
    # stage composition
    # ------------------------------------------------------------------ #

    def _plan_leaf_paths(self, plan: Plan):
        paths: List[str] = []
        if plan.named_host is not None:
            paths += list(plan.named_host)
        if plan.sharded is not None:
            paths += list(plan.sharded)
        if plan.deltas is not None:
            paths += [d.path for d in plan.deltas]
        return paths or plan.extra.get("parts", [])

    def _compute_reuse_keys(self, plan: Plan) -> None:
        """Derive chunk-layout reuse keys for FULL leaves from the block
        digests the diff engine holds (computed on the leaves' device) — a
        leaf whose digests and encoding spec are unchanged since the last
        store produces byte-identical container regions, so the chunk
        stream replays its recorded cut layout verbatim and the CDC scan
        is skipped for those bytes.  The key folds in the Protect spec
        because clause changes (compression, precision) alter the encoded
        bytes while the digests stay equal.  Correctness never depends on
        a key: chunk digests are always computed from the actual bytes — a
        wrong key only costs cut-placement quality."""
        if not plan.named_host:
            return
        specs = plan.specs or {}
        keys: Dict[str, str] = {}
        for path in plan.named_host:
            dk = self.diff.digest_key(path)
            if dk:
                keys[f"data/{path}"] = f"{path}|{specs.get(path)!r}|{dk}"
        plan.reuse_keys = keys or None

    def finish(self, plan: Plan) -> StoreReport:
        """The asynchronous tail: Pack → Place → Commit.

        Plan already advanced the digest chain (it must, so back-to-back
        async DIFF stores see each other); if the tail fails, the chain now
        describes a checkpoint that never committed — invalidate those
        leaves so a later DIFF can't delta against phantom data."""
        with ttrace.span("pipeline.store", ckpt_id=plan.ckpt_id,
                         level=plan.level, kind=plan.kind) as sp:
            report = self._finish_impl(plan)
            report.span_id = sp.id
            return report

    def _finish_impl(self, plan: Plan) -> StoreReport:
        plan.t0 = time.time()       # exclude any CP-queue wait from seconds
        try:
            if plan.kind == CHK_DIFF and plan.digest_epoch != self.diff.epoch:
                # a store that failed AFTER this one was planned invalidated
                # part of the chain — this delta may reference base content
                # that never committed; refuse rather than corrupt restores
                raise RuntimeError(
                    f"DIFF store {plan.ckpt_id}: digest base invalidated by "
                    "a failed store planned before it; retry (it will "
                    "promote to FULL)")
            packed = self.pack(plan)
            self.place(plan, packed)
            return self.commit(plan, packed)
        except BaseException:
            self.diff.invalidate(self._plan_leaf_paths(plan))
            raise

    def finish_external(self, plan: Plan, payload_path: str,
                        nbytes: int) -> StoreReport:
        """Place + Commit for a payload staged outside Pack (the file was
        already written into ``ckpt-<id>.tmp`` under ``plan.root``)."""
        plan.t0 = time.time()       # exclude any CP-queue wait from seconds
        packed = Packed(
            stage_dir=mf.ckpt_dir(plan.root, plan.ckpt_id, tmp=True),
            path=payload_path, nbytes=nbytes)
        with ttrace.span("pipeline.store", ckpt_id=plan.ckpt_id,
                         level=plan.level, kind=plan.kind,
                         external=True) as sp:
            try:
                self.place(plan, packed)
                report = self.commit(plan, packed)
            except BaseException:
                self.diff.invalidate(self._plan_leaf_paths(plan))
                raise
            report.span_id = sp.id
            return report

    def store(self, req: StoreRequest) -> StoreReport:
        """Run all four stages synchronously."""
        return self.finish(self.plan(req))

    # ------------------------------------------------------------------ #
    # retention: keep the last N FULLs plus the diff chain above them
    # ------------------------------------------------------------------ #

    def prune_chains(self, root: str) -> None:
        ids = mf.list_committed(root)
        fulls = [i for i in ids
                 if mf.read_manifest(root, i).get("kind") == CHK_FULL]
        keep_from = fulls[-self.cfg.keep_last_full] if len(
            fulls) >= self.cfg.keep_last_full else (fulls[0] if fulls else None)
        if keep_from is None:
            return
        for i in ids:
            if i < keep_from:
                import shutil
                shutil.rmtree(mf.ckpt_dir(root, i), ignore_errors=True)

    # ------------------------------------------------------------------ #
    # read path: the recovery ladder
    # ------------------------------------------------------------------ #

    def available_ids(self) -> List[Tuple[int, str]]:
        """All committed checkpoint ids across tiers → [(id, tier_root)].
        Includes reachable peers' node-local tiers (a restarted rank on a
        fresh node recovers from partner/parity held by survivors)."""
        roots = [self.ctx.local_root, self.cfg.global_root]
        for r in range(self.comm.world):
            if r == self.comm.rank:
                continue
            peer = self.comm.peer_local_dir(r)
            if peer is not None:
                roots.append(os.path.join(peer, "ckpts"))
        out = []
        for root in roots:
            for i in mf.list_committed(root):
                out.append((i, root))
        # discovery beyond directory scans: the objstore tier answers from
        # its catalog, so a run whose dirs are wiped still finds what the
        # object store holds
        for tier in self.ladder:
            out.extend(tier.list_ids())
        return sorted(set(out))

    def recover_payload(self, root: str, ckpt_id: int, rank: int
                        ) -> Optional[Tuple[bytes, Dict, str]]:
        """Walk the tier ladder L1 → L4 for one rank payload.
        Returns (payload, manifest, tier_name) or None."""
        man = mf.try_read_manifest(root, ckpt_id) or {}
        dirs = self.ctx.recovery_dirs(root, ckpt_id)   # scanned once, shared
        for tier in self.ladder:
            blob = tier.recover(ckpt_id, rank, root, man, dirs)
            if blob is not None:
                if not man:
                    # a catalog-backed tier materializes the checkpoint
                    # dir (manifest included) during recover — re-read so
                    # the restore walk sees kind/level/file coverage
                    man = mf.try_read_manifest(root, ckpt_id) or {}
                return blob, man, tier.name
        return None

    def load_latest(self, rank: Optional[int] = None,
                    devices: Optional[Dict[str, Any]] = None, *,
                    lazy_sharded: bool = False
                    ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Restore newest restorable checkpoint: FULL base + diff replay.

        Leaves come back as host numpy arrays, except those named in
        ``devices`` (path → device) that a DIFF link of the chain touches:
        each of those is placed on its device once, from its FULL base, and
        comes back as a tensor there with every delta scattered into it in
        place, one scatter per DIFF link and device for all such leaves (per
        group of at most ``diff.MAX_PACK_BYTES`` of rows).

        Sharded leaves (``shardidx/``, written by either package's
        shard-local store) restore from their shard files, found across the
        id's recovery dirs (partner replicas included).  By default they
        are materialized to host arrays; ``lazy_sharded=True`` returns
        :class:`~repro_torch.core.resharding.ShardedLeafRef` handles
        instead, which TCL reads onto the template leaf's device.  An
        incomplete shard set, or containers that fail to read, parse or
        verify, make the walk fall back to an older id (with a warning
        for the latter).  The replay on the devices runs after that walk:
        an error there (a kernel that does not build or launch, a device
        out of memory) is raised."""
        rank = self.comm.rank if rank is None else rank
        by_id: Dict[int, List[str]] = {}
        for i, root in self.available_ids():
            by_id.setdefault(i, []).append(root)
        for ckpt_id in sorted(by_id, reverse=True):
            try:
                got = self._try_restore(ckpt_id, by_id, rank, devices or {})
            except Exception as e:
                # a checkpoint whose container fails to parse/verify (e.g.
                # pre-digest corruption that stored a matching chunk digest)
                # must not abort the walk — fall back to the next-older id
                warnings.warn(
                    f"checkpoint {ckpt_id} unrestorable "
                    f"({type(e).__name__}: {e}); falling back to older id",
                    RuntimeWarning)
                continue
            if got is not None:
                named, replay, meta = got
                named.update(replay.run(devices))
                if not lazy_sharded:
                    named = {k: (v.materialize()
                                 if isinstance(v, ShardedLeafRef) else v)
                             for k, v in named.items()}
                return named, meta
        return None

    def _root_rank(self, root: str) -> int:
        """Walk order for the roots holding one checkpoint id: own local
        dir, then peers' local dirs, then the global dir, then catalog-
        backed roots (objstore cache) — mirroring the ladder's cost order
        so the object store is the fallback, never the first read."""
        if root == self.ctx.local_root:
            return 0
        if root == self.cfg.global_root:
            return 2
        if root in {t.root for t in self.ladder if t.level > 4}:
            return 3
        return 1                         # a reachable peer's local dir

    def _read_payload_any_tier(self, ckpt_id: int, by_id, rank: int
                               ) -> Optional[Tuple[bytes, Dict, str, str]]:
        for root in sorted(by_id.get(ckpt_id, []), key=self._root_rank):
            got = self.recover_payload(root, ckpt_id, rank)
            if got is not None:
                return got + (root,)
        return None

    def _try_restore(self, ckpt_id: int, by_id, rank: int,
                     devices: Dict[str, Any]):
        # walk back to the base FULL
        chain: List[Tuple[bytes, Dict, str]] = []
        via = None
        cur = ckpt_id
        while True:
            got = self._read_payload_any_tier(cur, by_id, rank)
            if got is None:
                return None
            blob, man, tier_name, root = got
            if via is None:
                via = tier_name             # how the newest link was produced
            chain.append((blob, man, root))
            if man.get("kind") == CHK_FULL:
                break
            prev = [i for i in by_id if i < cur]
            if not prev:
                return None
            cur = max(prev)
        chain.reverse()                     # [full, diff, diff, ...]

        named: Dict[str, Any] = {}
        flat_u32: Dict[str, np.ndarray] = {}        # host replay buffers
        replay = ChainReplay()                      # device replays, planned
        meta_shape: Dict[str, Tuple[str, List[int]]] = {}
        bb = None
        for link, (blob, man, root) in enumerate(chain):
            bb = man.get("block_bytes", self.cfg.block_bytes)
            ckid = man.get("id", ckpt_id)
            rd = CHK5Reader(io.BytesIO(blob))
            # one pass handles FULL, DIFF *and* mixed containers: a full
            # (or sharded) dataset supersedes any older delta replay of the
            # same leaf, a delta replays onto whatever base the chain built
            # so far.  Sharded leaves resolve their chunk files first: an
            # incomplete shard set (crash-lost / pruned file) makes this
            # checkpoint non-restorable and the walk falls back.
            refs = resolve_shard_refs(
                rd, self.ctx.recovery_dirs(root, ckid), rank)
            if refs is None:
                rd.close()
                warnings.warn(
                    f"checkpoint {ckid}: incomplete shard set (rank {rank}); "
                    "falling back to older id", RuntimeWarning)
                return None
            for name, ref in refs.items():
                named[name] = ref
                flat_u32.pop(name, None)
                replay.drop(name)
                meta_shape.pop(name, None)
            for ds in rd.datasets():
                if ds.startswith("data/"):
                    name = ds[len("data/"):]
                    named[name] = decode_leaf(rd, ds)
                    flat_u32.pop(name, None)
                    replay.drop(name)
                    meta_shape.pop(name, None)
                elif ds.startswith("delta/") and ds.endswith("/digest"):
                    name = ds[len("delta/"): -len("/digest")]
                    info = rd.info(ds)["attrs"]
                    idx = rd.read_dataset(f"delta/{name}/idx")
                    blocks = rd.read_dataset(f"delta/{name}/blocks")
                    if name not in flat_u32 and name not in replay:
                        if name not in named:
                            return None     # chain broken
                        if isinstance(named[name], ShardedLeafRef):
                            # delta replay needs the flat base: the one
                            # path that materializes a sharded leaf (on the
                            # host; ChainReplay places it on its device)
                            named[name] = named[name].materialize()
                        if devices.get(name) is not None:
                            replay.start(name, named[name], bb)
                        else:
                            flat_u32[name] = leaf_to_u32_flat(named[name], bb)
                    dt, shp = info["dtype"], info["shape"]
                    if name in replay:
                        replay.add(name, link, idx, blocks, bb, dt, shp)
                    else:
                        flat_u32[name] = apply_delta(flat_u32[name], idx,
                                                     blocks, bb)
                    meta_shape[name] = (dt, shp)
            rd.close()
        for name, buf in flat_u32.items():
            dt, shp = meta_shape[name]
            named[name] = u32_flat_to_leaf(buf, dt, shp)
        replay.finish()
        final_meta = dict(chain[-1][1], recovered_via=via)
        return named, replay, final_meta

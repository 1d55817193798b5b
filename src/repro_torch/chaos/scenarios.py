"""Declarative fault scenarios: store → inject → restart → verify-bit-exact.

Each scenario drives the *real* stack — backends built via
``make_backend`` over a :class:`~repro_torch.core.comm.SimulatedCluster` (or a
single-rank ``LocalComm``), faults armed through the chaos registry at the
same sites production code hits — and ends with a bit-exact comparison of
the restored state against what was stored.  The contract every scenario
asserts is the one "Checkpoint-Restart Libraries Must Become More Fault
Tolerant" demands: a fault may cost time (a retry, a weaker tier), it may
never cost *data* — ``data_loss_bytes`` is 0 or the scenario fails.

The matrix (× fti/scr/veloc backends):

    node-loss-mid-store   a node dies while another rank's store is in
                          flight; the victim restores its last committed
                          state from the partner replica
    straggler-demotion    a straggler's store dies before its partner
                          replica ships; its incomplete checkpoint blocks
                          nobody (quorum), and the straggler falls back
                          one id with zero loss vs its last commit
    mesh-shrink           world 4 → 2 after losing two nodes: the
                          survivors resume from the sharded checkpoint
                          via ft/elastic without re-initialization
    objstore-outage       the bucket goes dark: catalog discovery falls
                          back to directory tiers, an L4 store degrades
                          to global-dir durability (nothing lost), and
                          the post-outage publish restores from the
                          bucket alone
    corrupt-chunk         a chunk fetched on restore is corrupted in
                          transit: digest verification rejects it (no
                          silent bad bits), the retry restores bit-exact

Compound scenarios overlap two faults at once — the regime where a
checkpoint library's recovery paths actually interact:

    node-loss-during-outage   a node dies while the bucket is dark:
                          partner recovery works mid-outage, and the
                          post-outage bucket alone restores everything
    corrupt-chunk-straggler   one store is both slow (straggling upload)
                          and silently corrupted pre-digest; restore
                          rejects the poisoned container and falls back
                          one id, bit-exact
    heartbeat-loss-mid-gc a worker goes silent exactly while the
                          retention GC dies mid-sweep; the stale mark
                          resumes safely and the heartbeat gap registers
                          as a real MTBF failure observation

``supervised-kill`` (in :data:`SUPERVISED`, spawned on demand) runs the
real multi-process path: ``launch/train.py --supervise`` workers killed
by an ``OPENCHK_CHAOS`` exit spec, asserting kill-detect → backoff →
resume-from-checkpoint with restart-durable fault counters.

Reports are machine-readable dicts: faults fired, recovery path taken,
recovery wall time, MTTR, data loss in bytes.

The PyTorch port of the JAX package's scenario matrix, with the same
scenarios, assertions, recovery paths and report schema.  Every payload
is made of tensors on the ``device`` the caller names (``cuda`` unless it
asks for the CPU), so on a card each store hashes its leaves there; the
restored state is compared with it byte for byte on the host.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.backends.registry import make_backend
from repro_torch.chaos import inject as chaos
from repro_torch.chaos.cadence import MTBFEstimator
from repro_torch.core import manifest as mf
from repro_torch.core.comm import LocalComm, SimulatedCluster
from repro_torch.core.formats import as_numpy
from repro_torch.core.resharding import save_sharded
from repro_torch.core.storage import CHK_FULL, StorageConfig
from repro_torch.ft.detector import Heartbeat
from repro_torch.ft.elastic import rescale_restore
from repro_torch.ft.straggler import commit_if_quorum, validate_quorum
from repro_torch.objstore.client import ObjectStoreError
from repro_torch.objstore.gc import GC_MARK_KEY
from repro_torch.redundancy.groups import Topology
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace

BACKENDS = ("fti", "scr", "veloc")
WORLD = 4


@dataclass
class ScenarioResult:
    name: str
    backend: str
    ok: bool
    faults_fired: int
    recovery_path: str
    recovery_s: float
    data_loss_bytes: int
    #: mean time to repair — death/fault detection to verified recovery;
    #: defaults to recovery_s for scenarios whose restore walk IS the repair
    mttr_s: Optional[float] = None
    detail: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "backend": self.backend, "ok": self.ok,
            "faults_fired": self.faults_fired,
            "recovery_path": self.recovery_path,
            "recovery_s": round(self.recovery_s, 4),
            "mttr_s": round(self.mttr_s if self.mttr_s is not None
                            else self.recovery_s, 4),
            "data_loss_bytes": self.data_loss_bytes,
            "detail": self.detail,
        }


#: name → ``fn(workdir, backend, device)``
SCENARIOS: Dict[str, Callable[[str, str, Any], ScenarioResult]] = {}
#: scenarios that spawn real supervised worker processes — opt-in (slow),
#: run once (not per backend matrix cell) via ``--include-supervised``
SUPERVISED: Dict[str, Callable[[str, str, Any], ScenarioResult]] = {}


def scenario(name: str, table: Optional[Dict[str, Callable]] = None):
    def deco(fn):
        (SCENARIOS if table is None else table)[name] = fn
        fn.scenario_name = name
        return fn
    return deco


# -- helpers ----------------------------------------------------------------
def _payload(rank: int, ckpt_id: int, device) -> Dict[str, torch.Tensor]:
    """Deterministic per-(rank, id) state on ``device`` — the bit-exact
    reference (the same values as the JAX package's payload)."""
    base = float(rank * 1000 + ckpt_id)
    return {
        "w": torch.arange(512, dtype=torch.float32, device=device) + base,
        "m": torch.full((16, 16), base / 7.0, dtype=torch.float32,
                        device=device),
        "step": torch.tensor(ckpt_id, dtype=torch.int64, device=device),
    }


def _loss_bytes(expect: Dict[str, Any],
                got: Optional[Dict[str, Any]]) -> int:
    """Bytes of *expect* not bit-exactly reproduced in *got*, compared on
    the host so that every dtype counts byte for byte."""
    if got is None:
        return sum(as_numpy(v).nbytes for v in expect.values())
    loss = 0
    for k, v in expect.items():
        v = as_numpy(v)
        g = got.get(k)
        if g is None:
            loss += v.nbytes
            continue
        g = as_numpy(g)
        if g.shape != v.shape or g.dtype != v.dtype:
            loss += v.nbytes
        elif v.nbytes:
            vb = np.frombuffer(v.tobytes(), np.uint8)
            gb = np.frombuffer(g.tobytes(), np.uint8)
            loss += int(np.count_nonzero(vb != gb))
    return loss


def _cluster_backends(workdir: str, backend: str, world: int = WORLD):
    cluster = SimulatedCluster(os.path.join(workdir, "cluster"), world)
    cfg = StorageConfig(root=os.path.join(workdir, "shared"), group_size=4)
    kw = {"dedicated_thread": False} if backend == "fti" else {}
    backends = [make_backend(cfg, c, backend, **kw) for c in cluster.comms]
    return cluster, cfg, backends, kw


def _join_uploads(b) -> None:
    """Wait for the chunk puts that a failed L4 store left queued.  The
    store fails at its first failed put; the others run on the uploader's
    threads, and each fires a fault only while the outage lasts.  Joining
    them before the scenario goes on makes its fault count independent of
    thread timing."""
    tier = b.engine.objstore_tier()
    if tier is not None:
        tier.uploader.close()


def _restart_backend(cfg, comm, backend: str, kw):
    """A fresh backend over the same comm — the restarted process."""
    return make_backend(cfg, comm, backend, **kw)


def _store_all(backends, ckpt_id: int, level: int, device) -> None:
    for r, b in enumerate(backends):
        b.tcl_store(_payload(r, ckpt_id, device), ckpt_id, level, CHK_FULL)
        b.tcl_wait()


# -- scenarios --------------------------------------------------------------
@scenario("node-loss-mid-store")
def node_loss_mid_store(workdir: str, backend: str, device) -> ScenarioResult:
    """Node 2 dies while rank 3's next store is mid-place; rank 2 restores
    its last committed checkpoint from the partner replica."""
    cluster, cfg, backends, kw = _cluster_backends(workdir, backend)
    _store_all(backends, 1, 2, device)
    _store_all(backends, 2, 2, device)          # the last good commit
    # rank 3's store of id=3 dies in Place — a torn .tmp that must not
    # shadow the committed id=2
    chaos.arm("tier.place", mode="error", match={"rank": 3})
    torn = False
    try:
        backends[3].tcl_store(_payload(3, 3, device), 3, 2, CHK_FULL)
        backends[3].tcl_wait()
    except Exception:
        torn = True
    cluster.kill_node(2)                      # node loss
    t0 = time.time()
    b2 = _restart_backend(cfg, cluster.comms[2], backend, kw)
    got = b2.engine.load_latest()
    dt = time.time() - t0
    named, meta = got if got is not None else (None, {})
    loss = _loss_bytes(_payload(2, 2, device), named)
    ok = torn and loss == 0 and meta.get("recovered_via") == "partner"
    return ScenarioResult(
        "node-loss-mid-store", backend, ok,
        faults_fired=chaos.registry().fired_count(),
        recovery_path=str(meta.get("recovered_via")), recovery_s=dt,
        data_loss_bytes=loss,
        detail={"torn_store_detected": torn,
                "restored_id": meta.get("id", 2)})


@scenario("straggler-demotion")
def straggler_demotion(workdir: str, backend: str, device) -> ScenarioResult:
    """Rank 2's id=2 store dies before its partner replica ships: the
    straggler's torn store blocks nobody, and rank 2 restarts one id back
    with zero loss vs its last commit.  The quorum rule itself is
    exercised on a shared-dir shard set (partner covers a lost shard)."""
    cluster, cfg, backends, kw = _cluster_backends(workdir, backend)
    _store_all(backends, 1, 2, device)
    for r in (0, 1, 3):
        backends[r].tcl_store(_payload(r, 2, device), 2, 2, CHK_FULL)
        backends[r].tcl_wait()
    # the straggler: slow (delay at local place), then dead before the
    # partner tier ships its replica
    chaos.arm("tier.place", mode="delay", delay_s=0.05,
              match={"rank": 2, "tier": "local"})
    chaos.arm("tier.place", mode="error", match={"rank": 2, "tier": "partner"})
    demoted = False
    try:
        backends[2].tcl_store(_payload(2, 2, device), 2, 2, CHK_FULL)
        backends[2].tcl_wait()
    except Exception:
        demoted = True
    cluster.kill_node(2)
    t0 = time.time()
    b2 = _restart_backend(cfg, cluster.comms[2], backend, kw)
    got = b2.engine.load_latest()
    dt = time.time() - t0
    named, meta = got if got is not None else (None, {})
    loss = _loss_bytes(_payload(2, 1, device), named)   # last commit = id 1
    # the survivors' id=2 is intact
    survivors_ok = all(
        _loss_bytes(_payload(r, 2, device), backends[r].engine.load_latest()[0]) == 0
        for r in (0, 1, 3))
    # quorum commit over a multi-file shard set: rank 2's own shard 1 is
    # lost, the partner replica covers it
    topo = Topology(world=WORLD)
    qroot = os.path.join(workdir, "quorum")
    d = mf.begin(qroot, 9)
    for r in (0, 1, 3):
        open(os.path.join(d, f"rank{r}.chk5"), "wb").write(b"c" * 8)
        open(os.path.join(d, f"rank{r}.shard0.chk5"), "wb").write(b"s" * 8)
    h = topo.partner_of(2)
    open(os.path.join(d, f"rank{h}.partner2.chk5"), "wb").write(b"p")
    open(os.path.join(d, f"rank{h}.partner2.shard0.chk5"), "wb").write(b"p")
    rep = validate_quorum(d, topo)
    quorum_ok = (rep.restorable and 2 in rep.covered_by_partner
                 and (2, 0) in rep.shards_covered
                 and commit_if_quorum(qroot, 9, topo))
    ok = (demoted and loss == 0 and survivors_ok and quorum_ok)
    return ScenarioResult(
        "straggler-demotion", backend, ok,
        faults_fired=chaos.registry().fired_count(),
        recovery_path=str(meta.get("recovered_via")), recovery_s=dt,
        data_loss_bytes=loss,
        detail={"demoted": demoted, "survivors_ok": survivors_ok,
                "quorum_shard_covered": quorum_ok})


@scenario("mesh-shrink")
def mesh_shrink(workdir: str, backend: str, device) -> ScenarioResult:
    """World 4 → 2 after two node losses: survivors resume their slices of
    the sharded checkpoint via ft/elastic — no full re-initialization."""
    cluster, cfg, backends, kw = _cluster_backends(workdir, backend)
    _store_all(backends, 1, 2, device)          # per-backend baseline store
    # the sharded global state: each rank wrote its axis-0 slice
    g = (torch.arange(64 * 8, dtype=torch.float32,
                      device=device).reshape(64, 8) * 0.5) - 3.0
    d = mf.begin(cfg.global_root, 2)
    rows = 64 // WORLD
    for r in range(WORLD):
        save_sharded(os.path.join(d, f"rank{r}.chk5"),
                     {"g": g[r * rows:(r + 1) * rows]},
                     {"g": r * rows}, {"g": [64, 8]})
    mf.write_manifest(cfg.global_root, 2,
                      {"kind": CHK_FULL, "level": 4, "world": WORLD})
    mf.commit(cfg.global_root, 2)
    cluster.kill_node(2)                      # the shrink: two nodes gone
    cluster.kill_node(3)
    t0 = time.time()
    loss = 0
    ckpt_ids = []
    new_world = 2
    for new_rank in range(new_world):
        got = rescale_restore([cfg.global_root], new_world, new_rank)
        if got is None:
            loss += g.numel() * g.element_size() // new_world
            continue
        named, ckpt_id = got
        ckpt_ids.append(ckpt_id)
        expect = g[new_rank * (64 // new_world):(new_rank + 1) * (64 // new_world)]
        loss += _loss_bytes({"g": expect}, named)
    dt = time.time() - t0
    ok = loss == 0 and ckpt_ids == [2, 2]
    return ScenarioResult(
        "mesh-shrink", backend, ok,
        faults_fired=2,                       # the two node losses
        recovery_path="elastic", recovery_s=dt, data_loss_bytes=loss,
        detail={"old_world": WORLD, "new_world": new_world,
                "restored_ids": ckpt_ids})


@scenario("objstore-outage")
def objstore_outage(workdir: str, backend: str, device) -> ScenarioResult:
    """The bucket goes dark: discovery falls back to directory tiers, an
    L4 store degrades to global-dir durability (zero loss), and after the
    outage a publish restores from the bucket alone."""
    cfg = StorageConfig(root=os.path.join(workdir, "shared"), group_size=1)
    comm = LocalComm(os.path.join(workdir, "node-local"))
    kw = {"dedicated_thread": False} if backend == "fti" else {}
    b = make_backend(cfg, comm, backend, **kw)
    b.tcl_store(_payload(0, 1, device), 1, 4, CHK_FULL)
    b.tcl_wait()
    # outage: every objstore op fails until disarmed
    outage = [chaos.arm("objstore.*", mode="error", every=1, times=None)]
    store_degraded = False
    try:
        b.tcl_store(_payload(0, 2, device), 2, 4, CHK_FULL)
        b.tcl_wait()
    except ObjectStoreError:
        store_degraded = True
    except Exception:
        # some backends wrap the tier error at the wait fence
        store_degraded = True
    _join_uploads(b)
    # catalog fallback: discovery + restore must still work mid-outage
    t0 = time.time()
    b_mid = _restart_backend(cfg, comm, backend, kw)
    got_mid = b_mid.engine.load_latest()
    named_mid, meta_mid = got_mid if got_mid is not None else (None, {})
    # the store that "failed" lost nothing: its manifest committed to the
    # global dir before the publish step hit the outage
    loss_mid = _loss_bytes(_payload(0, 2, device), named_mid)
    mid_path = str(meta_mid.get("recovered_via"))
    # outage ends; a fresh publish, then wipe every directory tier
    chaos.registry().disarm_all()
    del outage
    b.tcl_store(_payload(0, 3, device), 3, 4, CHK_FULL)
    b.tcl_wait()
    shutil.rmtree(comm.node_local_dir, ignore_errors=True)
    os.makedirs(comm.node_local_dir, exist_ok=True)
    shutil.rmtree(cfg.global_root, ignore_errors=True)
    b_post = _restart_backend(cfg, comm, backend, kw)
    got = b_post.engine.load_latest()
    dt = time.time() - t0
    named, meta = got if got is not None else (None, {})
    loss = _loss_bytes(_payload(0, 3, device), named)
    ok = (store_degraded and loss_mid == 0 and loss == 0
          and meta.get("recovered_via") == "objstore")
    return ScenarioResult(
        "objstore-outage", backend, ok,
        faults_fired=chaos.registry().fired_count(),
        recovery_path=str(meta.get("recovered_via")), recovery_s=dt,
        data_loss_bytes=loss + loss_mid,
        detail={"store_degraded_not_lost": store_degraded and loss_mid == 0,
                "mid_outage_recovery": mid_path})


@scenario("corrupt-chunk")
def corrupt_chunk(workdir: str, backend: str, device) -> ScenarioResult:
    """A chunk is corrupted in transit on restore: digest verification
    refuses it (the load fails cleanly — no silent bad bits), and the
    retry restores bit-exact from the bucket."""
    cfg = StorageConfig(root=os.path.join(workdir, "shared"), group_size=1)
    comm = LocalComm(os.path.join(workdir, "node-local"))
    kw = {"dedicated_thread": False} if backend == "fti" else {}
    b = make_backend(cfg, comm, backend, **kw)
    b.tcl_store(_payload(0, 1, device), 1, 4, CHK_FULL)
    b.tcl_wait()
    tier = b.engine.objstore_tier()
    chunk_keys = tier.store.list("chunks/")
    # wipe every directory tier: the bucket is the only source
    shutil.rmtree(comm.node_local_dir, ignore_errors=True)
    os.makedirs(comm.node_local_dir, exist_ok=True)
    shutil.rmtree(cfg.global_root, ignore_errors=True)
    chaos.arm("objstore.get", mode="corrupt", times=1,
              match={"key": chunk_keys[0]})
    t0 = time.time()
    b1 = _restart_backend(cfg, comm, backend, kw)
    first = b1.engine.load_latest()           # hits the corrupted fetch
    corrupt_detected = first is None or _loss_bytes(
        _payload(0, 1, device), first[0]) == 0
    silent_corruption = first is not None and _loss_bytes(
        _payload(0, 1, device), first[0]) != 0
    # the retry (spec exhausted after times=1) must restore bit-exact
    b2 = _restart_backend(cfg, comm, backend, kw)
    got = b2.engine.load_latest()
    dt = time.time() - t0
    named, meta = got if got is not None else (None, {})
    loss = _loss_bytes(_payload(0, 1, device), named)
    fired = chaos.registry().fired_count("objstore.get")
    ok = (fired >= 1 and not silent_corruption and corrupt_detected
          and loss == 0 and meta.get("recovered_via") == "objstore")
    return ScenarioResult(
        "corrupt-chunk", backend, ok,
        faults_fired=chaos.registry().fired_count(),
        recovery_path=str(meta.get("recovered_via")), recovery_s=dt,
        data_loss_bytes=loss,
        detail={"chunks_in_bucket": len(chunk_keys),
                "first_load_failed_cleanly": first is None,
                "silent_corruption": silent_corruption})


# -- compound scenarios (two overlapping faults) ----------------------------
@scenario("node-loss-during-outage")
def node_loss_during_outage(workdir: str, backend: str, device) -> ScenarioResult:
    """Node 2 dies *while* the bucket is dark: a degraded L4 store loses
    nothing, the victim restores mid-outage from its partner replica, and
    once the outage lifts the bucket alone restores a post-outage store."""
    cluster, cfg, backends, kw = _cluster_backends(workdir, backend)
    _store_all(backends, 1, 4, device)          # all ranks published to bucket
    _store_all(backends, 2, 2, device)          # local + partner only
    chaos.arm("objstore.*", mode="error", every=1, times=None)
    store_degraded = False
    try:                                      # L4 store mid-outage degrades
        backends[3].tcl_store(_payload(3, 3, device), 3, 4, CHK_FULL)
        backends[3].tcl_wait()
    except Exception:
        store_degraded = True
    _join_uploads(backends[3])
    cluster.kill_node(2)                      # second fault, same window
    t0 = time.time()
    b2 = _restart_backend(cfg, cluster.comms[2], backend, kw)
    got_mid = b2.engine.load_latest()
    mttr = time.time() - t0
    named_mid, meta_mid = got_mid if got_mid is not None else (None, {})
    loss_mid = _loss_bytes(_payload(2, 2, device), named_mid)
    partner_ok = meta_mid.get("recovered_via") == "partner"
    # outage ends: a fresh publish must make the bucket whole again
    chaos.registry().disarm_all()
    backends[0].tcl_store(_payload(0, 4, device), 4, 4, CHK_FULL)
    backends[0].tcl_wait()
    for c in cluster.comms:                   # bucket is the only survivor
        shutil.rmtree(c.node_local_dir, ignore_errors=True)
        os.makedirs(c.node_local_dir, exist_ok=True)
    shutil.rmtree(cfg.global_root, ignore_errors=True)
    b0 = _restart_backend(cfg, cluster.comms[0], backend, kw)
    got = b0.engine.load_latest()
    dt = time.time() - t0
    named, meta = got if got is not None else (None, {})
    loss = _loss_bytes(_payload(0, 4, device), named)
    ok = (store_degraded and partner_ok and loss_mid == 0 and loss == 0
          and meta.get("recovered_via") == "objstore")
    return ScenarioResult(
        "node-loss-during-outage", backend, ok,
        faults_fired=chaos.registry().fired_count(),
        recovery_path=str(meta.get("recovered_via")), recovery_s=dt,
        data_loss_bytes=loss + loss_mid, mttr_s=mttr,
        detail={"store_degraded_not_lost": store_degraded and loss_mid == 0,
                "mid_outage_recovery": str(meta_mid.get("recovered_via"))})


@scenario("corrupt-chunk-straggler")
def corrupt_chunk_straggler(workdir: str, backend: str, device) -> ScenarioResult:
    """One store is slow AND silently poisoned: a straggling upload plus a
    pre-digest chunk corruption (the chunk digest *matches* the bad bytes,
    so transport verification cannot catch it).  Restore-side container
    verification rejects the poisoned id and the walk falls back one id
    with zero loss vs the last good commit."""
    cfg = StorageConfig(root=os.path.join(workdir, "shared"), group_size=1)
    comm = LocalComm(os.path.join(workdir, "node-local"))
    kw = {"dedicated_thread": False} if backend == "fti" else {}
    b = make_backend(cfg, comm, backend, **kw)
    b.tcl_store(_payload(0, 1, device), 1, 4, CHK_FULL)   # the last good commit
    b.tcl_wait()
    # both faults hit id=2's store: the payload bytes flip BEFORE the
    # transport digest sees them — pre-digest on the streamed chunk path
    # (fused-pack backends), at-put for backends that upload staged files
    # — and one chunk upload straggles.  Only NEW chunks upload (dedup),
    # so id=1's published chunks cannot be the poisoned ones.
    chaos.arm("chunkstream.emit", mode="corrupt", times=1)
    chaos.arm("objstore.put", mode="corrupt", times=1)
    chaos.arm("objstore.put", mode="delay", delay_s=0.05, times=1)
    b.tcl_store(_payload(0, 2, device), 2, 4, CHK_FULL)   # "succeeds" — poisoned
    b.tcl_wait()
    poisoned = (chaos.registry().fired_count("chunkstream.emit")
                + chaos.registry().fired_count("objstore.put")) >= 2
    chaos.registry().disarm_all()
    # bucket is the only source; the poisoned id=2 must not restore
    shutil.rmtree(comm.node_local_dir, ignore_errors=True)
    os.makedirs(comm.node_local_dir, exist_ok=True)
    shutil.rmtree(cfg.global_root, ignore_errors=True)
    t0 = time.time()
    b2 = _restart_backend(cfg, comm, backend, kw)
    import warnings as _w
    with _w.catch_warnings():
        _w.simplefilter("ignore", RuntimeWarning)   # the expected fallback
        got = b2.engine.load_latest()
    dt = time.time() - t0
    named, meta = got if got is not None else (None, {})
    loss = _loss_bytes(_payload(0, 1, device), named)
    silent_corruption = (named is not None
                         and _loss_bytes(_payload(0, 2, device), named) == 0)
    ok = (poisoned and not silent_corruption and loss == 0
          and meta.get("id") == 1
          and meta.get("recovered_via") == "objstore")
    return ScenarioResult(
        "corrupt-chunk-straggler", backend, ok,
        faults_fired=chaos.registry().fired_count(),
        recovery_path=str(meta.get("recovered_via")), recovery_s=dt,
        data_loss_bytes=loss, mttr_s=dt,
        detail={"poisoned_store": poisoned,
                "fell_back_to_id": meta.get("id"),
                "silent_corruption": silent_corruption})


@scenario("heartbeat-loss-mid-gc")
def heartbeat_loss_mid_gc(workdir: str, backend: str, device) -> ScenarioResult:
    """The worker goes silent exactly while retention GC dies mid-sweep:
    the stale GC mark resumes safely on the next store (never deleting a
    live chunk), the silent span registers as a *real* failure in the
    MTBF estimator, and the surviving newest id restores bit-exact."""
    cfg = StorageConfig(root=os.path.join(workdir, "shared"), group_size=1,
                        objstore_keep_last=2)
    comm = LocalComm(os.path.join(workdir, "node-local"))
    kw = {"dedicated_thread": False} if backend == "fti" else {}
    b = make_backend(cfg, comm, backend, **kw)
    hb = Heartbeat(os.path.join(workdir, "heartbeat"))
    est = MTBFEstimator(prior_mtbf_s=3600.0, gap_failure_s=0.2)
    hb.beat(1)
    est.note_progress()
    b.tcl_store(_payload(0, 1, device), 1, 4, CHK_FULL)
    b.tcl_wait()
    b.tcl_store(_payload(0, 2, device), 2, 4, CHK_FULL)
    b.tcl_wait()
    # both faults in one window: heartbeat writes stop landing, and the
    # GC sweep triggered by id=3's commit (which retires id=1) dies on
    # its first chunk delete — AFTER the id=3 entry is durable
    chaos.arm("heartbeat.beat", mode="skip", every=1, times=None)
    chaos.arm("objstore.delete", mode="error", at=1)
    gc_died = False
    try:
        b.tcl_store(_payload(0, 3, device), 3, 4, CHK_FULL)
        b.tcl_wait()
    except Exception:
        gc_died = True
    time.sleep(0.25)                          # the silent span
    hb.beat(3)                                # skipped — never lands
    est.note_progress()                       # gap > gap_failure_s
    stale = hb.stale_s()
    chaos.registry().disarm_all()
    t0 = time.time()
    b.tcl_store(_payload(0, 4, device), 4, 4, CHK_FULL)   # resumes the stale mark
    b.tcl_wait()
    tier = b.engine.objstore_tier()
    mark_cleared = tier.store.get_with_etag(GC_MARK_KEY)[0] is None
    shutil.rmtree(comm.node_local_dir, ignore_errors=True)
    os.makedirs(comm.node_local_dir, exist_ok=True)
    shutil.rmtree(cfg.global_root, ignore_errors=True)
    b2 = _restart_backend(cfg, comm, backend, kw)
    got = b2.engine.load_latest()
    dt = time.time() - t0
    named, meta = got if got is not None else (None, {})
    loss = _loss_bytes(_payload(0, 4, device), named)
    mtbf_moved = est.failures >= 1 and est.estimate() < est.prior_mtbf_s
    ok = (gc_died and mark_cleared and mtbf_moved and loss == 0
          and stale is not None and stale >= 0.25
          and meta.get("recovered_via") == "objstore")
    return ScenarioResult(
        "heartbeat-loss-mid-gc", backend, ok,
        faults_fired=chaos.registry().fired_count(),
        recovery_path=str(meta.get("recovered_via")), recovery_s=dt,
        data_loss_bytes=loss, mttr_s=dt,
        detail={"gc_died_mid_sweep": gc_died,
                "stale_mark_cleared": mark_cleared,
                "heartbeat_stale_s": round(stale or -1.0, 3),
                "mtbf_failures": est.failures,
                "mtbf_estimate_s": round(est.estimate(), 1)})


# -- supervised multi-process scenario ---------------------------------------
@scenario("supervised-kill", table=SUPERVISED)
def supervised_kill(workdir: str, backend: str, device,
                    layers: Optional[int] = None) -> ScenarioResult:
    """Real kill/restart supervision: spawn ``launch/train.py --supervise``
    with an ``OPENCHK_CHAOS`` exit spec that hard-kills the worker at step
    8 (checkpoints at 3 and 6).  Asserts kill-detect → backoff → resume
    from the last checkpoint (never step 0), that the restart-durable
    fault counters keep the exhausted spec from re-killing the restarted
    child, and that the supervisor's MTBF feed recorded the real death.

    The workers train on ``device``: the reduced config on the CPU, the
    published widths (``--full``) with the flash attention kernel on a
    card.  There each FULL is kept only until the next one commits
    (``--keep-last-full 1``), so the disk holds at most two of them.  The
    finishing worker's kernel launches come back in
    ``detail["worker_launches"]``.  ``layers`` cuts the workers' depth
    (``launch/train.py --layers``)."""
    ckpt_dir = os.path.join(workdir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    import repro_torch
    src = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    on_card = torch.device(device).type == "cuda"
    spec = chaos.FaultSpec(site="train.step", mode="exit", every=8, times=1)
    state_path = os.path.join(ckpt_dir, "chaos-state.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(chaos.env_for_specs([spec], state_path=state_path))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--supervise",
           "--arch", "tinyllama-1.1b", "--steps", "12", "--batch", "2",
           "--seq", "32", "--ckpt-every", "3", "--no-dedicated-thread",
           "--ckpt-dir", ckpt_dir, "--restart-backoff", "0.2",
           "--restart-backoff-max", "1.0", "--backend", backend,
           "--device", torch.device(device).type]
    cmd.append("--launch-counts")
    if layers is not None:
        cmd += ["--layers", str(layers)]
    if on_card:
        cmd += ["--full", "--keep-last-full", "1"]
        env["REPRO_ATTN_IMPL"] = "flash"
    t0 = time.time()
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=900)
    dt = time.time() - t0
    out = p.stdout + p.stderr
    resumed = "resuming from step 6" in out
    restarted_once = "attempt 2" in out and "attempt 3" not in out
    backed_off = "backing off" in out
    finished = "'final_step': 12" in out
    fired_total = 0
    try:
        with open(state_path, "r", encoding="utf-8") as f:
            fired_total = sum(int(v.get("fired", 0))
                              for v in json.load(f).values())
    except (OSError, ValueError, AttributeError):
        pass
    feed: Dict[str, Any] = {}
    try:
        with open(os.path.join(ckpt_dir, "mtbf-feed.json"),
                  encoding="utf-8") as f:
            feed = json.load(f)
    except (OSError, ValueError):
        pass
    feed_ok = (feed.get("deaths") == 1 and feed.get("failures", 0) >= 1
               and feed.get("estimate_s", 1e18) < 3600.0
               and len(feed.get("mttr_s") or []) == 1)
    mttr = (feed.get("mttr_s") or [dt])[0]
    launches = []
    for name in sorted(os.listdir(ckpt_dir)):
        if name.startswith("launches-") and name.endswith(".json"):
            with open(os.path.join(ckpt_dir, name), encoding="utf-8") as f:
                launches.append(json.load(f))
    ok = (p.returncode == 0 and resumed and restarted_once and backed_off
          and finished and fired_total == 1 and feed_ok)
    return ScenarioResult(
        "supervised-kill", backend, ok,
        faults_fired=fired_total,
        recovery_path="supervised", recovery_s=dt,
        data_loss_bytes=0 if (resumed and finished) else -1, mttr_s=mttr,
        detail={"returncode": p.returncode, "resumed_from_step_6": resumed,
                "exactly_one_restart": restarted_once,
                "backoff_paced": backed_off, "finished": finished,
                "state_fired": fired_total, "feed": feed,
                "worker_launches": launches})


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a card that is not there is an
    error, never a quiet fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda, but torch.cuda.is_available() is "
                           "false: pass device 'cpu' to run on the CPU")
    return dev


def run_scenario(name: str, backend: str, workdir: str,
                 trace_dir: Optional[str] = None,
                 device: Any = "cuda") -> ScenarioResult:
    """Run one scenario with a clean chaos registry, always disarming.

    The payloads live on ``device`` (:func:`check_device`).

    With *trace_dir*, the cell runs traced: this process records into
    ``<trace_dir>/<name>-<backend>/trace-<pid>.json``, spawned supervised
    workers inherit ``OPENCHK_TRACE_DIR`` and contribute their own files,
    and afterwards everything folds into ``<trace_dir>/<name>-<backend>.json``
    — ``detail.trace_file`` points there and ``detail.metrics`` embeds the
    cell's metrics-registry snapshot."""
    device = check_device(device)
    chaos.reset()
    os.makedirs(workdir, exist_ok=True)
    cell = f"{name}-{backend}"
    raw_dir = None
    prev_env: Dict[str, Optional[str]] = {}
    if trace_dir is not None:
        raw_dir = os.path.join(trace_dir, cell)
        os.makedirs(raw_dir, exist_ok=True)
        prev_env = {k: os.environ.get(k)
                    for k in (ttrace.TRACE_ENV, ttrace.TRACE_DIR_ENV)}
        os.environ.pop(ttrace.TRACE_ENV, None)
        os.environ[ttrace.TRACE_DIR_ENV] = raw_dir  # children inherit
        tmetrics.reset()
        ttrace.tracer().reset()
        ttrace.enable(os.path.join(raw_dir, f"trace-{os.getpid()}.json"))
    try:
        fn = SCENARIOS.get(name) or SUPERVISED[name]
        result = fn(workdir, backend, device)
    except Exception as e:  # a crashed scenario is a failed scenario
        result = ScenarioResult(
            name, backend, False,
            faults_fired=chaos.registry().fired_count(),
            recovery_path="error", recovery_s=0.0, data_loss_bytes=-1,
            detail={"error": f"{type(e).__name__}: {e}"})
    finally:
        chaos.reset()
        if raw_dir is not None:
            ttrace.flush()
            ttrace.disable()
            ttrace.tracer().reset()
            for k, v in prev_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    if raw_dir is not None:
        result.detail["trace_file"] = ttrace.merge_dir(
            raw_dir, os.path.join(trace_dir, f"{cell}.json"))
        result.detail["metrics"] = tmetrics.snapshot()
    return result


def run_matrix(workdir: str,
               backends=BACKENDS,
               names: Optional[List[str]] = None,
               include_supervised: bool = False,
               trace_dir: Optional[str] = None,
               device: Any = "cuda") -> Dict[str, Any]:
    """The full scenario × backend matrix → machine-readable report.

    Supervised scenarios spawn real worker processes, so they run once
    (first backend) instead of per matrix cell, and only when named
    explicitly or requested via *include_supervised*."""
    names = list(names or SCENARIOS)
    if include_supervised:
        names += [n for n in SUPERVISED if n not in names]
    results = []
    for n in names:
        if n in SUPERVISED:
            d = os.path.join(workdir, f"{n}-{backends[0]}")
            results.append(run_scenario(n, backends[0], d, trace_dir,
                                        device))
            continue
        for be in backends:
            d = os.path.join(workdir, f"{n}-{be}")
            results.append(run_scenario(n, be, d, trace_dir, device))
    return {
        "scenarios": [r.to_dict() for r in results],
        "total": len(results),
        "passed": sum(r.ok for r in results),
        "data_loss_bytes": sum(r.data_loss_bytes for r in results),
        "max_mttr_s": round(max(
            (r.mttr_s if r.mttr_s is not None else r.recovery_s)
            for r in results), 4) if results else 0.0,
        "ok": all(r.ok for r in results),
    }

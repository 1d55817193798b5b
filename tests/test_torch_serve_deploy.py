"""The torch mirror of tests/test_serve_deploy.py, on the port.

Checkpoint-as-deployment: the typed catalog-inspection API, the epoch
subscriber, chunk-delta pulls through the node-local cache, the engine's
atomic WeightsHandle swap, and the rolling fleet deployer under injected
faults — a killed replica, a corrupted cached chunk, and an objstore
outage all pin the affected replica on its current epoch (no torn params
ever observable from ``generate()``) and the rollout converges once the
fault clears."""

import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.comm import LocalComm
from repro_torch.core.formats import tensor_to_numpy
from repro_torch.core.protect import flatten_named, unflatten_named
from repro_torch.core.storage import StorageConfig, StorageEngine
from repro_torch.models.zoo import build_model
from repro_torch.objstore.catalog import Catalog
from repro_torch.objstore.chunks import (
    ChunkCache,
    ChunkUploader,
    FileEntry,
    fetch_file_delta,
)
from repro_torch.objstore.client import (
    MemoryObjectStore,
    ObjectStoreError,
    make_object_store,
)
from repro_torch.objstore.inspect import CatalogView
from repro_torch.objstore.subscriber import CatalogSubscriber, DeploySelector
from repro_torch.serve.deploy import FleetDeployer, Replica
from repro_torch.serve.engine import ServingEngine, WeightsHandle


def tree_map(fn, tree):
    """``fn`` over every leaf of a param tree (the reference's
    ``jax.tree.map`` with one tree)."""
    return unflatten_named({k: fn(v) for k, v in flatten_named(tree).items()},
                           tree)


def randint(seed, shape, high):
    """Seeded int32 prompts on the CPU."""
    return torch.randint(0, high, shape, dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))

# ------------------------------------------------------------------ #
# inspect: typed views + the chunk diff
# ------------------------------------------------------------------ #


def _publish(cat, ckpt_id, chunks, kind="FULL", level=4, name="rank0.chk5"):
    size = sum(n for _h, n in chunks)
    cat.publish(ckpt_id, {"kind": kind, "level": level, "id": ckpt_id},
                {name: FileEntry(name, size, list(chunks))})


def test_catalog_view_entries_latest_and_diff():
    st = MemoryObjectStore()
    cat = Catalog(st)
    _publish(cat, 1, [("a", 100), ("b", 100), ("c", 100)])
    _publish(cat, 2, [("a", 100), ("b", 100), ("d", 50)])
    _publish(cat, 3, [("x", 10)], kind="DIFF", level=1)
    view = CatalogView.from_store(st)
    assert view.ids() == [1, 2, 3]
    assert view.epoch == cat.epoch()
    # selector resolution: newest FULL, not the newer DIFF
    assert view.latest(kind="FULL").id == 2
    assert view.latest(kind="DIFF").id == 3
    assert view.latest(kind="FULL", min_id=3) is None
    e2 = view.entry(2)
    assert e2.kind == "FULL" and e2.level == 4
    assert e2.total_bytes == 250 and e2.n_chunks == 3
    assert e2.chunk_digests == {"a", "b", "d"}
    # the deploy delta: only the digest the base lacks is pulled
    d = CatalogView.diff(view.entry(1), e2)
    assert d.digests == {"d"} and d.bytes_delta == 50
    assert d.bytes_total == 250 and d.ratio == pytest.approx(0.2)
    # cold fleet: the delta is the whole entry
    cold = CatalogView.diff(None, e2)
    assert cold.bytes_delta == cold.bytes_total == 250


def test_inventory_shim_keeps_legacy_shape(tmp_path):
    eng = _engine(tmp_path)
    eng.store({"w": np.arange(4096, dtype=np.float32)}, ckpt_id=7, level=4)
    root = os.path.join(str(tmp_path / "shared"), "objstore")
    # the port's chkls and the reference's read the port's store alike
    from repro.tools.chkls import catalog_inventory as ref_catalog_inventory
    from repro_torch.tools.chkls import catalog_inventory
    inv = catalog_inventory(root)
    view = CatalogView.from_root(root, count_chunks=True)
    assert inv == view.to_inventory(root)
    assert ref_catalog_inventory(root) == inv
    e = inv["entries"][0]
    assert e["id"] == 7 and e["kind"] == "FULL"
    assert set(e) == {"id", "pinned", "kind", "level", "wall_time", "files",
                      "total_bytes", "n_chunks", "chunk_hist",
                      "chunk_bytes_min", "chunk_bytes_max"}
    assert sum(e["chunk_hist"].values()) == e["n_chunks"] > 0
    assert inv["stored_chunks"] >= e["n_chunks"]


# ------------------------------------------------------------------ #
# subscriber: epoch watch + selector
# ------------------------------------------------------------------ #


def test_subscriber_polls_epochs_and_tracks_deployed():
    st = MemoryObjectStore()
    cat = Catalog(st)
    sub = CatalogSubscriber(st)
    assert sub.poll() is None                     # empty catalog
    _publish(cat, 1, [("a", 10)])
    t1 = sub.poll()
    assert t1 is not None and t1.id == 1
    assert sub.poll() is None                     # epoch unchanged: no read
    sub.mark_deployed(t1)
    _publish(cat, 2, [("a", 10), ("b", 4)])
    t2 = sub.poll()
    assert t2.id == 2
    assert sub.delta(t2).digests == {"b"}         # diff vs deployed base
    sub.mark_deployed(t2)
    # a DIFF publish moves the epoch but resolves to the already-deployed
    # FULL entry — nothing to do
    _publish(cat, 3, [("z", 1)], kind="DIFF")
    assert sub.poll() is None
    # selector filters
    sub2 = CatalogSubscriber(st, DeploySelector(kind="DIFF"))
    assert sub2.poll().id == 3


def test_subscriber_outage_propagates():
    st = MemoryObjectStore()
    Catalog(st).publish(1, {"kind": "FULL"}, {})
    sub = CatalogSubscriber(st)

    class _Dead:
        def get_with_etag(self, key):
            raise ObjectStoreError("outage")
    sub.catalog.store = _Dead()
    with pytest.raises(ObjectStoreError, match="outage"):
        sub.poll()


# ------------------------------------------------------------------ #
# chunk cache + delta fetch
# ------------------------------------------------------------------ #


def test_fetch_file_delta_uses_cache_and_refetches_corruption(tmp_path):
    st = MemoryObjectStore()
    up = ChunkUploader(st, chunk_bytes=1024, transfers=2)
    payload = os.urandom(8192)
    src = str(tmp_path / "src")
    with open(src, "wb") as f:
        f.write(payload)
    entry = up.upload_file(src)
    cache = ChunkCache(str(tmp_path / "cache"))
    s1 = fetch_file_delta(st, entry, str(tmp_path / "out1"), cache)
    assert open(str(tmp_path / "out1"), "rb").read() == payload
    assert s1["chunks_fetched"] == 8 and s1["chunks_cached"] == 0
    # second fetch: everything served from the local cache
    s2 = fetch_file_delta(st, entry, str(tmp_path / "out2"), cache)
    assert s2["chunks_fetched"] == 0 and s2["chunks_cached"] == 8
    # corrupt one cached chunk in place: digest verify evicts + refetches
    victim = entry.chunks[3][0]
    with open(os.path.join(str(tmp_path / "cache"), victim), "r+b") as f:
        f.write(b"\x00garbage\x00")
    s3 = fetch_file_delta(st, entry, str(tmp_path / "out3"), cache)
    assert open(str(tmp_path / "out3"), "rb").read() == payload
    assert s3["chunks_corrupt"] == 1 and s3["chunks_fetched"] == 1
    # a chunk corrupt in the BUCKET fails loudly, leaves no torn file
    st._objects[f"chunks/{victim[:2]}/{victim}"] = b"bad"
    cache2 = ChunkCache(str(tmp_path / "cache2"))
    with pytest.raises(ObjectStoreError, match="corrupt"):
        fetch_file_delta(st, entry, str(tmp_path / "out4"), cache2)
    assert not os.path.exists(str(tmp_path / "out4"))


# ------------------------------------------------------------------ #
# engine: the WeightsHandle contract
# ------------------------------------------------------------------ #


def _tiny():
    cfg = get_arch("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def test_engine_weights_handle_is_the_only_mutation_path():
    _cfg, model, params = _tiny()
    eng = ServingEngine(model, params, batch=2, max_len=16)
    assert isinstance(eng.weights, WeightsHandle)
    assert eng.weights.epoch == 0 and eng.weights.entry_id is None
    assert eng.params is eng.weights.params
    with pytest.raises(AttributeError):
        eng.params = params                       # bare attribute is gone
    with pytest.raises(TypeError, match="WeightsHandle"):
        eng.set_weights(params)
    h1 = eng.set_weights(WeightsHandle(params=params, entry_id=42))
    assert h1.epoch == 1 and eng.weights.entry_id == 42
    # epochs are stamped monotonically even when the caller passes 0
    h2 = eng.set_weights(WeightsHandle(params=params))
    assert h2.epoch == 2
    swaps = []
    eng.swap_hook = lambda old, new: swaps.append((old.epoch, new.epoch))
    eng.set_weights(WeightsHandle(params=params))
    assert swaps == [(2, 3)]


def test_prefill_empty_prompt_raises_clearly():
    _cfg, model, params = _tiny()
    eng = ServingEngine(model, params, batch=2, max_len=16)
    with pytest.raises(ValueError, match="prompt_len=0"):
        eng.prefill(torch.zeros((2, 0), dtype=torch.int32))


def test_generate_finishes_inflight_batch_on_old_weights():
    cfg, model, params = _tiny()
    params_b = tree_map(lambda x: x + 0.05, params)
    prompts = randint(1, (2, 4), cfg.vocab_size)

    eng = ServingEngine(model, params, batch=2, max_len=32)
    eng.prefill(prompts)
    st0 = eng.get_state()

    # ground truth: the full batch on OLD weights, then new weights after
    ref_old = ServingEngine(model, params, batch=2, max_len=32)
    ref_old.set_state(st0)
    want_old = ref_old.generate(4)
    ref_new = ServingEngine(model, params_b, batch=2, max_len=32)
    ref_new.set_state(ref_old.get_state())
    want_new = ref_new.generate(3)

    # swap fires mid-batch: the in-flight batch must finish on the
    # handle it captured; the NEXT batch serves the new weights
    orig_step, calls = eng._step, []

    def step(p, tok, caches, pos):
        calls.append(1)
        if len(calls) == 2:
            eng.set_weights(WeightsHandle(params=params_b, entry_id=9))
        return orig_step(p, tok, caches, pos)

    eng._step = step
    got_old = eng.generate(4)
    np.testing.assert_array_equal(np.asarray(got_old), np.asarray(want_old))
    assert eng.weights.entry_id == 9
    got_new = eng.generate(3)
    np.testing.assert_array_equal(np.asarray(got_new), np.asarray(want_new))


# ------------------------------------------------------------------ #
# fleet deployer: rolling swap + failure matrix
# ------------------------------------------------------------------ #


def _engine(tmp_path, tag="pub", **cfg_kw):
    cfg_kw.setdefault("objstore_chunk_bytes", 4096)
    cfg_kw.setdefault("objstore_cdc_min_bytes", 1024)
    cfg_kw.setdefault("objstore_cdc_avg_bytes", 4096)
    cfg_kw.setdefault("objstore_cdc_max_bytes", 16384)
    cfg = StorageConfig(root=str(tmp_path / "shared"), block_bytes=256,
                        **cfg_kw)
    return StorageEngine(cfg, LocalComm(str(tmp_path / f"nl-{tag}")))


class _FaultStore:
    """Store wrapper with two injectable faults: a count-down kill on
    chunk gets (a replica dying mid-pull) and a global outage flag."""

    def __init__(self, inner):
        self._inner = inner
        self.die_after = None
        self.outage = False

    def _check(self, key):
        if self.outage:
            raise ObjectStoreError("objstore outage (injected)")
        if self.die_after is not None and key.startswith("chunks/"):
            if self.die_after == 0:
                raise ObjectStoreError("replica killed mid-pull (injected)")
            self.die_after -= 1

    def get(self, key):
        self._check(key)
        return self._inner.get(key)

    def get_with_etag(self, key):
        self._check(key)
        return self._inner.get_with_etag(key)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _Fleet:
    """Three real ServingEngines (shared tiny model) + a deployer wired
    to a publishing StorageEngine's bucket, on an injectable clock."""

    def __init__(self, tmp_path, n=3):
        self.cfg, self.model, self.params = _tiny()
        self.pub = _engine(tmp_path)
        self.store = _FaultStore(make_object_store(
            "file:" + os.path.join(str(tmp_path / "shared"), "objstore")))
        self.t = 0.0
        self.replicas = [
            Replica(name=f"r{i}",
                    engine=ServingEngine(self.model, self.params,
                                         batch=2, max_len=32),
                    cache_root=str(tmp_path / f"cache-{i}"),
                    prefix="params")
            for i in range(n)]
        self.dep = FleetDeployer(self.store, self.replicas,
                                 backoff_s=1.0, time_fn=lambda: self.t)

    def publish(self, ckpt_id, params):
        named = flatten_named({"params": params})
        state = {name: tensor_to_numpy(v) for name, v in named.items()}
        state["step"] = np.int32(ckpt_id)
        self.pub.store(state, ckpt_id=ckpt_id, level=4)

    def actions(self, n):
        out = []
        for _ in range(n):
            out.append(self.dep.poll()["action"])
        return out

    def entry_ids(self):
        return sorted(set(self.dep.fleet_epochs().values()),
                      key=lambda x: (x is None, x))


def _leaf0(tree):
    return tensor_to_numpy(next(iter(flatten_named(tree).values())))


def test_rolling_swap_one_replica_per_poll_and_delta_ratio(tmp_path):
    f = _Fleet(tmp_path)
    f.publish(1, f.params)
    st = f.dep.poll()
    assert st["action"] == "started" and st["entry"] == 1
    # cold fleet: the first delta is (essentially) the whole entry — only
    # digest-identical chunks within the entry itself can dedup
    assert st["delta"].ratio > 0.9
    # exactly one replica swaps per poll; mid-rollout the fleet serves at
    # most two distinct epochs (old None, new 1) — never a third
    assert f.dep.poll()["action"] == "swapped"
    assert f.entry_ids() == [1, None]
    assert f.actions(2) == ["swapped", "swapped"]
    assert f.dep.poll()["action"] == "converged"
    assert f.dep.fleet_epochs() == {"r0": 1, "r1": 1, "r2": 1}
    assert f.dep.poll()["action"] == "idle"

    # fine-tune publish: nudge ONE leaf, everything else chunk-dedups
    named = flatten_named(f.params)
    name0 = sorted(named)[0]
    tuned_named = dict(named)
    tuned_named[name0] = named[name0] + 0.01
    tuned = unflatten_named(tuned_named, f.params)
    f.publish(2, tuned)

    st = f.dep.poll()
    assert st["action"] == "started" and st["entry"] == 2
    # the catalog-level chunk diff already promises a small pull
    assert st["delta"].ratio < 0.30, st["delta"]
    pre = dict(f.dep.stats)
    assert f.actions(3) == ["swapped"] * 3
    assert f.dep.poll()["action"] == "converged"
    pulled = f.dep.stats["bytes_fetched"] - pre["bytes_fetched"]
    total = f.dep.stats["bytes_cached"] - pre["bytes_cached"] + pulled
    assert pulled < 0.30 * total, (pulled, total)
    # the swap actually installed the tuned weights, bit-exact
    for r in f.replicas:
        got = flatten_named(r.engine.params)
        assert torch.equal(got[name0], tuned_named[name0])
        assert r.engine.weights.entry_id == 2


def test_replica_killed_mid_pull_fleet_keeps_old_epoch_then_converges(
        tmp_path):
    f = _Fleet(tmp_path)
    f.publish(1, f.params)
    assert f.actions(5) == ["started", "swapped", "swapped", "swapped",
                            "converged"]
    old_leaf = _leaf0(f.replicas[1].engine.params).copy()

    f.publish(2, tree_map(lambda x: x + 0.5, f.params))
    assert f.dep.poll()["action"] == "started"
    assert f.dep.poll()["action"] == "swapped"    # r0 (canary) fine
    f.store.die_after = 2                         # r1 dies 2 chunks in
    st = f.dep.poll()
    assert st["action"] == "pinned" and st["replica"] == "r1"
    assert "killed mid-pull" in st["error"]
    # invariant: r1 still serves entry 1, bit-identical — no torn tree
    assert f.dep.fleet_epochs() == {"r0": 2, "r1": 1, "r2": 1}
    np.testing.assert_array_equal(
        _leaf0(f.replicas[1].engine.params), old_leaf)
    # rollout holds at r1 (canary discipline): r2 is NOT advanced past it
    f.t += 0.5
    assert f.dep.poll()["action"] == "waiting"    # backoff not elapsed
    # fault clears (the "revived" replica re-pulls; its cache survived)
    f.store.die_after = None
    f.t += 1.0
    st = f.dep.poll()
    assert st["action"] == "swapped" and st["replica"] == "r1"
    assert f.actions(2) == ["swapped", "converged"]
    assert f.dep.fleet_epochs() == {"r0": 2, "r1": 2, "r2": 2}


def test_corrupt_cached_chunk_is_refetched_during_swap(tmp_path):
    f = _Fleet(tmp_path, n=1)
    f.publish(1, f.params)
    assert f.actions(3) == ["started", "swapped", "converged"]
    # corrupt every cached chunk in place (same sizes, wrong bytes) —
    # any chunk the fine-tune swap tries to reuse must be caught
    cache_dir = os.path.join(str(tmp_path / "cache-0"), "chunks")
    for victim in os.listdir(cache_dir):
        p = os.path.join(cache_dir, victim)
        size = os.path.getsize(p)
        with open(p, "wb") as fh:
            fh.write(b"\xa5" * size)
    # fine-tune: one leaf changes, the rest would be served from cache
    named = flatten_named(f.params)
    name0 = sorted(named)[0]
    tuned_named = dict(named)
    tuned_named[name0] = named[name0] + 0.25
    f.publish(2, unflatten_named(tuned_named, f.params))
    assert f.dep.poll()["action"] == "started"
    st = f.dep.poll()
    # digest verify forced a refetch; the swap still completed cleanly
    assert st["action"] == "swapped" and st["chunks_corrupt"] >= 1
    assert f.dep.poll()["action"] == "converged"
    assert f.replicas[0].engine.weights.entry_id == 2


def test_objstore_outage_pins_epoch_with_backoff_no_torn_params(tmp_path):
    f = _Fleet(tmp_path, n=2)
    f.publish(1, f.params)
    assert f.actions(4) == ["started", "swapped", "swapped", "converged"]
    old = [_leaf0(r.engine.params).copy() for r in f.replicas]

    # outage while watching: the fleet keeps serving, watch backs off
    f.store.outage = True
    st = f.dep.poll()
    assert st["action"] == "watching" and "outage" in st["error"]
    assert f.dep.poll()["action"] == "watching"   # still in backoff
    f.store.outage = False
    f.t += 1.5
    assert f.dep.poll()["action"] == "idle"

    # outage mid-rollout: the pulling replica pins, backoff grows
    f.publish(2, tree_map(lambda x: x - 0.125, f.params))
    assert f.dep.poll()["action"] == "started"
    f.store.outage = True
    t_fail1 = f.t
    st = f.dep.poll()
    assert st["action"] == "pinned" and st["replica"] == "r0"
    interval1 = st["retry_at"] - t_fail1
    f.t = st["retry_at"]
    st = f.dep.poll()
    assert st["action"] == "pinned"
    assert st["retry_at"] - f.t > interval1       # exponential backoff
    # nothing moved: both replicas bit-exact on entry 1
    assert f.dep.fleet_epochs() == {"r0": 1, "r1": 1}
    for r, leaf in zip(f.replicas, old):
        np.testing.assert_array_equal(_leaf0(r.engine.params), leaf)
    # outage clears → rollout resumes from r0 and converges
    f.store.outage = False
    f.t = st["retry_at"] + 0.1
    assert f.actions(3) == ["swapped", "swapped", "converged"]
    assert f.dep.fleet_epochs() == {"r0": 2, "r1": 2}


def test_generate_is_consistent_through_a_fleet_swap(tmp_path):
    """The serving-path acceptance check: a replica that swaps between
    batches produces exactly what an engine born with the new weights
    would produce from the same state — and a replica that has NOT yet
    swapped still matches the old weights."""
    f = _Fleet(tmp_path, n=1)
    cfg = f.cfg
    prompts = randint(3, (2, 4), cfg.vocab_size)
    r = f.replicas[0]
    r.engine.prefill(prompts)
    f.publish(1, f.params)
    assert f.actions(3) == ["started", "swapped", "converged"]
    tuned = tree_map(lambda x: x + 0.02, f.params)
    f.publish(2, tuned)
    st_before = r.engine.get_state()
    assert f.actions(2) == ["started", "swapped"]
    got = r.engine.generate(4)
    ref = ServingEngine(f.model, tuned, batch=2, max_len=32)
    ref.set_state(st_before)
    want = ref.generate(4)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

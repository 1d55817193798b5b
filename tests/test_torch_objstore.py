"""The port's object store (``repro_torch.objstore``), mirroring
tests/test_objstore.py: the client contract (CAS, multipart/resumable
put), content-addressed chunk dedup, the CAS-epoch-guarded catalog,
crash-safe retention GC, and the L4 rung in the port's pipeline — a kill
mid-chunk-upload leaves the previous catalog entry authoritative, and a
run whose L1–L3 (and global) directories are wiped restores bit-exact
from the object store alone.  The directive-level and cross-package
checks are in tests/test_torch_objstore_l4.py.
"""
import glob
import json
import os
import shutil

import numpy as np
import pytest

from repro_torch.core import manifest as mf
from repro_torch.core.comm import LocalComm
from repro_torch.core.storage import StorageConfig, StorageEngine
from repro_torch.objstore import gc as objgc
from repro_torch.objstore.catalog import Catalog, CatalogConflictError
from repro_torch.objstore.chunks import (
    ChunkUploader,
    FileEntry,
    chunk_key,
    fetch_file,
)
from repro_torch.objstore.client import (
    LocalFSObjectStore,
    MemoryObjectStore,
    ObjectStoreError,
    PreconditionFailed,
    make_object_store,
)

# ------------------------------------------------------------------ #
# client contract (both backends)
# ------------------------------------------------------------------ #


def _stores(tmp_path):
    return [MemoryObjectStore(), LocalFSObjectStore(str(tmp_path / "bucket"))]


def test_put_get_list_delete_and_etags(tmp_path):
    for st in _stores(tmp_path):
        etag = st.put("a/b/one", b"payload-1")
        assert st.get("a/b/one") == b"payload-1"
        assert st.get_with_etag("a/b/one") == (b"payload-1", etag)
        st.put("a/two", b"payload-2")
        st.put("z", b"payload-3")
        assert st.list("a/") == ["a/b/one", "a/two"]
        assert st.list() == ["a/b/one", "a/two", "z"]
        st.delete("a/two")
        st.delete("a/two")
        assert not st.exists("a/two")
        assert st.get_with_etag("a/two") == (None, None)
        with pytest.raises(ObjectStoreError):
            st.get("a/two")
        with pytest.raises(ObjectStoreError):
            st.put("../escape", b"x")


def test_conditional_puts_are_cas(tmp_path):
    for st in _stores(tmp_path):
        etag = st.put("k", b"v1")
        with pytest.raises(PreconditionFailed):
            st.put("k", b"v2", if_none_match=True)
        st.put("fresh", b"v", if_none_match=True)
        with pytest.raises(PreconditionFailed):
            st.put("k", b"v2", if_match="not-the-etag")
        etag2 = st.put("k", b"v2", if_match=etag)
        assert st.get("k") == b"v2"
        with pytest.raises(PreconditionFailed):
            st.put("k", b"v3", if_match=etag)
        st.put("k", b"v3", if_match=etag2)
        with pytest.raises(PreconditionFailed):
            st.put("absent", b"v", if_match=etag)


def test_multipart_upload_is_resumable_and_atomic(tmp_path):
    for st in _stores(tmp_path):
        uid = st.create_multipart("big/object")
        st.upload_part("big/object", uid, 1, b"AAA-")
        st.upload_part("big/object", uid, 3, b"-CCC")
        assert not st.exists("big/object")
        assert st.list_parts("big/object", uid) == [1, 3]
        st.upload_part("big/object", uid, 2, b"BBB")
        assert st.complete_multipart("big/object", uid)
        assert st.get("big/object") == b"AAA-BBB-CCC"
        assert st.list_parts("big/object", uid) == []
        uid2 = st.create_multipart("big/object")
        st.upload_part("big/object", uid2, 1, b"other")
        st.abort_multipart("big/object", uid2)
        assert st.get("big/object") == b"AAA-BBB-CCC"


def test_make_object_store_gates_cloud_clients(tmp_path):
    assert isinstance(make_object_store(f"file:{tmp_path}/b"),
                      LocalFSObjectStore)
    assert isinstance(make_object_store("mem:test"), MemoryObjectStore)
    with pytest.raises(ObjectStoreError, match="boto3"):
        make_object_store("s3://bucket/prefix")
    with pytest.raises(ObjectStoreError, match="unrecognized"):
        make_object_store("ftp://nope")


def test_localfs_internal_state_hidden_from_list(tmp_path):
    st = LocalFSObjectStore(str(tmp_path / "b"))
    uid = st.create_multipart("k")
    st.upload_part("k", uid, 1, b"part")
    assert st.list() == []
    st.put("cas", b"v", if_none_match=True)
    assert st.exists("cas") and st.list() == ["cas"]


# ------------------------------------------------------------------ #
# chunk layer: dedup + verified reassembly
# ------------------------------------------------------------------ #


def test_chunk_dedup_across_files(tmp_path):
    st = MemoryObjectStore()
    up = ChunkUploader(st, chunk_bytes=1024, transfers=2)
    shared = np.random.default_rng(0).integers(0, 256, 4096,
                                               dtype=np.uint8).tobytes()
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_bytes(shared + b"tail-a")
    b.write_bytes(shared + b"tail-b-different")
    ea = up.upload_file(str(a))
    assert up.stats["chunks_uploaded"] == 5 and up.stats["chunks_deduped"] == 0
    eb = up.upload_file(str(b))
    assert up.stats["chunks_deduped"] == 4
    assert up.stats["chunks_uploaded"] == 6
    assert [h for h, _o, _n in ea.chunks[:4]] == \
        [h for h, _o, _n in eb.chunks[:4]]
    fetch_file(st, ea, str(tmp_path / "a.back"))
    assert (tmp_path / "a.back").read_bytes() == shared + b"tail-a"
    st._objects[chunk_key(eb.chunks[-1][0])] = b"corrupted!"
    with pytest.raises(ObjectStoreError, match="corrupt"):
        fetch_file(st, eb, str(tmp_path / "b.back"))
    assert not (tmp_path / "b.back").exists()


# ------------------------------------------------------------------ #
# catalog: CAS epoch guard + multi-writer merge
# ------------------------------------------------------------------ #


def _entry_files(tag: str):
    return {f"rank{tag}.chk5": FileEntry(f"rank{tag}.chk5", 8,
                                         [(f"h-{tag}", 8)])}


def test_catalog_publish_merges_ranks_and_bumps_epoch(tmp_path):
    for st in _stores(tmp_path):
        cat = Catalog(st)
        assert cat.ids() == [] and cat.epoch() == 0
        cat.publish(1, {"kind": "FULL", "level": 4}, _entry_files("0"))
        cat.publish(1, {"kind": "FULL", "level": 4}, _entry_files("1"))
        assert cat.epoch() == 2
        e = cat.entry(1)
        assert sorted(e["files"]) == ["rank0.chk5", "rank1.chk5"]
        assert sorted(cat.entry_chunks(e)) == ["h-0", "h-1"]
        cat.publish(2, {"kind": "FULL", "level": 4}, _entry_files("0"))
        assert cat.ids() == [1, 2]
        assert cat.live_chunks() == {"h-0", "h-1"}


class _RacingStore(MemoryObjectStore):
    """A competing catalog write lands between a reader's read and its CAS
    put: every conditional put loses its first ``races`` races."""

    def __init__(self, races: int):
        super().__init__()
        self._races = races

    def put(self, key, data, *, if_match=None, if_none_match=False):
        if (if_match or if_none_match) and self._races > 0:
            self._races -= 1
            doc = json.loads(super().get_with_etag(key)[0] or
                             b'{"version":1,"epoch":0,"entries":{}}')
            doc["epoch"] += 1
            doc["entries"].setdefault("999", {"id": 999, "files": {},
                                              "pinned": False,
                                              "manifest": {}})
            super().put(key, json.dumps(doc).encode())
        return super().put(key, data, if_match=if_match,
                           if_none_match=if_none_match)


def test_catalog_cas_retries_lost_races_without_dropping_entries():
    st = _RacingStore(races=2)
    cat = Catalog(st)
    cat.publish(1, {"kind": "FULL"}, _entry_files("0"))
    assert cat.ids() == [1, 999] and cat.epoch() >= 2
    with pytest.raises(CatalogConflictError):
        Catalog(_RacingStore(races=10**6)).publish(1, {}, _entry_files("0"))


# ------------------------------------------------------------------ #
# retention + GC crash windows
# ------------------------------------------------------------------ #


def test_retention_split_policies():
    ids = [1, 2, 3, 4, 5, 6]
    assert objgc.retention_split(ids, None, None) == (ids, [])
    assert objgc.retention_split(ids, 2, None) == ([5, 6], [1, 2, 3, 4])
    assert objgc.retention_split(ids, 1, 3) == ([3, 6], [1, 2, 4, 5])
    assert objgc.retention_split(ids, 2, None, pinned={1}) == (
        [1, 5, 6], [2, 3, 4])


def _catalog_with_entries(st, n=4, shared_chunk=True):
    cat = Catalog(st)
    for i in range(1, n + 1):
        chunks = [(f"priv-{i}", 8)] + ([("shared", 8)] if shared_chunk else [])
        st.put(chunk_key(f"priv-{i}"), b"x" * 8)
        cat.publish(i, {"kind": "FULL", "level": 4},
                    {"rank0.chk5": FileEntry("rank0.chk5", 8 * len(chunks),
                                             chunks)})
    if shared_chunk:
        st.put(chunk_key("shared"), b"s" * 8)
    return cat


def test_gc_keep_last_leaves_exactly_the_live_chunk_set():
    st = MemoryObjectStore()
    cat = _catalog_with_entries(st, n=4)
    st.put(chunk_key("orphan"), b"never referenced")
    got = objgc.collect(st, cat, keep_last=2)
    assert got["retired"] == 2 and cat.ids() == [3, 4]
    live = {chunk_key(h) for h in cat.live_chunks()}
    assert set(st.list("chunks/")) == live == {
        chunk_key("priv-3"), chunk_key("priv-4"), chunk_key("shared")}
    assert not st.exists(objgc.GC_MARK_KEY)
    assert objgc.collect(st, cat, keep_last=2)["deleted"] == 0


def test_gc_keep_every_and_pinned_survive():
    st = MemoryObjectStore()
    cat = _catalog_with_entries(st, n=6, shared_chunk=False)
    cat.pin(1)
    objgc.collect(st, cat, keep_last=1, keep_every=3)
    assert cat.ids() == [1, 3, 6]
    assert set(st.list("chunks/")) == {
        chunk_key("priv-1"), chunk_key("priv-3"), chunk_key("priv-6")}


class _DyingDeleteStore(MemoryObjectStore):
    def __init__(self, die_after: int):
        super().__init__()
        self._left = die_after

    def delete(self, key):
        if key.startswith("chunks/"):
            if self._left == 0:
                raise RuntimeError("simulated kill mid-GC sweep")
            self._left -= 1
        super().delete(key)


def test_kill_mid_gc_never_deletes_a_live_chunk_and_resumes():
    st = _DyingDeleteStore(die_after=1)
    cat = _catalog_with_entries(st, n=4)
    with pytest.raises(RuntimeError, match="mid-GC"):
        objgc.collect(st, cat, keep_last=2)
    assert cat.ids() == [3, 4] and st.exists(objgc.GC_MARK_KEY)
    for h in cat.live_chunks():
        assert st.exists(chunk_key(h)), f"live chunk {h} deleted mid-GC"
    st._left = 10**9
    objgc.collect(st, cat, keep_last=2)
    assert not st.exists(objgc.GC_MARK_KEY)
    assert set(st.list("chunks/")) == {chunk_key(h)
                                       for h in cat.live_chunks()}


def test_retired_sweep_spares_unpublished_peer_chunks():
    st = MemoryObjectStore()
    cat = _catalog_with_entries(st, n=3)
    st.put(chunk_key("peer-inflight"), b"uploaded, publish pending")
    got = objgc.collect(st, cat, keep_last=2, sweep="retired")
    assert cat.ids() == [2, 3] and got["retired"] == 1
    assert not st.exists(chunk_key("priv-1"))
    assert st.exists(chunk_key("shared"))
    assert st.exists(chunk_key("peer-inflight"))
    objgc.collect(st, cat, sweep="bucket")
    assert not st.exists(chunk_key("peer-inflight"))
    with pytest.raises(ValueError, match="sweep"):
        objgc.collect(st, cat, sweep="everything")


def test_stale_mark_spares_rereferenced_chunks():
    st = MemoryObjectStore()
    cat = _catalog_with_entries(st, n=2, shared_chunk=False)
    st.put(objgc.GC_MARK_KEY, json.dumps(
        {"condemned": [chunk_key("priv-2"), chunk_key("gone")]}).encode())
    st.put(chunk_key("gone"), b"zzz")
    objgc.collect(st, cat)
    assert st.exists(chunk_key("priv-2"))
    assert not st.exists(chunk_key("gone"))
    assert not st.exists(objgc.GC_MARK_KEY)


# ------------------------------------------------------------------ #
# pipeline integration: the L4 objstore rung
# ------------------------------------------------------------------ #


def _engine(tmp_path, tag="e", **cfg_kw):
    cfg = StorageConfig(root=str(tmp_path / "shared"), block_bytes=256,
                        **cfg_kw)
    return StorageEngine(cfg, LocalComm(str(tmp_path / f"nl-{tag}")))


def _state(val=1.0, n=4096):
    return {"w": np.full(n, val, np.float32), "step": np.int32(int(val))}


def _wipe_dirs(tmp_path, *engines):
    """Wipe L1–L3 node-local storage AND the L4 global directory — only
    the object-store bucket survives."""
    for e in engines:
        shutil.rmtree(e.comm.node_local_dir, ignore_errors=True)
    groot = os.path.join(str(tmp_path / "shared"), "global")
    for d in glob.glob(os.path.join(groot, "ckpt-*")):
        shutil.rmtree(d)
    latest = os.path.join(groot, "latest")
    if os.path.exists(latest):
        os.remove(latest)


def test_l4_store_publishes_catalog_and_dedups_second_store(tmp_path):
    eng = _engine(tmp_path, objstore_chunk_bytes=1024,
                  objstore_cdc_min_bytes=256, objstore_cdc_avg_bytes=1024,
                  objstore_cdc_max_bytes=4096)
    tier = eng.objstore_tier()
    rng = np.random.default_rng(0)
    st1 = {"w": rng.normal(size=4096).astype(np.float32), "step": np.int32(1)}
    eng.store(st1, ckpt_id=1, level=4)
    assert tier.catalog.ids() == [1]
    up1 = tier.uploader.stats["bytes_uploaded"]
    assert up1 > 0
    st2 = {"w": st1["w"].copy(), "step": np.int32(1)}
    st2["w"][:8] = -5.0
    eng.store(st2, ckpt_id=2, level=4)
    up2 = tier.uploader.stats["bytes_uploaded"] - up1
    assert tier.catalog.ids() == [1, 2]
    assert up2 < 0.30 * up1, (up1, up2)


def test_restore_from_objstore_alone_after_full_wipe(tmp_path):
    eng = _engine(tmp_path)
    eng.store(_state(3.0), ckpt_id=3, level=4)
    _wipe_dirs(tmp_path, eng)
    eng2 = _engine(tmp_path, tag="fresh")
    named, meta = eng2.load_latest()
    assert meta["recovered_via"] == "objstore" and meta["id"] == 3
    np.testing.assert_array_equal(named["w"], _state(3.0)["w"])
    named2, _ = eng2.load_latest()
    np.testing.assert_array_equal(named2["w"], named["w"])


def test_corrupt_or_stale_cache_is_refetched_not_reused(tmp_path):
    eng = _engine(tmp_path)
    eng.store(_state(4.0), ckpt_id=4, level=4)
    _wipe_dirs(tmp_path, eng)
    eng2 = _engine(tmp_path, tag="fresh")
    tier = eng2.objstore_tier()
    named, _ = eng2.load_latest()
    np.testing.assert_array_equal(named["w"], _state(4.0)["w"])
    cached = os.path.join(mf.ckpt_dir(tier.root, 4), "rank0.chk5")
    size = os.path.getsize(cached)
    with open(cached, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff" * 16)
    named3, meta3 = eng2.load_latest()
    assert meta3["id"] == 4
    np.testing.assert_array_equal(named3["w"], _state(4.0)["w"])


class _DyingPutStore:
    """Wraps a tier's store: put raises after N chunk puts — the
    in-process stand-in for a kill mid-chunk-upload."""

    def __init__(self, inner, die_after: int):
        self._inner = inner
        self._left = die_after

    def put(self, key, data, **kw):
        if key.startswith("chunks/"):
            if self._left == 0:
                raise RuntimeError("simulated kill mid-chunk-upload")
            self._left -= 1
        return self._inner.put(key, data, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_kill_mid_chunk_upload_previous_entry_stays_authoritative(tmp_path):
    eng = _engine(tmp_path)
    eng.store(_state(1.0), ckpt_id=1, level=4)
    tier = eng.objstore_tier()
    real = tier.store
    tier.store = tier.uploader.store = _DyingPutStore(real, die_after=0)
    with pytest.raises(RuntimeError, match="mid-chunk-upload"):
        eng.store(_state(2.0), ckpt_id=2, level=4)
    tier.store = tier.uploader.store = real
    assert tier.catalog.ids() == [1]
    _wipe_dirs(tmp_path, eng)
    eng2 = _engine(tmp_path, tag="fresh")
    named, meta = eng2.load_latest()
    assert meta["id"] == 1 and meta["recovered_via"] == "objstore"
    np.testing.assert_array_equal(named["w"], _state(1.0)["w"])
    tier2 = eng2.objstore_tier()
    objgc.collect(tier2.store, tier2.catalog, keep_last=4)
    assert set(tier2.store.list("chunks/")) == {
        chunk_key(h) for h in tier2.catalog.live_chunks()}


def test_pipeline_gc_keep_last_via_config(tmp_path):
    eng = _engine(tmp_path, objstore_keep_last=2)
    tier = eng.objstore_tier()
    for i in (1, 2, 3):
        eng.store(_state(float(i)), ckpt_id=i, level=4)
    assert tier.catalog.ids() == [2, 3]
    assert set(tier.store.list("chunks/")) == {
        chunk_key(h) for h in tier.catalog.live_chunks()}
    assert tier.stats["gc_deleted"] > 0


def test_store_streams_chunks_and_reuses_layout_for_clean_leaves(tmp_path):
    eng = _engine(tmp_path)
    tier = eng.objstore_tier()
    eng.store(_state(1.0), ckpt_id=1, level=4)
    s1 = dict(tier.uploader.stats)
    assert s1["chunks_uploaded"] > 0
    eng.store(_state(1.0), ckpt_id=2, level=4)
    s2 = tier.uploader.stats
    assert s2["regions_reused"] > s1["regions_reused"]
    assert s2["bytes_scan_skipped"] > s1["bytes_scan_skipped"]
    assert tier.catalog.ids() == [1, 2]


def test_boundary_shift_reuploads_only_the_neighborhood(tmp_path):
    eng = _engine(tmp_path, objstore_chunk_bytes=4096,
                  objstore_cdc_min_bytes=1024, objstore_cdc_avg_bytes=4096,
                  objstore_cdc_max_bytes=16384)
    tier = eng.objstore_tier()
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, 2 << 20, dtype=np.uint8)
    at = len(base) // 2
    eng.store({"blob": base}, ckpt_id=1, level=4)
    up1 = tier.uploader.stats["bytes_uploaded"]
    shifted = np.concatenate(
        [base[:at], rng.integers(0, 256, 1024, dtype=np.uint8), base[at:]])
    eng.store({"blob": shifted}, ckpt_id=2, level=4)
    delta = tier.uploader.stats["bytes_uploaded"] - up1
    assert delta < 0.30 * (len(base) - at), delta
    _wipe_dirs(tmp_path, eng)
    named, meta = _engine(tmp_path, tag="fresh").load_latest()
    assert meta["id"] == 2
    np.testing.assert_array_equal(named["blob"], shifted)


def test_objstore_chunking_config_plumbs_through(tmp_path):
    eng = _engine(tmp_path, objstore_cdc_min_bytes=512,
                  objstore_cdc_avg_bytes=2048, objstore_cdc_max_bytes=8192)
    tier = eng.objstore_tier()
    assert (tier.uploader.cdc.min_bytes, tier.uploader.cdc.avg_bytes,
            tier.uploader.cdc.max_bytes) == (512, 2048, 8192)
    eng.store(_state(1.0), ckpt_id=1, level=4)
    assert all(f["mode"] == "cdc"
               for f in tier.catalog.entry(1)["files"].values())
    engf = _engine(tmp_path / "fixed", tag="f", objstore_chunking="fixed")
    tierf = engf.objstore_tier()
    assert tierf.uploader.cdc is None
    engf.store(_state(2.0), ckpt_id=1, level=4)
    assert all(f["mode"] == "fixed"
               for f in tierf.catalog.entry(1)["files"].values())
    named, _ = engf.load_latest()
    np.testing.assert_array_equal(named["w"], _state(2.0)["w"])

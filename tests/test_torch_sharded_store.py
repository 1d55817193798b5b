"""Shard-local stores on the port, the in-process tests of the JAX
package's tests/test_sharded_store.py: the multi-file ``.tmp``-until-commit
invariant (crash after k of n shard files staged → checkpoint not
restorable, recovery falls back), manifest coverage of shard sets, the
partner replica of a shard set, the sharded CHK5 layout + ElasticLoader
region reads and the int8 chunk codec.  Cross-reads with the JAX package
are in tests/test_torch_shard_crossread.py."""

import os

import numpy as np
import pytest

import repro_torch.core.resharding as rs
from repro_torch.core import manifest as mf
from repro_torch.core.comm import LocalComm
from repro_torch.core.formats import CHK5Writer
from repro_torch.core.resharding import (
    ElasticLoader,
    ShardChunk,
    ShardSnapshot,
    write_shard_files,
)
from repro_torch.core.storage import StorageConfig, StorageEngine, StoreRequest


def _engine(tmp_path):
    cfg = StorageConfig(root=str(tmp_path / "shared"), block_bytes=256)
    return StorageEngine(cfg, LocalComm(str(tmp_path / "nl")))


def _sharded_plan(eng, ckpt_id, n_chunks=4, rows=16, cols=8):
    """A Plan carrying a hand-built shard snapshot (host chunks — the
    snapshot machinery accepts np data, so the multi-file commit protocol
    is testable without a multi-device mesh)."""
    plan = eng.pipeline.plan(StoreRequest(
        named={"step": np.int32(ckpt_id)}, ckpt_id=ckpt_id, level=1))
    full = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
    per = rows // n_chunks
    chunks = [ShardChunk(offset=(k * per, 0), shape=(per, cols),
                         data=full[k * per:(k + 1) * per])
              for k in range(n_chunks)]
    plan.sharded = {"w": ShardSnapshot(
        dtype="<f4", global_shape=(rows, cols), chunks=chunks)}
    return plan, full


def test_crash_mid_shard_write_stays_tmp_and_falls_back(tmp_path,
                                                        monkeypatch):
    """Kill the store after k of n shard files are written: the whole set
    stays in ``.tmp``, the checkpoint is not listed as restorable, and
    recovery falls back to the previous id."""
    eng = _engine(tmp_path)
    eng.store({"w": np.ones(64, np.float32)}, ckpt_id=1, level=1)

    real_writer = rs.CHK5Writer
    made = []

    class ExplodingWriter(real_writer):
        def __init__(self, path, **kw):
            if ".shard" in os.path.basename(path):
                made.append(path)
                if len(made) > 2:       # k=2 of n staged, then crash
                    raise RuntimeError("simulated crash mid-shard-write")
            super().__init__(path, **kw)

    monkeypatch.setattr(rs, "CHK5Writer", ExplodingWriter)
    plan, _ = _sharded_plan(eng, 2, n_chunks=8)
    with pytest.raises(RuntimeError, match="mid-shard-write"):
        eng.pipeline.finish(plan)
    monkeypatch.setattr(rs, "CHK5Writer", real_writer)

    root = eng.pipeline.tier_root(1)
    assert os.path.isdir(mf.ckpt_dir(root, 2, tmp=True))   # staged, not
    assert not os.path.isdir(mf.ckpt_dir(root, 2))         # committed
    assert mf.list_committed(root) == [1]
    named, meta = eng.load_latest()
    assert meta["id"] == 1 and named["w"][0] == 1.0


def test_committed_shard_set_with_lost_file_not_restorable(tmp_path):
    """Post-commit loss of one shard file: the manifest detects the
    incomplete set and the restore walk falls back to the previous id
    instead of assembling a partial leaf."""
    eng = _engine(tmp_path)
    eng.store({"w": np.ones(64, np.float32), "step": np.int32(1)},
              ckpt_id=1, level=1)
    plan, full = _sharded_plan(eng, 2)
    eng.pipeline.finish(plan)

    root = eng.pipeline.tier_root(1)
    man = mf.read_manifest(root, 2)
    files = mf.manifest_files(man)
    shard_files = [f for f in files if ".shard" in f]
    assert "rank0.chk5" in files and len(shard_files) == 4
    assert mf.missing_files(root, 2) == []

    # intact: the sharded leaf restores (materialized) bit-exact
    named, meta = eng.load_latest()
    assert meta["id"] == 2
    np.testing.assert_array_equal(named["w"], full)

    os.remove(os.path.join(mf.ckpt_dir(root, 2), shard_files[1]))
    assert mf.missing_files(root, 2) == [shard_files[1]]
    named, meta = eng.load_latest()       # falls back — never partial data
    assert meta["id"] == 1
    assert int(named["step"]) == 1


def test_partner_tier_replicates_shard_set_across_node_loss(tmp_path):
    """L2: the whole multi-file shard set is replicated to the ring
    partner, so a lost node's sharded checkpoint restores from partner
    copies (rank<k>.partner<j>.shard<s>.chk5)."""
    from repro_torch.core.comm import SimulatedCluster
    cluster = SimulatedCluster(str(tmp_path / "cluster"), 4)
    cfg = StorageConfig(root=str(tmp_path / "shared"), group_size=4,
                        block_bytes=256)
    engines = [StorageEngine(cfg, c) for c in cluster.comms]
    fulls = {}
    for r, eng in enumerate(engines):
        plan, full = _sharded_plan(eng, 1)
        plan.level = 2
        plan.tiers = eng.pipeline.tier_stack(2)
        plan.root = plan.tiers[0].root
        eng.pipeline.finish(plan)
        fulls[r] = full

    victim = 1
    cluster.kill_node(victim)
    got = engines[victim].load_latest()
    assert got is not None, "L2 sharded recovery failed after node loss"
    named, meta = got
    assert meta["recovered_via"] == "partner"
    np.testing.assert_array_equal(named["w"], fulls[victim])


def test_shard_layout_roundtrip_and_elastic_regions(tmp_path):
    """write_shard_files → ElasticLoader: multi-dim chunks reassemble any
    region; the legacy axis-0 layout reads through the same loader."""
    d = str(tmp_path)
    full = np.arange(12 * 10, dtype=np.float32).reshape(12, 10)
    chunks = [ShardChunk(offset=(r * 6, c * 5), shape=(6, 5),
                         data=full[r * 6:(r + 1) * 6, c * 5:(c + 1) * 5])
              for r in range(2) for c in range(2)]
    with CHK5Writer(os.path.join(d, "rank0.chk5")) as w:
        files = write_shard_files(
            d, "rank0", w,
            {"w": ShardSnapshot("<f4", (12, 10), chunks)}, max_writers=3)
    assert len(files) == 3 and all(os.path.exists(p) for p in files)

    loader = ElasticLoader(sorted(files))
    assert loader.names() == ["w"]
    assert loader.global_shape("w") == [12, 10]
    np.testing.assert_array_equal(loader.read_region("w", None), full)
    np.testing.assert_array_equal(
        loader.read_region("w", (slice(3, 9), slice(2, 8))),
        full[3:9, 2:8])
    np.testing.assert_array_equal(loader.read_rows("w", 5, 7), full[5:7])
    with pytest.raises(ValueError, match="not fully covered"):
        ElasticLoader(sorted(files)[:1]).read_region("w", None)
    loader.close()

    # legacy axis-0 chunk files read through the same loader
    legacy = os.path.join(d, "legacy.chk5")
    rs.save_sharded(legacy, {"v": full[4:]}, {"v": 4},
                    {"v": [12, 10]})
    lo = ElasticLoader([legacy])
    np.testing.assert_array_equal(lo.read_rows("v", 6, 10), full[6:10])
    lo.close()

    # OVERLAPPING chunk files (replicated shards merged from several rank
    # files) must assemble, not double-count coverage — regression: the
    # volume-sum check rejected fully-covered overlapping sets
    a = os.path.join(d, "ov-a.chk5")
    b = os.path.join(d, "ov-b.chk5")
    rs.save_sharded(a, {"v": full[0:8]}, {"v": 0}, {"v": [12, 10]})
    rs.save_sharded(b, {"v": full[5:12]}, {"v": 5}, {"v": [12, 10]})
    lo = ElasticLoader([a, b])
    np.testing.assert_array_equal(lo.read_region("v", None), full)
    np.testing.assert_array_equal(lo.read_rows("v", 3, 11), full[3:11])
    lo.close()
    # a genuine hole still raises, overlap or not
    c = os.path.join(d, "ov-c.chk5")
    rs.save_sharded(c, {"v": full[9:12]}, {"v": 9}, {"v": [12, 10]})
    lo = ElasticLoader([a, c])
    with pytest.raises(ValueError, match="not fully covered"):
        lo.read_region("v", None)
    lo.close()


def test_shard_chunk_int8_codec_roundtrip_regions_and_verify(tmp_path):
    """``compress="int8"`` reaches shard chunks: each chunk quantizes
    independently (scales in the same shard file), region reads decode
    only the touched blocks, a full-chunk read verifies the recorded
    dequantized crc32, and corruption is caught — closing the ROADMAP
    "chunks ship raw" gap."""
    from repro_torch.core.formats import CHK5CorruptionError, CHK5Reader
    from repro_torch.core.protect import Protect
    from repro_torch.core.resharding import resolve_shard_refs
    from repro_torch.dist.compression import dequantize_int8_np, quantize_int8_np

    d = str(tmp_path)
    rng = np.random.default_rng(1)
    full = rng.normal(size=(16, 10)).astype(np.float32)
    chunks = [ShardChunk(offset=(r * 8, c * 5), shape=(8, 5),
                         data=full[r * 8:(r + 1) * 8, c * 5:(c + 1) * 5])
              for r in range(2) for c in range(2)]
    with CHK5Writer(os.path.join(d, "rank0.chk5")) as w:
        files = write_shard_files(
            d, "rank0", w, {"w": ShardSnapshot("<f4", (16, 10), chunks)},
            specs={"w": Protect("w", compress="int8")}, max_writers=2)

    exp = np.empty_like(full)
    for c in chunks:
        q, s = quantize_int8_np(np.ascontiguousarray(c.data))
        back = dequantize_int8_np(q, s, c.data.shape).astype(np.float32)
        exp[c.offset[0]:c.offset[0] + 8, c.offset[1]:c.offset[1] + 5] = back

    loader = ElasticLoader(sorted(files))
    np.testing.assert_array_equal(loader.read_region("w", None), exp)
    np.testing.assert_array_equal(                   # partial-block decode
        loader.read_region("w", (slice(3, 13), slice(2, 9))),
        exp[3:13, 2:9])
    loader.close()
    assert np.abs(exp - full).max() <= np.abs(full).max() / 127 + 1e-6

    # lazy-ref restore path (what the pipeline hands TCL) decodes too
    rd = CHK5Reader(os.path.join(d, "rank0.chk5"))
    assert rd.info("shardidx/w")["attrs"].get("codec") == "int8"
    refs = resolve_shard_refs(rd, [d], 0)
    np.testing.assert_array_equal(refs["w"].materialize(), exp)
    rd.close()

    # per-chunk attrs: codec + scales dataset + dequantized crc32
    frd = CHK5Reader(sorted(files)[0])
    ds = [x for x in frd.datasets() if x.startswith("shard/")][0]
    attrs = frd.info(ds)["attrs"]
    assert attrs["codec"] == "int8" and "roundtrip_crc32" in attrs
    assert f"codecaux/{ds}/scale" in frd.datasets()
    off = frd.info(ds)["offset"]
    frd.close()

    # flip one payload byte: the full-chunk dequantized-crc verify trips
    with open(sorted(files)[0], "r+b") as fh:
        fh.seek(off)
        b = fh.read(1)
        fh.seek(off)
        fh.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CHK5CorruptionError, match="roundtrip"):
        ElasticLoader(sorted(files)).read_region("w", None)


def test_shard_chunk_int8_fallbacks(tmp_path):
    """Non-float leaves and chunks whose roundtrip error exceeds
    ``max_error`` ship raw, with the reason recorded per dataset."""
    from repro_torch.core.formats import CHK5Reader
    from repro_torch.core.protect import Protect

    d = str(tmp_path)
    ints = np.arange(40, dtype=np.int32).reshape(8, 5)
    # random normals roundtrip with ~1e-3 relative L2 — any bound tighter
    # than that trips the per-chunk fallback
    wild = np.random.default_rng(2).normal(size=(4, 2)).astype(np.float32)
    snaps = {
        "i": ShardSnapshot("<i4", (8, 5),
                           [ShardChunk((0, 0), (8, 5), ints)]),
        "f": ShardSnapshot("<f4", (4, 2),
                           [ShardChunk((0, 0), (4, 2), wild)]),
    }
    specs = {"i": Protect("i", compress="int8"),
             "f": Protect("f", compress="int8", max_error=1e-9)}
    with CHK5Writer(os.path.join(d, "rank0.chk5")) as w:
        files = write_shard_files(d, "rank0", w, snaps, specs=specs,
                                  max_writers=1)
    rd = CHK5Reader(os.path.join(d, "rank0.chk5"))
    assert "codec_fallback" in rd.info("shardidx/i")["attrs"]
    rd.close()
    frd = CHK5Reader(files[0])
    fa = frd.info("shard/f/shard-0")["attrs"]
    assert "codec" not in fa and "max_error" in fa["codec_fallback"]
    ia = frd.info("shard/i/shard-0")["attrs"]
    assert "codec" not in ia
    frd.close()
    # raw fallbacks restore bit-exact
    loader = ElasticLoader(files)
    np.testing.assert_array_equal(loader.read_region("i", None), ints)
    np.testing.assert_array_equal(loader.read_region("f", None), wild)
    loader.close()

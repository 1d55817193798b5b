"""The port's content-defined chunker and streaming chunk uploader
(``repro_torch.objstore.{cdc,chunks}``), mirroring tests/test_cdc.py, held
against the JAX package's: the same bytes give the same cut sequence and
the same chunk digests in both packages (catalogs and buckets are shared
between them), on the same seeded random inputs.
"""
import hashlib

import numpy as np
import pytest

from repro.objstore import cdc as jcdc
from repro.objstore.chunks import ChunkUploader as JChunkUploader
from repro.objstore.client import MemoryObjectStore as JMemoryObjectStore
from repro_torch.objstore.cdc import CDCParams, Chunker, split
from repro_torch.objstore.chunks import (
    ChunkUploader,
    FileEntry,
    chunk_key,
    fetch_file,
)
from repro_torch.objstore.client import MemoryObjectStore, ObjectStoreError

#: small bounds so a few hundred KiB exercises many chunks
P = CDCParams(min_bytes=2 << 10, avg_bytes=8 << 10, max_bytes=32 << 10)
JP = jcdc.CDCParams(min_bytes=2 << 10, avg_bytes=8 << 10, max_bytes=32 << 10)


def _rand(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _digests(chunks):
    return [hashlib.sha256(c).hexdigest() for c in chunks]


# ------------------------------------------------------------------ #
# the chunker itself
# ------------------------------------------------------------------ #


def test_params_validation():
    with pytest.raises(ValueError):
        CDCParams(min_bytes=2, avg_bytes=8, max_bytes=16)
    with pytest.raises(ValueError):
        CDCParams(min_bytes=1 << 20, avg_bytes=1 << 10, max_bytes=1 << 22)
    with pytest.raises(ValueError):
        CDCParams(min_bytes=1 << 10, avg_bytes=1 << 22, max_bytes=1 << 20)
    assert CDCParams(avg_bytes=1 << 20).mask == \
        jcdc.CDCParams(avg_bytes=1 << 20).mask == (1 << 20) - 1


@pytest.mark.parametrize("seed,n", [(0, 300 << 10), (11, 1 << 20)])
def test_cuts_equal_the_reference_and_ignore_push_granularity(seed, n):
    data = _rand(n, seed)
    want = jcdc.split(data, JP)
    got = split(data, P)
    assert _digests(got) == _digests(want) and b"".join(got) == data
    for step in (1 << 10, 7_919, 64 << 10, len(data)):
        c = Chunker(P)
        pushed = []
        for off in range(0, len(data), step):
            pushed += c.push(data[off:off + step])
        pushed += c.finish()
        assert pushed == got, f"push step {step} changed the cut sequence"


def test_chunk_size_bounds_and_reassembly():
    data = _rand(500 << 10, seed=1)
    chunks = split(data, P)
    assert b"".join(chunks) == data and len(chunks) > 5
    for ch in chunks[:-1]:
        assert P.min_bytes <= len(ch) <= P.max_bytes
    assert len(chunks[-1]) <= P.max_bytes
    assert _digests(chunks) == _digests(jcdc.split(data, JP))


def test_degenerate_data_cuts_at_min_and_dedups():
    data = bytes(256 << 10)
    chunks = split(data, P)
    assert all(len(c) == P.min_bytes for c in chunks[:-1])
    assert len(set(chunks[:-1])) == 1
    assert chunks == jcdc.split(data, JP)


def test_boundaries_resync_after_insert():
    v1 = _rand(256 << 10, seed=2)
    at = len(v1) // 3
    v2 = v1[:at] + b"wedge" + v1[at:]
    c1 = set(_digests(split(v1, P)))
    chunks2 = split(v2, P)
    new = [c for c in chunks2 if hashlib.sha256(c).hexdigest() not in c1]
    assert sum(len(c) for c in new) < len(v2) // 4
    assert b"".join(chunks2) == v2
    assert _digests(chunks2) == _digests(jcdc.split(v2, JP))


def test_max_bound_forces_cut():
    p = CDCParams(min_bytes=1 << 10, avg_bytes=16 << 10, max_bytes=16 << 10)
    data = _rand(256 << 10, seed=3)
    chunks = split(data, p)
    assert all(len(c) <= p.max_bytes for c in chunks)
    assert max(len(c) for c in chunks) == p.max_bytes
    assert chunks == jcdc.split(data, jcdc.CDCParams(
        min_bytes=1 << 10, avg_bytes=16 << 10, max_bytes=16 << 10))


# ------------------------------------------------------------------ #
# FileEntry: offsets, modes, legacy rows
# ------------------------------------------------------------------ #


def test_file_entry_legacy_rows_get_cumulative_offsets():
    fe = FileEntry("f", 30, [("a", 10), ("b", 12), ("c", 8)])
    assert fe.chunks == [("a", 0, 10), ("b", 10, 12), ("c", 22, 8)]
    assert fe.mode == "fixed"
    rt = FileEntry.from_json("f", fe.to_json())
    assert rt.chunks == fe.chunks and rt.mode == "fixed"


def test_file_entry_from_json_defaults_mode_for_precdc_catalogs():
    fe = FileEntry.from_json("old.chk5",
                             {"size": 7, "chunks": [["aa", 4], ["bb", 3]]})
    assert fe.mode == "fixed"
    assert fe.chunks == [("aa", 0, 4), ("bb", 4, 3)]


def test_fetch_file_restores_legacy_entry_bit_exact(tmp_path):
    store = MemoryObjectStore()
    data = _rand(10_000, seed=4)
    rows = []
    for off in range(0, len(data), 4096):
        piece = data[off:off + 4096]
        h = hashlib.sha256(piece).hexdigest()
        store.put(chunk_key(h), piece)
        rows.append([h, len(piece)])
    entry = FileEntry.from_json("old.chk5", {"size": len(data),
                                             "chunks": rows})
    dest = tmp_path / "restored.chk5"
    fetch_file(store, entry, str(dest))
    assert dest.read_bytes() == data


def test_fetch_file_rejects_non_tiling_offsets(tmp_path):
    store = MemoryObjectStore()
    piece = b"x" * 64
    h = hashlib.sha256(piece).hexdigest()
    store.put(chunk_key(h), piece)
    entry = FileEntry("gap.chk5", 128, [(h, 0, 64), (h, 70, 64)])
    with pytest.raises(ObjectStoreError, match="does not tile"):
        fetch_file(store, entry, str(tmp_path / "gap"))


# ------------------------------------------------------------------ #
# the streaming sink
# ------------------------------------------------------------------ #


def _stream(up, tag, data, step=10_000):
    s = up.open_stream(tag)
    for off in range(0, len(data), step):
        s.write(data[off:off + step])
    s.finish()
    return s.pending().result()


def test_stream_matches_file_based_cuts_and_the_reference(tmp_path):
    data = _rand(200 << 10, seed=5)
    path = tmp_path / "payload.bin"
    path.write_bytes(data)
    up = ChunkUploader(MemoryObjectStore(), cdc=P)
    streamed = _stream(up, "streamed", data)
    filed = up.upload_file(str(path), "filed")
    up.close()
    assert streamed.chunks == filed.chunks
    assert streamed.mode == filed.mode == "cdc"
    assert up.stats["bytes_deduped"] >= len(data)
    jup = JChunkUploader(JMemoryObjectStore(), cdc=JP)
    want = _stream(jup, "streamed", data)
    jup.close()
    assert streamed.chunks == want.chunks and streamed.size == want.size


def test_stream_roundtrips_through_fetch(tmp_path):
    store = MemoryObjectStore()
    up = ChunkUploader(store, cdc=P)
    data = _rand(100 << 10, seed=6)
    s = up.open_stream("rt.chk5")
    s.write(data)
    entry = s.finish().result()
    up.close()
    dest = tmp_path / "rt.chk5"
    fetch_file(store, entry, str(dest))
    assert dest.read_bytes() == data


def test_stream_guards_lifecycle():
    up = ChunkUploader(MemoryObjectStore(), cdc=P)
    s = up.open_stream("x")
    with pytest.raises(ObjectStoreError, match="not finished"):
        s.pending()
    s.write(b"abc")
    s.finish()
    with pytest.raises(ObjectStoreError, match="write after finish"):
        s.write(b"more")
    assert s.finish() is s.pending()
    up.close()


def _region_store(up, tag, region, key="leaf-key", head=b"HEADER--",
                  tail=b"--TAIL"):
    s = up.open_stream(tag)
    s.write(head)
    s.begin_region(key)
    for off in range(0, len(region), 9_000):
        s.write(region[off:off + 9_000])
    s.end_region()
    s.write(tail)
    return s.finish().result()


def test_region_replay_skips_scan_and_keeps_layout():
    region = _rand(120 << 10, seed=7)
    up = ChunkUploader(MemoryObjectStore(), cdc=P)
    e1 = _region_store(up, "a.chk5", region)
    assert up.stats["regions_reused"] == 0
    e2 = _region_store(up, "b.chk5", region)
    up.close()
    assert up.stats["regions_reused"] == 1
    assert up.stats["bytes_scan_skipped"] >= len(region)
    assert [h for h, _, _ in e1.chunks] == [h for h, _, _ in e2.chunks]
    jup = JChunkUploader(JMemoryObjectStore(), cdc=JP)
    je1 = _region_store(jup, "a.chk5", region)
    je2 = _region_store(jup, "b.chk5", region)
    jup.close()
    assert (e1.chunks, e2.chunks) == (je1.chunks, je2.chunks)


def test_stale_region_layout_still_stores_correct_bytes(tmp_path):
    store = MemoryObjectStore()
    up = ChunkUploader(store, cdc=P)
    v1 = _rand(64 << 10, seed=8)
    v2 = _rand(64 << 10, seed=9)
    _region_store(up, "a.chk5", v1, key="same-key", head=b"", tail=b"")
    e2 = _region_store(up, "b.chk5", v2, key="same-key", head=b"", tail=b"")
    up.close()
    dest = tmp_path / "b.chk5"
    fetch_file(store, e2, str(dest))
    assert dest.read_bytes() == v2


def test_fixed_mode_stream_matches_legacy_splitter(tmp_path):
    data = _rand(10 << 10, seed=10)
    path = tmp_path / "f.bin"
    path.write_bytes(data)
    up = ChunkUploader(MemoryObjectStore(), chunk_bytes=4096)
    s = up.open_stream("s")
    s.write(data)
    streamed = s.finish().result()
    filed = up.upload_file(str(path))
    up.close()
    assert streamed.mode == "fixed"
    assert [h for h, _, _ in streamed.chunks] == \
        [h for h, _, _ in filed.chunks]
    assert [n for _, _, n in streamed.chunks] == [4096, 4096, 2048]

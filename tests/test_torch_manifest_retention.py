"""The torch mirror of tests/test_manifest_retention.py, on the port.

Manifest commit protocol, crash-window recovery, diff-chain retention."""
import os

import numpy as np
import pytest

from repro_torch.core import manifest as mf
from repro_torch.core.comm import LocalComm
from repro_torch.core.storage import CHK_DIFF, CHK_FULL, StorageConfig, StorageEngine


def test_commit_is_atomic(tmp_path):
    root = str(tmp_path)
    d = mf.begin(root, 1)
    open(os.path.join(d, "rank0.chk5"), "wb").write(b"x")
    # not committed yet → invisible
    assert mf.list_committed(root) == []
    with pytest.raises(RuntimeError):
        mf.commit(root, 1)              # no manifest → refuse
    mf.write_manifest(root, 1, {"kind": CHK_FULL})
    mf.commit(root, 1)
    assert mf.list_committed(root) == [1]
    assert mf.latest_id(root) == 1


def test_uncommitted_tmp_ignored_after_crash(tmp_path):
    """A crash between begin() and commit() leaves a .tmp dir that restart
    logic must ignore."""
    root = str(tmp_path)
    mf.begin(root, 7)                   # crashed mid-write
    assert mf.list_committed(root) == []
    assert mf.latest_id(root) is None
    mf.abort(root, 7)
    assert not os.path.exists(mf.ckpt_dir(root, 7, tmp=True))


def test_latest_pointer_fallback(tmp_path):
    """Stale/corrupt 'latest' falls back to scanning committed dirs."""
    root = str(tmp_path)
    for i in (1, 2):
        d = mf.begin(root, i)
        open(os.path.join(d, "rank0.chk5"), "wb").write(b"x")
        mf.write_manifest(root, i, {"kind": CHK_FULL})
        mf.commit(root, i)
    open(os.path.join(root, mf.LATEST), "w").write("999")   # bogus
    assert mf.latest_id(root) == 2


def test_merge_commit_shared_tier(tmp_path):
    """Second rank committing to an existing dir merges instead of clobbering."""
    root = str(tmp_path)
    d = mf.begin(root, 3)
    open(os.path.join(d, "rank0.chk5"), "wb").write(b"a")
    mf.write_manifest(root, 3, {"kind": CHK_FULL})
    mf.commit(root, 3)
    d = mf.begin(root, 3)
    open(os.path.join(d, "rank1.chk5"), "wb").write(b"b")
    mf.write_manifest(root, 3, {"kind": CHK_FULL})
    mf.commit(root, 3)
    files = sorted(os.listdir(mf.ckpt_dir(root, 3)))
    assert "rank0.chk5" in files and "rank1.chk5" in files


def _engine(tmp_path, **kw):
    cfg = StorageConfig(root=str(tmp_path / "shared"), **kw)
    return StorageEngine(cfg, LocalComm(str(tmp_path / "nl")))


def test_diff_chain_retention_keeps_base(tmp_path):
    """Pruning must never drop the FULL base of a retained diff chain."""
    eng = _engine(tmp_path, keep_last_full=1, block_bytes=256)
    arr = {"x": np.arange(4096, dtype=np.float32)}
    eng.store(arr, 1, level=1, kind=CHK_FULL)
    for i in range(2, 6):
        arr = {"x": arr["x"].copy()}
        arr["x"][i] = -1.0
        eng.store(arr, i, level=1, kind=CHK_DIFF)
    ids = mf.list_committed(eng.local_root)
    assert 1 in ids, "FULL base pruned while diffs depend on it"
    named, meta = eng.load_latest()
    assert named["x"][5] == -1.0 and named["x"][4] == -1.0


def test_retention_prunes_old_chains(tmp_path):
    eng = _engine(tmp_path, keep_last_full=2, block_bytes=256)
    arr = np.arange(1024, dtype=np.float32)
    for i in range(1, 8):
        eng.store({"x": arr + i}, i, level=1, kind=CHK_FULL)
    ids = mf.list_committed(eng.local_root)
    assert len(ids) == 2 and ids == [6, 7]
    named, _ = eng.load_latest()
    assert named["x"][0] == 7.0


def test_corrupt_latest_checkpoint_falls_back(tmp_path):
    """A corrupted newest checkpoint must not block restart — the engine
    walks back to the previous restorable one."""
    eng = _engine(tmp_path, keep_last_full=3)
    eng.store({"x": np.float32(1.0)}, 1, level=1)
    eng.store({"x": np.float32(2.0)}, 2, level=1)
    # corrupt ckpt-2's payload
    p = os.path.join(mf.ckpt_dir(eng.local_root, 2), "rank0.chk5")
    raw = bytearray(open(p, "rb").read())
    raw[12] ^= 0xFF
    open(p, "wb").write(raw)
    named, meta = eng.load_latest()
    assert named["x"] == np.float32(1.0)
    assert meta["id"] == 1

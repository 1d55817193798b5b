"""The torch mirror of tests/test_formats.py, on the port.

CHK5 container: round trips, integrity, partial reads."""
import io
import os

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # container without hypothesis: tiny shim
    from _hypothesis_fallback import given, settings, st

from repro_torch.core.formats import (
    CHK5CorruptionError,
    CHK5Reader,
    CHK5Writer,
    dtype_to_str,
    str_to_dtype,
)

DTYPES = ["<f4", "<f8", "<i4", "<i8", "<u4", "<u2", "|i1"]


def test_roundtrip_basic(tmp_path):
    p = str(tmp_path / "a.chk5")
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    with CHK5Writer(p) as w:
        w.write_dataset("data/x", a, {"k": 1})
        w.write_bytes("raw/blob", b"\x00\x01hello")
        w.set_attrs("", {"id": 3, "kind": "FULL"})
    r = CHK5Reader(p, verify=True)
    assert r.datasets() == ["data/x", "raw/blob"]
    assert np.array_equal(r.read_dataset("data/x"), a)
    assert r.read_bytes("raw/blob") == b"\x00\x01hello"
    assert r.attrs("")["kind"] == "FULL"
    assert r.info("data/x")["attrs"] == {"k": 1}
    r.close()


def test_scalar_and_empty(tmp_path):
    p = str(tmp_path / "s.chk5")
    with CHK5Writer(p) as w:
        w.write_dataset("s", np.uint32(7))
        w.write_dataset("e", np.zeros((0, 4), np.float32))
    r = CHK5Reader(p)
    assert r.read_dataset("s").shape == ()
    assert r.read_dataset("s") == 7
    assert r.read_dataset("e").shape == (0, 4)


def test_bfloat16_roundtrip(tmp_path):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    p = str(tmp_path / "b.chk5")
    a = np.arange(8).astype(ml_dtypes.bfloat16)
    with CHK5Writer(p) as w:
        w.write_dataset("b", a)
    r = CHK5Reader(p)
    got = r.read_dataset("b")
    assert got.dtype == np.dtype(ml_dtypes.bfloat16)
    assert np.array_equal(got.astype(np.float32), a.astype(np.float32))


def test_corruption_detected(tmp_path):
    p = str(tmp_path / "c.chk5")
    a = np.random.RandomState(0).randn(64).astype(np.float32)
    with CHK5Writer(p) as w:
        w.write_dataset("x", a)
    raw = bytearray(open(p, "rb").read())
    raw[20] ^= 0xFF                    # flip a payload byte
    open(p, "wb").write(raw)
    r = CHK5Reader(p)
    with pytest.raises(CHK5CorruptionError):
        r.read_dataset("x")


def test_truncation_detected(tmp_path):
    p = str(tmp_path / "t.chk5")
    with CHK5Writer(p) as w:
        w.write_dataset("x", np.zeros(16, np.float32))
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[: len(raw) // 2])
    with pytest.raises((CHK5CorruptionError, Exception)):
        CHK5Reader(p)


def test_partial_range_read(tmp_path):
    p = str(tmp_path / "r.chk5")
    a = np.arange(1000, dtype=np.int64)
    with CHK5Writer(p) as w:
        w.write_dataset("x", a)
    r = CHK5Reader(p)
    assert np.array_equal(r.read_range("x", 100, 50), a[100:150])


def test_memory_file():
    buf = io.BytesIO()
    w = CHK5Writer.__new__(CHK5Writer)   # file-object writer path
    # simpler: write to bytes via temp then read through BytesIO
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".chk5", delete=False) as f:
        path = f.name
    with CHK5Writer(path) as w:
        w.write_dataset("x", np.ones(4))
    r = CHK5Reader(io.BytesIO(open(path, "rb").read()))
    assert np.array_equal(r.read_dataset("x"), np.ones(4))
    os.unlink(path)


@settings(max_examples=25, deadline=None)
@given(
    dtype=st.sampled_from(DTYPES),
    shape=st.lists(st.integers(1, 8), min_size=0, max_size=3),
    seed=st.integers(0, 2**31 - 1),
)
def test_roundtrip_property(tmp_path_factory, dtype, shape, seed):
    rng = np.random.RandomState(seed)
    a = np.asarray(rng.randn(*shape) * 100).astype(np.dtype(dtype))
    p = str(tmp_path_factory.mktemp("h") / "x.chk5")
    with CHK5Writer(p) as w:
        w.write_dataset("x", a)
    r = CHK5Reader(p, verify=True)
    got = r.read_dataset("x")
    assert got.dtype == a.dtype and got.shape == a.shape
    assert np.array_equal(got, a)
    r.close()


def test_dtype_str_helpers():
    assert str_to_dtype(dtype_to_str(np.float32)) == np.float32
    import ml_dtypes
    assert str_to_dtype(dtype_to_str(ml_dtypes.bfloat16)) == np.dtype(
        ml_dtypes.bfloat16)

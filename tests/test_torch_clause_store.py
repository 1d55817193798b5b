"""The torch mirror of tests/test_clause_store.py, on the port.  The
container inventory is read with the port's ``tools/chkls`` and with the
reference's, which reads the port's CHK5 as its own; both must agree.

Clause-driven stores end to end: per-subtree kind/compress/precision
clauses through store → crash → restart on every backend, the Pack-side
int8 compression tier (roundtrip-verified), the CHK5 format tier's clause
attrs, and mixed-kind (DIFF + FULL) checkpoints."""

import io
import json
import os

import numpy as np
import pytest
import torch

from repro.tools.chkls import main as ref_chkls_main
from repro_torch.core.context import (
    CHK_DIFF,
    CHK_FULL,
    CheckpointConfig,
    CheckpointContext,
    Protect,
)
from repro_torch.core.formats import (CHK5CorruptionError, CHK5Reader,
                                      CHK5Writer)
from repro_torch.core.tiers import decode_leaf, pack_named, unpack_named
from repro_torch.tools.chkls import main as chkls_main


def i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _int8_exact(n, seed=0, scale=0.25):
    """Values exactly representable under per-block int8 max-abs
    quantization: integers in [-127, 127] times a power-of-two scale,
    with ±127·scale present in every 1024-block so the recovered scale is
    exact."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-126, 127, size=n).astype(np.float32)
    v[::1024] = 127.0
    return v * np.float32(scale)


def _mixed_state(n=4096):
    return {
        "params": {"w": torch.from_numpy(_int8_exact(n)),
                   "b": torch.from_numpy(_int8_exact(64, seed=1))},
        "opt": {"m": torch.arange(512.0), "v": torch.ones(512) * 0.5},
        "step": i32(3),
    }


def _protects():
    return (Protect("params/**", kind=CHK_DIFF, compress="int8"),
            Protect("opt/**", kind=CHK_FULL),
            Protect("step"))


def _ckpt_file(root_dir, ckpt_id):
    p = os.path.join(root_dir, "node-local", "ckpts", f"ckpt-{ckpt_id}",
                     "rank0.chk5")
    assert os.path.exists(p), p
    return p


@pytest.mark.parametrize("backend", ["fti", "scr", "veloc"])
def test_clause_store_crash_restart_bit_exact(tmp_path, backend):
    """The acceptance scenario: one store with DIFF+int8 params and FULL
    opt round-trips bit-exact through store → crash → restart on all three
    backends, and chkls --json shows the int8 codec attr on params
    datasets only."""
    d = str(tmp_path / backend)
    state = _mixed_state()
    ctx = CheckpointContext(CheckpointConfig(
        dir=d, backend=backend, dedicated_thread=False))
    ctx.protect(*_protects())
    rep = ctx.store(state, id=1, level=1)
    assert rep is not None
    ctx.shutdown()                                  # "crash" boundary

    ctx2 = CheckpointContext(CheckpointConfig(
        dir=d, backend=backend, dedicated_thread=False))
    ctx2.protect(*_protects())
    tmpl = {"params": {"w": torch.zeros(4096), "b": torch.zeros(64)},
            "opt": {"m": torch.zeros(512), "v": torch.zeros(512)},
            "step": i32(0)}
    got = ctx2.load(tmpl)
    assert ctx2.restarted
    for k in ("w", "b"):
        assert torch.equal(got["params"][k], state["params"][k])
    for k in ("m", "v"):
        assert torch.equal(got["opt"][k], state["opt"][k])
    assert int(got["step"]) == 3
    ctx2.shutdown()

    # container inventory: codec attr on params datasets ONLY
    f = _ckpt_file(d, 1)
    import contextlib
    invs = []
    for main in (chkls_main, ref_chkls_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([f, "--json"]) == 0
        invs.append(json.loads(buf.getvalue()))
    inv, ref_inv = invs
    assert inv == ref_inv                      # the two tools agree
    by_name = {ds["name"]: ds for ds in inv["datasets"]}
    for name, ds in by_name.items():
        if name.startswith("data/params/"):
            assert ds["attrs"].get("codec") == "int8", name
            assert "roundtrip_crc32" in ds["attrs"], name
        elif name.startswith("data/"):
            assert "codec" not in ds["attrs"], name
    # the int8 payload actually shrinks the params datasets (~4x + scales)
    w = by_name["data/params/w"]
    assert w["nbytes"] < 4096 * 4 / 3


def test_compressed_payload_smaller_and_attrs_complete(tmp_path):
    d = str(tmp_path / "sz")
    n = 64 * 1024
    state = {"params": {"w": torch.from_numpy(_int8_exact(n))}}
    ctx = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                             dedicated_thread=False))
    ctx.protect(Protect("params/**", compress="int8"))
    rep_c = ctx.store(state, id=1, level=1)
    ctx.protect(Protect("params/**"))
    rep_u = ctx.store(state, id=2, level=1)
    assert rep_c.bytes_payload < rep_u.bytes_payload / 3
    rd = CHK5Reader(_ckpt_file(d, 1))
    attrs = rd.info("data/params/w")["attrs"]
    assert attrs["codec"] == "int8" and attrs["kind"] == CHK_FULL
    assert attrs["selector"] == "params/**"
    assert attrs["codec_error"] == 0.0          # representable values
    assert rd.info("codecaux/params/w/scale")["shape"] == [n // 1024]
    rd.close()
    ctx.shutdown()


def test_int8_fallbacks_nonfloat_and_max_error(tmp_path):
    """Non-float leaves and payloads above the max_error bound store
    uncompressed with a codec_fallback attr — and restore exactly."""
    d = str(tmp_path / "fb")
    state = {"step": i32(9), "noisy": torch.from_numpy(
        np.random.default_rng(3).normal(size=4096).astype(np.float32))}
    ctx = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                             dedicated_thread=False))
    ctx.protect(Protect("**", compress="int8", max_error=1e-9))
    ctx.store(state, id=1, level=1)
    ctx.shutdown()

    rd = CHK5Reader(_ckpt_file(d, 1))
    assert "int8: non-float" in rd.info("data/step")["attrs"]["codec_fallback"]
    assert "max_error" in rd.info("data/noisy")["attrs"]["codec_fallback"]
    assert "codec" not in rd.info("data/noisy")["attrs"]
    rd.close()

    ctx2 = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                              dedicated_thread=False))
    got = ctx2.load({"step": i32(0), "noisy": torch.zeros(4096)})
    assert int(got["step"]) == 9
    assert torch.equal(got["noisy"], state["noisy"])
    ctx2.shutdown()


def test_precision_clause_casts_and_restores_template_dtype(tmp_path):
    d = str(tmp_path / "prec")
    w = np.asarray([1.0, 1.0 + 2 ** -10, -3.25], np.float32)
    ctx = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                             dedicated_thread=False))
    ctx.protect(Protect("w", format="chk5", precision="bf16"))
    ctx.store({"w": torch.from_numpy(w)}, id=1, level=1)
    ctx.shutdown()

    rd = CHK5Reader(_ckpt_file(d, 1))
    info = rd.info("data/w")
    assert info["dtype"] == "bfloat16"          # stored at clause precision
    assert info["attrs"]["precision"] == "bf16"
    assert info["attrs"]["format"] == "chk5"
    assert info["attrs"]["dtype"] == "<f4"      # original, for cast-back
    rd.close()

    ctx2 = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                              dedicated_thread=False))
    got = ctx2.load({"w": torch.zeros(3)})
    assert got["w"].dtype == torch.float32
    arr = got["w"].numpy()
    assert arr.dtype == np.float32              # template dtype restored
    import ml_dtypes
    np.testing.assert_array_equal(
        arr, w.astype(ml_dtypes.bfloat16).astype(np.float32))
    ctx2.shutdown()


def test_precision_composes_with_int8_and_already_at_target(tmp_path):
    """precision + compress quantizes the precision-limited values (attr
    is honest); precision equal to the leaf dtype keeps the attr with no
    fallback; a custom pack chain without a catch-all fails at pack."""
    import ml_dtypes
    p = str(tmp_path / "pc.chk5")
    w = _int8_exact(2048)
    with CHK5Writer(p) as wtr:
        pack_named(wtr, {"w": w, "z": w},
                   {"w": Protect("w", compress="int8", precision="bf16"),
                    "z": Protect("z", precision="f32")})
    rd = CHK5Reader(p)
    aw = rd.info("data/w")["attrs"]
    assert aw["codec"] == "int8" and aw["precision"] == "bf16"
    assert aw["dtype"] == "<f4"                  # restore target = original
    got = decode_leaf(rd, "data/w")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(                # bf16-limited then int8
        got, w.astype(ml_dtypes.bfloat16).astype(np.float32))
    az = rd.info("data/z")["attrs"]
    assert az["precision"] == "f32" and "precision_fallback" not in az
    rd.close()
    # a pack chain with no catch-all tier must fail loudly at pack time
    from repro_torch.core.tiers import Int8CompressTier
    with pytest.raises(RuntimeError, match="no pack tier"):
        with CHK5Writer(str(tmp_path / "bad.chk5")) as wtr:
            pack_named(wtr, {"plain": w}, {"plain": None},
                       pack_tiers=[Int8CompressTier()])


def test_mixed_kind_diff_chain_replays(tmp_path):
    """Store 2 carries a real params DIFF link + FULL opt in one container;
    restore replays the delta onto the compressed-but-exact base."""
    d = str(tmp_path / "mx")
    state = _mixed_state()
    ctx = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                             dedicated_thread=False,
                                             block_bytes=256))
    ctx.protect(*_protects())
    rep1 = ctx.store(state, id=1, level=1)
    assert rep1.kind == CHK_FULL and rep1.promoted_full   # no base yet
    w2 = state["params"]["w"].clone()
    w2[5] = -5.0
    state2 = {"params": {"w": w2, "b": state["params"]["b"]},
              "opt": {"m": torch.arange(512.0) * 2, "v": state["opt"]["v"]},
              "step": i32(4)}
    rep2 = ctx.store(state2, id=2, level=1)
    assert rep2.kind == CHK_DIFF and rep2.dirty_ratio < 0.2
    ctx.shutdown()

    rd = CHK5Reader(_ckpt_file(d, 2))
    names = rd.datasets()
    assert any(n.startswith("delta/params/w/") for n in names)
    assert "data/opt/m" in names and "data/step" in names
    assert rd.attrs("")["kind"] == CHK_DIFF     # mixed container walks back
    rd.close()

    ctx2 = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                              dedicated_thread=False,
                                              block_bytes=256))
    got = ctx2.load({"params": {"w": torch.zeros(4096), "b": torch.zeros(64)},
                     "opt": {"m": torch.zeros(512), "v": torch.zeros(512)},
                     "step": i32(0)})
    assert float(got["params"]["w"][5]) == -5.0
    assert torch.equal(got["params"]["w"][6:], state["params"]["w"][6:])
    assert torch.equal(got["opt"]["m"], torch.arange(512.0) * 2)
    assert int(got["step"]) == 4
    ctx2.shutdown()


def test_store_level_kind_still_uniform_when_clauseless(tmp_path):
    """store(kind=CHK_DIFF) without kind clauses keeps the old whole-tree
    semantics (deprecation-compatible)."""
    d = str(tmp_path / "uni")
    ctx = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                             dedicated_thread=False,
                                             block_bytes=256))
    x = torch.arange(4096.0)
    ctx.store({"x": x}, id=1, level=1)
    x[0] = -1.0                                 # in place
    rep = ctx.store({"x": x}, id=2, level=1, kind=CHK_DIFF)
    assert rep.kind == CHK_DIFF and not rep.promoted_full
    ctx.shutdown()


def test_decode_leaf_verifies_roundtrip(monkeypatch, tmp_path):
    """Load-side verification: a dequantization that does not reproduce
    the pack-time payload bit-for-bit is refused."""
    p = str(tmp_path / "v.chk5")
    w = _int8_exact(2048)
    with CHK5Writer(p) as wtr:
        pack_named(wtr, {"w": w}, {"w": Protect("w", compress="int8")})
    rd = CHK5Reader(p)
    np.testing.assert_array_equal(decode_leaf(rd, "data/w"), w)  # honest path
    import repro_torch.dist.compression as comp
    real = comp.dequantize_int8_np
    monkeypatch.setattr(comp, "dequantize_int8_np",
                        lambda q, s, shape: real(q, s, shape) + 1.0)
    with pytest.raises(CHK5CorruptionError, match="roundtrip"):
        decode_leaf(rd, "data/w")
    rd.close()


def test_unpack_named_decodes_all_sections(tmp_path):
    p = str(tmp_path / "u.chk5")
    named = {"a": _int8_exact(1024), "b": np.arange(5, dtype=np.int32)}
    with CHK5Writer(p) as w:
        pack_named(w, named, {"a": Protect("a", compress="int8"), "b": None})
    rd = CHK5Reader(p)
    out = unpack_named(rd)
    assert set(out) == {"a", "b"}
    np.testing.assert_array_equal(out["a"], named["a"])
    np.testing.assert_array_equal(out["b"], named["b"])
    rd.close()

"""The object-store L4 through the port's directives, against the JAX
package.

- Wipe L1–L3 and the global directory: the state restores bit-exact from
  the object store alone, on all three backends (tests/test_objstore.py's
  directive-level case, on tensors).
- A level-4 FULL + DIFF chain written by either package restores from
  the object store alone in both, bit for bit; the port replays the DIFF
  on the template's device.
- The same state stored at L4 by each package gives the same container
  bytes, so the same chunk digests: a bucket can be shared.
- The byte-counted ratios of ``BENCH_overhead.json`` — which the JAX
  package's ``benchmarks/bench_overhead.py`` measured — come out equal
  through the port on the bench's own input bytes.
"""
import glob
import json
import os
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as jctx
from repro.objstore.catalog import Catalog as JCatalog
from repro.objstore.client import make_object_store as jmake_object_store
from repro_torch.core.context import (
    CHK_DIFF,
    CHK_FULL,
    CheckpointConfig,
    CheckpointContext,
    Protect,
)
from repro_torch.core.formats import tensor_to_numpy
from repro_torch.core.protect import flatten_named
from repro_torch.objstore.catalog import Catalog
from repro_torch.objstore.cdc import CDCParams
from repro_torch.objstore.chunks import DEFAULT_CHUNK_BYTES, ChunkUploader
from repro_torch.objstore.client import MemoryObjectStore, make_object_store

ROOT = Path(__file__).resolve().parents[1]


def _wipe_all_but_bucket(d):
    shutil.rmtree(os.path.join(d, "node-local"), ignore_errors=True)
    for g in glob.glob(os.path.join(d, "global", "ckpt-*")):
        shutil.rmtree(g)
    latest = os.path.join(d, "global", "latest")
    if os.path.exists(latest):
        os.remove(latest)


def _tree_state():
    return {"params": {"w": torch.arange(2048, dtype=torch.float32),
                       "b": torch.ones(17)},
            "opt": {"m": torch.full((33,), 0.5)},
            "step": torch.tensor(7, dtype=torch.int32)}


_PROTECTS = ("params/**", "opt/**", "step")


@pytest.mark.parametrize("backend", ["fti", "scr", "veloc"])
def test_restore_with_l1_l3_wiped_across_backends(tmp_path, backend):
    d = str(tmp_path / "ck")
    ctx = CheckpointContext(CheckpointConfig(dir=d, backend=backend,
                                             dedicated_thread=False))
    ctx.protect(*(Protect(p) for p in _PROTECTS))
    state = _tree_state()
    ctx.store(state, id=1, level=4)
    ctx.shutdown()
    _wipe_all_but_bucket(d)
    ctx2 = CheckpointContext(CheckpointConfig(dir=d, backend=backend,
                                              dedicated_thread=False))
    got = ctx2.tcl.backend.engine.load_latest()
    assert got is not None and got[1]["recovered_via"] == "objstore"
    ctx2.protect(*(Protect(p) for p in _PROTECTS))
    template = {"params": {k: torch.zeros_like(v)
                           for k, v in state["params"].items()},
                "opt": {"m": torch.zeros(33)},
                "step": torch.tensor(0, dtype=torch.int32)}
    restored = ctx2.load(template)
    assert ctx2.restarted
    ctx2.shutdown()
    a, b = flatten_named(restored), flatten_named(state)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_checkpoint_config_maps_cdc_fields(tmp_path):
    cfg = CheckpointConfig(dir=str(tmp_path), objstore_chunking="fixed",
                           objstore_cdc_avg_bytes=123 << 10,
                           objstore_cdc_min_bytes=12 << 10,
                           objstore_cdc_max_bytes=1234 << 10,
                           keep_last=3, keep_every=5)
    sc = cfg.storage()
    assert sc.objstore and sc.objstore_chunking == "fixed"
    assert (sc.objstore_cdc_min_bytes, sc.objstore_cdc_avg_bytes,
            sc.objstore_cdc_max_bytes) == (12 << 10, 123 << 10, 1234 << 10)
    assert (sc.objstore_keep_last, sc.objstore_keep_every) == (3, 5)
    # the defaults are the JAX package's
    mine = CheckpointConfig(dir=str(tmp_path)).storage()
    ref = jctx.CheckpointConfig(dir=str(tmp_path)).storage()
    fields = [k for k in vars(mine) if k.startswith("objstore")]
    assert len(fields) == 10
    assert {k: getattr(mine, k) for k in fields} == \
        {k: getattr(ref, k) for k in fields}


# --------------------------------------------------------------------------- #
# cross-read: L4 FULL + DIFF, restored from the object store alone
# --------------------------------------------------------------------------- #

def _np_state(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(500, 33).astype(np.float32),
            "u": rng.randint(0, 256, 999).astype(np.uint8),
            "step": np.asarray(np.int32(seed))}


def _np_edit(st):
    out = {k: np.array(v, copy=True) for k, v in st.items()}
    out["w"][7, 3] += 1.0
    out["w"][-1, -1] -= 1.0
    out["u"][-1] ^= 0x33
    out["step"] = np.asarray(np.int32(int(st["step"]) + 1))
    return out


def _cfg_kw(d):
    return dict(dir=d, backend="fti", block_bytes=1024,
                dedicated_thread=False, objstore_cdc_min_bytes=1 << 10,
                objstore_cdc_avg_bytes=4 << 10, objstore_cdc_max_bytes=16 << 10)


def _store_chain(pkg, d):
    st1 = _np_state(0)
    st2 = _np_edit(st1)
    if pkg == "jax":
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(**_cfg_kw(d)))
        conv = lambda s: {k: jnp.asarray(v) for k, v in s.items()}  # noqa: E731
    else:
        ctx = CheckpointContext(CheckpointConfig(**_cfg_kw(d)))
        conv = lambda s: {k: torch.from_numpy(v.copy())  # noqa: E731
                          for k, v in s.items()}
    r1 = ctx.store(conv(st1), id=1, level=4, kind=CHK_FULL)
    r2 = ctx.store(conv(st2), id=2, level=4, kind=CHK_DIFF)
    ctx.shutdown()
    assert (r1.kind, r2.kind) == (CHK_FULL, CHK_DIFF)
    return st2


def _restore(pkg, d):
    zeros = {k: np.zeros_like(v) for k, v in _np_state(0).items()}
    if pkg == "jax":
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(**_cfg_kw(d)))
        meta = ctx.tcl.backend.engine.load_latest()[1]
        got = ctx.load({k: jnp.asarray(v) for k, v in zeros.items()})
        out = {k: np.asarray(v) for k, v in got.items()}
    else:
        ctx = CheckpointContext(CheckpointConfig(**_cfg_kw(d)))
        meta = ctx.tcl.backend.engine.load_latest()[1]
        got = ctx.load({k: torch.from_numpy(v) for k, v in zeros.items()})
        out = {k: tensor_to_numpy(v) for k, v in got.items()}
    assert ctx.restarted
    ctx.shutdown()
    return out, meta


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_l4_objstore_chain_cross_reads_both_ways(tmp_path, writer):
    d = str(tmp_path / "ck")
    final = _store_chain(writer, d)
    _wipe_all_but_bucket(d)
    for reader in ("jax", "torch"):
        got, meta = _restore(reader, d)
        assert meta["recovered_via"] == "objstore" and meta["id"] == 2
        assert meta["kind"] == CHK_DIFF
        for k, v in final.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes()


def test_same_state_gives_the_same_chunks_in_both_packages(tmp_path):
    """Identical bytes stored at L4 by each package: identical containers,
    so identical catalog file entries (chunk digests, offsets, sizes)."""
    entries = {}
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg)
        _store_chain(pkg, d)
        url = "file:" + os.path.join(d, "objstore")
        cat = (JCatalog(jmake_object_store(url)) if pkg == "jax"
               else Catalog(make_object_store(url)))
        entries[pkg] = {i: cat.entry(i)["files"] for i in cat.ids()}
    assert list(entries["torch"]) == [1, 2]
    assert entries["torch"] == entries["jax"]


# --------------------------------------------------------------------------- #
# the byte-counted ratios of BENCH_overhead.json, through the port
# --------------------------------------------------------------------------- #

def _bench():
    return json.loads((ROOT / "BENCH_overhead.json").read_text())["results"]


def test_compress_ratio_int8_equals_the_committed_value(tmp_path):
    """``compressed_store``'s bytes: 16 MiB of f32 stored FULL at L1 with
    and without ``compress="int8"``."""
    n = 1 << 22
    w = torch.from_numpy(np.random.default_rng(0).normal(size=n)
                         .astype(np.float32))
    nbytes = {}
    for tag, protects in (("full", [Protect("params/**")]),
                          ("int8", [Protect("params/**", compress="int8")])):
        ctx = CheckpointContext(CheckpointConfig(
            dir=str(tmp_path / tag), backend="fti", dedicated_thread=False))
        ctx.protect(*protects)
        nbytes[tag] = ctx.store({"params": {"w": w}}, id=1,
                                level=1).bytes_payload
        ctx.shutdown()
    assert nbytes["int8"] / nbytes["full"] == _bench()["compress_ratio_int8"]


def test_objstore_dedup_ratio_equals_the_committed_value(tmp_path):
    """``objstore_store``'s bytes: 32 MiB of f32 stored at L4, then again
    after a small parameter delta; the second store's uploaded bytes over
    the first's."""
    n = 1 << 23
    base = np.random.default_rng(0).normal(size=n).astype(np.float32)
    ctx = CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / "o"), backend="fti", dedicated_thread=False))
    tier = ctx.tcl.backend.engine.objstore_tier()
    ctx.store({"params": {"w": torch.from_numpy(base)}}, id=1, level=4)
    up1 = tier.uploader.stats["bytes_uploaded"]
    delta = base.copy()
    delta[:4096] += 1.0
    ctx.store({"params": {"w": torch.from_numpy(delta)}}, id=2, level=4)
    ratio = (tier.uploader.stats["bytes_uploaded"] - up1) / max(up1, 1)
    ctx.shutdown()
    assert ratio == _bench()["objstore_dedup_ratio"]


def test_objstore_shift_dedup_vs_fixed_equals_the_committed_value():
    """``objstore_shift_dedup``'s bytes: 16 MiB of random bytes, then the
    same with 1 KiB inserted at the 25 % mark, through the CDC uploader,
    against a fixed-size chunker's re-uploaded bytes."""
    import hashlib
    rng = np.random.default_rng(7)
    v1 = rng.integers(0, 256, 16 << 20, dtype=np.uint8).tobytes()
    insert = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    at = len(v1) // 4
    v2 = v1[:at] + insert + v1[at:]
    up = ChunkUploader(MemoryObjectStore(), cdc=CDCParams())
    for tag, payload in (("v1", v1), ("v2", v2)):
        before = up.stats["bytes_uploaded"]
        s = up.open_stream(tag)
        s.write(payload)
        s.finish()
        s.pending().result()
    cdc_delta = up.stats["bytes_uploaded"] - before
    up.close()

    def fixed(buf):
        return [(hashlib.sha256(buf[o:o + DEFAULT_CHUNK_BYTES]).hexdigest(),
                 len(buf[o:o + DEFAULT_CHUNK_BYTES]))
                for o in range(0, len(buf), DEFAULT_CHUNK_BYTES)]
    seen = {h for h, _ in fixed(v1)}
    fixed_delta = sum(n for h, n in fixed(v2) if h not in seen)
    assert cdc_delta / max(fixed_delta, 1) == \
        _bench()["objstore_shift_dedup_vs_fixed"]

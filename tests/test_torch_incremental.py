"""Incremental stores in the port (tests/test_incremental.py, mirrored):
parts stream in, commit is atomic, restore is indistinguishable from a
monolithic store — and the checkpoint crosses the packages both ways.
A DIFF right after an incremental store ships exactly the blocks the
update touched: ``add`` hashed each part before its snapshot.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as jctx
from repro_torch.core import manifest as mf
from repro_torch.core.context import (
    CHK_DIFF,
    CHK_FULL,
    CheckpointConfig,
    CheckpointContext,
)
from repro_torch.core.formats import CHK5Reader, tensor_to_numpy


def _ctx(tmp_path, name="i", **kw):
    return CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / name), backend="fti",
        **{"dedicated_thread": False, **kw}))


def test_incremental_store_restores_like_monolithic(tmp_path):
    state = {"params": {"w": torch.arange(8.0)}, "opt": {"m": torch.ones(8)},
             "step": torch.tensor(4, dtype=torch.int32)}
    ctx = _ctx(tmp_path)
    inc = ctx.store_begin(id=4, level=1)
    inc.add({"w": state["params"]["w"]}, prefix="params")
    inc.add({"m": state["opt"]["m"]}, prefix="opt")
    inc.add({"step": state["step"]})
    rep = inc.commit()
    assert rep.kind == CHK_FULL and rep.bytes_payload > 0
    ctx.shutdown()
    ctx2 = _ctx(tmp_path)
    got = ctx2.load({"params": {"w": torch.zeros(8)},
                     "opt": {"m": torch.zeros(8)},
                     "step": torch.tensor(0, dtype=torch.int32)})
    assert ctx2.restarted and int(got["step"]) == 4
    assert torch.equal(got["params"]["w"], torch.arange(8.0))
    assert torch.equal(got["opt"]["m"], torch.ones(8))
    ctx2.shutdown()


def test_uncommitted_incremental_invisible(tmp_path):
    ctx = _ctx(tmp_path)
    inc = ctx.store_begin(id=1, level=1)
    inc.add({"w": torch.ones(4)})
    ctx2 = _ctx(tmp_path)
    ctx2.load({"w": torch.zeros(4)})
    assert not ctx2.restarted
    inc.abort()
    ctx.shutdown()
    ctx2.shutdown()


def test_duplicate_part_rejected(tmp_path):
    ctx = _ctx(tmp_path)
    inc = ctx.store_begin(id=1, level=1)
    inc.add({"w": torch.ones(4)})
    with pytest.raises(ValueError, match="twice"):
        inc.add({"w": torch.zeros(4)})
    inc.abort()
    ctx.shutdown()


def test_if_clause(tmp_path):
    ctx = _ctx(tmp_path)
    assert ctx.store_begin(id=1, level=1, if_=False) is None
    ctx.shutdown()


def test_parts_recorded_in_manifest(tmp_path):
    ctx = _ctx(tmp_path)
    inc = ctx.store_begin(id=9, level=1)
    inc.add({"a": torch.ones(2)})
    inc.add({"b": torch.zeros(3)}, prefix="later")
    inc.commit()
    man = mf.read_manifest(ctx.tcl.backend.engine.local_root, 9)
    assert man["incremental"] is True and man["parts"] == ["a", "later/b"]
    ctx.shutdown()


@pytest.mark.parametrize("dedicated", [False, True])
def test_incremental_then_diff_ships_exactly_the_touched_blocks(tmp_path,
                                                                dedicated):
    """The parts are hashed in ``add``, before their snapshot: an update in
    place right after ``add`` (before ``commit``, before the async tail)
    is still seen as dirty by the next DIFF, which ships exactly the
    touched blocks and restores the final state."""
    bb = 4096
    x = torch.arange(100_000, dtype=torch.float32)       # 98 blocks
    y = torch.arange(5000, dtype=torch.int32)
    ctx = _ctx(tmp_path, "d", block_bytes=bb, dedicated_thread=dedicated)
    inc = ctx.store_begin(id=1, level=1)
    inc.add({"x": x})
    x[5] = -1.0                                  # block 0, after x's snapshot
    inc.add({"y": y})
    inc.commit()
    x[60_000] = -2.0                             # block 58
    y[-1] = 7                                    # y's last, partial block
    ctx.store({"x": x, "y": y}, id=2, level=1, kind=CHK_DIFF)
    ctx.shutdown()
    eng = _ctx(tmp_path, "d").tcl.backend.engine
    named, meta = eng.load_latest()
    assert meta["kind"] == CHK_DIFF and meta["id"] == 2
    assert named["x"].tobytes() == x.numpy().tobytes()
    assert named["y"].tobytes() == y.numpy().tobytes()
    rd = CHK5Reader(f"{mf.ckpt_dir(eng.local_root, 2)}/rank0.chk5")
    assert rd.read_dataset("delta/x/idx").tolist() == [0, 58]
    assert rd.read_dataset("delta/y/idx").tolist() == [4]
    rd.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_incremental_checkpoint_cross_reads_both_ways(tmp_path, writer):
    rng = np.random.RandomState(0)
    w = rng.randn(300, 7).astype(np.float32)
    m = rng.randint(0, 2**16, 77).astype(np.uint16)
    step = np.asarray(np.int32(11))
    d = str(tmp_path / "ck")
    if writer == "jax":
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
            dir=d, backend="fti", dedicated_thread=False))
        conv = jnp.asarray
    else:
        ctx = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                                 dedicated_thread=False))
        conv = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    inc = ctx.store_begin(id=3, level=2)
    inc.add({"w": conv(w)}, prefix="params")
    inc.add({"m": conv(m)}, prefix="opt")
    inc.add({"step": conv(step)})
    inc.commit()
    ctx.shutdown()
    zeros = {"params": {"w": np.zeros_like(w)}, "opt": {"m": np.zeros_like(m)},
             "step": np.zeros((), np.int32)}
    jc = jctx.CheckpointContext(jctx.CheckpointConfig(dir=d, backend="fti"))
    jgot = jc.load({"params": {"w": jnp.asarray(zeros["params"]["w"])},
                    "opt": {"m": jnp.asarray(zeros["opt"]["m"])},
                    "step": jnp.asarray(zeros["step"])})
    jc.shutdown()
    tc = CheckpointContext(CheckpointConfig(dir=d, backend="fti"))
    tgot = tc.load({"params": {"w": torch.zeros(300, 7)},
                    "opt": {"m": torch.zeros(77, dtype=torch.uint16)},
                    "step": torch.tensor(0, dtype=torch.int32)})
    tc.shutdown()
    assert jc.restarted and tc.restarted
    for want, j, t in ((w, jgot["params"]["w"], tgot["params"]["w"]),
                       (m, jgot["opt"]["m"], tgot["opt"]["m"]),
                       (step, jgot["step"], tgot["step"])):
        assert np.asarray(j).tobytes() == want.tobytes()
        assert tensor_to_numpy(t).tobytes() == want.tobytes()

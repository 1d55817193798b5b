"""One scatter per replayed DIFF link: ``ops.unpack_dirty_many`` and the
chain replay, on the CPU, against the JAX package.

On the CPU ``unpack_dirty_many`` runs the plain version leaf by leaf.
Over a table mixing dtypes, ragged last blocks, a 0-byte leaf and a view
with a storage offset it must leave every leaf with the bytes the
reference's ``diffunpack_pallas`` (interpret mode) scatters into it, bit
for bit (tolerance 0), and refuse on the host, before it writes anything,
what a scatter on the card could not do safely.  A restore replays each
DIFF link with one ``unpack_dirty_many`` per device and group of at most
``diff.MAX_PACK_BYTES`` of rows, and gives the bytes of the port's numpy
replay and of the JAX package's own restore.  Inputs are numpy arrays
from a seed.  The Hopper kernel is checked on a card in
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import context as jctx
from repro.kernels.diffpack import diffunpack_pallas
from repro_torch.core import diff
from repro_torch.core.context import CHK_DIFF, CheckpointConfig, CheckpointContext
from repro_torch.core.diff import leaf_to_u32_flat
from repro_torch.core.formats import CHK5Reader, numpy_to_tensor, tensor_to_numpy
from repro_torch.kernels import ops


def _arrays(rng):
    return [(rng.randn(40_003) * 100).astype(np.float32),        # ragged
            (rng.randn(513) * 10).astype(ml_dtypes.bfloat16),
            rng.randint(-128, 128, 70_001).astype(np.int8),       # ragged
            np.zeros((0,), np.float32),                          # 0 bytes
            (rng.randn(3001) * 100).astype(np.float32)]          # offset view


def _rows(rng, n, block_bytes):
    return rng.randint(0, 2**32, size=(n, block_bytes // 4), dtype=np.uint64
                       ).astype(np.uint32)


@pytest.mark.parametrize("block_bytes", [256, 65_536])
def test_unpack_dirty_many_matches_pallas_leaf_by_leaf(block_bytes):
    """One call over the mixed table leaves each leaf as the Pallas scatter
    (interpret mode) leaves its zero-padded block copy, cut back to the
    leaf's bytes; the bytes around the offset view stay as they were."""
    rng = np.random.RandomState(block_bytes % 1000)
    arrays = _arrays(rng)
    dirty, packed, want = [], [], []
    for a in arrays:
        n = max(1, -(-a.nbytes // block_bytes))
        idx = np.unique(np.append(rng.choice(n, size=min(n, 4),
                                             replace=False), n - 1)
                        ).astype(np.int32)
        rows = _rows(rng, idx.size, block_bytes)
        base = leaf_to_u32_flat(a, block_bytes).reshape(-1, block_bytes // 4)
        out = np.asarray(diffunpack_pallas(jnp.asarray(base),
                                           jnp.asarray(rows),
                                           jnp.asarray(idx), interpret=True))
        want.append(out.tobytes()[:a.nbytes])
        dirty.append(idx)
        packed.append(rows)
    leaves = [numpy_to_tensor(a) for a in arrays[:-1]]
    buf = torch.arange(3003, dtype=torch.float32)
    view = buf[1:3002]                       # 4 bytes into its storage
    view.copy_(torch.from_numpy(arrays[-1]))
    leaves.append(view)
    # the rows as the restore gives them: read-only host words, and one
    # leaf's as int32 bits in a tensor
    for p in packed:
        p.flags.writeable = False
    packed[1] = torch.from_numpy(packed[1].view(np.int32).copy())
    out = ops.unpack_dirty_many(leaves, dirty, packed, block_bytes)
    assert all(a is b for a, b in zip(out, leaves))
    for t, w in zip(leaves, want):
        assert tensor_to_numpy(t).tobytes() == w
    assert float(buf[0]) == 0.0 and float(buf[3002]) == 3002.0
    assert ops.launch_counts()["diffunpack"] == 0        # the plain version


def _refusals():
    x = torch.arange(1000, dtype=torch.float32)          # 16 blocks of 256 B
    rows = np.zeros((2, 64), np.uint32)
    ok = ([x.clone()], [np.array([1, 2])], [rows])
    return {
        "index past the end": (IndexError, "outside",
                               ([x], [np.array([3, 16])], [rows])),
        "negative index": (IndexError, "outside",
                           ([x], [np.array([-1, 3])], [rows])),
        "repeated index": (ValueError, "increase strictly",
                           ([x], [np.array([4, 4])], [rows])),
        "decreasing indices": (ValueError, "increase strictly",
                               ([x], [np.array([5, 4])], [rows])),
        "float indices": (TypeError, "integers",
                          ([x], [np.array([1.0, 2.0])], [rows])),
        "rows of another count": (ValueError, "packed rows",
                                  ([x], [np.array([1, 2, 3])], [rows])),
        "rows of another width": (ValueError, "packed rows",
                                  ([x], [np.array([1, 2])],
                                   [np.zeros((2, 32), np.uint32)])),
        "non-contiguous target": (ValueError, "contiguous",
                                  ([x.reshape(40, 25).t()],
                                   [np.array([1, 2])], [rows])),
        "an index array short": (ValueError, "one index array per leaf",
                                 ([x, x], [np.array([1, 2])], [rows, rows])),
        "a row array short": (ValueError, "one index array per leaf",
                              ([x, x], [np.array([1]), np.array([2])],
                               [rows])),
        "no leaf": (ValueError, "at least one leaf", ([], [], [])),
        "a leaf on another device": (ValueError, "no checkpoint kernel",
                                     ([x.to("meta")], [np.array([1, 2])],
                                      [rows])),
        "the second leaf bad": (IndexError, "outside",
                                (ok[0] + [x], ok[1] + [np.array([16])],
                                 ok[2] + [rows[:1]])),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_unpack_dirty_many_refuses_on_the_host(case):
    """What the per-leaf scatter refused, the batched one refuses before
    it writes into any leaf."""
    err, match, (leaves, dirty, packed) = _refusals()[case]
    before = [t.clone() for t in leaves if t.device.type == "cpu"]
    with pytest.raises(err, match=match):
        ops.unpack_dirty_many(leaves, dirty, packed, 256)
    after = [t for t in leaves if t.device.type == "cpu"]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_unpack_dirty_many_refuses_a_block_size_not_of_words():
    x = torch.zeros(100)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.unpack_dirty_many([x], [np.array([0])],
                              [np.zeros((1, 1), np.uint32)], 6)


def test_row_groups_cut_per_device_and_cap():
    """Every device's rows, in order, in groups of at most ``cap``; a leaf
    straddles two groups; a leaf with no row is in none."""
    items = [("a", 3), ("b", 2), ("a", 0), ("a", 4), ("b", 1)]
    assert diff.row_groups(items, 3) == [
        [(0, 0, 3)], [(3, 0, 3)], [(3, 3, 4)], [(1, 0, 2), (4, 0, 1)]]
    assert diff.row_groups(items, 100) == [
        [(0, 0, 3), (3, 0, 4)], [(1, 0, 2), (4, 0, 1)]]
    assert diff.row_groups([("a", 0)], 2) == []


# --------------------------------------------------------------------------- #
# the restore: one scatter per DIFF link and device
# --------------------------------------------------------------------------- #

BB = 256


def _state(rng):
    return {"a": (rng.randn(40, 33) * 10).astype(np.float32),
            "b": (rng.randn(513) * 10).astype(ml_dtypes.bfloat16),
            "c": rng.randint(0, 256, 1001).astype(np.uint8),
            "d": rng.randn(7).astype(np.float32),
            "e": np.zeros((0,), np.float32)}


def _touch(st, rng, n):
    out = {k: v.copy() for k, v in st.items()}
    out["a"].reshape(-1)[rng.choice(out["a"].size, n, replace=False)] += 1.0
    out["b"][-3:] += 1
    out["c"][rng.choice(1001, n, replace=False)] ^= 0x5A
    out["d"][-1] -= 2.0
    return out


def _write(d, links):
    """FULL, then ``links`` DIFFs touching every leaf but the empty one →
    the final state."""
    rng = np.random.RandomState(7)
    st = _state(rng)
    ctx = CheckpointContext(CheckpointConfig(
        dir=d, backend="fti", block_bytes=BB, objstore=False,
        dedicated_thread=False))
    ctx.store({k: numpy_to_tensor(v) for k, v in st.items()}, id=1, level=1)
    for i in range(links):
        st = _touch(st, rng, 20 + 10 * i)
        rep = ctx.store({k: numpy_to_tensor(v) for k, v in st.items()},
                        id=2 + i, level=1, kind=CHK_DIFF)
        assert rep.kind == CHK_DIFF
    ctx.shutdown()
    return st


def _spy(monkeypatch):
    calls = []
    real = ops.unpack_dirty_many

    def spy(leaves, idxs, packed, bb):
        calls.append((len(leaves), sum(int(i.size) for i in idxs)))
        return real(leaves, idxs, packed, bb)

    monkeypatch.setattr(ops, "unpack_dirty_many", spy)
    return calls


def _restore_jax(d, names):
    ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
        dir=d, backend="fti", objstore=False))
    z = _state(np.random.RandomState(7))
    got = ctx.load({k: jnp.zeros_like(jnp.asarray(z[k])) for k in names})
    assert ctx.restarted
    ctx.shutdown()
    return {k: np.asarray(v) for k, v in got.items()}


def _link_rows(root):
    """The dirty rows of each DIFF container under ``root``, in id
    order."""
    out = []
    for path in sorted(root.rglob("ckpt-*/*.chk5"),
                       key=lambda p: int(p.parent.name.split("-")[1])):
        rd = CHK5Reader(str(path))
        n = [int(rd.read_dataset(ds).size) for ds in rd.datasets()
             if ds.startswith("delta/") and ds.endswith("/idx")]
        rd.close()
        if n:
            out.append(sum(n))
    return out


@pytest.mark.parametrize("cap_rows", [1, 3, 1000])
def test_replay_by_row_groups_equals_numpy_replay_and_jax_restore(
        tmp_path, monkeypatch, cap_rows):
    """With MAX_PACK_BYTES small a link's rows span several groups: one
    unpack per group (on the one device here), none above the cap, and the
    leaves end with the bytes of the numpy replay, of the JAX package's
    restore and of the final state."""
    d = str(tmp_path / "ck")
    final = _write(d, links=2)
    link_rows = _link_rows(tmp_path / "ck")
    assert len(link_rows) == 2 and min(link_rows) > 3
    eng = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
    host, _ = eng.tcl.backend.engine.load_latest()
    monkeypatch.setattr(diff, "MAX_PACK_BYTES", cap_rows * BB)
    calls = _spy(monkeypatch)
    dev, meta = eng.tcl.backend.engine.load_latest(
        devices={k: torch.device("cpu") for k in final})
    eng.shutdown()
    assert meta["id"] == 3
    assert len(calls) == sum(-(-n // cap_rows) for n in link_rows)
    assert sum(r for _, r in calls) == sum(link_rows)
    assert max(r for _, r in calls) <= cap_rows
    ref = _restore_jax(d, list(final))
    for k, v in final.items():
        assert isinstance(dev[k], torch.Tensor), k
        got = tensor_to_numpy(dev[k]).tobytes()
        assert got == host[k].tobytes() == ref[k].tobytes() == v.tobytes(), k


def test_load_latest_scatters_once_per_diff_link_not_per_leaf(tmp_path,
                                                              monkeypatch):
    """FULL + three DIFFs touching four leaves each: three unpack calls,
    each over the four leaves, into tensors equal to the final state."""
    d = str(tmp_path / "ck")
    final = _write(d, links=3)
    calls = _spy(monkeypatch)
    eng = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
    dev, meta = eng.tcl.backend.engine.load_latest(
        devices={k: torch.device("cpu") for k in final})
    eng.shutdown()
    assert meta["id"] == 4
    assert [n for n, _ in calls] == [4, 4, 4]
    for k, v in final.items():
        assert tensor_to_numpy(dev[k]).tobytes() == v.tobytes(), k

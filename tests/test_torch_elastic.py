"""Elastic restore on the port (the elastic tests of the JAX package's
tests/test_async_data_reshard.py): axis-0 rank files saved under one world
size restore any new world's rank slices, and ``ft.elastic`` rescales a
committed checkpoint whose rows a new world splits raggedly."""
import numpy as np

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # container without hypothesis: tiny shim
    from _hypothesis_fallback import given, settings, st

from repro_torch.core.resharding import ElasticLoader, save_sharded, shard_bounds


def _write_shards(tmp_path, world, arrays):
    files = []
    for r in range(world):
        named, offs, gshapes = {}, {}, {}
        for name, arr in arrays.items():
            lo, hi = shard_bounds(arr.shape[0], world, r)
            named[name] = arr[lo:hi]
            offs[name] = lo
            gshapes[name] = list(arr.shape)
        p = str(tmp_path / f"rank{r}.chk5")
        save_sharded(p, named, offs, gshapes, {"world": world})
        files.append(p)
    return files


@settings(max_examples=8, deadline=None)
@given(w1=st.integers(1, 6), w2=st.integers(1, 6),
       rows=st.integers(1, 40), seed=st.integers(0, 100))
def test_elastic_restore_any_world_change(tmp_path_factory, w1, w2, rows, seed):
    tmp = tmp_path_factory.mktemp("el")
    rng = np.random.RandomState(seed)
    arrays = {
        "w": rng.randn(rows, 3).astype(np.float32),
        "m": rng.randn(rows).astype(np.float32),
    }
    files = _write_shards(tmp, w1, arrays)
    loader = ElasticLoader(files)
    for name, arr in arrays.items():
        parts = [loader.read_for_rank(name, w2, r) for r in range(w2)]
        got = np.concatenate(parts, axis=0)
        np.testing.assert_array_equal(got, arr)
    loader.close()


def test_elastic_restore_function(tmp_path):
    from repro_torch.core.resharding import elastic_restore
    arrays = {"w": np.arange(24, dtype=np.float32).reshape(12, 2)}
    _write_shards(tmp_path, 4, arrays)
    got = [elastic_restore(str(tmp_path), 3, r)["w"] for r in range(3)]
    np.testing.assert_array_equal(np.concatenate(got), arrays["w"])


def test_rescale_restore_of_a_committed_checkpoint_ragged(tmp_path):
    """``rescale_restore`` finds the newest committed id across roots and
    gives each rank of a new world 3 its ragged rows of a world-4 save."""
    from repro_torch.core import manifest as mf
    from repro_torch.ft.elastic import rescale_restore
    root = str(tmp_path / "global")
    g = np.random.default_rng(0).normal(size=(22, 6)).astype(np.float32)
    for ckpt_id, arr in ((1, g * 0), (2, g)):
        d = mf.begin(root, ckpt_id)
        for r in range(4):
            lo, hi = shard_bounds(22, 4, r)
            save_sharded(f"{d}/rank{r}.chk5", {"g": arr[lo:hi]}, {"g": lo},
                         {"g": [22, 6]})
        mf.write_manifest(root, ckpt_id, {"kind": "FULL", "level": 4,
                                          "world": 4})
        mf.commit(root, ckpt_id, keep_last=10)
    rows = []
    for rank in range(3):
        named, ckpt_id = rescale_restore([root], 3, rank)
        assert ckpt_id == 2
        lo, hi = shard_bounds(22, 3, rank)
        assert named["g"].shape == (hi - lo, 6)
        rows.append(named["g"])
    assert [len(r) for r in rows] == [8, 7, 7]
    assert np.concatenate(rows).tobytes() == g.tobytes()
    assert rescale_restore([str(tmp_path / "none")], 2, 0) is None

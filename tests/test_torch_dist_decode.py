"""Sequence-sharded KV decode on the CPU: a mirror of
``tests/test_distributed_decode.py`` on the reference's (8, 1) mesh,
eight gloo processes in one world.

The reference (reduced tinyllama-1.1b, parameters from ``PRNGKey(0)``)
warms a 64-slot cache with 16 tokens on one device and decodes the 17th
with the cache sharded along its sequence over the 8 ranks: GSPMD's
partial-softmax combine must match the single-device step within its
tolerance (``rtol=5e-2, atol=2e-2``: bf16 activations and another
reduction order), and must be all-reduces, not a gather of the cache.

The port runs the same steps on the same numpy parameters and tokens:
the single-device decode (held to the reference's logits here), the 17th
step over the cache sharded by ``cache_shardings(seq_axis_sharded=True)``
after the single-device warm-up, and a decode sharded from position 0
(its writes land on the first three ranks' shards, the others' slots all
masked).  One sharded step's collectives are recorded.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

SLOTS, WARM, WORLD = 64, 16, 8
RTOL, ATOL = 5e-2, 2e-2                 # the reference's


def _worker(d: str) -> None:
    from repro_torch.configs import get_arch
    from repro_torch.core.protect import (flatten_named, from_numpy_named,
                                          unflatten_named)
    from repro_torch.core.resharding import reshard_tree
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharding import cache_shardings
    from repro_torch.launch.dryrun import CollectiveRecorder
    from repro_torch.launch.mesh import join_from_env, leave, make_mesh
    from repro_torch.models.zoo import build_model

    rank, _, _, _ = join_from_env("cpu")
    mesh = make_mesh((WORLD, 1), ("data", "model"), "cpu")
    model = build_model(get_arch("tinyllama-1.1b").reduced())
    with np.load(f"{d}/params.npz") as z:
        params = unflatten_named(from_numpy_named(dict(z)),
                                 model.param_struct())
    toks = torch.from_numpy(np.load(f"{d}/tokens.npy"))

    def seq_sharded(caches):
        return reshard_tree(caches, cache_shardings(
            mesh, model.cache_struct(1, SLOTS), 1, seq_axis_sharded=True,
            protects=model.cache_protects()))

    res = {"rank": rank}
    with torch.no_grad():
        caches = model.init_caches(1, SLOTS, device="cpu")
        plain = []
        for i in range(WARM + 1):
            if i == WARM:
                warm = seq_sharded(caches)     # the reference's warm cache
            logits, caches = model.decode_step(params, toks[:, i:i + 1],
                                               caches, i)
            plain.append(logits.float().numpy())
        with use_mesh(mesh):
            rec = CollectiveRecorder()
            with rec:
                got, _ = model.decode_step(params, toks[:, WARM:WARM + 1],
                                           warm, WARM)
            sharded = [got.full_tensor().float().numpy()]
            cold = seq_sharded(model.init_caches(1, SLOTS, device="cpu"))
            from_zero = []
            for i in range(WARM + 1):
                logits, cold = model.decode_step(params, toks[:, i:i + 1],
                                                 cold, i)
                from_zero.append(logits.full_tensor().float().numpy())
        leaf = flatten_named(cold)
        res.update(
            collectives=rec.counts,
            gathers=[g for g in rec.details if g[0] == "all-gather"],
            cache_shapes=[list(x.shape) for x in leaf.values()],
            placements={k: [repr(q) for q in x.placements]
                        for k, x in leaf.items()},
            local_slots=[int(x.to_local().shape[2]) for x in leaf.values()],
            # the sharded-from-zero cache against the plain one, per layer
            # (layer 0's rows depend on the tokens alone)
            cache_close=[[bool(torch.equal(x.full_tensor()[0], y[0]))] + [
                bool(torch.allclose(x.full_tensor()[g].float(),
                                    y[g].float(), rtol=RTOL, atol=ATOL))
                for g in range(1, x.shape[0])]
                for x, y in zip(leaf.values(),
                                flatten_named(caches).values())])
    if rank == 0:
        np.savez(f"{d}/logits.npz", plain=np.stack(plain),
                 sharded=np.stack(sharded), from_zero=np.stack(from_zero))
    with open(f"{d}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    leave()


@pytest.fixture(scope="module")
def decode_world(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.core.protect import flatten_named as jflatten
    from repro.models.zoo import build_model as jbuild

    d = str(tmp_path_factory.mktemp("dist_decode"))
    cfg = jget_arch("tinyllama-1.1b").reduced()
    m = jbuild(cfg)
    params = m.init(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, WARM + 1), 0,
                              cfg.vocab_size, jnp.int32)
    caches = m.init_caches(1, SLOTS)
    ref = []
    for i in range(WARM + 1):
        logits, caches = m.decode_step(params, toks[:, i:i + 1], caches,
                                       jnp.int32(i))
        ref.append(np.asarray(logits, np.float32))
    named, _ = jflatten(params)
    np.savez(f"{d}/params.npz", **{k: np.asarray(v)
                                   for k, v in named.items()})
    np.save(f"{d}/tokens.npy", np.asarray(toks))
    e = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), __file__, d],
        cwd=ROOT, env=e, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-5000:]
    with np.load(f"{d}/logits.npz") as z:
        got = {k: z[k] for k in z.files}
    return np.stack(ref), got, [json.load(open(f"{d}/rank{i}.json"))
                                for i in range(WORLD)]


def test_single_device_decode_matches_reference(decode_world):
    """The port's single-device decode of all 17 tokens against the
    reference's, within the reference's tolerance."""
    ref, got, _ = decode_world
    np.testing.assert_allclose(got["plain"], ref, rtol=RTOL, atol=ATOL)


def test_seq_sharded_decode_matches_single_device(decode_world):
    """The 17th step over the warm cache sharded 8 ways along its
    sequence matches the single-device step, and the reference's."""
    ref, got, ranks = decode_world
    np.testing.assert_allclose(got["sharded"][0], got["plain"][WARM],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["sharded"][0], ref[WARM], rtol=RTOL,
                               atol=ATOL)
    for r in ranks:
        # the cache-seq dim (2 of (L, B, C, KV, dh)) on data
        assert all(p[0] == "Shard(dim=2)"
                   for p in r["placements"].values()), r["placements"]
        assert r["local_slots"] == [SLOTS // WORLD] * 2


def test_combine_is_all_reduces_not_a_cache_gather(decode_world):
    """The combine's collectives are all-reduces (the maximum, the sum of
    exponentials, the weighted values: three per layer), and no
    all-gather rebuilds a cache leaf or one layer of it."""
    _, _, ranks = decode_world
    n_layers = 2
    for r in ranks:
        assert r["collectives"].get("all-reduce", 0) >= 3 * n_layers, r
        cache = set()
        for shape in r["cache_shapes"]:
            cache.add(tuple(shape))
            cache.add(tuple(shape[1:]))
        for op, nbytes, group, shape in r["gathers"]:
            assert tuple(shape) not in cache, (shape, r["gathers"])
            assert np.prod(shape) < np.prod(r["cache_shapes"][0][2:]), shape


def test_seq_sharded_decode_from_position_zero(decode_world):
    """Every step decoded over a sharded cache from position 0 (writes on
    the shards of ranks 0–2; the others' slots masked) matches the
    single-device step.  The cache it leaves: layer 0's K and V rows (the
    tokens' alone) bit for bit the plain cache's, the next layer's within
    the tolerance (they follow the combine's rounding)."""
    _, got, ranks = decode_world
    np.testing.assert_allclose(got["from_zero"], got["plain"], rtol=RTOL,
                               atol=ATOL)
    for r in ranks:
        assert all(all(layers) for layers in r["cache_close"]), r


if __name__ == "__main__":
    _worker(sys.argv[1])

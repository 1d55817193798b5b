"""Sharded execution on the CPU: the port's models and train step on
``DTensor`` parameters and batches over a (data 2, model 2) mesh of four
gloo processes, held to the JAX package on one device.

- One gloo world (a module fixture) runs every check's sharded half: each
  family ``build_model`` builds (dense GQA, vision prefix, MoE, MLA,
  RWKV6, the Mamba hybrid, the encoder-decoder), reduced, f32 compute,
  forward on parameters laid out by ``param_shardings``; and two train
  steps of a reduced tinyllama under each ``train_state_shardings`` knob
  (``zero1``, ``fsdp``, ``dp_only``).  The reference runs here, in the
  test process, on the same numpy parameters and batches.
- Each forward's collectives are recorded: no all-gather may carry a
  whole parameter (a silent gather); where the port replicates a
  parameter on purpose (FSDP's weight gather) the test names it.
- The hint layer's call counts per forward and per decode step equal the
  reference's, counted by patching both packages (one layer group, so
  the reference's scan body is traced once, as the port runs one group).

Tolerances: a family's forward is held to its existing port-to-reference
bound (f32 logits within 2e-5); losses and gradient norms within 1e-5
relative; parameters as stated in the train test.
"""
import dataclasses
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

from repro_torch.configs import get_arch  # noqa: E402

FAMILIES = ["tinyllama-1.1b", "internvl2-1b", "granite-moe-3b-a800m",
            "minicpm3-4b", "rwkv6-3b", "jamba-1.5-large-398b",
            "whisper-small"]
KNOBS = ["zero1", "fsdp", "dp_only"]
#: B·S (192 tokens, 96 per data shard) matches no parameter dim, so a
#: gathered activation never has a parameter's shape
B, S = 4, 48
TRAIN_STEPS = 2
LR_WARMUP, LR_TOTAL = 1, 10


def _cfg(arch: str, **kw):
    return dataclasses.replace(get_arch(arch).reduced(),
                               compute_dtype="float32", **kw)


def _seeded(named: dict, seed: int) -> dict:
    """Every floating leaf perturbed by seeded noise at its own scale, so
    no leaf is zero (the reference's init zeros several SSM leaves)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(named):
        v = np.asarray(named[k])
        if v.dtype.kind != "f":
            out[k] = v
            continue
        v32 = v.astype(np.float32)
        scale = float(v32.std()) or 0.2
        out[k] = (v32 + 0.5 * scale * rng.randn(*v.shape)).astype(np.float32)
    return out


def _batch(cfg, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encdec:
        out["frames"] = (rng.randn(B, S, cfg.d_model) * 0.5).astype(
            np.float32)
    if cfg.n_frontend_tokens:
        p = cfg.n_frontend_tokens
        out["patch_embeds"] = (rng.randn(B, p, cfg.d_model) * 0.5).astype(
            np.float32)
        out["tokens"] = out["tokens"][:, :S - p]
    return out


# --------------------------------------------------------------------------- #
# the sharded half: four gloo processes
# --------------------------------------------------------------------------- #


def _worker(d: str) -> None:
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core.protect import (flatten_named, from_numpy_named,
                                          unflatten_named)
    from repro_torch.core.resharding import reshard_tree
    from repro_torch.data.synthetic import data_state_struct, init_data_state
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharding import (batch_sharding, param_shardings,
                                           train_state_shardings)
    from repro_torch.launch.dryrun import CollectiveRecorder
    from repro_torch.launch.mesh import join_from_env, leave, make_mesh
    from repro_torch.models.zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.state import (init_sharded_train_state, prng_key,
                                         train_state_struct)
    from repro_torch.train.step import make_train_step

    rank, _, _, _ = join_from_env("cpu")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")

    def load(path, struct):
        with np.load(path) as z:
            return unflatten_named(from_numpy_named(dict(z)), struct)

    def batch_of(path):
        with np.load(path) as z:
            b = {k: torch.from_numpy(z[k]) for k in z.files}
        return reshard_tree(b, {k: batch_sharding(mesh, v.ndim)
                                for k, v in b.items()})

    res = {}
    for arch in FAMILIES:
        model = build_model(_cfg(arch))
        struct = model.param_struct()
        params = reshard_tree(load(f"{d}/{arch}.params.npz", struct),
                              param_shardings(mesh, struct))
        batch = batch_of(f"{d}/{arch}.batch.npz")
        batch.pop("labels")
        rec, comm = CollectiveRecorder(), CommDebugMode()
        with use_mesh(mesh), rec, comm:
            logits, aux = model.forward(params, batch)
        logits = logits.full_tensor()
        aux = aux.full_tensor() if hasattr(aux, "full_tensor") else aux
        if rank == 0:
            np.save(f"{d}/{arch}.logits.npy", logits.numpy())
        res[arch] = {"aux": float(aux), "collectives": rec.counts,
                     "comm_debug": {str(k): v for k, v in
                                    comm.get_comm_counts().items()},
                     "gathers": [g for g in rec.details
                                 if g[0] == "all-gather"],
                     "sharded_params": {
                         k: list(x.shape) for k, x in
                         flatten_named(params).items()
                         if any(q.is_shard() for q in x.placements)}}

    model = build_model(_cfg("tinyllama-1.1b"))
    for knob in KNOBS:
        struct = train_state_struct(model.param_struct(), data_state_struct())
        sh = train_state_shardings(mesh, struct, zero1=knob == "zero1",
                                   fsdp=knob == "fsdp",
                                   dp_only=knob == "dp_only")
        state = init_sharded_train_state(
            load(f"{d}/train.params.npz", model.param_struct()), sh,
            prng_key(1), init_data_state(0))
        step = make_train_step(model, AdamWConfig(
            warmup_steps=LR_WARMUP, total_steps=LR_TOTAL), remat=True)
        batch = batch_of(f"{d}/train.batch.npz")
        mets = []
        with use_mesh(mesh):
            for _ in range(TRAIN_STEPS):
                state, met = step(state, batch)
                mets.append({k: float(v) for k, v in met.items()})
        full = {k: x.full_tensor().numpy()
                for k, x in flatten_named(state.params).items()}
        if rank == 0:
            np.savez(f"{d}/train.{knob}.npz", **full)
        res["train-" + knob] = {
            "metrics": mets,
            "mu": {k: [repr(q) for q in x.placements] for k, x in
                   flatten_named(state.opt.mu).items()},
            "params": {k: [repr(q) for q in x.placements] for k, x in
                       flatten_named(state.params).items()}}
    with open(f"{d}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    leave()


def _run_world(n: int, d: str):
    e = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), __file__, d],
        cwd=ROOT, env=e, capture_output=True, text=True, timeout=240)


# --------------------------------------------------------------------------- #
# the reference half, in this process
# --------------------------------------------------------------------------- #


def _ref_params(arch: str, seed: int = 0):
    import jax
    from repro.configs import get_arch as jget_arch
    from repro.core.protect import flatten_named as jflatten
    from repro.models.zoo import build_model as jbuild

    jcfg = dataclasses.replace(jget_arch(arch).reduced(),
                               compute_dtype="float32")
    jmodel = jbuild(jcfg)
    named, jdef = jflatten(jmodel.init(jax.random.PRNGKey(seed)))
    vals = _seeded({k: np.asarray(v) for k, v in named.items()}, seed + 100)
    jparams = jax.tree_util.tree_unflatten(
        jdef, [jax.numpy.asarray(vals[k]) for k in named])
    return jmodel, jparams, vals


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded"))
    for arch in FAMILIES:
        _, _, vals = _ref_params(arch)
        np.savez(f"{d}/{arch}.params.npz", **vals)
        np.savez(f"{d}/{arch}.batch.npz", **_batch(_cfg(arch), 5))
    _, _, vals = _ref_params("tinyllama-1.1b", seed=3)
    np.savez(f"{d}/train.params.npz", **vals)
    np.savez(f"{d}/train.batch.npz", **_batch(_cfg("tinyllama-1.1b"), 9))
    r = _run_world(4, d)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-5000:]
    return d, [json.load(open(f"{d}/rank{i}.json")) for i in range(4)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_forward_matches_reference(world, arch):
    """Each family's forward on (2, 2) ``DTensor`` parameters: logits
    within 2e-5 of the reference's single-device forward on the same
    numpy parameters and batch (every family's f32 port-to-reference
    bound); the MoE aux loss within 1e-6 relative, on every rank."""
    import jax.numpy as jnp
    d, ranks = world
    jmodel, jparams, _ = _ref_params(arch)
    with np.load(f"{d}/{arch}.batch.npz") as z:
        batch = {k: jnp.asarray(z[k]) for k in z.files if k != "labels"}
    want, jaux = jmodel.forward(jparams, batch)
    got = np.load(f"{d}/{arch}.logits.npy")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)
    for r in ranks:
        np.testing.assert_allclose(r[arch]["aux"], float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_forward_gathers_no_whole_parameter(world, arch):
    """No all-gather of the forward rebuilds a parameter the mesh shards:
    no gathered tensor has the shape of such a leaf, or of one layer of
    it, in any order of its dims (what the forward gathers are
    activations: the rows of a head split that does not divide, the
    vocab of the logits for the argmax).  Collectives ran (the layouts
    are real) and every rank saw the same ones."""
    _, ranks = world
    got = ranks[0][arch]
    assert got["collectives"].get("all-reduce", 0) > 0, got["collectives"]
    forbidden = set()
    for shape in got["sharded_params"].values():
        forbidden.add(tuple(sorted(shape)))
        forbidden.add(tuple(sorted(shape[1:])))
    for op, nbytes, group, shape in got["gathers"]:
        assert tuple(sorted(shape)) not in forbidden, (arch, shape, group)
    assert all(r[arch]["collectives"] == got["collectives"] for r in ranks)


@pytest.mark.parametrize("knob", KNOBS)
def test_sharded_train_steps_match_reference(world, knob):
    """Two steps of a reduced tinyllama under each knob against the
    reference's ``make_train_step`` (f32, remat, one device): losses and
    gradient norms within 1e-5 relative.  Parameters: AdamW's first steps
    move a weight by about lr·sign(g) (lr 3e-4 here), so a gradient near
    zero whose sign depends on the reduction order (the shards sum in
    another order than one device) moves its weight the other way; every
    weight within 2e-5 but for at most 0.1 % of a leaf, and those within
    4·lr (two steps, each at most lr the other way)."""
    import jax
    from repro.train.optimizer import AdamWConfig as JAdamW
    from repro.train.state import init_train_state as jinit
    from repro.train.step import make_train_step as jstep
    from repro.core.protect import flatten_named as jflatten

    d, ranks = world
    jmodel, jparams, _ = _ref_params("tinyllama-1.1b", seed=3)
    with np.load(f"{d}/train.batch.npz") as z:
        batch = {k: jax.numpy.asarray(z[k]) for k in z.files}
    from repro.data.synthetic import init_data_state as jdata
    state = jinit(jparams, jax.random.PRNGKey(1), jdata(0))
    step = jax.jit(jstep(jmodel, JAdamW(warmup_steps=LR_WARMUP,
                                        total_steps=LR_TOTAL), remat=True))
    want = []
    for _ in range(TRAIN_STEPS):
        state, met = step(state, batch)
        want.append({k: float(v) for k, v in met.items()})
    jnamed, _ = jflatten(state.params)
    lr = 3e-4
    for r in ranks:
        got = r["train-" + knob]["metrics"]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-5)
    with np.load(f"{d}/train.{knob}.npz") as z:
        for k, v in jnamed.items():
            diff = np.abs(z[k] - np.asarray(v))
            assert diff.max() <= 4 * lr, (knob, k, diff.max())
            assert (diff > 2e-5).mean() <= 1e-3, (knob, k,
                                                   (diff > 2e-5).sum())


def test_train_layouts_are_the_knobs(world):
    """The state the step returns keeps the knob's layout: ZeRO-1 moments
    sharded over data where the parameters are not; FSDP parameters
    sharded over data; dp-only parameters and moments replicated (the
    reference augments moments only under ZeRO-1)."""
    _, ranks = world
    r = ranks[0]
    wq = "groups/0/attn/wq"
    assert r["train-zero1"]["params"][wq] == ["Replicate()", "Shard(dim=2)"]
    assert r["train-zero1"]["mu"][wq][0].startswith("Shard")
    assert r["train-fsdp"]["params"][wq][0].startswith("Shard")
    assert r["train-dp_only"]["params"][wq] == ["Replicate()", "Replicate()"]
    assert r["train-dp_only"]["mu"][wq] == ["Replicate()", "Replicate()"]


# --------------------------------------------------------------------------- #
# hint call counts (one process, no mesh: hints are the identity)
# --------------------------------------------------------------------------- #

_HINT_MODULES = ("models.attention", "models.transformer", "models.encdec")


def _count_calls(monkeypatch, package: str) -> dict:
    import importlib
    counts = {"shard_hint": 0, "shard_decode_kv": 0}
    for mod in _HINT_MODULES:
        m = importlib.import_module(f"{package}.{mod}")
        for name in counts:
            if hasattr(m, name):
                orig = getattr(m, name)

                def wrapped(*a, _orig=orig, _name=name, **kw):
                    counts[_name] += 1
                    return _orig(*a, **kw)
                monkeypatch.setattr(m, name, wrapped)
    return counts


def _one_group(arch: str) -> dict:
    cfg = get_arch(arch).reduced()
    n = len(cfg.hybrid_pattern) if cfg.hybrid_pattern else 1
    return {"n_layers": n}


@pytest.mark.parametrize("arch", FAMILIES)
def test_hint_calls_per_forward_and_decode_step_equal_reference(
        monkeypatch, arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.models.zoo import build_model as jbuild
    from repro_torch.models.zoo import build_model

    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    kw = _one_group(arch)
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    b = {k: v for k, v in _batch(cfg, 1).items() if k != "labels"}
    jm, m = jbuild(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = m.init(torch.Generator().manual_seed(0))

    jc = _count_calls(monkeypatch, "repro")
    jm.forward(jp, {k: jnp.asarray(v) for k, v in b.items()})
    want_fwd = dict(jc)
    jcaches = jm.init_caches(2, 16)
    jc.update(shard_hint=0, shard_decode_kv=0)
    jm.decode_step(jp, jnp.zeros((2, 1), jnp.int32), jcaches, jnp.int32(0))
    want_dec = dict(jc)

    pc = _count_calls(monkeypatch, "repro_torch")
    m.forward(p, {k: torch.from_numpy(v) for k, v in b.items()})
    got_fwd = dict(pc)
    caches = m.init_caches(2, 16, device="cpu")
    pc.update(shard_hint=0, shard_decode_kv=0)
    m.decode_step(p, torch.zeros((2, 1), dtype=torch.int32), caches, 0)
    got_dec = dict(pc)
    assert got_fwd == want_fwd and got_dec == want_dec, (
        arch, got_fwd, want_fwd, got_dec, want_dec)
    assert sum(got_fwd.values()) > 0


def test_batched_prefill_fills_the_cache_as_sequential_decode():
    """``lm_prefill`` (one pass over the prompt, the decode world's
    prefill on the card) against the sequential prefill (one decode step a
    token, the reference's): the same cache rows and last logits within
    f32 rounding (2e-5), slots past the prompt untouched."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.zoo import build_model
    cfg = _cfg("tinyllama-1.1b")
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_batch(cfg, 2)["tokens"][:2, :24])
    seq = m.init_caches(2, 40, device="cpu")
    for i in range(toks.shape[1]):
        want, seq = m.decode_step(p, toks[:, i:i + 1], seq, i)
    caches = m.init_caches(2, 40, device="cpu")
    got = tf.lm_prefill(p, toks, caches, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    for a, b in zip(caches[0], seq[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)
        assert not a[:, :, 24:].any()


if __name__ == "__main__":
    _worker(sys.argv[1])

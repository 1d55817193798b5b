"""The port's checkpointed training against the JAX package, on the CPU.

- A ``TrainState`` checkpoint crosses the packages in both directions, bit
  for bit: a NamedTuple's leaves are named by field, as jax names them.
- The threefry key arithmetic (``PRNGKey``, ``fold_in``) equals jax's.
- One ``make_train_step`` step on the same weights and batch (f32 compute)
  gives the reference's parameters, moments and loss within 1e-6.
- train → kill → resume ends bit-equal to an uninterrupted run, through
  the flash attention path (``REPRO_ATTN_IMPL=flash``).

Inputs are numpy arrays from a seed, handed to both packages; weights
cross with ``from_numpy_named`` onto the port's own template.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import context as jctx
from repro.core.protect import flatten_named as jflatten
from repro.core.protect import resolve_specs as jresolve_specs
from repro.data.synthetic import init_data_state as jinit_data_state
from repro.models.zoo import build_model as jbuild_model
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.state import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_arch
from repro_torch.core.context import (CheckpointConfig, CheckpointContext,
                                      Protect)
from repro_torch.core.protect import (flatten_named, from_numpy_named,
                                      resolve_specs, to_host,
                                      unflatten_named)
from repro_torch.data.synthetic import DataState, init_data_state, next_batch
from repro_torch.ft.failures import FaultInjector, SimulatedFault
from repro_torch.kernels import ops
from repro_torch.models.zoo import build_model
from repro_torch.train.loop import LevelSchedule, LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.state import (TrainState, fold_in, init_train_state,
                                     prng_key)
from repro_torch.train.step import make_train_step

ARCH = "tinyllama-1.1b"


def _jax_state(cfg, seed=0):
    m = jbuild_model(cfg)
    return jinit_train_state(m.init(jax.random.PRNGKey(seed)),
                             jax.random.PRNGKey(seed + 1),
                             jinit_data_state(seed))


def _torch_state(cfg, seed=0):
    m = build_model(cfg)
    return init_train_state(m.init(torch.Generator().manual_seed(seed)),
                            prng_key(seed + 1), init_data_state(seed))


def _random_leaves(named_np, seed):
    """Every leaf replaced by seeded random values of its shape and dtype."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in named_np.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            out[k] = rng.randn(*v.shape).astype(v.dtype)
        else:
            out[k] = rng.randint(0, 2**31 - 1, size=v.shape).astype(v.dtype)
    return out


def _jax_named_np(jstate):
    named, _ = jflatten(jstate)
    return {k: np.asarray(v) for k, v in named.items()}


# --------------------------------------------------------------------------- #
# a TrainState checkpoint crosses the packages (NamedTuple leaf names)
# --------------------------------------------------------------------------- #

def test_trainstate_leaf_paths_equal_the_reference():
    cfg = jget_arch(ARCH).reduced()
    jnamed = _jax_named_np(_jax_state(cfg))
    tnamed = flatten_named(_torch_state(get_arch(ARCH).reduced()))
    assert list(tnamed) == list(jnamed)
    assert list(tnamed)[:3] == ["step", "params/embed",
                                "params/groups/0/attn/wk"]
    for k, v in tnamed.items():
        assert tuple(v.shape) == jnamed[k].shape, k
        assert to_host({k: v})[k].dtype == jnamed[k].dtype, k


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_trainstate_cross_reads_both_ways(tmp_path, writer):
    """A reduced-tinyllama TrainState stored by one package (FTI, level 1)
    restores bit for bit into the other package's own template."""
    d = str(tmp_path / "ck")
    jstate = _jax_state(jget_arch(ARCH).reduced())
    tstate = _torch_state(get_arch(ARCH).reduced())
    jnamed, jdef = jflatten(jstate)
    want = _random_leaves({k: np.asarray(v) for k, v in jnamed.items()}, 7)

    if writer == "jax":
        jx = jax.tree_util.tree_unflatten(
            jdef, [jnp.asarray(want[k]) for k in jnamed])
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
            dir=d, backend="fti", objstore=False, dedicated_thread=False))
        ctx.store(jx, id=3, level=1)
        ctx.shutdown()
        ctx = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
        got = ctx.load(tstate)
        assert ctx.restarted and isinstance(got, TrainState)
        assert isinstance(got.data_state, DataState)
        got_np = to_host(flatten_named(got))
    else:
        tx = unflatten_named(from_numpy_named(want), tstate)
        ctx = CheckpointContext(CheckpointConfig(
            dir=d, backend="fti", objstore=False, dedicated_thread=False))
        ctx.store(tx, id=3, level=1)
        ctx.shutdown()
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
            dir=d, objstore=False))
        got = ctx.load(jstate)
        assert ctx.restarted
        got_np = _jax_named_np(got)
    ctx.shutdown()
    assert list(got_np) == list(want)
    for k, v in want.items():
        assert got_np[k].dtype == v.dtype and got_np[k].shape == v.shape, k
        assert got_np[k].tobytes() == v.tobytes(), k


def test_protect_selects_the_reference_paths_on_a_trainstate(tmp_path):
    tstate = _torch_state(get_arch(ARCH).reduced())
    jnamed, _ = jflatten(_jax_state(jget_arch(ARCH).reduced()))
    for sel in ("params/**", "opt/mu/**", "data_state/*", "rng"):
        got = resolve_specs(flatten_named(tstate), [Protect(sel)])
        want = jresolve_specs(jnamed, [jctx.Protect(sel)])
        assert list(got) == list(want) and got, sel
    ctx = CheckpointContext(CheckpointConfig(dir=str(tmp_path / "p"),
                                             objstore=False))
    ctx.protect(Protect("params/**"), Protect("step"))
    ctx.store(tstate, id=1, level=1)
    ctx.shutdown()


def test_namedtuple_template_rebuilds_by_field_and_tuples_by_index():
    st = DataState(torch.tensor(5, dtype=torch.uint32),
                   torch.tensor(2, dtype=torch.int32))
    tree = {"d": st, "pair": (torch.ones(1), torch.zeros(1))}
    named = flatten_named(tree)
    assert list(named) == ["d/seed", "d/position", "pair/0", "pair/1"]
    back = unflatten_named(named, tree)
    assert isinstance(back["d"], DataState) and back["d"].seed is st.seed
    assert isinstance(back["pair"], tuple) and back["pair"][1] is \
        tree["pair"][1]


# --------------------------------------------------------------------------- #
# threefry keys
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5, 2**40 + 3])
def test_prng_key_and_fold_in_equal_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng_key(seed)
    assert key.dtype == torch.uint32
    assert np.array_equal(key.numpy(), np.asarray(jkey))
    for data in (0, 1, 12345, 2**32 - 1):
        want = np.asarray(jax.random.fold_in(jkey, data))
        assert np.array_equal(fold_in(key, data).numpy(), want), data
    # the per-step chain of the train step
    k, jk = key, jkey
    for _ in range(5):
        k, jk = fold_in(k, 0), jax.random.fold_in(jk, 0)
    assert np.array_equal(k.numpy(), np.asarray(jk))


# --------------------------------------------------------------------------- #
# data cursor
# --------------------------------------------------------------------------- #

def test_next_batch_is_a_pure_function_of_the_cursor():
    cfg = get_arch(ARCH).reduced()
    st = init_data_state(3)
    assert st.seed.dtype == torch.uint32 and st.position.dtype == torch.int32
    b1, st1 = next_batch(st, cfg, 2, 16)
    b1again, _ = next_batch(st, cfg, 2, 16)
    b2, st2 = next_batch(st1, cfg, 2, 16)
    assert int(st1.position) == 1 and int(st2.position) == 2
    assert torch.equal(b1["tokens"], b1again["tokens"])
    assert not torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert b1["tokens"].shape == (2, 16) and b1["tokens"].dtype == torch.int32
    assert int(b1["tokens"].max()) < cfg.vocab_size


# --------------------------------------------------------------------------- #
# one train step against the reference
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,attn_impl,microbatches,eps", [
    pytest.param(ARCH, "blockwise", 1, 1e-6, id="blockwise-1"),
    pytest.param(ARCH, "flash", 1, 1e-6, id="flash-1"),
    pytest.param(ARCH, "blockwise", 2, 1e-6, id="blockwise-2"),
    # the other dense archs: qkv bias; the vision stub's patch embeddings
    pytest.param("llama3.2-3b", "flash", 1, 1e-5, id="llama3.2-3b-flash-1"),
    pytest.param("codeqwen1.5-7b", "blockwise", 1, 1e-5,
                 id="codeqwen1.5-7b-blockwise-1"),
    pytest.param("internvl2-1b", "flash", 1, 1e-5,
                 id="internvl2-1b-flash-1"),
    # MLA: the naive form runs blockwise whatever REPRO_ATTN_IMPL says
    pytest.param("minicpm3-4b", "flash", 1, 1e-6,
                 id="minicpm3-4b-flash-1"),
    # RWKV6: the chunked WKV recurrence, no attention
    pytest.param("rwkv6-3b", "blockwise", 1, 1e-6,
                 id="rwkv6-3b-blockwise-1"),
    # the encoder-decoder: frames beside tokens, cross-attention, gelu,
    # tied logits
    pytest.param("whisper-small", "flash", 1, 1e-6,
                 id="whisper-small-flash-1")])
def test_train_step_matches_jax(monkeypatch, arch, attn_impl, microbatches,
                                eps):
    """Same weights, batch and f32 compute: new params, mu, nu within 1e-6
    of the reference, mu (a tenth of the clipped gradient) within 2e-8, the
    loss within 1e-6 relative (the packages sum in different orders; f32
    carries 6e-8), the step, count, cursor and rng bit for bit.  The
    reference runs its blockwise attention: its flash kernel has no
    gradient.

    Adam's eps is 1e-6 here, not the default 1e-8: the first step moves a
    weight by lr·g/(|g|+eps), which near |g| = eps turns a 1e-9 difference
    in g (f32 rounding of larger sums) into 4e-6 of weight.  The other
    dense archs run it at 1e-5: reduced codeqwen's embed has a gradient of
    7.8e-7, where a 2e-8 difference in g (mu within its 2e-8) moves the
    weight by 1.01e-6 at eps 1e-6."""
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    jcfg = dataclasses.replace(jget_arch(arch).reduced(),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              compute_dtype="float32")
    jstate = _jax_state(jcfg)
    opt = dict(total_steps=20, warmup_steps=2, eps=eps)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(4, 33)).astype(np.int32)
    batch_np = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_frontend_tokens:             # labels cover patches + text
        p = cfg.n_frontend_tokens
        batch_np["patch_embeds"] = (rng.randn(4, p, cfg.d_model)
                                    * 0.02).astype(np.float32)
        batch_np["labels"] = np.concatenate(
            [np.full((4, p), -1, np.int32), toks[:, 1:]], axis=1)
    if cfg.encdec:                        # frames as many as tokens
        batch_np["frames"] = (rng.randn(4, 32, cfg.d_model)
                              * 0.02).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jnew, jmet = jax.jit(jmake_train_step(
        jbuild_model(jcfg), JAdamWConfig(**opt), remat=False,
        num_microbatches=microbatches))(jstate, jbatch)
    want = _jax_named_np(jnew)

    monkeypatch.setenv("REPRO_ATTN_IMPL", attn_impl)
    tstate = unflatten_named(from_numpy_named(_jax_named_np(jstate)),
                             _torch_state(cfg))
    before = to_host(flatten_named(tstate))
    batch = {k: torch.from_numpy(v.copy()) for k, v in batch_np.items()}
    ops.reset_launch_counts()
    new, met = make_train_step(build_model(cfg), AdamWConfig(**opt),
                               remat=True, num_microbatches=microbatches)(
        tstate, batch)
    got = to_host(flatten_named(new))
    assert ops.launch_counts()["flashattn"] == 0       # CPU: plain version
    # functional: the input state is unchanged
    after = to_host(flatten_named(tstate))
    assert all(after[k].tobytes() == before[k].tobytes() for k in before)

    assert list(got) == list(want)
    for k in ("step", "rng", "opt/count", "data_state/seed",
              "data_state/position"):
        assert got[k].tobytes() == want[k].tobytes(), k
    for k, v in want.items():
        if k.startswith(("params/", "opt/mu/", "opt/nu/")):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)
        if k.startswith("opt/mu/"):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=2e-8,
                                       err_msg=k)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)


# --------------------------------------------------------------------------- #
# train → kill → resume (tests/test_restart.py, ported)
# --------------------------------------------------------------------------- #

def _setup(seed=0):
    cfg = get_arch(ARCH).reduced()
    m = build_model(cfg)
    state = _torch_state(cfg, seed)
    step = make_train_step(m, AdamWConfig(total_steps=20, warmup_steps=2),
                           remat=False)
    return cfg, m, state, step


def test_resume_is_bitwise_identical_through_flash(tmp_path, monkeypatch):
    """Train 10 straight vs train → crash at 7 → restore → finish, with
    REPRO_ATTN_IMPL=flash: identical final state, every leaf (exactly-once
    data via the in-state cursor)."""
    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    cfg, m, state0, step = _setup()
    loop = LoopConfig(total_steps=10, ckpt_every=3,
                      levels=LevelSchedule(l2_every=0, l3_every=0, l4_every=0))

    def ctx(name):
        return CheckpointContext(CheckpointConfig(
            dir=str(tmp_path / name), backend="fti", dedicated_thread=False,
            objstore=False))

    ctxa = ctx("a")
    out_a = run_training(m, step, state0, ctxa, loop, 2, 32,
                         log=lambda *_: None)
    ctxa.shutdown()

    ctxb = ctx("b")
    inj = FaultInjector(total_steps=10, at_progress=0.7)
    with pytest.raises(SimulatedFault):
        run_training(m, step, state0, ctxb, loop, 2, 32, injector=inj,
                     log=lambda *_: None)
    ctxb.shutdown()
    ctxb2 = ctx("b")
    out_b = run_training(m, step, state0, ctxb2, loop, 2, 32,
                         log=lambda *_: None)
    ctxb2.shutdown()
    assert out_b["restarted"] and not out_a["restarted"]

    a = flatten_named(out_a["state"])
    b = flatten_named(out_b["state"])
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(out_a["state"].data_state.position) == 10
    assert int(out_a["state"].step) == 10
    assert np.isfinite(out_a["loss"]) and out_a["loss"] == out_b["loss"]


def test_training_loop_advances_data_cursor(tmp_path):
    cfg, m, state, step = _setup()
    loop = LoopConfig(total_steps=4, ckpt_every=2,
                      levels=LevelSchedule(l2_every=0, l3_every=0, l4_every=0))
    ctx = CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / "c"), backend="fti", dedicated_thread=False,
        objstore=False))
    run_training(m, step, state, ctx, loop, 2, 32, log=lambda *_: None)
    ctx.shutdown()
    ctx2 = CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / "c"), backend="fti", dedicated_thread=False,
        objstore=False))
    restored = ctx2.load(state)
    assert ctx2.restarted
    assert int(restored.step) == 4
    assert int(restored.data_state.position) == 4
    ctx2.shutdown()

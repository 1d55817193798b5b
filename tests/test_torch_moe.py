"""The port's Mixture-of-Experts models against the JAX package, on the CPU.

- ``moe_mlp`` of ``repro_torch.models.moe`` against ``repro.models.moe``
  on the same inputs and parameters, both dispatches, f32; the capacity
  overflow (dropped tokens give the reference's zero rows) and the router's
  aux loss.
- Reduced granite-moe-3b-a800m and mixtral-8x7b: ``lm_forward`` (f32
  through either attention, and bf16), ``lm_decode_step``, one train step
  against ``repro.train.step``, and a MoE ``TrainState`` checkpoint that
  crosses the packages both ways bit for bit.
- The in-place AdamW update of a donated state (``adamw_update_``,
  ``make_train_step(donate=True)``) equals the functional one bit for bit
  over 3 steps.

Inputs are numpy arrays from a seed; parameters cross with
``from_numpy_named`` onto the port's own template.  Every tolerance is
stated where it is used.
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
from repro.data.synthetic import init_data_state as jinit_data_state
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.zoo import build_model as jbuild_model
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.state import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_arch
from repro_torch.core.context import CheckpointConfig, CheckpointContext
from repro_torch.core.protect import (flatten_named, from_numpy_named,
                                      to_host, unflatten_named)
from repro_torch.data.synthetic import init_data_state
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.zoo import build_model
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_init, adamw_update,
                                         adamw_update_, tree_leaves)
from repro_torch.train.state import init_train_state, prng_key
from repro_torch.train.step import make_train_step

MOE_ARCHS = ["granite-moe-3b-a800m", "mixtral-8x7b"]


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def np_of(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def _cfgs(arch, compute="float32", **moe_kw):
    """The reference's and the port's reduced config of ``arch``."""
    out = []
    for get in (jget_arch, get_arch):
        c = get(arch).reduced()
        out.append(dataclasses.replace(
            c, compute_dtype=compute,
            moe=dataclasses.replace(c.moe, **moe_kw)))
    return out


def _carried(jcfg, cfg, seed=0):
    """Reference params from a key → the same bytes in the port's layout."""
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    named, _ = jflatten(jparams)
    tmpl = build_model(cfg).init(torch.Generator().manual_seed(seed))
    return jparams, unflatten_named(
        from_numpy_named({k: np.asarray(v) for k, v in named.items()}), tmpl)


def _moe_params(jcfg, cfg, seed=0):
    """One MoE layer's parameters in both packages (the same bytes)."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: t(np.asarray(v)) for k, v in jp.items()}


# --------------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------------- #

def test_moe_param_layout_equals_reference():
    """Leaf paths, shapes and dtypes of a reduced granite's parameters:
    ``params/groups/0/moe/{router, moe_w_gate, moe_w_up, moe_w_down}``
    stacked on axis 0."""
    for arch in MOE_ARCHS:
        jcfg, cfg = _cfgs(arch)
        jnamed, _ = jflatten(jax.eval_shape(
            lambda: jtf.init_lm(jax.random.PRNGKey(0), jcfg)))
        named = flatten_named(tf.init_lm(torch.Generator().manual_seed(0),
                                         cfg))
        assert list(named) == list(jnamed)
        assert "groups/0/moe/moe_w_gate" in named and \
            "groups/0/mlp/w_gate" not in named
        for k, v in named.items():
            assert tuple(v.shape) == jnamed[k].shape, k
            assert v.dtype == torch.float32, k
        e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
        assert tuple(named["groups/0/moe/router"].shape) == (2, d, e)
        assert tuple(named["groups/0/moe/moe_w_down"].shape) == (2, e, f, d)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_f32_matches_reference(arch, dispatch):
    """f32: the output within 1e-5 (einsum: absolute; scatter: relative to
    the output's largest value, its index_add sums in another order), the
    aux loss within 1e-6 relative."""
    jcfg, cfg = _cfgs(arch, dispatch=dispatch)
    jp, p = _moe_params(jcfg, cfg)
    x = np.random.RandomState(1).randn(2, 64, cfg.d_model).astype(np.float32)
    want, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_mlp(p, t(x), cfg)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    atol = 1e-5 if dispatch == "einsum" else 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=atol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_moe_capacity_and_router_pieces_match_reference():
    """The capacity rounds the configured group's count up to a multiple
    of 4 (granite: 76); the router's gates, expert choices and aux loss."""
    for arch in MOE_ARCHS:
        assert moe._capacity(get_arch(arch).moe) == \
            jmoe._capacity(jget_arch(arch).moe)
        assert moe._capacity(get_arch(arch).reduced().moe) == \
            jmoe._capacity(jget_arch(arch).reduced().moe)
    assert moe._capacity(get_arch("granite-moe-3b-a800m").moe) == 76
    jcfg, cfg = _cfgs("granite-moe-3b-a800m")
    jp, p = _moe_params(jcfg, cfg, seed=3)
    xg = np.random.RandomState(2).randn(4, 32, cfg.d_model).astype(np.float32)
    jg, jidx, jaux = jmoe._router(jnp.asarray(xg), jp, jcfg.moe)
    g, idx, aux = moe._router(t(xg), p, cfg.moe)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_capacity_overflow_drops_tokens_as_the_reference(dispatch):
    """A router biased so that every token's first choice is expert 0:
    past the capacity (8 per group of 32 at top-1 and factor 1.0 for the
    einsum; 24 for the scatter's whole-batch count) the tokens are
    dropped, and their rows are exactly zero where the reference's are."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", top_k=1, capacity_factor=1.0,
                      dispatch=dispatch)
    jp, p = _moe_params(jcfg, cfg, seed=4)
    router = np.asarray(jp["router"]).copy()
    router[0, 0] = 100.0
    jp["router"], p["router"] = jnp.asarray(router), t(router)
    x = np.random.RandomState(5).randn(2, 48, cfg.d_model).astype(np.float32)
    x[..., 0] = 1.0                      # logit 0 ≈ 100: expert 0 for all
    want, _ = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    got, _ = moe.moe_mlp(p, t(x), cfg)
    want, got = np.asarray(want), np_of(got)
    zero_w = np.all(want == 0.0, axis=-1)
    zero_g = np.all(got == 0.0, axis=-1)
    assert np.array_equal(zero_g, zero_w)
    n = 2 * 48
    kept = (n // 32) * moe._capacity(cfg.moe) if dispatch == "einsum" \
        else max(4, int(n * 1 * 1.0 / cfg.moe.n_experts))
    assert int(zero_w.sum()) == n - kept
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
# the whole LM
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("impl", ["blockwise", "flash"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_forward_f32_matches_reference(monkeypatch, arch, impl):
    """f32 compute: logits within 2e-5 of the reference (its blockwise
    attention) through either attention of the port, the summed aux loss
    within 1e-6 relative; remat gives the same bits."""
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    jcfg, cfg = _cfgs(arch)
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 64))
    want, jaux = jtf.lm_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    monkeypatch.setenv("REPRO_ATTN_IMPL", impl)
    got, aux = tf.lm_forward(params, t(toks.astype(np.int32)), cfg)
    again, aux2 = tf.lm_forward(params, t(toks.astype(np.int32)), cfg,
                                remat=True)
    assert got.dtype == torch.float32 and float(aux) > 0.0
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert torch.equal(got, again) and torch.equal(aux, aux2)


def _routes(monkeypatch):
    """Record every router call of both packages, layer by layer: the
    chosen experts and the probabilities (the reference's through
    ``jax.debug.callback``, since its layers run inside a scan)."""
    import repro_torch.models.moe as pmoe
    rec = {"jax": [], "torch": []}
    jrouter, trouter = jmoe._router, pmoe._router

    def jax_router(x, p, m):
        gates, idx, aux = jrouter(x, p, m)
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        jax.debug.callback(lambda i, q: rec["jax"].append(
            (np.asarray(i), np.asarray(q))), idx, probs, ordered=True)
        return gates, idx, aux

    def torch_router(x, p, m):
        gates, idx, aux = trouter(x, p, m)
        probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
        rec["torch"].append((idx.numpy(), probs.detach().numpy()))
        return gates, idx, aux

    monkeypatch.setattr(jmoe, "_router", jax_router)
    monkeypatch.setattr(pmoe, "_router", torch_router)
    return rec


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_forward_bf16_matches_reference(monkeypatch, capsys, arch):
    """bf16 compute (the training path), flash attention in the port.

    The expert choices are compared first, layer by layer.  The first
    layer sees the same input in both packages and must route every token
    alike.  In a later layer the hidden states differ by bf16 rounding
    (the probabilities by up to ~6e-3), so a token whose k-th and
    (k+1)-th probabilities lie within 0.01 of each other in the reference
    may take the other expert: each such flip is printed, and must be
    such a near-tie.  The logits of every position no flip reaches (a
    flip in the last layer reaches its own token; an earlier one, the
    later tokens of its sequence) are held to the bound of
    ``test_lm_forward_bf16_matches_reference``: within 0.05, and 99 % of
    them within 0.02 (|logit| < 2)."""
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    jcfg, cfg = _cfgs(arch, compute="bfloat16")
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 64))
    rec = _routes(monkeypatch)
    want, _ = jtf.lm_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    want = np.asarray(want).astype(np.float32)
    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    got, _ = tf.lm_forward(params, t(toks.astype(np.int32)), cfg)
    assert got.dtype == torch.bfloat16
    n_layers, k = cfg.n_layers, cfg.moe.top_k
    assert len(rec["jax"]) == len(rec["torch"]) == n_layers
    reached = np.zeros(toks.shape, bool)
    for layer, ((ij, pj), (it, _)) in enumerate(zip(rec["jax"],
                                                    rec["torch"])):
        # groups of 32 tokens → (B, S)
        ij, it, pj = (a.reshape(toks.shape + a.shape[2:])
                      for a in (ij, it, pj))
        flipped = np.argwhere(np.any(np.sort(ij, -1) != np.sort(it, -1), -1))
        if layer == 0:
            assert len(flipped) == 0
        for b, s in flipped:
            top = np.sort(pj[b, s])[::-1]
            print(f"{arch} layer {layer} token ({b}, {s}): experts "
                  f"{sorted(ij[b, s])} in the reference, {sorted(it[b, s])} "
                  f"in the port; reference probabilities {top}")
            assert top[k - 1] - top[k] < 0.01, (layer, b, s, top)
            if layer == n_layers - 1:
                reached[b, s] = True
            else:
                reached[b, s:] = True
    print(f"{arch}: {int(reached.sum())} of {reached.size} positions "
          f"reached by a flip")
    assert reached.mean() < 0.25
    err = np.abs(np_of(got) - want)[~reached]
    assert np.abs(want).max() < 2.0
    assert err.max() <= 0.05 and np.quantile(err, 0.99) <= 0.02


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_steps_match_reference(arch):
    """Four ``lm_decode_step`` calls from empty caches, f32 compute: each
    step's logits within 2e-5 of the reference's (the MoE layer runs on a
    group of B tokens; its capacity still comes from the configured
    group), and the caches within 1e-5, as ``tests/test_torch_serve.py``
    holds the dense decode's."""
    jcfg, cfg = _cfgs(arch)
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 4))
    jc = jtf.init_caches(2, jcfg, 16)
    c = tf.init_caches(2, cfg, 16, device="cpu")
    for i in range(4):
        want, jc = jtf.lm_decode_step(jparams, jnp.asarray(
            toks[:, i:i + 1], jnp.int32), jc, jnp.int32(i), jcfg)
        got, c = tf.lm_decode_step(params, t(toks[:, i:i + 1].astype(
            np.int32)), c, i, cfg)
        assert got.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                                   atol=2e-5)
    jleaves = jax.tree.leaves(jc)
    assert len(jleaves) == len(flatten_named(c))
    for a, b in zip(flatten_named(c).values(), jleaves):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=0,
                                   atol=1e-5)


def _jax_state(cfg, seed=0):
    m = jbuild_model(cfg)
    return jinit_train_state(m.init(jax.random.PRNGKey(seed)),
                             jax.random.PRNGKey(seed + 1),
                             jinit_data_state(seed))


def _torch_state(cfg, seed=0):
    m = build_model(cfg)
    return init_train_state(m.init(torch.Generator().manual_seed(seed)),
                            prng_key(seed + 1), init_data_state(seed))


def _jax_named_np(jstate):
    named, _ = jflatten(jstate)
    return {k: np.asarray(v) for k, v in named.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_matches_jax(monkeypatch, arch):
    """Same weights, batch and f32 compute: the loss (cross-entropy plus
    ``router_aux_weight`` · aux) within 1e-6 relative, the grad norm within
    1e-5 relative, new params, mu and nu within 1e-6, the step, count,
    cursor and rng bit for bit (Adam's eps 1e-6, as in
    ``test_train_step_matches_jax``)."""
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    jcfg, cfg = _cfgs(arch)
    jstate = _jax_state(jcfg)
    opt = dict(total_steps=20, warmup_steps=2, eps=1e-6)
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(4, 33)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    jnew, jmet = jax.jit(jmake_train_step(
        jbuild_model(jcfg), JAdamWConfig(**opt), remat=False))(jstate, jbatch)
    want = _jax_named_np(jnew)

    tstate = unflatten_named(from_numpy_named(_jax_named_np(jstate)),
                             _torch_state(cfg))
    batch = {"tokens": t(toks[:, :-1]), "labels": t(toks[:, 1:])}
    new, met = make_train_step(build_model(cfg), AdamWConfig(**opt),
                               remat=True)(tstate, batch)
    got = to_host(flatten_named(new))
    assert list(got) == list(want)
    for k in ("step", "rng", "opt/count", "data_state/seed",
              "data_state/position"):
        assert got[k].tobytes() == want[k].tobytes(), k
    for k, v in want.items():
        if k.startswith(("params/", "opt/mu/", "opt/nu/")):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)
    assert float(met["aux"]) > 0.0
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_moe_trainstate_cross_reads_both_ways(tmp_path, writer):
    """A reduced granite TrainState (its MoE leaves included) stored by one
    package (FTI, level 1) restores bit for bit into the other package's
    own template."""
    arch = "granite-moe-3b-a800m"
    d = str(tmp_path / "ck")
    jstate = _jax_state(jget_arch(arch).reduced())
    tstate = _torch_state(get_arch(arch).reduced())
    jnamed, jdef = jflatten(jstate)
    rng = np.random.RandomState(9)
    want = {}
    for k, v in jnamed.items():
        v = np.asarray(v)
        want[k] = rng.randn(*v.shape).astype(v.dtype) if v.dtype.kind == "f" \
            else rng.randint(0, 2**31 - 1, size=v.shape).astype(v.dtype)
    assert "params/groups/0/moe/moe_w_up" in want
    if writer == "jax":
        jx = jax.tree_util.tree_unflatten(
            jdef, [jnp.asarray(want[k]) for k in jnamed])
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
            dir=d, backend="fti", objstore=False, dedicated_thread=False))
        ctx.store(jx, id=3, level=1)
        ctx.shutdown()
        ctx = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
        got_np = to_host(flatten_named(ctx.load(tstate)))
    else:
        tx = unflatten_named(from_numpy_named(want), tstate)
        ctx = CheckpointContext(CheckpointConfig(
            dir=d, backend="fti", objstore=False, dedicated_thread=False))
        ctx.store(tx, id=3, level=1)
        ctx.shutdown()
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
            dir=d, objstore=False))
        got_np = _jax_named_np(ctx.load(jstate))
    assert ctx.restarted
    ctx.shutdown()
    assert list(got_np) == list(want)
    for k, v in want.items():
        assert got_np[k].dtype == v.dtype and got_np[k].shape == v.shape, k
        assert got_np[k].tobytes() == v.tobytes(), k


# --------------------------------------------------------------------------- #
# the in-place AdamW update of a donated state
# --------------------------------------------------------------------------- #

def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone()


def test_adamw_update_in_place_is_bit_equal_to_functional():
    """Three updates of a tree with a matrix, a vector and a bf16 matrix
    (gradients scaled past the clip): the in-place update's params, mu and
    nu equal the functional update's bit for bit, its tensors keep their
    identity and each gradient entry is released."""
    rng = np.random.RandomState(10)
    params = {"w": t(rng.randn(8, 16).astype(np.float32)),
              "b": t(rng.randn(16).astype(np.float32)),
              "h": t(rng.randn(4, 8).astype(np.float32)).bfloat16()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    f_params, f_state = _clone_tree(params), adamw_init(params)
    i_params, i_state = _clone_tree(params), adamw_init(params)
    keep = (tree_leaves(i_params), tree_leaves(i_state.mu),
            tree_leaves(i_state.nu))
    for s in range(3):
        grads = {k: t(rng.randn(*v.shape).astype(np.float32) * 10).to(
            v.dtype) for k, v in params.items()}
        f_params, f_state, f_met = adamw_update(cfg, grads, f_state,
                                                f_params)
        glist = tree_leaves(_clone_tree(grads))
        i_state, i_met = adamw_update_(cfg, glist, i_state, i_params)
        assert glist == [None] * 3
        assert torch.equal(f_met["grad_norm"], i_met["grad_norm"])
        assert torch.equal(f_met["lr"], i_met["lr"])
        assert int(i_state.count) == s + 1 == int(f_state.count)
    for a, b in zip(keep, (tree_leaves(i_params), tree_leaves(i_state.mu),
                           tree_leaves(i_state.nu))):
        assert all(x is y for x, y in zip(a, b))
    for f, i in ((f_params, i_params), (f_state.mu, i_state.mu),
                 (f_state.nu, i_state.nu)):
        for x, y in zip(tree_leaves(f), tree_leaves(i)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert isinstance(i_state, AdamWState)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "tinyllama-1.1b"])
def test_donated_train_step_is_bit_equal_to_functional(monkeypatch, arch):
    """Three steps of ``make_train_step(donate=True)`` against three of the
    functional step from the same state and batches, through the flash
    path: every leaf and the metrics bit for bit; the donated state's
    tensors are the returned state's."""
    from repro_torch.data.synthetic import next_batch
    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    opt = AdamWConfig(total_steps=10, warmup_steps=1)
    functional = make_train_step(model, opt)
    donating = make_train_step(model, opt, donate=True)
    fs = _torch_state(cfg)
    ds = unflatten_named({k: v.clone() for k, v in
                          flatten_named(fs).items()}, fs)
    embed = ds.params["embed"]
    for _ in range(3):
        batch, nxt = next_batch(fs.data_state, cfg, 2, 32)
        fs, fm = functional(fs, batch)
        ds, dm = donating(ds, batch)
        fs, ds = fs._replace(data_state=nxt), ds._replace(data_state=nxt)
        for k in ("loss", "grad_norm", "aux"):
            assert torch.equal(fm[k], dm[k]), k
    assert ds.params["embed"] is embed
    a, b = flatten_named(fs), flatten_named(ds)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k

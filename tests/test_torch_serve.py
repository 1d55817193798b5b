"""The port's decode path and serving engine against the JAX package, on
the CPU, with a reduced tinyllama.

- ``gqa_decode`` (plain and with a rolling windowed cache) and
  ``lm_decode_step`` against the reference on the same weights (carried
  across with ``from_numpy_named``), caches and tokens: f32 within 1e-5;
  the attention decode bit-equal in bf16.  In bf16 the two differ only by
  what XLA makes of the reference on the CPU: its silu rounds after every
  op of ``x * (1 / (1 + exp(-x)))``, and its fusions skip the bf16
  rounding of the residual before the MLP's norm.  With both undone the
  MLP is bit-equal and the logits are within two bf16 ulps per element;
  as shipped, within four bf16 ulps of each row's largest logit.
- ``ServingEngine.prefill`` + ``generate``: the same tokens as the
  reference's engine (f32 compute, where an argmax cannot flip on a bf16
  near-tie).
- A ``ServeState`` checkpoint (FULL + DIFF) written by either package
  restores bit-exact in the other.
- The bench's ``serve_swap_delta`` datapoint on the port, and an entry
  published by ``repro`` pulled by the port's ``EntryPuller``.

Inputs are numpy arrays from a seed; every tolerance is stated where it
is used.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.context import CheckpointConfig as JConfig
from repro.core.context import CheckpointContext as JContext
from repro.core.protect import flatten_named as jflatten
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.zoo import build_model as jbuild_model
from repro.serve.engine import ServeState as JServeState
from repro.serve.engine import ServingEngine as JEngine
from repro_torch.configs import get_arch
from repro_torch.core.context import (CHK_DIFF, CheckpointConfig,
                                      CheckpointContext)
from repro_torch.core.formats import tensor_to_numpy
from repro_torch.core.protect import (flatten_named, from_numpy_named,
                                      unflatten_named)
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import ServeState, ServingEngine, WeightsHandle

ARCH = "tinyllama-1.1b"


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def bf16(a: np.ndarray) -> torch.Tensor:
    """f32 numpy → bf16 tensor, rounded as jax rounds it."""
    return t(a.astype(ml_dtypes.bfloat16).view(np.int16)).view(torch.bfloat16)


def np_of(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def _cfgs(compute="float32", **kw):
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(),
                               compute_dtype=compute, **kw)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(),
                              compute_dtype=compute, **kw)
    return jcfg, cfg


def _carried(jcfg, cfg, seed=0):
    """Reference params from a key → the same bytes in the port's layout."""
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    named, _ = jflatten(jparams)
    tmpl = build_model(cfg).init(torch.Generator().manual_seed(seed))
    return jparams, unflatten_named(
        from_numpy_named({k: np.asarray(v) for k, v in named.items()}), tmpl)


def _np_named(tree) -> dict:
    """Every leaf of a jax or torch tree as numpy, by name (both packages
    name a tree's leaves alike)."""
    return {k: tensor_to_numpy(v) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in flatten_named(tree).items()}


# --------------------------------------------------------------------------- #
# layer and model parity
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("window", [None, 8])
def test_gqa_decode_matches_reference(window):
    """One attention layer decoded over 20 positions, f32: the output and
    the cache within 1e-5 of the reference at every step.  With a window
    of 8 the cache is allocated at the window and rolls (slot pos % 8,
    every slot valid once wrapped)."""
    jcfg, cfg = _cfgs(sliding_window=window)
    rng = np.random.RandomState(3)
    d, kv, dh = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    p_np = {"wq": rng.randn(d, cfg.n_heads * dh), "wk": rng.randn(d, kv * dh),
            "wv": rng.randn(d, kv * dh), "wo": rng.randn(cfg.n_heads * dh, d)}
    p_np = {k: (v * 0.1).astype(np.float32) for k, v in p_np.items()}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    p = {k: t(v) for k, v in p_np.items()}
    max_len = 32
    jcache = jattn.init_kv_cache(2, jcfg, max_len, jnp.float32)
    cache = attn.init_kv_cache(2, cfg, max_len, torch.float32, "cpu")
    assert tuple(cache.k.shape) == jcache.k.shape
    assert cache.is_windowed(cfg) == (window is not None)
    for pos in range(20):
        x = (rng.randn(2, 1, d) * 0.5).astype(np.float32)
        want, jcache = jattn.gqa_decode(jp, jnp.asarray(x), jcache,
                                        jnp.int32(pos), jcfg)
        got, cache = attn.gqa_decode(p, t(x), cache, pos, cfg)
        np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(np_of(cache.k), np.asarray(jcache.k),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(np_of(cache.v), np.asarray(jcache.v),
                                   rtol=0, atol=1e-5)


def test_cache_layout_equals_reference():
    """The cache tree's leaf names, shapes and dtypes are the reference's
    (bf16 compute, stacked (n_groups, B, C, KV, dh)); ``cache_struct``
    allocates on the meta device."""
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jst, _ = jflatten(jbuild_model(jcfg).cache_struct(3, 24))
    model = build_model(cfg)
    st = flatten_named(model.init_caches(3, 24, device="cpu"))
    meta = flatten_named(model.cache_struct(3, 24))
    assert list(st) == list(jst) == list(meta) == ["0/k", "0/v"]
    for k, v in st.items():
        assert tuple(v.shape) == jst[k].shape == tuple(meta[k].shape)
        assert str(v.dtype).split(".")[1] == str(jst[k].dtype)
        assert meta[k].device.type == "meta" and not v.any()
    assert [s.axis for s in model.cache_protects()] == [{"batch": 1}]


def _decode_both(jcfg, cfg, steps=8, seed=0, exact_bf16=False):
    """Both packages decode ``steps`` seeded tokens → ([(reference logits,
    port logits)], reference caches, port caches).  ``exact_bf16``
    compiles the reference with ``xla_allow_excess_precision`` off, so XLA
    rounds every bf16 op it is asked for."""
    jparams, params = _carried(jcfg, cfg, seed)
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, (2, steps)).astype(np.int32)
    jcaches = jtf.init_caches(2, jcfg, 16)
    caches = tf.init_caches(2, cfg, 16, device="cpu")
    jstep = functools.partial(jtf.lm_decode_step, cfg=jcfg)
    if exact_bf16:
        jstep = jax.jit(jstep).lower(
            jparams, jnp.asarray(toks[:, :1]), jcaches, jnp.int32(0)
        ).compile(compiler_options={"xla_allow_excess_precision": False})
    out = []
    for i in range(steps):
        want, jcaches = jstep(jparams, jnp.asarray(toks[:, i:i + 1]),
                              jcaches, jnp.int32(i))
        got, caches = tf.lm_decode_step(params, t(toks[:, i:i + 1]), caches,
                                        i, cfg)
        out.append((np.asarray(want).astype(np.float32), np_of(got)))
    return out, jcaches, caches


def test_lm_decode_step_f32_matches_reference():
    """f32 compute: logits within 1e-5 of the reference over 8 steps, and
    the caches after them."""
    out, jcaches, caches = _decode_both(*_cfgs())
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jn, n = _np_named(jcaches), _np_named(caches)
    for k in jn:
        np.testing.assert_allclose(n[k], jn[k], rtol=0, atol=1e-5)


def xla_silu(x: torch.Tensor) -> torch.Tensor:
    """silu as XLA expands it on the CPU: ``x * (1 / (1 + exp(-x)))`` with
    every op rounded to ``x``'s dtype (torch's ``F.silu`` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


def test_mlp_bf16_matches_reference(monkeypatch):
    """The MLP block alone in bf16 on seeded weights and inputs: the
    port's silu is within two bf16 ulps of XLA's expansion of it at every
    element, and with that expansion the port's MLP equals the jitted
    reference's bit for bit, so the silu is the MLP's only gap."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    rng = np.random.RandomState(7)
    d, f = cfg.d_model, cfg.d_ff
    p_np = {"w_gate": rng.randn(d, f), "w_up": rng.randn(d, f),
            "w_down": rng.randn(f, d)}
    p_np = {k: (v * 0.05).astype(np.float32) for k, v in p_np.items()}
    x = rng.randn(4, 1, d).astype(np.float32)
    want = jax.jit(lambda p, x: jlayers.mlp(p, x, jcfg.act))(
        {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p_np.items()},
        jnp.asarray(x).astype(jnp.bfloat16))
    g = bf16(x.reshape(-1, d)) @ bf16(p_np["w_gate"])
    ours, theirs = np_of(torch.nn.functional.silu(g)), np_of(xla_silu(g))
    assert np.all(np.abs(ours - theirs) <= 2 * bf16_ulp(theirs))
    monkeypatch.setitem(layers._ACTS, "silu", xla_silu)
    got = layers.mlp({k: bf16(v) for k, v in p_np.items()}, bf16(x),
                     cfg.act)
    assert tensor_to_numpy(got).tobytes() == np.asarray(want).tobytes()


def test_lm_decode_step_bf16_matches_reference(monkeypatch):
    """bf16 compute (the serving default), 8 steps: with the reference's
    bf16 roundings all kept (excess precision off) and XLA's silu in the
    port, the logits are within two bf16 ulps of the reference at every
    element (measured: equal)."""
    from repro_torch.models import layers
    monkeypatch.setitem(layers._ACTS, "silu", xla_silu)
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    out, _, _ = _decode_both(jcfg, cfg, exact_bf16=True)
    for want, got in out:
        assert np.all(np.abs(got - want) <= 2 * bf16_ulp(want))


def test_lm_decode_step_bf16_as_shipped_near_reference():
    """Each package as it ships, bf16 compute, 8 steps: the logits within
    four bf16 ulps of each row's largest logit magnitude (measured: at
    most three).  Per element no ulp bound holds: the silu and the
    residual's rounding (see the two tests above) move the hidden state
    in its last bits, and a logit near zero carries the rounding of the
    large terms of its sum (measured: thousands of its own ulps)."""
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    out, _, _ = _decode_both(jcfg, cfg)
    for want, got in out:
        row = np.abs(want).max(axis=-1, keepdims=True)
        assert np.all(np.abs(got - want) <= 4 * bf16_ulp(row))


def test_gqa_decode_bf16_equals_reference():
    """bf16 in, bf16 out, one attention layer over 6 positions: the output
    and the cache equal the reference's bit for bit."""
    jcfg, cfg = _cfgs("bfloat16")
    rng = np.random.RandomState(3)
    d, kv, dh = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, cfg.n_heads * dh), "wk": (d, kv * dh),
              "wv": (d, kv * dh), "wo": (cfg.n_heads * dh, d)}
    p_np = {k: (rng.randn(*s) * 0.1).astype(np.float32)
            for k, s in shapes.items()}
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p_np.items()}
    p = {k: bf16(v) for k, v in p_np.items()}
    jcache = jattn.init_kv_cache(2, jcfg, 16, jnp.bfloat16)
    cache = attn.init_kv_cache(2, cfg, 16, torch.bfloat16, "cpu")
    for pos in range(6):
        x = (rng.randn(2, 1, d) * 0.5).astype(np.float32)
        want, jcache = jattn.gqa_decode(
            jp, jnp.asarray(x).astype(jnp.bfloat16), jcache, jnp.int32(pos),
            jcfg)
        got, cache = attn.gqa_decode(p, bf16(x), cache, pos, cfg)
        assert got.dtype == torch.bfloat16
        for a, b in ((got, want), (cache.k, jcache.k), (cache.v, jcache.v)):
            assert tensor_to_numpy(a).tobytes() == np.asarray(b).tobytes()


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

def test_engine_tokens_match_reference():
    """Prefill 6 tokens and generate 10 (two batches of 5), f32 compute:
    the port's tokens, position and last token equal the reference
    engine's, and its caches are within 1e-5."""
    jcfg, cfg = _cfgs()
    jparams, params = _carried(jcfg, cfg)
    prompts = np.random.RandomState(9).randint(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jeng = JEngine(jbuild_model(jcfg), jparams, batch=2, max_len=32)
    jeng.prefill(jnp.asarray(prompts))
    want = np.concatenate([np.asarray(jeng.generate(5)),
                           np.asarray(jeng.generate(5))], axis=1)
    eng = ServingEngine(build_model(cfg), params, batch=2, max_len=32)
    eng.prefill(t(prompts))
    got = torch.cat([eng.generate(5), eng.generate(5)], dim=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    st, jst = eng.get_state(), jeng.get_state()
    assert st.pos.dtype == torch.int32 and st.pos.device.type == "cpu"
    assert int(st.pos) == int(jst.pos) == 16
    np.testing.assert_array_equal(st.last_token.numpy(),
                                  np.asarray(jst.last_token))
    jn, n = _np_named(jst.caches), _np_named(st.caches)
    for k in jn:
        np.testing.assert_allclose(n[k], jn[k], rtol=0, atol=1e-5)


def test_weights_are_cast_once_per_handle():
    """bf16 compute: the engine casts a handle's f32 params once and
    reuses the cast for every batch of that handle; a new handle gets its
    own cast.  The cast equals the decode step's own (bit-identical)."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServingEngine(model, params, batch=2, max_len=16)
    h = eng.weights
    c1 = h.compute_params(torch.bfloat16)
    assert h.compute_params(torch.bfloat16) is c1
    assert c1["embed"].dtype == torch.bfloat16
    assert params["embed"].dtype == torch.float32
    prompts = torch.randint(0, cfg.vocab_size, (2, 3), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    eng.prefill(prompts)
    eng.generate(2)
    assert eng.weights.compute_params(torch.bfloat16) is c1
    h2 = eng.set_weights(WeightsHandle(params=params))
    assert h2.compute_params(torch.bfloat16) is not c1
    # the handle's cast gives the logits of the uncast params
    caches_a = model.init_caches(2, 16, device="cpu")
    caches_b = model.init_caches(2, 16, device="cpu")
    tok = prompts[:, :1]
    a, _ = model.decode_step(params, tok, caches_a, 0)
    b, _ = model.decode_step(c1, tok, caches_b, 0)
    assert torch.equal(a, b)


def test_engines_share_no_cache_buffer():
    """get_state is a copy and set_state takes one: decoding on one
    engine never changes a state held by the caller or another engine."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 4), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    a = ServingEngine(model, params, batch=2, max_len=16)
    a.prefill(prompts)
    held = a.get_state()
    snap = {k: v.clone() for k, v in flatten_named(held).items()}
    b = ServingEngine(model, params, batch=2, max_len=16)
    b.set_state(held)
    a.generate(3)
    b.generate(5)
    for k, v in flatten_named(held).items():
        assert torch.equal(v, snap[k]), k
    pa, pb = flatten_named(a.state), flatten_named(b.state)
    assert all(pa[k].data_ptr() != pb[k].data_ptr() for k in pa
               if pa[k].numel())


# --------------------------------------------------------------------------- #
# ServeState checkpoints across the packages
# --------------------------------------------------------------------------- #

def _ckpt_cfg(cls, d):
    return cls(dir=str(d), backend="fti", block_bytes=256,
               dedicated_thread=False, objstore=False)


def _store_chain(engine, ctx_cls, cfg_cls, d, diff_kind):
    """FULL after prefill, then a DIFF 4 tokens later → the state stored
    last, as numpy by name."""
    ctx = ctx_cls(_ckpt_cfg(cfg_cls, d))
    ctx.store(engine.get_state(), id=1, level=1)
    engine.generate(4)
    rep = ctx.store(engine.get_state(), id=2, level=1, kind=diff_kind)
    assert rep.kind == diff_kind
    ctx.shutdown()
    return _np_named(engine.get_state())


def _assert_named_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want) == ["caches/0/k", "caches/0/v",
                                           "last_token", "pos"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_reference_serve_checkpoint_restores_in_port(tmp_path):
    """repro stores FULL + DIFF of its engine's ServeState (bf16 caches);
    a port engine restores it bit-exact into a cold template and decodes
    on from it."""
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jparams, params = _carried(jcfg, cfg)
    prompts = np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    jeng = JEngine(jbuild_model(jcfg), jparams, batch=2, max_len=32)
    jeng.prefill(jnp.asarray(prompts))
    want = _store_chain(jeng, JContext, JConfig, tmp_path, "DIFF")
    model = build_model(cfg)
    cold = ServeState(model.init_caches(2, 32, device="cpu"),
                      torch.tensor(0, dtype=torch.int32),
                      torch.zeros((2, 1), dtype=torch.int32))
    ctx = CheckpointContext(_ckpt_cfg(CheckpointConfig, tmp_path))
    got = ctx.load(cold)
    ctx.shutdown()
    assert ctx.restarted
    _assert_named_equal(_np_named(got), want)
    eng = ServingEngine(model, params, batch=2, max_len=32)
    eng.set_state(got)
    assert eng.generate(2).shape == (2, 2) and int(eng.state.pos) == 11


def test_port_serve_checkpoint_restores_in_reference(tmp_path):
    """The port stores FULL + DIFF of its engine's ServeState; the
    reference restores it bit-exact into its own cold template."""
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    _, params = _carried(jcfg, cfg)
    prompts = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 5)).astype(np.int32))
    eng = ServingEngine(build_model(cfg), params, batch=2, max_len=32)
    eng.prefill(prompts)
    want = _store_chain(eng, CheckpointContext, CheckpointConfig, tmp_path,
                        CHK_DIFF)
    cold = JServeState(jbuild_model(jcfg).init_caches(2, 32), jnp.int32(0),
                       jnp.zeros((2, 1), jnp.int32))
    ctx = JContext(_ckpt_cfg(JConfig, tmp_path))
    got = ctx.load(cold)
    ctx.shutdown()
    assert ctx.restarted
    _assert_named_equal(_np_named(got), want)


# --------------------------------------------------------------------------- #
# the deploy datapoint and a cross-package pull
# --------------------------------------------------------------------------- #

SERVE_SWAP_DELTA_RATIO = 0.044930637296215915     # BENCH_overhead.json


def test_serve_swap_delta_ratio_equals_the_committed_value(tmp_path):
    """benchmarks/bench_overhead.py's serve_swap_delta on the port: 32 MiB
    of f32 from default_rng(0), a fine-tune of its first 4,096 values,
    two FULL L4 stores; a replica that pulled v1 pulls v2.  The fetched
    share is byte-counted, so it equals the committed value exactly."""
    from repro_torch.objstore.client import make_object_store
    from repro_torch.objstore.inspect import CatalogView
    from repro_torch.serve.deploy import EntryPuller

    n = 1 << 23
    base = np.random.default_rng(0).normal(size=n).astype(np.float32)
    d = str(tmp_path / "swap")
    ctx = CheckpointContext(CheckpointConfig(
        dir=d, backend="fti", dedicated_thread=False))
    ctx.store({"params": {"w": torch.from_numpy(base)}}, id=1, level=4)
    tuned = base.copy()
    tuned[:4096] += 1.0
    ctx.store({"params": {"w": torch.from_numpy(tuned)}}, id=2, level=4)
    ctx.shutdown()
    store = make_object_store("file:" + os.path.join(d, "objstore"))
    view = CatalogView.from_store(store)
    puller = EntryPuller(store, os.path.join(d, "replica-cache"))
    puller.pull(view.entry(1))
    got = puller.pull(view.entry(2))
    fetched, cached = got["bytes_fetched"], got["bytes_cached"]
    assert fetched / max(fetched + cached, 1) == SERVE_SWAP_DELTA_RATIO
    assert CatalogView.diff(view.entry(1), view.entry(2)).ratio == \
        SERVE_SWAP_DELTA_RATIO


def test_port_puller_fetches_a_reference_entry(tmp_path):
    """An entry the reference publishes (FULL L4 through its object store)
    pulled by the port's EntryPuller: the same container bytes as the
    reference's own puller materializes, and its params load onto the
    CPU through the port's load_named_onto equal to what was stored."""
    from repro.objstore.client import make_object_store as jmake_store
    from repro.objstore.inspect import CatalogView as JView
    from repro.serve.deploy import EntryPuller as JPuller
    from repro_torch.core.resharding import load_named_onto
    from repro_torch.objstore.client import make_object_store
    from repro_torch.objstore.inspect import CatalogView
    from repro_torch.serve.deploy import EntryPuller

    rng = np.random.default_rng(1)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    b = rng.normal(size=(96,)).astype(ml_dtypes.bfloat16)
    d = str(tmp_path / "pub")
    ctx = JContext(JConfig(dir=d, backend="fti", dedicated_thread=False,
                           block_bytes=256, objstore_chunk_bytes=4096,
                           objstore_cdc_min_bytes=1024,
                           objstore_cdc_avg_bytes=4096,
                           objstore_cdc_max_bytes=16384))
    ctx.store({"params": {"w": jnp.asarray(w), "b": jnp.asarray(b)}},
              id=3, level=4)
    ctx.shutdown()
    url = "file:" + os.path.join(d, "objstore")
    got = EntryPuller(make_object_store(url), str(tmp_path / "c-port")).pull(
        CatalogView.from_store(make_object_store(url)).entry(3))
    want = JPuller(jmake_store(url), str(tmp_path / "c-ref")).pull(
        JView.from_store(jmake_store(url)).entry(3))
    assert got["bytes_fetched"] == want["bytes_fetched"] > 0
    with open(got["container"], "rb") as f1, \
            open(want["container"], "rb") as f2:
        assert f1.read() == f2.read()
    cpu = torch.device("cpu")
    named = load_named_onto(got["container"], [got["dir"]], rank=0,
                            devices={"params/w": cpu, "params/b": cpu})
    assert torch.equal(named["params/w"], torch.from_numpy(w))
    assert named["params/b"].dtype == torch.bfloat16
    assert tensor_to_numpy(named["params/b"]).tobytes() == b.tobytes()

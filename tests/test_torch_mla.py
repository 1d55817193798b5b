"""The port's Multi-head Latent Attention against the JAX package, on the CPU,
with a reduced minicpm3-4b (MLA: q_lora 32, kv_lora 16, qk nope/rope 16/8,
v_head 16, 4 heads).

- ``init_mla`` and the model's parameter and cache layouts: the
  reference's leaf names, shapes and dtypes.
- ``mla_attention`` (the naive train/prefill form) and ``mla_decode`` (the
  absorbed form over the latent cache, written in place) on the same
  weights and inputs, f32 and bf16; the absorbed decode against the naive
  forward within the port.
- ``lm_forward``, ``lm_decode_step`` and ``ServingEngine`` tokens.
- A ``ServeState`` with an MLA cache (FULL + DIFF) and a ``TrainState``
  stored by one package restore bit for bit in the other.

Inputs are numpy arrays from a seed; parameters cross with
``from_numpy_named`` onto the port's own template.  Every tolerance is
stated where it is used.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import context as jctx
from repro.core.protect import flatten_named as jflatten
from repro.data.synthetic import init_data_state as jinit_data_state
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.zoo import build_model as jbuild_model
from repro.serve.engine import ServeState as JServeState
from repro.serve.engine import ServingEngine as JEngine
from repro.train.state import init_train_state as jinit_train_state
from repro_torch.configs import get_arch
from repro_torch.core.context import (CHK_DIFF, CheckpointConfig,
                                      CheckpointContext)
from repro_torch.core.formats import tensor_to_numpy
from repro_torch.core.protect import (flatten_named, from_numpy_named,
                                      to_host, unflatten_named)
from repro_torch.data.synthetic import init_data_state
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import ServeState, ServingEngine
from repro_torch.train.state import init_train_state, prng_key

ARCH = "minicpm3-4b"


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


def _cfgs(compute=None):
    """The reference's and the port's reduced minicpm3 (``compute``: the
    compute dtype, else the config's bf16)."""
    kw = {} if compute is None else {"compute_dtype": compute}
    return (dataclasses.replace(jget_arch(ARCH).reduced(), **kw),
            dataclasses.replace(get_arch(ARCH).reduced(), **kw))


def _carried(jcfg, cfg, seed=0):
    """Reference params from a key → the same bytes in the port's layout."""
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    named, _ = jflatten(jparams)
    tmpl = build_model(cfg).init(torch.Generator().manual_seed(seed))
    return jparams, unflatten_named(
        from_numpy_named({k: np.asarray(v) for k, v in named.items()}), tmpl)


def _layer_params(jcfg, dtype, seed=1):
    """One MLA layer's parameters in both packages (the same bytes, in
    ``dtype``: "f32" or "bf16")."""
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p_np = {k: np.array(v) for k, v in jp.items()}
    if dtype == "f32":
        return jp, {k: t(v) for k, v in p_np.items()}
    return ({k: v.astype(jnp.bfloat16) for k, v in jp.items()},
            {k: bf16(v) for k, v in p_np.items()})


def _np_named(tree) -> dict:
    """Every leaf of a jax or torch tree as numpy, by name."""
    return {k: tensor_to_numpy(v) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in flatten_named(tree).items()}


def _bytes_equal(got: torch.Tensor, want) -> bool:
    return tensor_to_numpy(got).tobytes() == np.asarray(want).tobytes()


def _assert_bf16_near(got: torch.Tensor, want):
    """bf16 against the reference: every element within one bf16 ulp, and
    at most two elements of the call not bit-equal.  Torch and XLA sum a
    matrix product's terms in different orders, so a sum that lands next
    to a rounding boundary can round the other way (seeds 0–7: 0 or 1
    element per call)."""
    g, w = np_of(got), np.asarray(want).astype(np.float32)
    assert got.dtype == torch.bfloat16 and g.shape == w.shape
    assert np.all(np.abs(g - w) <= bf16_ulp(w))
    assert np.count_nonzero(g != w) <= 2


# --------------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------------- #

def test_init_mla_layout_equals_reference():
    """``init_mla``'s leaves and the model's ``groups/0/attn/*`` leaves:
    the reference's names, shapes and dtypes (f32 params), in its order."""
    jcfg, cfg = _cfgs()
    jp = jattn.init_mla(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = attn.init_mla(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert list(p) == list(jp) == ["w_dq", "w_uq", "w_dkv", "w_kr", "w_uk",
                                   "w_uv", "wo"]
    for k in jp:
        assert tuple(p[k].shape) == jp[k].shape and p[k].dtype == \
            torch.float32, k
    assert attn.init_attention(torch.Generator().manual_seed(0), cfg,
                               torch.float32).keys() == p.keys()
    jnamed, _ = jflatten(jax.eval_shape(
        lambda: jtf.init_lm(jax.random.PRNGKey(0), jcfg)))
    named = flatten_named(tf.init_lm(torch.Generator().manual_seed(0), cfg))
    assert list(named) == list(jnamed)
    for k, v in named.items():
        assert tuple(v.shape) == jnamed[k].shape, k
        assert str(v.dtype).split(".")[1] == str(jnamed[k].dtype), k
    m = cfg.mla
    assert tuple(named["groups/0/attn/w_uk"].shape) == (
        2, m.kv_lora_rank, cfg.n_heads * m.qk_nope_dim)
    assert "lm_head" in named                 # untied, as published


def test_cache_layout_equals_reference():
    """The cache tree: ``0/c_kv`` (n_groups, B, C, r) and ``0/k_rope``
    (n_groups, B, C, rope_dim) in bf16, as the reference's; ``cache_struct``
    allocates on the meta device; batch is dim 1."""
    jcfg, cfg = _cfgs()
    jst, _ = jflatten(jbuild_model(jcfg).cache_struct(3, 24))
    model = build_model(cfg)
    st = flatten_named(model.init_caches(3, 24, device="cpu"))
    meta = flatten_named(model.cache_struct(3, 24))
    assert list(st) == list(jst) == list(meta) == ["0/c_kv", "0/k_rope"]
    for k, v in st.items():
        assert tuple(v.shape) == jst[k].shape == tuple(meta[k].shape)
        assert str(v.dtype).split(".")[1] == str(jst[k].dtype) == "bfloat16"
        assert meta[k].device.type == "meta" and not v.any()
    assert tuple(st["0/c_kv"].shape) == (2, 3, 24, cfg.mla.kv_lora_rank)
    assert [s.axis for s in model.cache_protects()] == [{"batch": 1}]
    one = attn.init_decode_cache(3, cfg, 24, torch.float32, "cpu")
    assert isinstance(one, attn.MLACache) and one._fields == \
        jattn.MLACache._fields


# --------------------------------------------------------------------------- #
# the layer: naive and absorbed forms
# --------------------------------------------------------------------------- #

def test_rope_on_a_head_slice_matches_reference():
    """minicpm3-4b's rotary part: the 32-dim frequency table equals the
    reference's bit for bit, and ``apply_rope`` of the non-contiguous
    slice ``q[..., 64:]`` of a (B, S, 40, 96) f32 tensor is within 1e-6 of
    the reference's at positions up to 2,047 (measured 2.4e-7: at angles
    of up to 2,047 radians the two libraries' cos and sin differ in their
    last bits)."""
    from repro.models import layers as jlayers
    cfg = get_arch(ARCH)
    m = cfg.mla
    assert layers.rope_frequencies(m.qk_rope_dim, cfg.rope_theta).numpy(
        ).tobytes() == np.asarray(jlayers.rope_frequencies(
            m.qk_rope_dim, cfg.rope_theta)).tobytes()
    rng = np.random.RandomState(8)
    q = rng.randn(2, 8, cfg.n_heads, 96).astype(np.float32)
    pos = np.stack([np.arange(8), np.arange(2040, 2048)]).astype(np.int32)
    got = layers.apply_rope(t(q)[..., m.qk_nope_dim:], t(pos),
                            cfg.rope_theta)
    want = jlayers.apply_rope(jnp.asarray(q)[..., m.qk_nope_dim:],
                              jnp.asarray(pos), cfg.rope_theta)
    assert not t(q)[..., m.qk_nope_dim:].is_contiguous()
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_blockwise_attention_with_narrower_values_matches_reference():
    """q and k of 24 dims, v of 16 (MLA's shapes, reduced), S 96 in query
    blocks of 32: the three blocks' outputs concatenate to (B, S, H, 16),
    within 1e-6 of the reference, causal, f32."""
    rng = np.random.RandomState(9)
    q, k = (rng.randn(2, 96, 4, 24).astype(np.float32) for _ in range(2))
    v = rng.randn(2, 96, 4, 16).astype(np.float32)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, q_block=32)
    got = attn.blockwise_attention(t(q), t(k), t(v), causal=True, q_block=32)
    assert got.shape == (2, 96, 4, 16)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                               atol=1e-6)

def test_mla_attention_f32_matches_reference(monkeypatch):
    """f32, B 2, S 64 (one query block): within 1e-5 of the reference
    (measured 8e-7 at outputs of magnitude 3).  The flash setting does not
    reach MLA: it runs blockwise, as the reference does."""
    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    jcfg, cfg = _cfgs()
    jp, p = _layer_params(jcfg, "f32")
    x = np.random.RandomState(3).randn(2, 64, cfg.d_model).astype(np.float32)
    want = np.asarray(jattn.mla_attention(jp, jnp.asarray(x), jcfg))
    got = attn.mla_attention(p, t(x), cfg)
    assert got.shape == want.shape == (2, 64, cfg.d_model)
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=1e-5)


def test_mla_attention_bf16_matches_reference():
    """bf16 in, bf16 out, B 2, S 64: within one bf16 ulp of the reference
    at every element (``_assert_bf16_near``; this seed: one element of
    8,192 one ulp off, the rest bit-equal).  Both round in bf16 at the
    same places; the rotary embedding runs on the 8-dim slice of each
    24-dim head, a non-contiguous view in the port."""
    jcfg, cfg = _cfgs()
    jp, p = _layer_params(jcfg, "bf16")
    x = np.random.RandomState(4).randn(2, 64, cfg.d_model).astype(np.float32)
    want = jattn.mla_attention(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    got = attn.mla_attention(p, bf16(x), cfg)
    _assert_bf16_near(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_decode_matches_reference(dtype):
    """One MLA layer decoded over 12 positions into a 16-slot latent cache:
    f32, the output and both cache leaves within 1e-5 of the reference at
    every step (measured 4e-7); bf16, within one bf16 ulp at every element
    (``_assert_bf16_near``; this seed: one output element one ulp off over
    the 12 steps, the caches bit-equal), with the two score products added
    in bf16 before the f32 cast, as the reference adds them.  Each step
    writes slot ``pos`` in place and leaves the later slots zero."""
    jcfg, cfg = _cfgs()
    jp, p = _layer_params(jcfg, dtype)
    jdt, dt = ((jnp.float32, torch.float32) if dtype == "f32"
               else (jnp.bfloat16, torch.bfloat16))
    conv = t if dtype == "f32" else bf16
    jcache = jattn.init_mla_cache(2, jcfg, 16, jdt)
    cache = attn.init_mla_cache(2, cfg, 16, dt, "cpu")
    c_kv = cache.c_kv
    rng = np.random.RandomState(0)
    for pos in range(12):
        x = (rng.randn(2, 1, cfg.d_model) * 0.5).astype(np.float32)
        want, jcache = jattn.mla_decode(jp, jnp.asarray(x).astype(jdt),
                                        jcache, jnp.int32(pos), jcfg)
        got, cache = attn.mla_decode(p, conv(x), cache, pos, cfg)
        assert cache.c_kv is c_kv and got.dtype == dt
        assert not cache.c_kv[:, pos + 1:].any()
        pairs = ((got, want), (cache.c_kv, jcache.c_kv),
                 (cache.k_rope, jcache.k_rope))
        for a, b in pairs:
            if dtype == "f32":
                np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=0,
                                           atol=1e-5)
            else:
                _assert_bf16_near(a, b)


def test_absorbed_decode_equals_naive_forward_f32():
    """Within the port, f32: the absorbed-form decode of 16 positions,
    token by token, gives the naive form's output at each position within
    1e-5 (the two forms are equal algebraically and round differently;
    measured 5e-7 at outputs of magnitude 3)."""
    _, cfg = _cfgs()
    _, p = _layer_params(_cfgs()[0], "f32")
    x = np.random.RandomState(6).randn(2, 16, cfg.d_model).astype(np.float32)
    full = np_of(attn.mla_attention(p, t(x), cfg))
    cache = attn.init_mla_cache(2, cfg, 16, torch.float32, "cpu")
    for pos in range(16):
        got, cache = attn.mla_decode(p, t(x[:, pos:pos + 1]), cache, pos, cfg)
        np.testing.assert_allclose(np_of(got)[:, 0], full[:, pos], rtol=0,
                                   atol=1e-5)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

def test_lm_forward_f32_matches_reference():
    """f32 compute, B 2, S 32: the logits within 2e-5 of the reference
    (the bound of the dense models' test)."""
    jcfg, cfg = _cfgs("float32")
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 32))
    want, _ = jtf.lm_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = tf.lm_forward(params, t(toks.astype(np.int32)), cfg)
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_lm_forward_bf16_matches_reference():
    """bf16 compute (the training path), B 2, S 64: the logits within
    0.05 and 99 % of them within 0.02, the dense models' bounds (a few
    bf16 ulps at |logit| < 2; measured 0.0072).  Both round the same
    products in bf16, but XLA fuses the MLP and the residual adds."""
    jcfg, cfg = _cfgs()
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 64))
    want, _ = jtf.lm_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    want = np.asarray(want).astype(np.float32)
    got, _ = tf.lm_forward(params, t(toks.astype(np.int32)), cfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(np_of(got) - want)
    assert np.abs(want).max() < 2.0
    assert err.max() <= 0.05 and np.quantile(err, 0.99) <= 0.02


def _decode_both(jcfg, cfg, steps=8, seed=0, exact_bf16=False):
    """Both packages decode ``steps`` seeded tokens → ([(reference logits,
    port logits)], reference caches, port caches).  ``exact_bf16``
    compiles the reference with ``xla_allow_excess_precision`` off, so XLA
    rounds every bf16 op it is asked for."""
    jparams, params = _carried(jcfg, cfg, seed)
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, steps)).astype(np.int32)
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
    """f32 compute: the logits within 1e-5 of the reference over 8 steps,
    and both latent cache leaves after them."""
    out, jcaches, caches = _decode_both(*_cfgs("float32"))
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jn, n = _np_named(jcaches), _np_named(caches)
    assert sorted(n) == sorted(jn) == ["0/c_kv", "0/k_rope"]
    for k in jn:
        np.testing.assert_allclose(n[k], jn[k], rtol=0, atol=1e-5)


def xla_silu(x: torch.Tensor) -> torch.Tensor:
    """silu as XLA expands it on the CPU, every op rounded to ``x``'s
    dtype (``tests/test_torch_serve.py``)."""
    return x * (1 / (1 + torch.exp(-x)))


def test_lm_decode_step_bf16_matches_reference(monkeypatch):
    """bf16 compute (the serving default), 8 steps: with the reference's
    bf16 roundings all kept (excess precision off) and XLA's silu in the
    port, the logits are within two bf16 ulps of the reference at every
    element, as for the dense path."""
    monkeypatch.setitem(layers._ACTS, "silu", xla_silu)
    out, _, _ = _decode_both(*_cfgs(), exact_bf16=True)
    for want, got in out:
        assert np.all(np.abs(got - want) <= 2 * bf16_ulp(want))


def test_lm_decode_step_bf16_as_shipped_near_reference():
    """Each package as it ships, bf16 compute, 8 steps: the logits within
    four bf16 ulps of each row's largest logit magnitude, the dense path's
    bound (the silu and the residual's rounding differ in their last
    bits; see ``tests/test_torch_serve.py``)."""
    out, jcaches, caches = _decode_both(*_cfgs())
    for want, got in out:
        row = np.abs(want).max(axis=-1, keepdims=True)
        assert np.all(np.abs(got - want) <= 4 * bf16_ulp(row))


def test_engine_tokens_match_reference():
    """Prefill 6 tokens and generate 10 (two batches of 5), f32 compute:
    the port's tokens, position and last token equal the reference
    engine's, and its latent caches are within 1e-5."""
    jcfg, cfg = _cfgs("float32")
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
    np.testing.assert_array_equal(got.numpy(), want)
    st, jst = eng.get_state(), jeng.get_state()
    assert int(st.pos) == int(jst.pos) == 16
    np.testing.assert_array_equal(st.last_token.numpy(),
                                  np.asarray(jst.last_token))
    jn, n = _np_named(jst.caches), _np_named(st.caches)
    for k in jn:
        np.testing.assert_allclose(n[k], jn[k], rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
# checkpoints across the packages
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
    assert sorted(got) == sorted(want) == ["caches/0/c_kv", "caches/0/k_rope",
                                           "last_token", "pos"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_reference_mla_serve_checkpoint_restores_in_port(tmp_path):
    """repro stores FULL + DIFF of its engine's ServeState (bf16 latent
    caches); a port engine restores it bit-exact into a cold template and
    decodes on from it."""
    jcfg, cfg = _cfgs()
    jparams, params = _carried(jcfg, cfg)
    prompts = np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    jeng = JEngine(jbuild_model(jcfg), jparams, batch=2, max_len=32)
    jeng.prefill(jnp.asarray(prompts))
    want = _store_chain(jeng, jctx.CheckpointContext, jctx.CheckpointConfig,
                        tmp_path, "DIFF")
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


def test_port_mla_serve_checkpoint_restores_in_reference(tmp_path):
    """The port stores FULL + DIFF of its engine's ServeState; the
    reference restores it bit-exact into its own cold template."""
    jcfg, cfg = _cfgs()
    _, params = _carried(jcfg, cfg)
    prompts = t(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 5)).astype(np.int32))
    eng = ServingEngine(build_model(cfg), params, batch=2, max_len=32)
    eng.prefill(prompts)
    want = _store_chain(eng, CheckpointContext, CheckpointConfig, tmp_path,
                        CHK_DIFF)
    cold = JServeState(jbuild_model(jcfg).init_caches(2, 32), jnp.int32(0),
                       jnp.zeros((2, 1), jnp.int32))
    ctx = jctx.CheckpointContext(_ckpt_cfg(jctx.CheckpointConfig, tmp_path))
    got = ctx.load(cold)
    ctx.shutdown()
    assert ctx.restarted
    _assert_named_equal(_np_named(got), want)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mla_trainstate_cross_reads_both_ways(tmp_path, writer):
    """A reduced minicpm3 TrainState (its MLA leaves included), filled with
    seeded values, stored by one package (FTI, level 1) restores bit for
    bit into the other package's own template."""
    d = str(tmp_path / "ck")
    jcfg, cfg = _cfgs()
    jm = jbuild_model(jcfg)
    jstate = jinit_train_state(jm.init(jax.random.PRNGKey(0)),
                               jax.random.PRNGKey(1), jinit_data_state(0))
    tstate = init_train_state(
        build_model(cfg).init(torch.Generator().manual_seed(0)), prng_key(1),
        init_data_state(0))
    jnamed, jdef = jflatten(jstate)
    rng = np.random.RandomState(9)
    want = {}
    for k, v in jnamed.items():
        v = np.asarray(v)
        want[k] = rng.randn(*v.shape).astype(v.dtype) if v.dtype.kind == "f" \
            else rng.randint(0, 2**31 - 1, size=v.shape).astype(v.dtype)
    assert {"params/groups/0/attn/w_dkv", "opt/mu/groups/0/attn/w_kr",
            "opt/nu/groups/0/attn/w_uv"} <= set(want)
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
        named, _ = jflatten(ctx.load(jstate))
        got_np = {k: np.asarray(v) for k, v in named.items()}
    assert ctx.restarted
    ctx.shutdown()
    assert list(got_np) == list(want)
    for k, v in want.items():
        assert got_np[k].dtype == v.dtype and got_np[k].shape == v.shape, k
        assert got_np[k].tobytes() == v.tobytes(), k

"""The port's encoder-decoder (whisper-small) against the JAX package, on the
CPU, with a reduced whisper-small (2 + 2 layers, d_model 64, 4 heads of
16, d_ff 128, vocab 512, tied, gelu, no rope).

- ``layernorm``, ``sinusoidal_positions``, cross-attention
  (``gqa_attention`` and ``gqa_decode`` with ``kv_override``), ``encode``,
  ``decode_train``, ``encdec_forward`` and ``encdec_decode_step`` on the
  same weights and inputs, f32 and bf16; decode over the precomputed
  cross K/V equals ``decode_train`` in both packages.
- The parameter and cache layouts: the reference's leaf names, shapes
  and dtypes.
- ``ServingEngine`` over an ``EncDecCache`` (zero cross K/V, as the
  reference serves it); a ``TrainState`` and a ``ServeState`` stored by
  one package restore bit for bit in the other, and a DIFF of the
  ``ServeState`` dirties the same blocks in both.

The reference's init makes every norm scale 1, so every parameter leaf
here is drawn from a seeded numpy generator, non-zero, and the same arrays
go to both packages.  The reference's blockwise cross-attention takes only
as many keys as queries (its mask is (S, S)), so cases with S ≠ T run the
reference's flash kernel in interpret mode.  Every tolerance is stated
where it is used.
"""
import dataclasses

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
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
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
from repro_torch.data.synthetic import init_data_state, next_batch
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models import layers
from repro_torch.models.layers import cast_floating
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import ServeState, ServingEngine
from repro_torch.train.state import init_train_state, prng_key

ARCH = "whisper-small"
LEAVES = ["dec_layers/cross_attn/wk", "dec_layers/cross_attn/wo",
          "dec_layers/cross_attn/wq", "dec_layers/cross_attn/wv",
          "dec_layers/ln1/scale", "dec_layers/ln2/scale",
          "dec_layers/ln_x/scale", "dec_layers/mlp/w_down",
          "dec_layers/mlp/w_gate", "dec_layers/mlp/w_up",
          "dec_layers/self_attn/wk", "dec_layers/self_attn/wo",
          "dec_layers/self_attn/wq", "dec_layers/self_attn/wv", "embed",
          "enc_layers/attn/wk", "enc_layers/attn/wo", "enc_layers/attn/wq",
          "enc_layers/attn/wv", "enc_layers/ln1/scale",
          "enc_layers/ln2/scale", "enc_layers/mlp/w_down",
          "enc_layers/mlp/w_gate", "enc_layers/mlp/w_up", "ln_enc/scale",
          "ln_f/scale"]
CACHE_LEAVES = ["self_kv/k", "self_kv/v", "cross_k", "cross_v"]


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


def _assert_rows_near(got: np.ndarray, want: np.ndarray, ulps: int = 4):
    """bf16 against the reference: every element within ``ulps`` bf16 ulps
    of its row's largest magnitude (ROADMAP Queue 3, "bf16 logits against
    XLA": XLA keeps f32 inside its fusions and its CPU gelu rounds
    otherwise)."""
    row = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= ulps * bf16_ulp(row))


def _cfgs(compute=None):
    """The reference's and the port's reduced whisper-small (``compute``:
    the compute dtype, else the config's bf16)."""
    kw = {} if compute is None else {"compute_dtype": compute}
    return (dataclasses.replace(jget_arch(ARCH).reduced(), **kw),
            dataclasses.replace(get_arch(ARCH).reduced(), **kw))


def _seeded(named: dict, seed: int) -> dict:
    """Every leaf drawn from a seeded numpy generator: a norm scale around
    1 (± 0.2), a weight at 1/sqrt(its fan-in), ``embed`` at 0.5 so the tied
    logits are not all near zero."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in named.items():
        shape = tuple(v.shape)
        if k.endswith("scale"):
            a = 1.0 + 0.2 * rng.randn(*shape)
        elif k == "embed":
            a = 0.5 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) / np.sqrt(shape[-2])
        out[k] = a.astype(np.float32)
    return out


def _params(jcfg, cfg, seed=0):
    """Seeded parameters in both packages (the same f32 bytes)."""
    jnamed, jdef = jflatten(jencdec.encdec_param_struct(jcfg))
    arrays = _seeded(jnamed, seed)
    jparams = jax.tree_util.tree_unflatten(
        jdef, [jnp.asarray(arrays[k]) for k in jnamed])
    params = unflatten_named(from_numpy_named(arrays),
                             encdec.encdec_param_struct(cfg))
    return jparams, params


def _inputs(cfg, s, t_enc, seed=3):
    rng = np.random.RandomState(seed)
    frames = rng.randn(2, t_enc, cfg.d_model).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, (2, s)).astype(np.int32)
    return frames, toks


def _np_named(tree) -> dict:
    """Every leaf of a jax or torch tree as numpy, by name."""
    return {k: tensor_to_numpy(v) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in flatten_named(tree).items()}


# --------------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------------- #

def test_param_layout_equals_reference():
    """The 26 parameter leaves: the reference's names, order, shapes and
    dtypes (f32), stacked over the layers in dim 0; ``init_encdec`` and
    ``encdec_param_struct`` (meta device) agree.  At full width the tree
    holds 294,683,904 parameters in both packages, 47,616 more than
    ``ArchConfig.param_count`` (the 62 norm scales of 768)."""
    jcfg, cfg = _cfgs()
    jnamed, _ = jflatten(jencdec.encdec_param_struct(jcfg))
    named = flatten_named(build_model(cfg).init(
        torch.Generator().manual_seed(0)))
    meta = flatten_named(encdec.encdec_param_struct(cfg))
    assert list(jnamed) == list(named) == list(meta) == LEAVES
    for k, v in named.items():
        assert tuple(v.shape) == jnamed[k].shape == tuple(meta[k].shape), k
        assert v.dtype == torch.float32 and str(jnamed[k].dtype) == \
            "float32" and meta[k].device.type == "meta"
    assert tuple(named["dec_layers/cross_attn/wk"].shape) == (2, 64, 64)
    full, jfull = get_arch(ARCH), jget_arch(ARCH)
    n = sum(v.numel() for v in flatten_named(
        encdec.encdec_param_struct(full)).values())
    jn = sum(int(np.prod(v.shape)) for v in jflatten(
        jencdec.encdec_param_struct(jfull))[0].values())
    assert n == jn == 294_683_904 == full.param_count() + 62 * 768


def test_cache_layout_equals_reference():
    """The cache tree: ``self_kv/k``, ``self_kv/v`` (L, B, max_len, KV, dh)
    and ``cross_k``, ``cross_v`` (L, B, enc_len, KV, dh), bf16 zeros, as
    the reference's; ``enc_len`` defaults to ``max_len``; ``cache_struct``
    allocates on the meta device; batch is dim 1."""
    jcfg, cfg = _cfgs()
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    for enc_len in (None, 40):
        kw = {} if enc_len is None else {"enc_len": enc_len}
        jst, _ = jflatten(jmodel.cache_struct(3, 24, **kw))
        st = flatten_named(model.init_caches(3, 24, device="cpu", **kw))
        meta = flatten_named(model.cache_struct(3, 24, **kw))
        assert list(st) == list(jst) == list(meta) == CACHE_LEAVES
        for k, v in st.items():
            assert tuple(v.shape) == jst[k].shape == tuple(meta[k].shape)
            assert str(v.dtype).split(".")[1] == str(jst[k].dtype) == \
                "bfloat16"
            assert meta[k].device.type == "meta" and not v.any()
        assert tuple(st["cross_k"].shape) == (2, 3, enc_len or 24, 4, 16)
    assert isinstance(model.init_caches(1, 8, device="cpu"),
                      encdec.EncDecCache)
    assert encdec.EncDecCache._fields == jencdec.EncDecCache._fields
    assert [s.axis for s in model.cache_protects()] == [{"batch": 1}]


# --------------------------------------------------------------------------- #
# the pieces
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layernorm_matches_reference(dtype):
    """f32: within 2e-5 of the reference; bf16 in and out: within one bf16
    ulp of each element (both compute in f32 and round once).  The
    variance is the population one.  Nothing on the whisper path calls
    it."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 48) * 2 + 0.5).astype(np.float32)
    p_np = {"scale": (1 + 0.2 * rng.randn(48)).astype(np.float32),
            "bias": (0.1 * rng.randn(48)).astype(np.float32)}
    init = layers.init_layernorm(48, torch.float32)
    assert sorted(init) == sorted(jlayers.init_layernorm(48, jnp.float32))
    assert init["scale"].eq(1).all() and not init["bias"].any()
    conv, jdt = (t, jnp.float32) if dtype == "f32" else (bf16, jnp.bfloat16)
    want = np.asarray(jlayers.layernorm(
        {k: jnp.asarray(v) for k, v in p_np.items()},
        jnp.asarray(x).astype(jdt))).astype(np.float32)
    got = layers.layernorm({k: t(v) for k, v in p_np.items()}, conv(x))
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    if dtype == "f32":
        np.testing.assert_allclose(np_of(got), want, rtol=2e-5, atol=2e-5)
    else:
        assert np.all(np.abs(np_of(got) - want) <= bf16_ulp(want))


@pytest.mark.parametrize("seq,d", [(64, 64), (1536, 768)])
def test_sinusoidal_positions_match_reference(seq, d):
    """The (seq, d) f32 table against the reference at the reduced width
    and at whisper-small's (1,536 frames of 768).  The frequency factors
    are built from f32 tensors, as jnp builds them, and come out within
    one f32 ulp of the reference's (XLA's CPU exp is off the correctly
    rounded value for 36 of the 384 factors, torch's for 5).  Position
    ``p`` multiplies that ulp by ``p`` and the f32 angle ``p · div`` then
    rounds to its own ulp, so each element is held to 2e-5 plus ``p`` ulps
    of its factor plus one ulp of its angle (up to 2.4e-4 at 1,535;
    measured 1.2e-4)."""
    got = encdec.sinusoidal_positions(seq, d).numpy()
    want = np.asarray(jencdec.sinusoidal_positions(seq, d))
    div = np.asarray(jnp.exp(jnp.arange(0, d, 2, dtype=jnp.float32)
                             * (-jnp.log(10000.0) / d)))
    assert np.all(np.abs(encdec._div_term(d).numpy() - div)
                  <= np.spacing(div))
    assert got.dtype == np.float32 and got.shape == want.shape
    pos = np.arange(seq, dtype=np.float32)[:, None]
    tol = 2e-5 + np.repeat(pos * np.spacing(div) + np.spacing(pos * div), 2,
                           axis=1)
    assert np.all(np.abs(got - want) <= tol)


def _cross_layer(jcfg, cfg, seed=5):
    """One cross-attention layer's parameters in both packages."""
    jp = jattn.init_cross_attn(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = attn.init_cross_attn(torch.Generator().manual_seed(seed), cfg,
                             torch.float32)
    assert sorted(p) == sorted(jp) == ["wk", "wo", "wq", "wv"]
    arrays = _seeded({k: v for k, v in jp.items()}, seed)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: t(v) for k, v in arrays.items()})


@pytest.mark.parametrize("impl,ref_impl,s,t_enc", [
    ("blockwise", "blockwise", 64, 64),
    ("flash", "flash", 64, 64),
    ("flash", "flash", 32, 64),
    ("blockwise", "flash", 32, 64)])
def test_cross_attention_matches_reference(monkeypatch, impl, ref_impl, s,
                                           t_enc):
    """``gqa_attention`` with ``kv_override``, f32, B 2: within 2e-5 of the
    reference, which runs blockwise or its flash kernel in interpret mode
    (the port's flash path is its plain version here).  S ≠ T: the port's
    blockwise takes T keys; the reference's needs its flash."""
    jcfg, cfg = _cfgs("float32")
    jp, p = _cross_layer(jcfg, cfg)
    rng = np.random.RandomState(2)
    x = rng.randn(2, s, cfg.d_model).astype(np.float32)
    enc = rng.randn(2, t_enc, cfg.d_model).astype(np.float32)
    monkeypatch.setenv("REPRO_ATTN_IMPL", ref_impl)
    want = np.asarray(jattn.gqa_attention(jp, jnp.asarray(x), jcfg,
                                          kv_override=jnp.asarray(enc)))
    monkeypatch.setenv("REPRO_ATTN_IMPL", impl)
    got = attn.gqa_attention(p, t(x), cfg, kv_override=t(enc))
    assert got.shape == want.shape == (2, s, cfg.d_model)
    np.testing.assert_allclose(np_of(got), want, rtol=2e-5, atol=2e-5)


def test_cross_attention_is_never_causal():
    """``causal=True`` is ignored with ``kv_override``: the first query
    reads every key (a causal mask would leave it key 0 alone)."""
    _, cfg = _cfgs("float32")
    _, p = _cross_layer(*_cfgs("float32"))
    rng = np.random.RandomState(4)
    x, enc = (t(rng.randn(1, 16, cfg.d_model).astype(np.float32))
              for _ in range(2))
    a = attn.gqa_attention(p, x, cfg, causal=True, kv_override=enc)
    b = attn.gqa_attention(p, x, cfg, causal=False, kv_override=enc)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_decode_matches_reference(dtype):
    """``gqa_decode`` with ``kv_override=(k, v)`` over a static (B, 24, KV,
    dh) cross cache, 6 positions: f32 within 2e-5 of the reference, bf16
    within 4 ulps of each row's largest; the self cache it is given comes
    back as it was, unwritten."""
    jcfg, cfg = _cfgs("float32")
    jp, p = _cross_layer(jcfg, cfg)
    conv, jdt, dt = ((t, jnp.float32, torch.float32) if dtype == "f32"
                     else (bf16, jnp.bfloat16, torch.bfloat16))
    if dtype == "bf16":
        jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
        p = {k: bf16(np.asarray(v)) for k, v in p.items()}
    rng = np.random.RandomState(6)
    shape = (2, 24, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    jself = jattn.init_kv_cache(2, jcfg, 16, jdt)
    cache = attn.init_kv_cache(2, cfg, 16, dt, "cpu")
    for pos in range(6):
        x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        want, _ = jattn.gqa_decode(
            jp, jnp.asarray(x).astype(jdt), jself, jnp.int32(pos), jcfg,
            kv_override=(jnp.asarray(ck).astype(jdt),
                         jnp.asarray(cv).astype(jdt)))
        got, back = attn.gqa_decode(p, conv(x), cache, pos, cfg,
                                    kv_override=(conv(ck), conv(cv)))
        assert back is cache and not cache.k.any() and not cache.v.any()
        want = np.asarray(want).astype(np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(np_of(got), want, rtol=2e-5,
                                       atol=2e-5)
        else:
            _assert_rows_near(np_of(got), want)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("impl,s,t_enc", [("blockwise", 32, 32),
                                          ("flash", 32, 64)])
def test_encode_decode_train_forward_f32_match_reference(monkeypatch, impl,
                                                         s, t_enc):
    """f32 compute, B 2: ``encode`` (T frames), ``decode_train`` (S tokens
    over the reference's encoder states) and ``encdec_forward`` within
    2e-5 of the reference, whose aux is a zero f32 as the port's.  S ≠ T
    through flash (the reference's interpret mode, the port's plain
    version)."""
    monkeypatch.setenv("REPRO_ATTN_IMPL", impl)
    jcfg, cfg = _cfgs("float32")
    jparams, params = _params(jcfg, cfg)
    frames, toks = _inputs(cfg, s, t_enc)
    jenc = jencdec.encode(jparams, jnp.asarray(frames), jcfg)
    enc = encdec.encode(params, t(frames), cfg)
    np.testing.assert_allclose(np_of(enc), np.asarray(jenc), rtol=2e-5,
                               atol=2e-5)
    want = np.asarray(jencdec.decode_train(jparams, jnp.asarray(toks), jenc,
                                           jcfg))
    got = encdec.decode_train(params, t(toks), t(np.asarray(jenc)), cfg)
    assert got.shape == want.shape == (2, s, cfg.vocab_size)
    np.testing.assert_allclose(np_of(got), want, rtol=2e-5, atol=2e-5)
    jlog, jaux = jencdec.encdec_forward(jparams, jnp.asarray(frames),
                                        jnp.asarray(toks), jcfg)
    log, aux = build_model(cfg).forward(
        params, {"frames": t(frames), "tokens": t(toks)})
    np.testing.assert_allclose(np_of(log), np.asarray(jlog), rtol=2e-5,
                               atol=2e-5)
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0


def test_encdec_forward_bf16_near_reference():
    """bf16 compute (the training path), B 2, S 32, T 32, each package as
    it ships: the logits within four bf16 ulps of each row's largest
    magnitude (ROADMAP Queue 3's rule for the XLA-vs-torch gap: XLA keeps
    f32 inside its fusions, and its CPU gelu rounds otherwise; measured
    two ulps, 24,550 of 32,768 logits not bit-equal)."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, cfg)
    frames, toks = _inputs(cfg, 32, 32)
    want, _ = jencdec.encdec_forward(jparams, jnp.asarray(frames),
                                     jnp.asarray(toks), jcfg)
    got, _ = encdec.encdec_forward(params, t(frames), t(toks), cfg)
    assert got.dtype == torch.bfloat16
    _assert_rows_near(np_of(got), np.asarray(want).astype(np.float32))


def _decode_both(jcfg, cfg, steps=8, t_enc=24):
    """Both packages decode ``steps`` seeded tokens over the cross K/V of
    their own encoder states (``precompute_cross_kv(encode(frames))``) →
    ([(reference logits, port logits)], reference caches, port caches)."""
    jparams, params = _params(jcfg, cfg)
    frames, toks = _inputs(cfg, steps, t_enc)
    jcast = jlayers.cast_floating(jparams, jnp.dtype(jcfg.compute_dtype))
    cast = cast_floating(params, getattr(torch, cfg.compute_dtype))
    jk, jv = jencdec.precompute_cross_kv(
        jcast, jencdec.encode(jcast, jnp.asarray(frames), jcfg), jcfg)
    k, v = encdec.precompute_cross_kv(
        cast, encdec.encode(cast, t(frames), cfg), cfg)
    jcaches = jencdec.init_encdec_caches(2, jcfg, 16, t_enc)._replace(
        cross_k=jk, cross_v=jv)
    caches = build_model(cfg).init_caches(2, 16, device="cpu", enc_len=t_enc)
    caches.cross_k.copy_(k)
    caches.cross_v.copy_(v)
    out = []
    for i in range(steps):
        want, jcaches = jencdec.encdec_decode_step(
            jparams, jnp.asarray(toks[:, i:i + 1]), jcaches, jnp.int32(i),
            jcfg)
        got, back = encdec.encdec_decode_step(params, t(toks[:, i:i + 1]),
                                              caches, i, cfg)
        assert back is caches
        out.append((np.asarray(want).astype(np.float32), np_of(got)))
    return out, jcaches, caches, (jparams, params, frames, toks)


def test_encdec_decode_steps_f32_match_reference():
    """f32 compute, eight ``encdec_decode_step``s over the cross K/V of 24
    encoder states: the logits within 2e-5 of the reference at every step,
    and every cache leaf after them (the self-KV rows 0–7 written in place,
    the rest zero; measured 6.7e-6 at logits of magnitude 14)."""
    out, jcaches, caches, _ = _decode_both(*_cfgs("float32"))
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    jn, n = _np_named(jcaches), _np_named(caches)
    assert list(n) == list(jn) == CACHE_LEAVES
    for k in jn:
        np.testing.assert_allclose(n[k], jn[k], rtol=2e-5, atol=2e-5,
                                   err_msg=k)
    assert n["self_kv/k"][:, :, :8].any() and not n["self_kv/k"][:, :, 8:].any()


def test_encdec_decode_steps_bf16_near_reference():
    """bf16 compute (the serving default), each package as it ships, eight
    steps: the logits within four bf16 ulps of each row's largest at every
    step (the rule of ROADMAP Queue 3; measured two)."""
    out, _, _, _ = _decode_both(*_cfgs())
    for want, got in out:
        _assert_rows_near(got, want)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_decode_over_precomputed_cross_kv_equals_decode_train(monkeypatch,
                                                              package):
    """Within each package, f32: eight decode steps over
    ``precompute_cross_kv(encode(frames))`` give ``decode_train``'s logits
    at each position within 2e-5, so decode reads the cross cache at the
    right place (no reference test checks this).  Flash attention (the
    reference's in interpret mode, the port's plain version): the
    reference's blockwise takes no S ≠ T."""
    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")      # S 8 ≠ T 24
    jcfg, cfg = _cfgs("float32")
    out, _, _, (jparams, params, frames, toks) = _decode_both(jcfg, cfg)
    if package == "jax":
        full = np.asarray(jencdec.decode_train(
            jparams, jnp.asarray(toks),
            jencdec.encode(jparams, jnp.asarray(frames), jcfg), jcfg))
        steps = [w for w, _ in out]
    else:
        full = np_of(encdec.decode_train(
            params, t(toks), encdec.encode(params, t(frames), cfg), cfg))
        steps = [g for _, g in out]
    for i, lg in enumerate(steps):
        np.testing.assert_allclose(lg[:, 0], full[:, i], rtol=2e-5,
                                   atol=2e-5)


def test_next_batch_gives_frames_tokens_and_labels():
    """The encdec batch: ``frames`` (B, S, d_model) in the compute dtype
    at the scale of 0.02, tokens and labels of S + 1 draws split as the
    dense case does, the reference's shapes and dtypes."""
    from repro.data.synthetic import next_batch as jnext_batch
    jcfg, cfg = _cfgs()
    b, st = next_batch(init_data_state(3), cfg, 2, 16)
    jb, _ = jnext_batch(jinit_data_state(3), jcfg, 2, 16)
    assert list(b) == list(jb) == ["frames", "tokens", "labels"]
    for k in b:
        assert tuple(b[k].shape) == jb[k].shape, k
        assert str(b[k].dtype).split(".")[1] == str(jb[k].dtype), k
    assert 0.01 < float(b["frames"].float().std()) < 0.03
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(st.position) == 1
    again, _ = next_batch(init_data_state(3), cfg, 2, 16)
    assert all(torch.equal(again[k], b[k]) for k in b)


# --------------------------------------------------------------------------- #
# serving over an EncDecCache
# --------------------------------------------------------------------------- #

def test_engine_tokens_match_reference():
    """Prefill 6 tokens and generate 10, f32 compute, over the zero cross
    K/V both engines serve (neither runs the encoder): the port's tokens,
    position and last token equal the reference engine's, and its caches
    are within 2e-5."""
    jcfg, cfg = _cfgs("float32")
    jparams, params = _params(jcfg, cfg)
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
    assert list(n) == list(jn) == CACHE_LEAVES
    assert not n["cross_k"].any() and not n["cross_v"].any()
    for k in jn:
        np.testing.assert_allclose(n[k], jn[k], rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------- #
# checkpoints across the packages
# --------------------------------------------------------------------------- #

def _ckpt_cfg(cls, d):
    return cls(dir=str(d), backend="fti", block_bytes=256,
               dedicated_thread=False, objstore=False)


def _store_chain(engine, ctx_cls, cfg_cls, d, diff_kind):
    """FULL after prefill, then a DIFF 4 tokens later → (the DIFF's report,
    the state stored last, as numpy by name)."""
    ctx = ctx_cls(_ckpt_cfg(cfg_cls, d))
    ctx.store(engine.get_state(), id=1, level=1)
    engine.generate(4)
    rep = ctx.store(engine.get_state(), id=2, level=1, kind=diff_kind)
    ctx.shutdown()
    return rep, _np_named(engine.get_state())


SERVE_LEAVES = sorted(["caches/" + c for c in CACHE_LEAVES] +
                      ["last_token", "pos"])


def _assert_named_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want) == SERVE_LEAVES
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def _prompts(cfg):
    return np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)


def test_reference_serve_checkpoint_restores_in_port(tmp_path):
    """repro stores FULL + DIFF of its engine's whisper ServeState (bf16
    self-KV and cross caches); a port engine restores it bit-exact into a
    cold template and decodes on from it."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, cfg)
    jeng = JEngine(jbuild_model(jcfg), jparams, batch=2, max_len=32)
    jeng.prefill(jnp.asarray(_prompts(cfg)))
    rep, want = _store_chain(jeng, jctx.CheckpointContext,
                             jctx.CheckpointConfig, tmp_path, "DIFF")
    assert rep.kind == "DIFF"
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
    """The port stores FULL + DIFF of its engine's whisper ServeState; the
    reference restores it bit-exact into its own cold template."""
    jcfg, cfg = _cfgs()
    _, params = _params(jcfg, cfg)
    eng = ServingEngine(build_model(cfg), params, batch=2, max_len=32)
    eng.prefill(t(_prompts(cfg)))
    rep, want = _store_chain(eng, CheckpointContext, CheckpointConfig,
                             tmp_path, CHK_DIFF)
    assert rep.kind == CHK_DIFF
    cold = JServeState(jbuild_model(jcfg).init_caches(2, 32), jnp.int32(0),
                       jnp.zeros((2, 1), jnp.int32))
    ctx = jctx.CheckpointContext(_ckpt_cfg(jctx.CheckpointConfig, tmp_path))
    got = ctx.load(cold)
    ctx.shutdown()
    assert ctx.restarted
    _assert_named_equal(_np_named(got), want)


def test_diff_dirty_blocks_equal_reference(tmp_path):
    """Both engines, from the same weights and prompts, store a FULL after
    prefill and a DIFF 4 tokens later (256-byte blocks): the same
    dirty-block count, equal to the self-KV rows written (positions 5–8 of
    both sequences, K and V of each layer) plus ``pos`` and, if its tokens
    moved, ``last_token``; the cross caches never change."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, cfg)
    jeng = JEngine(jbuild_model(jcfg), jparams, batch=2, max_len=32)
    jeng.prefill(jnp.asarray(_prompts(cfg)))
    jrep, _ = _store_chain(jeng, jctx.CheckpointContext,
                           jctx.CheckpointConfig, tmp_path / "j", "DIFF")
    eng = ServingEngine(build_model(cfg), params, batch=2, max_len=32)
    eng.prefill(t(_prompts(cfg)))
    rep, named = _store_chain(eng, CheckpointContext, CheckpointConfig,
                              tmp_path / "t", CHK_DIFF)
    blocks = sum(-(-max(v.nbytes, 1) // 256) for v in named.values())
    got = round(rep.dirty_ratio * blocks)
    assert rep.kind == jrep.kind == CHK_DIFF
    assert got == round(jrep.dirty_ratio * blocks)
    row = cfg.n_kv_heads * cfg.head_dim * 2             # one bf16 K or V row
    kv = {((layer * 2 + s) * 32 + p) * row // 256 for layer in range(2)
          for s in range(2) for p in range(5, 9)}
    want = 2 * len(kv) + 1
    assert got in (want, want + 1)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_trainstate_cross_reads_both_ways(tmp_path, writer):
    """A reduced whisper TrainState (its 26 parameter leaves and their
    moments), filled with seeded values, stored by one package (FTI,
    level 1) restores bit for bit into the other package's own
    template."""
    d = str(tmp_path / "ck")
    jcfg, cfg = _cfgs()
    jstate = jinit_train_state(jbuild_model(jcfg).init(jax.random.PRNGKey(0)),
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
    assert {"params/dec_layers/cross_attn/wk", "opt/mu/enc_layers/attn/wq",
            "opt/nu/ln_enc/scale"} <= set(want)
    assert sum(k.startswith("params/") for k in want) == 26
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


def test_decode_step_position_row_equals_the_table():
    """The decode step adds position ``pos`` from its own formula
    (``pos · div``, as the reference's decode does); it equals row ``pos``
    of ``sinusoidal_positions`` bit for bit in the port."""
    _, cfg = _cfgs("float32")
    table = encdec.sinusoidal_positions(40, cfg.d_model)
    for pos in (0, 1, 7, 39):
        ang = torch.tensor(float(pos)) * encdec._div_term(cfg.d_model)
        row = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(-1)
        assert torch.equal(row, table[pos])

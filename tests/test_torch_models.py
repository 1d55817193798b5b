"""The port's model modules against the JAX package, on the CPU.

- ``flash_attention_ref`` (the flash kernel's plain version, what a CPU
  tensor runs) against the Pallas kernel in interpret mode at the shapes
  of ``tests/test_flash_compression.py``; the autograd.Function's gradient
  against ``jax.grad`` of the reference's ``blockwise_attention``.
- The layers, blockwise attention and ``lm_forward`` of a reduced
  tinyllama against the reference on the same weights (carried across
  with ``from_numpy_named`` onto the port's template) and tokens.

Inputs are numpy arrays from a seed; every tolerance is stated where it
is used.  The Hopper kernel itself is checked on a card in
``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.protect import flatten_named as jflatten
from repro.kernels.flashattn import flash_attention as jflash
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.zoo import build_model as jbuild_model
from repro_torch.configs import get_arch
from repro_torch.core.protect import (flatten_named, from_numpy_named,
                                      unflatten_named)
from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.zoo import build_model

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


# --------------------------------------------------------------------------- #
# the flash kernel's plain version and gradient
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,bq,bk", [(128, 64, 64), (256, 128, 64)])
def test_flash_ref_matches_pallas_interpret(causal, s, bq, bk):
    """f32 within rtol = atol = 2e-5, as the reference's own test holds
    the Pallas kernel to its blockwise oracle."""
    rng = np.random.RandomState(0)
    b, h, dh = 2, 2, 64
    q, k, v = ((rng.randn(b * h, s, dh) * 0.3).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, bq=bq, bk=bk, interpret=True))
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal, bq=bq, bk=bk)
    np.testing.assert_allclose(np_of(got), want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, ref.flash_attention_ref(t(q), t(k), t(v),
                                                    causal=causal))


def test_flash_ref_bf16_within_one_ulp_of_pallas():
    """bf16 in, bf16 out: both round one f32 result, so they agree within
    one bf16 ulp of the output."""
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 128, 64).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, causal=True, bq=64, bk=64,
                             interpret=True)).astype(np.float32)
    got = ops.flash_attention(bf16(q), bf16(k), bf16(v), causal=True,
                              bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(np_of(got) - want) <= bf16_ulp(want))


def test_flash_ref_extreme_logits_stable():
    """The reference's own case: scores of 8·8·64/8 = 512 do not overflow."""
    q = torch.full((1, 128, 64), 8.0)
    o = ops.flash_attention(q, q, torch.ones(1, 128, 64), causal=False,
                            bq=64, bk=64)
    np.testing.assert_allclose(np_of(o), 1.0, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_moving_maximum_at_extreme_logits_matches_pallas(causal):
    """Scores of about ±512 whose row maximum rises from one key tile to
    the next, so the online softmax rescales at every tile (the reference's
    equal scores never do): the plain version against the Pallas kernel in
    interpret mode, f32 within 2e-5.  q and k are integers (every partial
    sum of q·k exact in f32), dim 0 a ramp: 32 in every query, -88 to 88
    over the keys; the case ``chip_smoke.py`` and the ``gpu`` test hold
    both Hopper kernels to."""
    rng = np.random.RandomState(6)
    bh, s, dh = 2, 256, 64
    q, k = (np.clip(np.round(rng.randn(bh, s, dh) * 6), -31, 31)
            .astype(np.float32) for _ in range(2))
    q[..., 0] = 32
    k[..., 0] = np.round(np.linspace(-88, 88, s))
    v = rng.randn(bh, s, dh).astype(np.float32)
    sc = np.einsum("bqd,bkd->bqk", q, k) / 8
    assert 300 < -sc.min() and sc.max() > 300
    tile_max = sc.reshape(bh, s, -1, 64).max(-1)
    assert np.all(tile_max[..., 1:] > np.maximum.accumulate(
        tile_max, axis=-1)[..., :-1])
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, bq=64, bk=64, interpret=True))
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal, bq=64, bk=64)
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradient_matches_jax_grad_of_blockwise(causal):
    """The autograd.Function (plain forward on the CPU, the exact backward
    in plain PyTorch) against jax.grad of the reference's
    blockwise_attention: f32, within 1e-5."""
    rng = np.random.RandomState(2)
    b, s, h, dh = 2, 128, 4, 16
    q, k, v, w = ((rng.randn(b, s, h, dh) * 0.5).astype(np.float32)
                  for _ in range(4))

    def jloss(q, k, v):
        return jnp.sum(jattn.blockwise_attention(
            q, k, v, causal=causal, q_block=64) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    (ops.flash_attention_bshd(*leaves, causal=causal) * t(w)).sum().backward()
    for got, exp in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(exp),
                                   rtol=0, atol=1e-5)


def test_flash_vjp_matches_autograd_of_the_plain_version():
    """The explicit gradient (chunked over batch·heads) equals autograd
    through flash_attention_ref: f32, within 1e-6 plus 2e-6 relative (the
    two sum the same terms in another order)."""
    rng = np.random.RandomState(3)
    q, k, v, do = (t(rng.randn(6, 64, 32).astype(np.float32))
                   for _ in range(4))
    for causal in (True, False):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (ref.flash_attention_ref(*leaves, causal=causal) * do).sum().backward()
        got = ref.flash_attention_vjp_ref(q, k, v, do, causal=causal,
                                          chunk_bytes=64 * 64 * 4 * 2)
        for g, leaf in zip(got, leaves):
            np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(),
                                       rtol=2e-6, atol=1e-6)


def test_flash_shape_contract_raises():
    x = torch.zeros(2, 200, 64)                 # 200 is not a multiple of 128
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="BH"):
        ops.flash_attention(torch.zeros(2, 64, 64), torch.zeros(3, 64, 64),
                            torch.zeros(3, 64, 64))
    # bf16 takes dh 128 on the tensor cores; f32 keeps the CUDA-core widths
    assert fa.HEAD_DIMS == (16, 32, 64, 128)
    assert fa.F32_HEAD_DIMS == (16, 32, 64)


# --------------------------------------------------------------------------- #
# layers and blockwise attention
# --------------------------------------------------------------------------- #

def test_layers_match_reference():
    """rmsnorm, the gated MLP, rotary embedding and the cross-entropy on
    the same inputs: f32, within 2e-6 (transcendentals differ by an ulp
    between the two libraries), rotary within 2e-5 (its angles reach 63
    rad, where an ulp of the angle is 4e-6)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 32).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(layers.rmsnorm({"scale": t(scale)}, t(x))),
        np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(x))), rtol=0, atol=2e-6)
    p = {k: (rng.randn(*s) * 0.2).astype(np.float32) for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    np.testing.assert_allclose(
        np_of(layers.mlp({k: t(v) for k, v in p.items()}, t(x))),
        np.asarray(jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x))), rtol=0, atol=2e-6)
    xr = rng.randn(2, 64, 4, 16).astype(np.float32)
    pos = np.arange(64)[None, :]
    np.testing.assert_allclose(
        np_of(layers.apply_rope(t(xr), t(pos), 10_000.0)),
        np.asarray(jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos),
                                      10_000.0)), rtol=0, atol=2e-5)
    logits = (rng.randn(3, 8, 50) * 3).astype(np.float32)
    labels = rng.randint(0, 50, size=(3, 8)).astype(np.int32)
    np.testing.assert_allclose(
        np_of(layers.softmax_cross_entropy(t(logits), t(labels))),
        np.asarray(jlayers.softmax_cross_entropy(jnp.asarray(logits),
                                                 jnp.asarray(labels))),
        rtol=0, atol=2e-6)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48)])
def test_blockwise_attention_matches_reference(causal, window):
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 256, 4, 16).astype(np.float32) for _ in range(3))
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, q_block=64)
    got = attn.blockwise_attention(t(q), t(k), t(v), causal=causal,
                                   window=window, q_block=64)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_repeat_kv_matches_reference():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    assert np.array_equal(np_of(attn.repeat_kv(t(x), 3)),
                          np.asarray(jattn.repeat_kv(jnp.asarray(x), 3)))


# --------------------------------------------------------------------------- #
# the whole LM
# --------------------------------------------------------------------------- #

def _carried(jcfg, cfg, seed=0):
    """Reference params from a key → the same bytes in the port's layout."""
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    named, _ = jflatten(jparams)
    tmpl = build_model(cfg).init(torch.Generator().manual_seed(seed))
    return jparams, unflatten_named(
        from_numpy_named({k: np.asarray(v) for k, v in named.items()}), tmpl)


def test_param_layout_equals_reference():
    cfg = get_arch(ARCH)
    jnamed, _ = jflatten(jax.eval_shape(
        lambda: jtf.init_lm(jax.random.PRNGKey(0), jget_arch(ARCH).reduced())))
    named = flatten_named(tf.init_lm(torch.Generator().manual_seed(0),
                                     cfg.reduced()))
    assert list(named) == list(jnamed)
    for k, v in named.items():
        assert tuple(v.shape) == jnamed[k].shape and v.dtype == torch.float32


@pytest.mark.parametrize("impl", ["blockwise", "flash"])
@pytest.mark.parametrize("remat", [False, True])
def test_lm_forward_f32_matches_reference(monkeypatch, impl, remat):
    """f32 compute: logits within 2e-5 of the reference (which runs its
    blockwise attention), through either attention of the port."""
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_arch(ARCH).reduced(),
                              compute_dtype="float32")
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 64))
    want, _ = jtf.lm_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    monkeypatch.setenv("REPRO_ATTN_IMPL", impl)
    got, aux = tf.lm_forward(params, t(toks.astype(np.int32)), cfg,
                             remat=remat)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "codeqwen1.5-7b",
                                  "internvl2-1b"])
def test_other_dense_archs_forward_match_reference(monkeypatch, arch):
    """The other decoder-only archs the dense path serves (qkv bias; the
    vision stub's prepended patch embeddings), reduced, f32 compute:
    logits within 2e-5 of the reference."""
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    jcfg = dataclasses.replace(jget_arch(arch).reduced(),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              compute_dtype="float32")
    jparams, params = _carried(jcfg, cfg)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    extra = None
    if cfg.n_frontend_tokens:
        extra = (rng.randn(2, cfg.n_frontend_tokens, cfg.d_model)
                 * 0.02).astype(np.float32)
    want, _ = jtf.lm_forward(jparams, jnp.asarray(toks), jcfg,
                             extra_embeds=None if extra is None
                             else jnp.asarray(extra))
    got, _ = tf.lm_forward(params, t(toks), cfg,
                           extra_embeds=None if extra is None else t(extra))
    assert got.shape == want.shape
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_lm_forward_bf16_matches_reference(monkeypatch):
    """bf16 compute (the training path), flash attention in the port: the
    logits within 0.05, a few bf16 ulps at their magnitude (|logit| < 2),
    and 99 % of them within 0.02.  Both round the same products in bf16,
    but not at the same places (matmul accumulation, the embedding
    gather's cast)."""
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 64))
    want, _ = jtf.lm_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    want = np.asarray(want).astype(np.float32)
    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    got, _ = tf.lm_forward(params, t(toks.astype(np.int32)), cfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(np_of(got) - want)
    assert np.abs(want).max() < 2.0
    assert err.max() <= 0.05 and np.quantile(err, 0.99) <= 0.02


def test_unported_architectures_raise():
    gen = torch.Generator().manual_seed(0)
    # every architecture is ported: mixtral, minicpm3, rwkv6, jamba (its
    # attention, mamba and MoE layers) and the encoder-decoder build, and
    # none raises
    assert "groups/0/moe/router" in flatten_named(
        build_model(get_arch("mixtral-8x7b").reduced()).init(gen))
    assert "groups/0/attn/w_uk" in flatten_named(
        build_model(get_arch("minicpm3-4b").reduced()).init(gen))
    assert "groups/0/mixer/lora_A" in flatten_named(
        build_model(get_arch("rwkv6-3b").reduced()).init(gen))
    assert {"groups/0/attn/wq", "groups/1/mixer/A_log",
            "groups/1/moe/router"} <= set(flatten_named(build_model(
                get_arch("jamba-1.5-large-398b").reduced()).init(gen)))
    assert {"enc_layers/attn/wq", "dec_layers/cross_attn/wk"} <= set(
        flatten_named(build_model(get_arch("whisper-small").reduced()).init(
            gen)))
    # decode is ported for the dense and MLA models: MLA's latent cache
    # builds
    cfg = get_arch("minicpm3-4b").reduced()
    caches = flatten_named(build_model(cfg).init_caches(2, 16, device="cpu"))
    assert {k: tuple(v.shape) for k, v in caches.items()} == {
        "0/c_kv": (2, 2, 16, cfg.mla.kv_lora_rank),
        "0/k_rope": (2, 2, 16, cfg.mla.qk_rope_dim)}

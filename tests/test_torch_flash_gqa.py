"""The grouped flash entry (``ops.flash_attention_gqa``) against the JAX
package, on the CPU.

Here the entry runs its plain version (``ref.flash_attention_gqa_ref``:
the KV heads repeated, then the flash kernel's plain version).  It must
match the reference's ``flash_attention_bshd`` run in interpret mode on the
reference's ``repeat_kv``'d inputs (f32, rtol = atol = 2e-5, as the
reference's own test holds the Pallas kernel to its oracle), and its
gradient ``jax.grad`` of the reference's ``blockwise_attention`` on
repeated KV, which sums dk and dv over each group (f32, atol 1e-5).  The
Hopper kernel, which reads the grouped heads in place, is checked on a
card in ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.protect import flatten_named as jflatten
from repro.kernels.flashattn import flash_attention_bshd as jflash_bshd
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.zoo import build_model as jbuild_model
from repro_torch.configs import get_arch
from repro_torch.core.protect import from_numpy_named, unflatten_named
from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.zoo import build_model


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(rng, b, s, h, kv, dh, scale=0.3):
    q = (rng.randn(b, s, h, dh) * scale).astype(np.float32)
    k = (rng.randn(b, s, kv, dh) * scale).astype(np.float32)
    v = (rng.randn(b, s, kv, dh) * scale).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 1), (8, 2)])
def test_gqa_forward_matches_pallas_interpret_on_repeated_kv(causal, h, kv):
    rng = np.random.RandomState(h * 10 + kv)
    b, s, dh = 2, 128, 32
    q, k, v = _qkv(rng, b, s, h, kv, dh)
    rep = h // kv
    want = np.asarray(jflash_bshd(
        jnp.asarray(q), jattn.repeat_kv(jnp.asarray(k), rep),
        jattn.repeat_kv(jnp.asarray(v), rep), causal=causal, bq=64, bk=64,
        interpret=True))
    got = ops.flash_attention_gqa(t(q), t(k), t(v), causal=causal, bq=64,
                                  bk=64)
    assert tuple(got.shape) == (b, s, h, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # the plain version is the BH-layout one on repeated heads
    rk, rv = (ref.repeat_kv(t(x), rep) for x in (k, v))
    assert torch.equal(got, ops.flash_attention_bshd(t(q), rk, rv,
                                                     causal=causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 1), (4, 4)])
def test_gqa_gradient_matches_jax_grad_of_blockwise(causal, h, kv):
    """dq, and dk, dv summed over each group, against jax.grad of the
    reference's blockwise_attention on repeat_kv'd K and V."""
    rng = np.random.RandomState(20 + h + kv)
    b, s, dh = 2, 128, 16
    q, k, v = _qkv(rng, b, s, h, kv, dh, scale=0.5)
    w = rng.randn(b, s, h, dh).astype(np.float32)
    rep = h // kv

    def jloss(q, k, v):
        return jnp.sum(jattn.blockwise_attention(
            q, jattn.repeat_kv(k, rep), jattn.repeat_kv(v, rep),
            causal=causal, q_block=64) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    (ops.flash_attention_gqa(*leaves, causal=causal) * t(w)).sum().backward()
    for got, exp in zip(leaves, want):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(exp),
                                   rtol=0, atol=1e-5)


def test_gqa_shape_contract_raises():
    q = torch.zeros(2, 128, 4, 16)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention_gqa(q, torch.zeros(2, 128, 3, 16),
                                torch.zeros(2, 128, 3, 16))
    with pytest.raises(ValueError, match="divide"):
        x = torch.zeros(2, 200, 4, 16)
        ops.flash_attention_gqa(x, x, x)
    with pytest.raises(ValueError, match="KV heads"):
        ops.flash_attention_bshd(q, torch.zeros(2, 128, 2, 16),
                                 torch.zeros(2, 128, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_gqa(q, q, q)              # the kernel entry


def test_model_flash_path_reads_grouped_kv_and_matches_reference(
        monkeypatch):
    """A reduced tinyllama forward with REPRO_ATTN_IMPL=flash hands the
    grouped entry K and V with their KV heads, not repeated, and its f32
    logits stay within 2e-5 of the reference's (blockwise) forward."""
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    jcfg = dataclasses.replace(jget_arch("tinyllama-1.1b").reduced(),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").reduced(),
                              compute_dtype="float32")
    assert cfg.n_kv_heads < cfg.n_heads
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    named, _ = jflatten(jparams)
    params = unflatten_named(
        from_numpy_named({k: np.asarray(v) for k, v in named.items()}),
        build_model(cfg).init(torch.Generator().manual_seed(0)))
    toks = np.random.RandomState(9).randint(0, cfg.vocab_size, (2, 64))
    want, _ = jtf.lm_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    seen = []
    real = attn.flash_attention_gqa

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], v.shape[2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn, "flash_attention_gqa", spy)
    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    got, _ = tf.lm_forward(params, t(toks.astype(np.int32)), cfg)
    assert seen == [(cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)] * \
        cfg.n_layers
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)

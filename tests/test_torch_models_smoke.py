"""Per-arch smoke tests of the port (``tests/test_models_smoke.py`` on the
PyTorch package): a reduced config of every ported architecture takes one
forward, one train step and one decode step on the CPU; output shapes and
finiteness.  Incremental decode equals the teacher-forced forward for
tinyllama, and the sliding-window mask keeps exactly the window.

Every registered architecture is ported, the encoder-decoder
(whisper-small, whose batch carries ``frames``) included."""
import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_arch
from repro_torch.core.protect import flatten_named
from repro_torch.data.synthetic import init_data_state, next_batch
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.state import init_train_state, prng_key
from repro_torch.train.step import make_train_step

BATCH, SEQ = 2, 32
PORTED = ("tinyllama-1.1b", "llama3.2-3b", "codeqwen1.5-7b", "internvl2-1b",
          "granite-moe-3b-a800m", "mixtral-8x7b", "minicpm3-4b", "rwkv6-3b",
          "jamba-1.5-large-398b", "whisper-small")


@pytest.fixture(scope="module")
def built():
    out = {}
    for name in PORTED:
        cfg = get_arch(name).reduced()
        m = build_model(cfg)
        out[name] = (cfg, m, m.init(torch.Generator().manual_seed(0)))
    return out


def test_every_arch_is_ported_or_raises():
    assert [n for n in ALL_ARCHS if n not in PORTED] == []
    for name in ALL_ARCHS:
        cfg = get_arch(name).reduced()
        assert build_model(cfg).cfg is cfg


@pytest.mark.parametrize("name", PORTED)
def test_forward_shapes_finite(built, name):
    cfg, m, params = built[name]
    batch, _ = next_batch(init_data_state(0), cfg, BATCH, SEQ)
    logits, aux = m.forward(params, batch)
    assert logits.shape == (BATCH, SEQ, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(aux)) and (float(aux) > 0) == (
        cfg.moe is not None)


@pytest.mark.parametrize("name", PORTED)
def test_train_step_reduces_loss_shape(built, name):
    cfg, m, params = built[name]
    state = init_train_state(params, prng_key(1), init_data_state(0))
    step = make_train_step(m, AdamWConfig(total_steps=5, warmup_steps=1))
    batch, _ = next_batch(state.data_state, cfg, BATCH, SEQ)
    s1, metrics = step(state, batch)
    assert int(s1.step) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0


@pytest.mark.parametrize("name", PORTED)
def test_decode_step(built, name):
    cfg, m, params = built[name]
    caches = m.init_caches(BATCH, 64, device="cpu")
    before = list(flatten_named(caches))
    tok = torch.ones((BATCH, 1), dtype=torch.int32)
    logits, caches2 = m.decode_step(params, tok, caches, 3)
    assert logits.shape == (BATCH, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    # the cache tree keeps its structure (and is written in place)
    assert list(flatten_named(caches2)) == before and caches2 is caches


def test_decode_matches_forward_tinyllama(built):
    """Incremental decode logits == teacher-forced forward logits (bf16
    compute: within 2e-2, the reference's bound)."""
    cfg, m, params = built["tinyllama-1.1b"]
    toks = torch.randint(0, cfg.vocab_size, (1, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    full_logits, _ = m.forward(params, {"tokens": toks})
    caches = m.init_caches(1, 16, device="cpu")
    outs = []
    for i in range(8):
        lg, caches = m.decode_step(params, toks[:, i:i + 1], caches, i)
        outs.append(lg)
    inc = torch.cat(outs, dim=1)
    np.testing.assert_allclose(inc.float().numpy(),
                               full_logits.float().detach().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_swa_mask_matches_window():
    """Mixtral's SWA: tokens beyond the window are masked out."""
    b, s, h, dh = 1, 64, 2, 8
    g = torch.Generator().manual_seed(0)
    k, q, v = (torch.randn(b, s, h, dh, generator=g) for _ in range(3))
    full = blockwise_attention(q, k, v, causal=True, window=16, q_block=16)
    # reference: dense masked attention
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dh)
    qi = torch.arange(s)[:, None]
    ki = torch.arange(s)[None, :]
    mask = (ki <= qi) & (ki > qi - 16)
    scores = torch.where(mask[None, None], scores, -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    np.testing.assert_allclose(full.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)

"""The port's device int8 codec (``repro_torch.dist.compression``):
``tests/test_flash_compression.py``'s int8 tests on tensors (error
feedback included), and its payloads and scales against the numpy codec
and the JAX package's device codec, byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # container without hypothesis: tiny shim
    from _hypothesis_fallback import given, settings, st

from repro.dist.compression import dequantize_int8 as jdequantize_int8
from repro.dist.compression import quantize_int8 as jquantize_int8
from repro_torch.dist.compression import (
    compress_roundtrip_error,
    dequantize_int8,
    quantize_int8,
    quantize_int8_np,
)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), n=st.integers(1, 10_000),
       scale=st.floats(1e-6, 1e4))
def test_int8_roundtrip_bounded_error(seed, n, scale):
    rng = np.random.RandomState(seed)
    g = torch.from_numpy((rng.randn(n) * scale).astype(np.float32))
    q, s = quantize_int8(g)
    back = dequantize_int8(q, s, g.shape)
    # per-block max-abs scaling → elementwise error ≤ scale/127 ≤ max/127
    err = (back - g).abs().numpy()
    bound = float(g.abs().max()) / 127.0 + 1e-12
    assert err.max() <= bound * 1.01


def test_int8_zero_grad_exact():
    g = torch.zeros(100)
    q, s = quantize_int8(g)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert not dequantize_int8(q, s, g.shape).any()
    assert not q.any() and not s.any()          # scale 0, payload 0


def test_roundtrip_error_metric_small():
    rng = np.random.RandomState(3)
    g = torch.from_numpy(rng.randn(4, 1000).astype(np.float32))
    rel = float(compress_roundtrip_error(g))
    assert 0.0 < rel < 0.01          # int8 ≈ 1/127 per-block relative error
    assert float(compress_roundtrip_error(torch.zeros(64))) == 0.0


@pytest.mark.parametrize("n,block", [(1, 1024), (5000, 1024), (4096, 1024),
                                     (3000, 256)])
def test_int8_payload_equals_numpy_codec_and_reference(n, block):
    """Ragged and whole blocks, an all-zero first block, and a last block
    whose scale is exactly 1 holding values at exact halves of a step
    (round half to even): the int8 payload and the f32 scales equal
    ``quantize_int8_np``'s and the JAX package's ``quantize_int8``'s byte
    for byte."""
    rng = np.random.RandomState(n)
    a = (rng.randn(n) * 3).astype(np.float32)
    if n > block:
        a[:block] = 0.0
    if n >= 8:
        a[-8:] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -1.5]
    q, s = quantize_int8(torch.from_numpy(a), block)
    qn, sn = quantize_int8_np(a, block)
    qj, sj = jquantize_int8(jnp.asarray(a), block)
    assert q.shape == qn.shape and s.shape == sn.shape
    assert q.numpy().tobytes() == qn.tobytes() == np.asarray(qj).tobytes()
    assert s.numpy().tobytes() == sn.tobytes() == np.asarray(sj).tobytes()
    if n >= 8:
        assert float(s[-1]) == 1.0
        assert q.reshape(-1)[n - 7:n].tolist() == [0, 2, 2, 0, -2, 4, -2]


def _feedback_rounds(g, zeros, quantize, dequantize, rounds: int = 20):
    """The reference test's loop, for either package: ``rounds`` int8
    round trips of ``g`` with the quantization error fed back into the
    next, and without → (sum with feedback, sum without)."""
    err, acc_fb, acc_nofb = zeros, zeros, zeros
    for _ in range(rounds):
        q, s = quantize(g + err)
        deq = dequantize(q, s, g.shape)
        err = (g + err) - deq
        acc_fb = acc_fb + deq
        q2, s2 = quantize(g)
        acc_nofb = acc_nofb + dequantize(q2, s2, g.shape)
    return acc_fb, acc_nofb


def test_error_feedback_reduces_bias():
    """With feedback the accumulated quantization error stays bounded
    instead of growing with the rounds (the reference's two bounds), and
    both sums equal the JAX package's loop on the same gradient bit for
    bit."""
    rng = np.random.RandomState(0)
    a = rng.randn(4096).astype(np.float32)
    g = torch.from_numpy(a) * 1e-3
    gj = jnp.asarray(a) * 1e-3
    assert g.numpy().tobytes() == np.asarray(gj).tobytes()
    acc_fb, acc_nofb = _feedback_rounds(g, torch.zeros_like(g),
                                        quantize_int8, dequantize_int8)
    true = g.numpy() * 20
    err_fb = np.linalg.norm(acc_fb.numpy() - true)
    err_nofb = np.linalg.norm(acc_nofb.numpy() - true)
    assert err_fb <= err_nofb * 1.05
    assert err_fb < np.linalg.norm(true) * 0.05
    jfb, jnofb = _feedback_rounds(gj, jnp.zeros_like(gj), jquantize_int8,
                                  jdequantize_int8)
    assert acc_fb.numpy().tobytes() == np.asarray(jfb).tobytes()
    assert acc_nofb.numpy().tobytes() == np.asarray(jnofb).tobytes()

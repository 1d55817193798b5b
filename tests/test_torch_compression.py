"""The port's device int8 codec (``repro_torch.dist.compression``):
``tests/test_flash_compression.py``'s int8 tests on tensors, and its
payloads and scales against the numpy codec and the JAX package's device
codec, byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # container without hypothesis: tiny shim
    from _hypothesis_fallback import given, settings, st

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

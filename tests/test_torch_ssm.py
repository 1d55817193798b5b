"""The port's SSM layers (RWKV6, Mamba) and the hybrid layer pattern against
the JAX package, on the CPU, with reduced rwkv6-3b (2 layers, d_model 64,
4 WKV heads of 16, chunk 16) and reduced jamba-1.5-large-398b (one group
of an attention and a Mamba layer: d_inner 128, 8 heads of 16, d_state 8,
conv 4, chunk 16; MoE on the Mamba layer).

- The chunked recurrences equal the sequential ones (the reference's
  ``tests/test_ssm_math.py``, on the port).
- ``groupnorm_heads``, the RWKV6 time and channel mixes, their decode
  steps, ``mamba_block`` and ``mamba_decode_step`` on the same weights and
  inputs as the reference, f32.
- ``lm_forward``, eight ``lm_decode_step``s and ``ServingEngine`` tokens of
  both models; the model's decode against its own forward.
- The parameter and cache layouts: the reference's leaf names and shapes.
- A ``ServeState`` (an RWKV recurrent state; jamba's KV cache and Mamba
  state) and a ``TrainState`` stored by one package restore bit for bit in
  the other, with the same dirty-block counts and promote decisions.

The reference initialises ``lora_B``, ``wB``, ``u`` and every ``mu`` to
zero, so parity on init weights would never reach ddlerp's LoRA, the decay
LoRA or the bonus: every leaf here is drawn from a seeded numpy generator,
non-zero, and the same arrays go to both packages.  Every tolerance is
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
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.zoo import build_model as jbuild_model
from repro.serve.engine import ServeState as JServeState
from repro.serve.engine import ServingEngine as JEngine
from repro.train.state import init_train_state as jinit_train_state
from repro_torch.configs import get_arch
from repro_torch.core.context import (CHK_DIFF, CHK_FULL, CheckpointConfig,
                                      CheckpointContext)
from repro_torch.core.formats import tensor_to_numpy
from repro_torch.core.protect import (flatten_named, from_numpy_named,
                                      to_host, unflatten_named)
from repro_torch.data.synthetic import init_data_state
from repro_torch.models import layers
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import ServeState, ServingEngine
from repro_torch.train.state import init_train_state, prng_key

RWKV = "rwkv6-3b"
JAMBA = "jamba-1.5-large-398b"


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


def _cfgs(arch, compute=None):
    """The reference's and the port's reduced ``arch`` (``compute``: the
    compute dtype, else the config's bf16)."""
    kw = {} if compute is None else {"compute_dtype": compute}
    return (dataclasses.replace(jget_arch(arch).reduced(), **kw),
            dataclasses.replace(get_arch(arch).reduced(), **kw))


def _seeded(named: dict, seed: int) -> dict:
    """Every leaf drawn from a seeded generator, non-zero, at the scale of
    the reference's init: a random leaf keeps its spread, a constant one
    (zeros, ones) gets 0.2 of noise around its value; ``w0`` (-6 at init,
    a decay of 0.9975) is drawn around -1 (a decay of ~0.7 per token)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in named.items():
        v = np.asarray(v)
        if v.dtype.kind != "f":
            out[k] = v
            continue
        v32 = v.astype(np.float32)
        noise = rng.randn(*v.shape).astype(np.float32)
        if k.endswith("w0"):
            x = -1.0 + 0.5 * noise
        elif float(v32.std()) > 0:
            x = noise * float(v32.std())
        else:
            x = v32 + 0.2 * noise
        out[k] = x.astype(v.dtype)
    return out


def _carried(jcfg, cfg, seed=0):
    """Seeded parameters in both packages' layouts (the same bytes)."""
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    named, jdef = jflatten(jparams)
    vals = _seeded(named, seed + 100)
    jparams = jax.tree_util.tree_unflatten(
        jdef, [jnp.asarray(vals[k]) for k in named])
    tmpl = build_model(cfg).init(torch.Generator().manual_seed(seed))
    return jparams, unflatten_named(from_numpy_named(vals), tmpl)


def _layer(init_j, jcfg, dtype="f32", seed=1):
    """One layer's seeded parameters in both packages (``dtype``: "f32" or
    "bf16")."""
    jp = init_j(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    vals = _seeded({k: np.asarray(v) for k, v in jp.items()}, seed)
    if dtype == "f32":
        return ({k: jnp.asarray(v) for k, v in vals.items()},
                {k: t(v) for k, v in vals.items()})
    return ({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in vals.items()},
            {k: bf16(v) for k, v in vals.items()})


def _np_named(tree) -> dict:
    """Every leaf of a jax or torch tree as numpy, by name."""
    return {k: tensor_to_numpy(v) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in flatten_named(tree).items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np_of(got) if isinstance(got, torch.Tensor)
                               else got, np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# --------------------------------------------------------------------------- #
# chunked = sequential (tests/test_ssm_math.py on the port)
# --------------------------------------------------------------------------- #

def wkv6_seq(r, k, v, logw, u):
    b, t_, h, K = r.shape
    V = v.shape[-1]
    S = np.zeros((b, h, K, V))
    out = np.zeros((b, t_, h, V))
    for i in range(t_):
        kv = np.einsum("bhk,bhv->bhkv", k[:, i], v[:, i])
        out[:, i] = np.einsum("bhk,bhkv->bhv", r[:, i],
                              S + u[None, :, :, None] * kv)
        S = np.exp(logw[:, i])[..., None] * S + kv
    return out


def ssd_seq(x, B, C, loga):
    b, t_, h, P = x.shape
    S = np.zeros((b, h, P, B.shape[-1]))
    out = np.zeros((b, t_, h, P))
    for i in range(t_):
        a = np.exp(loga[:, i])
        S = a[..., None, None] * S + np.einsum("bhp,bn->bhpn", x[:, i], B[:, i])
        out[:, i] = np.einsum("bhpn,bn->bhp", S, C[:, i])
    return out


def _wkv_inputs(seed, t_, logw=None):
    rng = np.random.RandomState(seed)
    b, h, K, V = 2, 3, 8, 8
    r = rng.randn(b, t_, h, K).astype(np.float32)
    k = rng.randn(b, t_, h, K).astype(np.float32)
    v = rng.randn(b, t_, h, V).astype(np.float32)
    if logw is None:
        logw = -np.exp(rng.randn(b, t_, h, K).astype(np.float32))
    u = rng.randn(h, K).astype(np.float32)
    return r, k, v, logw, u


def _ssd_inputs(seed, t_):
    rng = np.random.RandomState(seed)
    b, h, P, N = 2, 3, 4, 5
    return (rng.randn(b, t_, h, P).astype(np.float32),
            rng.randn(b, t_, N).astype(np.float32),
            rng.randn(b, t_, N).astype(np.float32),
            -np.abs(rng.randn(b, t_, h).astype(np.float32)))


@pytest.mark.parametrize("seed,t_,chunk", [(0, 8, 4), (1, 16, 8), (2, 32, 16),
                                           (3, 48, 16), (4, 16, 16),
                                           (5, 32, 4)])
def test_wkv6_chunked_equals_sequential(seed, t_, chunk):
    """rtol = atol = 2e-4 against the float64 recurrence, as the
    reference's own test; and within 2e-5 of the reference's chunked
    form (f32 both)."""
    r, k, v, logw, u = _wkv_inputs(seed, t_)
    got = ssm._wkv6_chunked(t(r), t(k), t(v), t(logw), t(u), chunk)
    np.testing.assert_allclose(np_of(got), wkv6_seq(r, k, v, logw, u),
                               rtol=2e-4, atol=2e-4)
    want = jssm._wkv6_chunked(*map(jnp.asarray, (r, k, v, logw)),
                              jnp.asarray(u), chunk)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("seed,t_,chunk", [(0, 8, 4), (1, 16, 8), (2, 32, 8),
                                           (3, 32, 4), (4, 16, 16)])
def test_ssd_chunked_equals_sequential(seed, t_, chunk):
    """rtol = atol = 2e-4 against the float64 recurrence, and within 2e-5
    of the reference's chunked form."""
    x, B, C, loga = _ssd_inputs(seed, t_)
    got = ssm._ssd_chunked(t(x), t(B), t(C), t(loga), chunk)
    np.testing.assert_allclose(np_of(got), ssd_seq(x, B, C, loga),
                               rtol=2e-4, atol=2e-4)
    want = jssm._ssd_chunked(*map(jnp.asarray, (x, B, C, loga)), chunk)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_wkv6_extreme_decay_stable():
    """No overflow with near-zero decay (exp(-exp(x)) can be tiny): a
    log-decay of -80, past the [-60, 0] clip of the intra-chunk ratios,
    stays finite and equals the sequential recurrence within 2e-4."""
    b, t_, h, K = 1, 32, 1, 4
    r, k, v, _, _ = _wkv_inputs(0, t_)
    r, k, v = r[:b, :, :h, :K], k[:b, :, :h, :K], v[:b, :, :h, :K]
    logw = np.full((b, t_, h, K), -80.0, np.float32)    # decay ≈ 0
    u = np.zeros((h, K), np.float32)
    got = np_of(ssm._wkv6_chunked(t(r), t(k), t(v), t(logw), t(u), 8))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, wkv6_seq(r, k, v, logw, u), rtol=2e-4,
                               atol=2e-4)


def test_ssd_extreme_decay_stable():
    """A log-decay of -80 per step in the SSD form: finite, and within
    2e-4 of the sequential recurrence."""
    x, B, C, _ = _ssd_inputs(1, 16)
    loga = np.full(x.shape[:3], -80.0, np.float32)
    got = np_of(ssm._ssd_chunked(t(x), t(B), t(C), t(loga), 8))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ssd_seq(x, B, C, loga), rtol=2e-4,
                               atol=2e-4)


def test_softplus_equals_jax_in_f32():
    """The port's softplus is the reference's ``jax.nn.softplus`` in f32:
    within two f32 ulps (rtol 2.4e-7) over [-100, 100], past
    ``F.softplus``'s threshold of 20 included; below ~-87 the result is
    subnormal, which XLA's CPU code flushes to zero (atol 1.2e-38, the
    smallest normal f32)."""
    x = np.concatenate([np.linspace(-100, 100, 20001),
                        np.random.RandomState(0).randn(4096) * 30]
                       ).astype(np.float32)
    got = np_of(ssm._softplus(t(x)))
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=1.2e-38)
    big = x > 20
    assert np.array_equal(got[big], want[big])


# --------------------------------------------------------------------------- #
# the layers against the reference, f32
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_groupnorm_heads_matches_reference(dtype):
    """(2, 8, 64) over 4 heads, each head's values offset from zero:
    f32 within 2e-5; bf16 within one bf16 ulp of the reference (both
    normalise in f32 and round once)."""
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 8, 64) * 3 + rng.randn(64)).astype(np.float32)
    conv, jdt = (t, jnp.float32) if dtype == "f32" else (bf16, jnp.bfloat16)
    got = layers.groupnorm_heads(conv(x), 4, 1e-5)
    want = np.asarray(jlayers.groupnorm_heads(jnp.asarray(x).astype(jdt), 4,
                                              1e-5)).astype(np.float32)
    assert got.dtype == conv(x).dtype
    if dtype == "f32":
        _close(got, want, 2e-5)
    else:
        assert np.all(np.abs(np_of(got) - want) <= bf16_ulp(want))


@pytest.mark.parametrize("shift", [False, True])
def test_rwkv6_time_mix_f32_matches_reference(shift):
    """B 2, T 32 (two chunks of 16), f32, every leaf seeded: within 2e-5,
    with and without a carried token shift."""
    jcfg, cfg = _cfgs(RWKV, "float32")
    jp, p = _layer(jssm.init_rwkv6_layer, jcfg)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 32, cfg.d_model).astype(np.float32)
    xs = rng.randn(2, 1, cfg.d_model).astype(np.float32) if shift else None
    want = jssm.rwkv6_time_mix(jp, jnp.asarray(x), jcfg,
                               None if xs is None else jnp.asarray(xs))
    got = ssm.rwkv6_time_mix(p, t(x), cfg, None if xs is None else t(xs))
    assert got.shape == want.shape == (2, 32, cfg.d_model)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    _close(got, want, 2e-5)


@pytest.mark.parametrize("shift", [False, True])
def test_rwkv6_channel_mix_f32_matches_reference(shift):
    """B 2, T 8, f32: within 2e-5."""
    jcfg, cfg = _cfgs(RWKV, "float32")
    jp, p = _layer(jssm.init_rwkv6_layer, jcfg)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    xs = rng.randn(2, 1, cfg.d_model).astype(np.float32) if shift else None
    want = jssm.rwkv6_channel_mix(jp, jnp.asarray(x),
                                  None if xs is None else jnp.asarray(xs))
    got = ssm.rwkv6_channel_mix(p, t(x), None if xs is None else t(xs))
    _close(got, want, 2e-5)


def test_rwkv6_decode_steps_f32_match_reference():
    """Twelve tokens through ``rwkv6_decode_step`` then
    ``rwkv6_channel_mix_decode``: both outputs and the three state leaves
    within 2e-5 of the reference at every step; the state is written in
    place (the same tensors come back)."""
    jcfg, cfg = _cfgs(RWKV, "float32")
    jp, p = _layer(jssm.init_rwkv6_layer, jcfg)
    jst = jssm.init_rwkv_state(2, jcfg, jnp.float32)
    st = ssm.init_rwkv_state(2, cfg, torch.float32, "cpu")
    bufs = tuple(st)
    rng = np.random.RandomState(5)
    for _ in range(12):
        x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        x2 = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        want, jst = jssm.rwkv6_decode_step(jp, jnp.asarray(x), jst, jcfg)
        want2, jst = jssm.rwkv6_channel_mix_decode(jp, jnp.asarray(x2), jst)
        got, st = ssm.rwkv6_decode_step(p, t(x), st, cfg)
        got2, st = ssm.rwkv6_channel_mix_decode(p, t(x2), st)
        assert all(a is b for a, b in zip(st, bufs))
        for a, b in ((got, want), (got2, want2), (st.tm_shift, jst.tm_shift),
                     (st.cm_shift, jst.cm_shift), (st.wkv, jst.wkv)):
            _close(a, b, 2e-5)
    assert float(st.wkv.abs().max()) > 0.5


def test_rwkv6_decode_equals_time_mix_within_the_port():
    """Within the port, f32: 16 decode steps of the time mix give the
    chunked forward's output at each position within 2e-5."""
    jcfg, cfg = _cfgs(RWKV, "float32")
    _, p = _layer(jssm.init_rwkv6_layer, jcfg)
    x = np.random.RandomState(6).randn(2, 16, cfg.d_model).astype(np.float32)
    full = np_of(ssm.rwkv6_time_mix(p, t(x), cfg))
    st = ssm.init_rwkv_state(2, cfg, torch.float32, "cpu")
    for i in range(16):
        got, st = ssm.rwkv6_decode_step(p, t(x[:, i:i + 1]), st, cfg)
        _close(got[:, 0], full[:, i], 2e-5)


def test_mamba_block_f32_matches_reference():
    """B 2, T 32 (two chunks of 16), f32, every leaf seeded (``A_log``,
    ``dt_bias`` and ``D`` included): within 2e-5."""
    jcfg, cfg = _cfgs(JAMBA, "float32")
    jp, p = _layer(jssm.init_mamba_layer, jcfg)
    assert p["A_log"].dtype == p["D"].dtype == torch.float32
    x = np.random.RandomState(7).randn(2, 32, cfg.d_model).astype(np.float32)
    want = jssm.mamba_block(jp, jnp.asarray(x), jcfg)
    got = ssm.mamba_block(p, t(x), cfg)
    assert got.shape == want.shape == (2, 32, cfg.d_model)
    _close(got, want, 2e-5)


def test_mamba_decode_steps_f32_match_reference():
    """Ten tokens through ``mamba_decode_step``: the output and the three
    state leaves within 2e-5 of the reference at every step, written in
    place; and the decode equals ``mamba_block`` over the same tokens
    within 2e-5."""
    jcfg, cfg = _cfgs(JAMBA, "float32")
    jp, p = _layer(jssm.init_mamba_layer, jcfg)
    jst = jssm.init_mamba_state(2, jcfg, jnp.float32)
    st = ssm.init_mamba_state(2, cfg, torch.float32, "cpu")
    bufs = tuple(st)
    x = np.random.RandomState(8).randn(2, 16, cfg.d_model).astype(np.float32)
    full = np_of(ssm.mamba_block(p, t(x), cfg))
    for i in range(10):
        xi = x[:, i:i + 1]
        want, jst = jssm.mamba_decode_step(jp, jnp.asarray(xi), jst, jcfg)
        got, st = ssm.mamba_decode_step(p, t(xi), st, cfg)
        assert all(a is b for a, b in zip(st, bufs))
        for a, b in ((got, want), (st.conv_x, jst.conv_x),
                     (st.conv_bc, jst.conv_bc), (st.ssm, jst.ssm)):
            _close(a, b, 2e-5)
        _close(got[:, 0], full[:, i], 2e-5)


def test_causal_conv_bf16_equals_reference():
    """The taps summed in order from 0 in bf16: bit-equal to the
    reference's Python ``sum``."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 12, 24).astype(np.float32)
    w = (rng.randn(4, 24) * 0.5).astype(np.float32)
    b = (rng.randn(24) * 0.1).astype(np.float32)
    got = ssm._causal_conv(bf16(x), bf16(w), bf16(b))
    want = jssm._causal_conv(*(jnp.asarray(a).astype(jnp.bfloat16)
                               for a in (x, w, b)))
    assert got.dtype == torch.bfloat16
    assert np_of(got).tobytes() == np.asarray(want).astype(
        np.float32).tobytes()


# --------------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_param_layout_equals_reference(arch):
    """The model's parameter leaves: the reference's names, shapes and
    dtypes (``A_log``, ``dt_bias``, ``D`` f32), in its order; an RWKV
    layer has ``ln1``, ``ln2`` and ``mixer`` and no ``mlp``."""
    jcfg, cfg = _cfgs(arch)
    jnamed, _ = jflatten(jax.eval_shape(
        lambda: jtf.init_lm(jax.random.PRNGKey(0), jcfg)))
    named = flatten_named(tf.init_lm(torch.Generator().manual_seed(0), cfg))
    assert list(named) == list(jnamed)
    for k, v in named.items():
        assert tuple(v.shape) == jnamed[k].shape, k
        assert str(v.dtype).split(".")[1] == str(jnamed[k].dtype), k
    if arch == RWKV:
        assert not any("/mlp/" in k for k in named)
        assert tuple(named["groups/0/mixer/lora_B"].shape) == (2, 5, 32, 64)
    else:
        assert named["groups/1/mixer/A_log"].dtype == torch.float32
        assert "groups/1/moe/router" in named and "groups/0/mlp/w_up" in named


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_cache_layout_equals_reference(arch):
    """The cache tree's leaf names, shapes and dtypes equal the
    reference's ``cache_struct``: ``0/tm_shift``, ``0/cm_shift``, ``0/wkv``
    (f32) for rwkv6; jamba's ``0/k``, ``0/v`` and ``1/conv_x``,
    ``1/conv_bc``, ``1/ssm`` (f32); ``cache_struct`` allocates on the meta
    device; batch is dim 1."""
    jcfg, cfg = _cfgs(arch)
    jst, _ = jflatten(jbuild_model(jcfg).cache_struct(3, 24))
    model = build_model(cfg)
    st = flatten_named(model.init_caches(3, 24, device="cpu"))
    meta = flatten_named(model.cache_struct(3, 24))
    assert list(st) == list(jst) == list(meta)
    want = (["0/cm_shift", "0/tm_shift", "0/wkv"] if arch == RWKV else
            ["0/k", "0/v", "1/conv_bc", "1/conv_x", "1/ssm"])
    assert sorted(st) == want
    for k, v in st.items():
        assert tuple(v.shape) == jst[k].shape == tuple(meta[k].shape), k
        assert str(v.dtype).split(".")[1] == str(jst[k].dtype), k
        assert meta[k].device.type == "meta" and not v.any()
        assert v.shape[1] == 3
    big = "0/wkv" if arch == RWKV else "1/ssm"
    assert st[big].dtype == torch.float32
    assert [s.axis for s in model.cache_protects()] == [{"batch": 1}]


# --------------------------------------------------------------------------- #
# the models against the reference
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_lm_forward_f32_matches_reference(arch):
    """f32 compute, B 2, S 32, every leaf seeded: the logits within 2e-5
    of the reference (the dense models' bound) and the MoE aux loss
    within 1e-6 relative."""
    jcfg, cfg = _cfgs(arch, "float32")
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 32))
    want, jaux = jtf.lm_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = tf.lm_forward(params, t(toks.astype(np.int32)), cfg)
    assert got.shape == want.shape
    _close(got, want, 2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def xla_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid as XLA expands it on the CPU, every op rounded to ``x``'s
    dtype."""
    return 1 / (1 + torch.exp(-x))


def xla_silu(x: torch.Tensor) -> torch.Tensor:
    """silu as XLA expands it on the CPU (``tests/test_torch_serve.py``)."""
    return x * xla_sigmoid(x)


@pytest.fixture
def xla_activations(monkeypatch):
    """The port's silu and sigmoid computed as XLA's CPU code computes
    them, for the duration of a test."""
    monkeypatch.setattr(torch.nn.functional, "silu", xla_silu)
    monkeypatch.setitem(layers._ACTS, "silu", xla_silu)
    monkeypatch.setattr(torch, "sigmoid", xla_sigmoid)


def _exact(fn, *args):
    """``fn`` compiled with ``xla_allow_excess_precision`` off, so XLA
    rounds every bf16 op it is asked for instead of keeping f32 inside a
    fusion."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _assert_bf16_near(got: np.ndarray, want: np.ndarray, ulps: float,
                      max_unequal=None):
    """Every element within ``ulps`` bf16 ulps of its row's largest
    magnitude; at most ``max_unequal`` elements not bit-equal, if given."""
    row = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= ulps * bf16_ulp(row))
    if max_unequal is not None:
        assert np.count_nonzero(got != want) <= max_unequal


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_lm_forward_bf16_matches_reference(arch, xla_activations):
    """bf16 compute (the training path), B 2, S 32: with the reference's
    bf16 roundings all kept (excess precision off) and XLA's silu and
    sigmoid in the port, the logits are bit-equal but for at most 8 of
    32,768, each within one bf16 ulp of its row's largest (measured: 1
    and 3 elements differ, by under 0.01 ulp: f32 sums in another
    order)."""
    jcfg, cfg = _cfgs(arch)
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 32))
    jt = jnp.asarray(toks, jnp.int32)
    want, _ = _exact(functools.partial(jtf.lm_forward, cfg=jcfg),
                     jparams, jt)(jparams, jt)
    got, _ = tf.lm_forward(params, t(toks.astype(np.int32)), cfg)
    assert got.dtype == torch.bfloat16
    _assert_bf16_near(np_of(got), np.asarray(want).astype(np.float32), 1,
                      max_unequal=8)


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_lm_forward_bf16_as_shipped_near_reference(arch):
    """Each package as it ships, bf16 compute, B 2, S 32: the logits
    within 12 bf16 ulps of each row's largest logit magnitude (measured:
    7.25 for rwkv6, 5.56 for jamba).  The gap is XLA's: it keeps f32
    inside its fusions where the model asks for bf16 (the test above,
    with every rounding kept, is bit-equal), and RWKV6's time mix chains
    many such ops (ddlerp, the decay LoRA, the gate, the group norm)."""
    jcfg, cfg = _cfgs(arch)
    jparams, params = _carried(jcfg, cfg)
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 32))
    want, _ = jtf.lm_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    want = np.asarray(want).astype(np.float32)
    got, _ = tf.lm_forward(params, t(toks.astype(np.int32)), cfg)
    row = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(np_of(got) - want) <= 12 * bf16_ulp(row))


def _decode_both(jcfg, cfg, steps=8, seed=0, exact_bf16=False):
    """Both packages decode ``steps`` seeded tokens → ([(reference logits,
    port logits)], reference caches, port caches).  ``exact_bf16``
    compiles the reference with excess precision off (:func:`_exact`)."""
    jparams, params = _carried(jcfg, cfg, seed)
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, steps)).astype(np.int32)
    jcaches = jtf.init_caches(2, jcfg, 16)
    caches = tf.init_caches(2, cfg, 16, device="cpu")
    jstep = functools.partial(jtf.lm_decode_step, cfg=jcfg)
    jstep = _exact(jstep, jparams, jnp.asarray(toks[:, :1]), jcaches,
                   jnp.int32(0)) if exact_bf16 else jax.jit(jstep)
    out = []
    for i in range(steps):
        want, jcaches = jstep(jparams, jnp.asarray(toks[:, i:i + 1]),
                              jcaches, jnp.int32(i))
        got, caches2 = tf.lm_decode_step(params, t(toks[:, i:i + 1]),
                                         caches, i, cfg)
        assert caches2 is caches
        out.append((np.asarray(want).astype(np.float32), np_of(got)))
    return out, jcaches, caches


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_lm_decode_step_f32_matches_reference(arch):
    """f32 compute: the logits within 2e-5 of the reference over 8 steps
    (measured 2.2e-6), and every cache leaf after them within rtol = atol
    = 2e-5 (the WKV state grows past 10: measured 2.0e-5 absolute)."""
    out, jcaches, caches = _decode_both(*_cfgs(arch, "float32"))
    for want, got in out:
        _close(got, want, 2e-5)
    jn, n = _np_named(jcaches), _np_named(caches)
    assert sorted(n) == sorted(jn)
    for k in jn:
        np.testing.assert_allclose(n[k].astype(np.float32),
                                   jn[k].astype(np.float32), rtol=2e-5,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_lm_decode_step_bf16_matches_reference(arch, xla_activations):
    """bf16 compute (the serving default), 8 steps, with the reference's
    bf16 roundings all kept and XLA's silu and sigmoid in the port: the
    logits at every step, and every cache leaf after them (the f32 states
    are sums of bf16 products), within four bf16 ulps of each row's
    largest (the dense path's bound).  Measured: jamba bit-equal but for
    one shift element; rwkv6 bit-equal for two steps, then up to 2 ulps
    (an f32 sum of the WKV read-out in another order flips one bf16
    rounding, which every later layer carries)."""
    out, jcaches, caches = _decode_both(*_cfgs(arch), exact_bf16=True)
    for want, got in out:
        _assert_bf16_near(got, want, 4)
    jn, n = _np_named(jcaches), _np_named(caches)
    for k in jn:
        _assert_bf16_near(n[k].astype(np.float32), jn[k].astype(np.float32),
                          4)


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_lm_decode_step_bf16_as_shipped_near_reference(arch):
    """Each package as it ships, bf16 compute, 8 steps: the logits within
    12 bf16 ulps of each row's largest logit magnitude (measured: 5.5 for
    rwkv6, 4.0 for jamba; the gap is XLA's excess precision, as for the
    forward)."""
    out, _, _ = _decode_both(*_cfgs(arch))
    for want, got in out:
        row = np.abs(want).max(axis=-1, keepdims=True)
        assert np.all(np.abs(got - want) <= 12 * bf16_ulp(row))


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_decode_matches_forward(arch):
    """Incremental decode logits == teacher-forced forward logits, within
    the port, bf16 compute (``tests/test_models_smoke.py``: within 5e-2 for
    rwkv6, the reference's bound)."""
    _, cfg = _cfgs(arch)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(3))
    toks = torch.randint(0, cfg.vocab_size, (1, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))
    full, _ = m.forward(params, {"tokens": toks})
    caches = m.init_caches(1, 16, device="cpu")
    outs = []
    for i in range(8):
        lg, caches = m.decode_step(params, toks[:, i:i + 1], caches, i)
        outs.append(lg)
    np.testing.assert_allclose(np_of(torch.cat(outs, dim=1)), np_of(full),
                               rtol=5e-2, atol=5e-2)


def test_engine_tokens_match_reference():
    """Reduced rwkv6, f32 compute: prefill 6 tokens and generate 10 (two
    batches of 5); the port's tokens, position and last token equal the
    reference engine's, and its recurrent state is within 2e-5."""
    jcfg, cfg = _cfgs(RWKV, "float32")
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
    assert sorted(n) == sorted(jn) == ["0/cm_shift", "0/tm_shift", "0/wkv"]
    for k in jn:
        _close(n[k], jn[k], 2e-5)


# --------------------------------------------------------------------------- #
# checkpoints across the packages
# --------------------------------------------------------------------------- #

def _ckpt_cfg(cls, d):
    return cls(dir=str(d), backend="fti", block_bytes=256,
               dedicated_thread=False, objstore=False)


def _store_chain(engine, ctx_cls, cfg_cls, d, diff_kind):
    """FULL after prefill, then a DIFF 4 tokens later → (the second
    store's report, the state stored last as numpy by name)."""
    ctx = ctx_cls(_ckpt_cfg(cfg_cls, d))
    ctx.store(engine.get_state(), id=1, level=1)
    engine.generate(4)
    rep = ctx.store(engine.get_state(), id=2, level=1, kind=diff_kind)
    ctx.shutdown()
    return rep, _np_named(engine.get_state())


def _assert_named_equal(got: dict, want: dict, caches: list):
    assert sorted(got) == sorted(want) == sorted(
        ["caches/" + c for c in caches] + ["last_token", "pos"])
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


_LEAVES = {RWKV: ["0/cm_shift", "0/tm_shift", "0/wkv"],
           JAMBA: ["0/k", "0/v", "1/conv_bc", "1/conv_x", "1/ssm"]}


def _engines(arch, seed=0):
    jcfg, cfg = _cfgs(arch)
    jparams, params = _carried(jcfg, cfg, seed)
    prompts = np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    return jcfg, cfg, jparams, params, prompts


def _want_kind(arch):
    """An RWKV state is rewritten whole by every step: the DIFF is
    promoted to FULL.  Jamba's KV rows and Mamba state make a partial
    DIFF."""
    return CHK_FULL if arch == RWKV else CHK_DIFF


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_reference_serve_checkpoint_restores_in_port(tmp_path, arch):
    """repro stores FULL + DIFF of its engine's ServeState; a port engine
    restores it bit-exact into a cold template and decodes on from it."""
    jcfg, cfg, jparams, params, prompts = _engines(arch)
    jeng = JEngine(jbuild_model(jcfg), jparams, batch=2, max_len=32)
    jeng.prefill(jnp.asarray(prompts))
    rep, want = _store_chain(jeng, jctx.CheckpointContext,
                             jctx.CheckpointConfig, tmp_path, "DIFF")
    assert rep.kind == _want_kind(arch)
    model = build_model(cfg)
    cold = ServeState(model.init_caches(2, 32, device="cpu"),
                      torch.tensor(0, dtype=torch.int32),
                      torch.zeros((2, 1), dtype=torch.int32))
    ctx = CheckpointContext(_ckpt_cfg(CheckpointConfig, tmp_path))
    got = ctx.load(cold)
    ctx.shutdown()
    assert ctx.restarted
    _assert_named_equal(_np_named(got), want, _LEAVES[arch])
    eng = ServingEngine(model, params, batch=2, max_len=32)
    eng.set_state(got)
    assert eng.generate(2).shape == (2, 2) and int(eng.state.pos) == 11


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_port_serve_checkpoint_restores_in_reference(tmp_path, arch):
    """The port stores FULL + DIFF of its engine's ServeState; the
    reference restores it bit-exact into its own cold template."""
    jcfg, cfg, _, params, prompts = _engines(arch)
    eng = ServingEngine(build_model(cfg), params, batch=2, max_len=32)
    eng.prefill(t(prompts))
    rep, want = _store_chain(eng, CheckpointContext, CheckpointConfig,
                             tmp_path, CHK_DIFF)
    assert rep.kind == _want_kind(arch)
    cold = JServeState(jbuild_model(jcfg).init_caches(2, 32), jnp.int32(0),
                       jnp.zeros((2, 1), jnp.int32))
    ctx = jctx.CheckpointContext(_ckpt_cfg(jctx.CheckpointConfig, tmp_path))
    got = ctx.load(cold)
    ctx.shutdown()
    assert ctx.restarted
    _assert_named_equal(_np_named(got), want, _LEAVES[arch])


def _dirty_reports(arch, tmp_path):
    """Both packages' engines, from the same weights and prompts, store a
    FULL after prefill and a DIFF 4 tokens later (256-byte blocks) →
    (the reference's DIFF report, the port's, the block count of the
    state)."""
    jcfg, cfg, jparams, params, prompts = _engines(arch)
    jeng = JEngine(jbuild_model(jcfg), jparams, batch=2, max_len=32)
    jeng.prefill(jnp.asarray(prompts))
    jrep, _ = _store_chain(jeng, jctx.CheckpointContext,
                           jctx.CheckpointConfig, tmp_path / "j", "DIFF")
    eng = ServingEngine(build_model(cfg), params, batch=2, max_len=32)
    eng.prefill(t(prompts))
    rep, named = _store_chain(eng, CheckpointContext, CheckpointConfig,
                              tmp_path / "t", CHK_DIFF)
    blocks = sum(-(-max(v.nbytes, 1) // 256) for v in named.values())
    return jrep, rep, blocks


def test_jamba_diff_dirty_blocks_equal_reference(tmp_path):
    """Reduced jamba, bf16: 4 tokens after the FULL, the KV cache has 4
    new rows per sequence and the Mamba state is rewritten whole; both
    packages ship a partial DIFF with the same dirty-block count, equal to
    the count from the rows written plus every block of the Mamba state
    (256-byte blocks)."""
    jrep, rep, blocks = _dirty_reports(JAMBA, tmp_path)
    assert rep.kind == jrep.kind == CHK_DIFF
    got = round(rep.dirty_ratio * blocks)
    assert got == round(jrep.dirty_ratio * blocks)
    _, cfg = _cfgs(JAMBA)
    caches = flatten_named(build_model(cfg).cache_struct(2, 32))
    row = cfg.n_kv_heads * cfg.head_dim * 2             # bf16 K or V row
    kv = {(s * 32 + p) * row // 256 for s in range(2) for p in range(5, 9)}
    state = sum(-(-v.numel() * v.element_size() // 256)
                for k, v in caches.items() if k.startswith("1/"))
    # K and V rows, the Mamba state, pos, and last_token if its tokens moved
    want = 2 * len(kv) + state + 1
    assert got in (want, want + 1)
    assert 0.0 < rep.dirty_ratio < 0.95


def test_rwkv6_promote_decision_equals_reference(tmp_path):
    """Reduced rwkv6: a DIFF 4 tokens after the FULL finds every block of
    the recurrent state dirty, past the 0.95 promote threshold; both
    packages promote it to FULL and report the same dirty ratio."""
    jrep, rep, blocks = _dirty_reports(RWKV, tmp_path)
    assert rep.kind == jrep.kind == CHK_FULL
    assert rep.promoted_full and jrep.promoted_full
    assert rep.dirty_ratio == pytest.approx(jrep.dirty_ratio, abs=0)
    assert rep.dirty_ratio > 0.95


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_rwkv6_trainstate_cross_reads_both_ways(tmp_path, writer):
    """A reduced rwkv6 TrainState (every mixer leaf and its moments),
    filled with seeded values, stored by one package (FTI, level 1)
    restores bit for bit into the other package's own template."""
    d = str(tmp_path / "ck")
    jcfg, cfg = _cfgs(RWKV)
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
    assert {"params/groups/0/mixer/lora_B", "opt/mu/groups/0/mixer/wA",
            "opt/nu/groups/0/mixer/u"} <= set(want)
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


def test_serve_launcher_resumes_rwkv6(tmp_path, capsys):
    """``launch.serve --arch rwkv6-3b`` on the CPU serves an RWKV
    ``ServeState``: a run killed after 20 tokens (rc 39; a store every 8)
    and a rerun that restores the store at 16 tokens (pos 20) without
    prefill and generates the last 8."""
    from repro_torch.launch import serve as serve_mod
    argv = ["--arch", RWKV, "--device", "cpu", "--gen", "24",
            "--prompt-len", "4", "--batch", "2", "--ckpt-dir",
            str(tmp_path)]
    assert serve_mod.main(argv + ["--kill-after", "20"]) == 39
    assert "simulated failure after 20 tokens" in capsys.readouterr().out
    assert serve_mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "resumed at pos 20" in out
    assert "generated 8 tokens/req" in out

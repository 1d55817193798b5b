"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba (SSD chunked form).

The PyTorch counterpart of ``repro.models.ssm``: plain functions over dicts
of tensors, with the reference's names, parameter layout and f32 upcasts.

- RWKV6: data-dependent **vector** decay w_t ∈ (0,1)^K per head, bonus u for
  the current token, ddlerp token-shift mixing [arXiv:2404.05892].
- Mamba: **scalar**-per-head decay a_t = exp(−Δ_t·A_h) (Mamba-2/SSD algebra
  [arXiv:2405.21060]); short causal conv; gated output norm.

The train-time forms are chunked recurrences: chunk-local pairwise products
plus a loop over chunks carrying the O(1) state in f32 (the reference's
``lax.scan``).  Decay products are bounded ratios ``exp(logdecay_t −
logdecay_s) ≤ 1``, each clipped to [-60, 0] before the ``exp``.

The decode steps take one token and an O(1) state (:class:`RWKVState`,
:class:`MambaState`), write the new state into that state's tensors *in
place* and return the same state, as the attention decode writes its cache
(``models/attention.py``); the reference returns a new state.  The values
are the reference's.

On ``DTensor`` parameters (the projections column- and row-parallel over
MODEL by the rules) and batch-sharded inputs the chunked forms run as
they are: every operator here has a DTensor sharding rule, none gathers
a parameter, and the scans' plain constants (masks, zero states) meet
``DTensor`` operands inside ``dist.context.sharded_scope``.  The
collectives of a forward are in ``PERF.md`` (§6, PR 23).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init, groupnorm_heads

Params = Dict[str, Any]

_MIX_LORA = 32
_DECAY_LORA = 64


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) as the reference computes
    it; ``F.softplus`` switches to ``x`` past its threshold of 20."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _to_chunks(a: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """(B, T, ...) → (N, B, C, ...)."""
    return a.reshape(a.shape[0], n, c, *a.shape[2:]).transpose(0, 1)


# =========================================================================== #
# RWKV6
# =========================================================================== #


def init_rwkv6_layer(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    d = cfg.d_model
    f = cfg.d_ff
    dev = gen.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        # ddlerp token-shift: base mus + per-target lora (w,k,v,r,g)
        "mu_base": zeros(d),
        "mu_wkvrg": zeros(5, d),
        "lora_A": dense_init(gen, d, 5 * _MIX_LORA, dtype),
        "lora_B": zeros(5, _MIX_LORA, d),
        # decay lora
        "w0": torch.full((d,), -6.0, dtype=dtype, device=dev),
        "wA": dense_init(gen, d, _DECAY_LORA, dtype),
        "wB": zeros(_DECAY_LORA, d),
        # projections
        "wr": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wg": dense_init(gen, d, d, dtype),
        "wo": dense_init(gen, d, d, dtype),
        "u": zeros(d),                            # per-channel bonus (heads×K)
        # channel mix
        "cm_mu_k": zeros(d),
        "cm_mu_r": zeros(d),
        "cm_wk": dense_init(gen, d, f, dtype),
        "cm_wv": dense_init(gen, f, d, dtype),
        "cm_wr": dense_init(gen, d, d, dtype),
    }


def _ddlerp(p: Params, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent token-shift interpolation → (5, B, T, d) mixed inputs."""
    delta = x_prev - x
    xxx = x + delta * p["mu_base"]
    lora = torch.tanh(xxx @ p["lora_A"])
    b, t, _ = x.shape
    lora = lora.reshape(b, t, 5, _MIX_LORA)
    dyn = torch.einsum("btlr,lrd->lbtd", lora, p["lora_B"])
    mix = p["mu_wkvrg"][:, None, None, :] + dyn               # (5,B,T,d)
    return x[None] + delta[None] * mix


def _wkv6_chunked(r, k, v, logw, u, chunk: int):
    """Chunked WKV6. r,k,logw: (B,T,H,K); v: (B,T,H,V); u: (H,K)."""
    b, t, h, kk = r.shape
    vv = v.shape[-1]
    c = min(chunk, t)
    assert t % c == 0
    n = t // c
    r_, k_, v_, lw_ = (_to_chunks(a, n, c) for a in (r, k, v, logw))
    bsum = torch.cumsum(lw_, dim=2)                           # inclusive (N,B,C,H,K)
    bprev = bsum - lw_                                        # exclusive
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     -1)                                      # strict lower

    S = torch.zeros((b, h, kk, vv), dtype=torch.float32, device=r.device)
    outs = []
    for i in range(n):
        rc, kc, vc, bs, bp = r_[i], k_[i], v_[i], bsum[i], bprev[i]
        # intra-chunk: A[t,s] = Σ_k r_t k_s exp(bp_t − bs_s), s<t (bounded ≤1)
        ratio = torch.exp(torch.clamp(bp[:, :, None] - bs[:, None, :],
                                      -60.0, 0.0))            # (B,C,C,H,K)
        A = (rc[:, :, None] * kc[:, None] * ratio).sum(-1).permute(0, 3, 1, 2)
        A = torch.where(tri[None, None], A, 0.0)
        # current-token bonus u
        diag = (rc * u[None, None] * kc).sum(-1)                # (B,C,H)
        o = torch.einsum("bhts,bshv->bthv", A, vc)
        o = o + diag[..., None] * vc
        # inter-chunk: r_t ⊙ exp(bp_t) attends the carried state
        o = o + torch.einsum("bthk,bhkv->bthv", rc * torch.exp(bp), S)
        # state update: S ← exp(bs_C) S + Σ_s (k_s exp(bs_C − bs_s)) ⊗ v_s
        dec_end = torch.exp(bs[:, -1])                        # (B,H,K)
        kdec = kc * torch.exp(torch.clamp(bs[:, -1][:, None] - bs, -60.0,
                                          0.0))
        S = dec_end[..., None] * S + torch.einsum("bshk,bshv->bhkv", kdec, vc)
        outs.append(o)
    return torch.stack(outs).transpose(0, 1).reshape(b, t, h, vv)  # (B,T,H,V)


def _logw(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """The log-decay, f32: the bf16 LoRA product is cast before the exp."""
    return -torch.exp(p["w0"].float() +
                      (torch.tanh(xw @ p["wA"]) @ p["wB"]).float())


def rwkv6_time_mix(p: Params, x: torch.Tensor, cfg: ArchConfig,
                   x_shift: torch.Tensor | None = None) -> torch.Tensor:
    b, t, d = x.shape
    hd = cfg.ssm.head_dim
    h = d // hd
    first = x.new_zeros((b, 1, d)) if x_shift is None else x_shift
    x_prev = torch.cat([first, x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)

    logw = _logw(p, xw)
    r = (xr @ p["wr"]).reshape(b, t, h, hd).float()
    k = (xk @ p["wk"]).reshape(b, t, h, hd).float()
    v = (xv @ p["wv"]).reshape(b, t, h, hd).float()
    g = F.silu(xg @ p["wg"])
    logw = logw.reshape(b, t, h, hd)
    u = p["u"].float().reshape(h, hd)

    o = _wkv6_chunked(r, k, v, logw, u, cfg.ssm.chunk)
    o = groupnorm_heads(o.reshape(b, t, d).to(x.dtype), h, cfg.norm_eps)
    return (o * g) @ p["wo"]


def _channel_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor
                 ) -> torch.Tensor:
    xk = x + (x_prev - x) * p["cm_mu_k"]
    xr = x + (x_prev - x) * p["cm_mu_r"]
    kk = torch.square(F.relu(xk @ p["cm_wk"]))
    return torch.sigmoid(xr @ p["cm_wr"]) * (kk @ p["cm_wv"])


def rwkv6_channel_mix(p: Params, x: torch.Tensor,
                      x_shift: torch.Tensor | None = None) -> torch.Tensor:
    b, _, d = x.shape
    first = x.new_zeros((b, 1, d)) if x_shift is None else x_shift
    return _channel_mix(p, x, torch.cat([first, x[:, :-1]], dim=1))


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor       # (B, 1, d)
    cm_shift: torch.Tensor       # (B, 1, d)
    wkv: torch.Tensor            # (B, H, K, V) fp32


def init_rwkv_state(batch: int, cfg: ArchConfig, dtype,
                    device="cuda") -> RWKVState:
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    h = d // hd
    return RWKVState(
        torch.zeros((batch, 1, d), dtype=dtype, device=device),
        torch.zeros((batch, 1, d), dtype=dtype, device=device),
        torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
    )


def rwkv6_decode_step(p: Params, x: torch.Tensor, st: RWKVState,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, RWKVState]:
    """x (B,1,d) → (the time-mix output, ``st`` with ``tm_shift`` and
    ``wkv`` written in place); the caller applies the channel mix."""
    b, _, d = x.shape
    hd = cfg.ssm.head_dim
    h = d // hd
    xw, xk, xv, xr, xg = _ddlerp(p, x, st.tm_shift)
    logw = _logw(p, xw)
    r = (xr @ p["wr"]).reshape(b, 1, h, hd).float()[:, 0]
    k = (xk @ p["wk"]).reshape(b, 1, h, hd).float()[:, 0]
    v = (xv @ p["wv"]).reshape(b, 1, h, hd).float()[:, 0]
    g = F.silu(xg @ p["wg"])[:, 0]
    w = torch.exp(logw.reshape(b, h, hd))
    u = p["u"].float().reshape(h, hd)

    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r, st.wkv + u[None, ..., None] * kv)
    st.wkv.copy_(w[..., None] * st.wkv + kv)
    st.tm_shift.copy_(x)
    o = groupnorm_heads(o.reshape(b, 1, d).to(x.dtype), h, cfg.norm_eps)
    return (o * g[:, None]) @ p["wo"], st


def rwkv6_channel_mix_decode(p: Params, x: torch.Tensor, st: RWKVState
                             ) -> Tuple[torch.Tensor, RWKVState]:
    """x (B,1,d) → (the channel-mix output, ``st`` with ``cm_shift``
    written in place)."""
    out = _channel_mix(p, x, st.cm_shift)
    st.cm_shift.copy_(x)
    return out, st


# =========================================================================== #
# Mamba (SSD chunked)
# =========================================================================== #


def init_mamba_layer(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    """Split projections (z, x, B, C, dt), as the reference's; ``A_log``,
    ``dt_bias`` and ``D`` in f32."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    h = di // s.head_dim
    dev = gen.device

    def normal(*shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * 0.2).to(dtype)

    return {
        "w_z": dense_init(gen, d, di, dtype),
        "w_x": dense_init(gen, d, di, dtype),
        "w_B": dense_init(gen, d, s.d_state, dtype),
        "w_C": dense_init(gen, d, s.d_state, dtype),
        "w_dt": dense_init(gen, d, h, dtype),
        "conv_x_w": normal(s.conv_width, di),
        "conv_x_b": torch.zeros((di,), dtype=dtype, device=dev),
        "conv_bc_w": normal(s.conv_width, 2 * s.d_state),
        "conv_bc_b": torch.zeros((2 * s.d_state,), dtype=dtype, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _ssd_chunked(x, Bm, Cm, loga, chunk: int):
    """x:(B,T,H,P) Bm/Cm:(B,T,N) loga:(B,T,H) ≤0 → y:(B,T,H,P)."""
    b, t, h, pp = x.shape
    nn = Bm.shape[-1]
    c = min(chunk, t)
    assert t % c == 0
    n = t // c
    x_, B_, C_, la_ = (_to_chunks(a, n, c) for a in (x, Bm, Cm, loga))
    cs = torch.cumsum(la_, dim=2)                             # inclusive (N,B,C,H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=x.device))             # include diagonal

    S = torch.zeros((b, h, pp, nn), dtype=torch.float32, device=x.device)
    outs = []
    for i in range(n):
        xc, bc, cc, ls = x_[i], B_[i], C_[i], cs[i]
        ratio = torch.exp(torch.clamp(ls[:, :, None] - ls[:, None, :],
                                      -60.0, 0.0))
        ratio = torch.where(tri[None, :, :, None], ratio, 0.0)  # (B,C,C,H)
        M = torch.einsum("btn,bsn->bts", cc, bc)              # (B,C,C)
        y = torch.einsum("btsh,bshp->bthp", M[..., None] * ratio, xc)
        # inter-chunk from carried state
        y = y + torch.einsum("btn,bhpn->bthp", cc, S) * \
            torch.exp(ls)[..., None]
        # state update
        dec_end = torch.exp(ls[:, -1])                        # (B,H)
        xdec = xc * torch.exp(torch.clamp(ls[:, -1][:, None] - ls, -60.0,
                                          0.0))[..., None]
        S = dec_end[..., None, None] * S + torch.einsum("bshp,bsn->bhpn",
                                                        xdec, bc)
        outs.append(y)
    return torch.stack(outs).transpose(0, 1).reshape(b, t, h, pp)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b_: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal short conv; x (B,T,C), w (W,C).  The taps are
    summed in order from 0, as the reference's Python ``sum``."""
    bsz, t, _ = x.shape
    width = w.shape[0]
    pad = x.new_zeros((bsz, width - 1, x.shape[-1]))
    xp = torch.cat([pad, x], dim=1)
    return sum(xp[:, i: i + t] * w[i][None, None] for i in range(width)) + b_


def _gated_norm_out(p: Params, y: torch.Tensor, z: torch.Tensor,
                    dtype, eps: float) -> torch.Tensor:
    """Gated RMSNorm (Mamba-2), then the output projection."""
    y = y.to(dtype) * F.silu(z)
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + eps)).to(dtype)
    y = y * p["norm_scale"]
    return y @ p["out_proj"]


def mamba_block(p: Params, u: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """u (B,T,d) → (B,T,d)."""
    s = cfg.ssm
    b, t, _ = u.shape
    di = s.expand * cfg.d_model
    h = di // s.head_dim

    z = u @ p["w_z"]
    xs = u @ p["w_x"]
    bc = torch.cat([u @ p["w_B"], u @ p["w_C"]], dim=-1)
    dt = u @ p["w_dt"]

    xs = F.silu(_causal_conv(xs, p["conv_x_w"], p["conv_x_b"]))
    bc = F.silu(_causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"]))
    x = xs.reshape(b, t, h, s.head_dim)
    Bm = bc[..., : s.d_state]
    Cm = bc[..., s.d_state:]

    delta = _softplus(dt.float() + p["dt_bias"])                # (B,T,H)
    loga = -delta * torch.exp(p["A_log"])[None, None]
    xin = x.float() * delta[..., None]

    y = _ssd_chunked(xin, Bm.float(), Cm.float(), loga, s.chunk)
    y = y + p["D"][None, None, :, None] * x.float()
    return _gated_norm_out(p, y.reshape(b, t, di), z, u.dtype, cfg.norm_eps)


class MambaState(NamedTuple):
    conv_x: torch.Tensor         # (B, W-1, d_inner)
    conv_bc: torch.Tensor        # (B, W-1, 2N)
    ssm: torch.Tensor            # (B, H, P, N) fp32


def init_mamba_state(batch: int, cfg: ArchConfig, dtype,
                     device="cuda") -> MambaState:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    h = di // s.head_dim
    return MambaState(
        torch.zeros((batch, s.conv_width - 1, di), dtype=dtype,
                    device=device),
        torch.zeros((batch, s.conv_width - 1, 2 * s.d_state), dtype=dtype,
                    device=device),
        torch.zeros((batch, h, s.head_dim, s.d_state), dtype=torch.float32,
                    device=device),
    )


def mamba_decode_step(p: Params, u: torch.Tensor, st: MambaState,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, MambaState]:
    """u (B,1,d) → (out, ``st`` with both conv windows and the SSM state
    written in place)."""
    s = cfg.ssm
    b, _, _ = u.shape
    di = s.expand * cfg.d_model
    h = di // s.head_dim

    z = u @ p["w_z"]
    xs = (u @ p["w_x"])[:, 0]
    bc = torch.cat([u @ p["w_B"], u @ p["w_C"]], dim=-1)[:, 0]
    dt = u @ p["w_dt"]

    win_x = torch.cat([st.conv_x, xs[:, None]], dim=1)        # (B, W, di)
    win_bc = torch.cat([st.conv_bc, bc[:, None]], dim=1)
    xs = F.silu(torch.einsum("bwc,wc->bc", win_x, p["conv_x_w"])
                + p["conv_x_b"])
    bc = F.silu(torch.einsum("bwc,wc->bc", win_bc, p["conv_bc_w"])
                + p["conv_bc_b"])
    x = xs.reshape(b, h, s.head_dim)
    Bm = bc[..., : s.d_state]
    Cm = bc[..., s.d_state:]

    delta = _softplus(dt[:, 0].float() + p["dt_bias"])          # (B,H)
    a = torch.exp(-delta * torch.exp(p["A_log"])[None])
    xin = x.float() * delta[..., None]
    S = a[..., None, None] * st.ssm + torch.einsum(
        "bhp,bn->bhpn", xin, Bm.float())
    y = torch.einsum("bhpn,bn->bhp", S, Cm.float())
    y = y + p["D"][None, :, None] * x.float()
    st.conv_x.copy_(win_x[:, 1:])
    st.conv_bc.copy_(win_bc[:, 1:])
    st.ssm.copy_(S)
    return _gated_norm_out(p, y.reshape(b, 1, di), z, u.dtype,
                           cfg.norm_eps), st

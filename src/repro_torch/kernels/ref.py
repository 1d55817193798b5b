"""Plain PyTorch versions of the kernels (and the CPU path).

The hash is a position-salted multiply–xorshift mix (murmur3-finalizer
family) folded with wrapping uint32 addition — commutative, so a kernel
can reduce in any order and still match these versions bit for bit.

u32 words travel in ``torch.int32`` tensors (same bits): ``torch.uint32``
has no ``>>`` and no ``sum`` on the CPU.  The arithmetic runs in int64,
masked to 32 bits after every multiply and add; each 32×32-bit multiply
is split into 16-bit halves so no int64 product overflows.

Attention (:func:`flash_attention_ref`) is the function the flash kernel
computes, written as one softmax over the whole key axis in f32; its
exact gradient is :func:`flash_attention_vjp_ref`.  The grouped layout's
plain version (:func:`flash_attention_gqa_ref`) repeats the KV heads and
calls it.
"""
from __future__ import annotations

import math

import torch

HASH_SALT_A = 0x9E3779B9   # golden-ratio odd constants
HASH_SALT_B = 0x85EBCA6B

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → int64 values in [0, 2³²)."""
    return x.to(torch.int64) & _M32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) → int32 tensor with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for x in [0, 2³²) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over int64 values in [0, 2³²)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def blockhash_ref(blocks_u32: torch.Tensor, salt: int = HASH_SALT_A
                  ) -> torch.Tensor:
    """(n_blocks, elems) u32 words → (n_blocks,) u32 per-block hash.

    hash(b) = Σ_i mix32(x[b,i] ⊕ (i·salt))  (wrapping add — commutative).
    """
    _n, e = blocks_u32.shape
    idx = _mul32(torch.arange(e, dtype=torch.int64,
                              device=blocks_u32.device), salt)
    h = mix32(_u32(blocks_u32) ^ idx[None, :])
    return _as_i32(h.sum(dim=1) & _M32)


def blockhash2_ref(blocks_u32: torch.Tensor) -> torch.Tensor:
    """Two independent 32-bit lanes → (n_blocks, 2) u32 (64-bit digest)."""
    return torch.stack([blockhash_ref(blocks_u32, HASH_SALT_A),
                        blockhash_ref(blocks_u32, HASH_SALT_B)], dim=1)


def diffpack_ref(blocks: torch.Tensor, dirty_idx: torch.Tensor
                 ) -> torch.Tensor:
    """Gather dirty blocks: (n_blocks, e), (n_dirty,) → (n_dirty, e)."""
    return blocks[dirty_idx.to(torch.int64)]


def diffunpack_ref(base: torch.Tensor, packed: torch.Tensor,
                   dirty_idx: torch.Tensor) -> torch.Tensor:
    """Scatter packed blocks into a copy of base: inverse of diffpack."""
    out = base.clone()
    out[dirty_idx.to(torch.int64)] = packed
    return out


# --------------------------------------------------------------------------- #
# attention (the flash kernel's function and its gradient)
# --------------------------------------------------------------------------- #

NEG_INF = -1e30        # the masked score, as in the JAX package's kernel


def attention_scale(dh: int) -> float:
    """``1/sqrt(dh)`` rounded to f32, as the reference's weak-typed scalar
    is when it multiplies f32 scores."""
    return float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))


def _probs(q32: torch.Tensor, k32: torch.Tensor, causal: bool, scale: float
           ) -> torch.Tensor:
    """Unnormalised softmax numerators ``exp(s - max s)`` of the f32 scores
    (masked at ``NEG_INF``) → ``(p, l)`` with ``l`` the row sums."""
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    if causal:
        sq, sk = q32.shape[-2], k32.shape[-2]
        pos_q = torch.arange(sq, device=q32.device)
        pos_k = torch.arange(sk, device=q32.device)
        s = torch.where(pos_k[None, :] <= pos_q[:, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1, keepdim=True)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """(BH, S, dh) × (BH, Sk, dh) × (BH, Sk, dh) → (BH, S, dh) in q's dtype.

    Scores ``q·kᵀ/sqrt(dh)`` in f32, causal mask at -1e30 (key position ≤
    query position, both from 0), softmax in f32, the denominator floored
    at 1e-30, ``p·v`` in f32."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    p, l = _probs(q32, k32, causal, attention_scale(q.shape[-1]))
    return (torch.matmul(p, v32) / torch.clamp(l, min=1e-30)).to(q.dtype)


def to_bh(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) → (B·H, S, dh)."""
    b, s, h, dh = x.shape
    return x.transpose(1, 2).reshape(b * h, s, dh)


def from_bh(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B·H, S, dh) → (B, S, H, dh)."""
    bh, s, dh = x.shape
    return x.reshape(b, bh // b, s, dh).transpose(1, 2)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,KV,dh) → (B,S,KV·n_rep,dh), each KV head repeated n_rep times
    in place (head h reads KV head h // n_rep)."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None].expand(b, s, kv, n_rep, dh).reshape(
        b, s, kv * n_rep, dh)


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True
                            ) -> torch.Tensor:
    """(B, S, H, dh) × (B, Sk, KV, dh) × (B, Sk, KV, dh) → (B, S, H, dh) in
    q's dtype: the KV heads repeated to H, then :func:`flash_attention_ref`
    per batch·head."""
    rep = q.shape[2] // k.shape[2]
    o = flash_attention_ref(to_bh(q), to_bh(repeat_kv(k, rep)),
                            to_bh(repeat_kv(v, rep)), causal=causal)
    return from_bh(o, q.shape[0])


def flash_attention_vjp_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True,
                            chunk_bytes: int = 1 << 28):
    """The exact gradient of :func:`flash_attention_ref` → ``(dq, dk, dv)``
    in the dtypes of q, k, v.  Recomputes the f32 scores from q and k, a
    group of batch·heads at a time so the ``(S, Sk)`` f32 temporaries stay
    under ``chunk_bytes`` each.  The output cast passes the gradient
    through unchanged; a masked score gets none; the 1e-30 floor never
    binds (each row's largest term is exp(0) = 1)."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    scale = attention_scale(dh)
    step = max(1, chunk_bytes // max(1, sq * sk * 4))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for lo in range(0, bh, step):
        sl = slice(lo, min(bh, lo + step))
        q32, k32, v32 = q[sl].float(), k[sl].float(), v[sl].float()
        do32 = dout[sl].float()
        p, l = _probs(q32, k32, causal, scale)
        p = p / torch.clamp(l, min=1e-30)
        dv[sl] = torch.matmul(p.transpose(-1, -2), do32).to(v.dtype)
        dp = torch.matmul(do32, v32.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        del p, dp
        dq[sl] = (torch.matmul(ds, k32) * scale).to(q.dtype)
        dk[sl] = (torch.matmul(ds.transpose(-1, -2), q32) * scale).to(k.dtype)
    return dq, dk, dv

"""The flash attention's saved row statistic and the dispatch of its
backward, on the CPU.

The forward operator returns the output and each query row's log-sum-exp;
its fake implementation gives both shapes under a fake-tensor trace.  On
the CPU, bf16 and f32 alike, the backward is the plain gradient
(``ref.flash_attention_vjp_ref``) and no kernel is launched; the backward
kernel itself runs only on a card (``tests/test_torch_gpu.py``)."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import ops, ref


def _qkv(b, s, sk, h, kv, dh, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, s, h, dh, generator=g).to(dtype)
    k = torch.randn(b, sk, kv, dh, generator=g).to(dtype)
    v = torch.randn(b, sk, kv, dh, generator=g).to(dtype)
    return q, k, v


def _plain_grads(q, k, v, dout, causal):
    """The gradient the backward computed before the kernel: the plain vjp
    on K and V repeated to the query heads, dk and dv summed per group."""
    b, s, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    dq, dk, dv = ref.flash_attention_vjp_ref(
        ref.to_bh(q), ref.to_bh(ref.repeat_kv(k, rep)),
        ref.to_bh(ref.repeat_kv(v, rep)), ref.to_bh(dout), causal=causal)
    dk = ref.from_bh(dk, b).reshape(b, sk, kv, rep, dh).sum(dim=3)
    dv = ref.from_bh(dv, b).reshape(b, sk, kv, rep, dh).sum(dim=3)
    return ref.from_bh(dq, b), dk, dv


@pytest.mark.parametrize("shape", [(2, 64, 64, 4, 2, 16, True),
                                   (1, 32, 96, 6, 3, 32, False)])
def test_fake_forward_gives_output_and_lse_shapes(shape):
    b, s, sk, h, kv, dh, causal = shape
    with FakeTensorMode():
        q = torch.empty(b, s, h, dh, dtype=torch.bfloat16)
        k = torch.empty(b, sk, kv, dh, dtype=torch.bfloat16)
        out, lse = torch.ops.repro_torch.flash_attention_fwd(
            q, k, k, causal, 32, 32)
        assert out.shape == (b, s, h, dh) and out.dtype == torch.bfloat16
        assert lse.shape == (b, h, s) and lse.dtype == torch.float32
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, k, lse, out, causal)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    real = _qkv(b, s, sk, h, kv, dh, torch.float32)
    got = torch.ops.repro_torch.flash_attention_fwd(*real, causal, 32, 32)
    assert [tuple(x.shape) for x in got] == [(b, s, h, dh), (b, h, s)]


@pytest.mark.parametrize("causal", [True, False])
def test_cpu_lse_is_the_rows_logsumexp(causal):
    q, k, v = _qkv(2, 48, 48, 4, 2, 16, torch.float32, seed=1)
    out, lse = ref.flash_attention_gqa_lse_ref(q, k, v, causal=causal)
    s = torch.einsum("bqhd,bkhd->bhqk", q, ref.repeat_kv(k, 2)) \
        * ref.attention_scale(16)
    if causal:
        s = s.masked_fill(torch.ones(48, 48).triu(1).bool(), ref.NEG_INF)
    assert torch.allclose(lse, torch.logsumexp(s, dim=-1), atol=1e-5)
    assert torch.equal(out, ref.flash_attention_gqa_ref(q, k, v,
                                                        causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cpu_backward_is_the_plain_gradient(dtype, causal):
    q, k, v = _qkv(2, 64, 64, 4, 2, 32, dtype, seed=2)
    dout = torch.randn(2, 64, 4, 32, generator=torch.Generator()
                       .manual_seed(3)).to(dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launch_counts()
    ops.flash_attention_gqa(*leaves, causal=causal).backward(dout)
    assert ops.launch_counts()["flashattn_bwd"] == 0
    want = _plain_grads(q, k, v, dout, causal)
    for a, w in zip(leaves, want):
        assert a.grad.dtype == dtype
        assert torch.equal(a.grad, w)


def test_backward_kernel_refuses_cpu_tensors():
    q, k, v = _qkv(1, 32, 32, 2, 2, 16, torch.bfloat16)
    out, lse = ref.flash_attention_gqa_lse_ref(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_gqa_bwd(q, k, v, lse, out)

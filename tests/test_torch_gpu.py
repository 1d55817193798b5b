"""The hand-written Hopper kernels against their plain PyTorch versions,
on a card (marker ``gpu``; skipped where no CUDA device is present).

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import blockhash as bh
from repro_torch.kernels import diffpack as dp
from repro_torch.kernels import flashattn as fa
from repro_torch.kernels import ops, ref

# read when cuBLAS starts; the training test runs deterministically
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def bf16_tolerance(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's magnitude (8 significant bits),
    floored at the f32 tolerance 2e-5: near zero, where the softmax
    average cancels, the f32 rounding of the terms outweighs a bf16 ulp."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7).clamp(min=2e-5)


@pytest.mark.gpu
def test_hopper_kernels_match_plain_versions_on_card():
    """blockhash2 and diffpack against their plain versions on the card:
    ragged sizes, every dtype width, an unaligned storage offset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    f = torch.randn(300_001, generator=g, device="cuda")
    raw = (f * 1000).to(torch.int64).to(torch.uint8)
    cases = [f[:1], f, f[1:], raw[3:70_000], f[:7].to(torch.bfloat16),
             (f * 100).to(torch.float16), (f * 1000).to(torch.int32),
             f.to(torch.float64), (f * 100).to(torch.int8)]
    for x in cases:
        for bb in (256, 65_536):
            want = ref.blockhash2_ref(ops.as_u32_blocks(x, bb)[0])
            assert torch.equal(bh.blockhash2(x, bb), want)
            n = want.shape[0]
            idx = np.unique(np.array([0, n - 1, n // 2], np.int32))
            want_p = ref.diffpack_ref(ops.as_u32_blocks(x, bb)[0],
                                      torch.from_numpy(idx).cuda())
            assert torch.equal(dp.diffpack_many([x], [idx], bb), want_p)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_diffpack_many_matches_per_leaf_diffpack_on_card():
    """One launch over a table of (leaf, block) rows gives the rows of
    one launch per leaf and of diffpack_ref, bit for bit: every dtype width,
    an unaligned view, a 0-byte leaf, a leaf with no dirty block, a ragged
    last block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(4)
    f = torch.randn(300_001, generator=g, device="cuda")
    raw = (f * 1000).to(torch.int64).to(torch.uint8)
    leaves = [f, f[1:], raw[3:70_000], f[:7].to(torch.bfloat16),
              (f * 100).to(torch.float16), f.to(torch.float64),
              torch.zeros(0, device="cuda"), (f * 100).to(torch.int8)]
    for bb in (256, 65_536):
        dirty = []
        for i, x in enumerate(leaves):
            n = ops.as_u32_blocks(x, bb)[1]
            dirty.append(np.zeros(0, np.int32) if i == 4 else np.unique(
                np.array([0, n // 3, n - 1], np.int32)))
        n0 = dp.LAUNCHES.n
        got = ops.pack_dirty_many(leaves, dirty, bb)
        assert dp.LAUNCHES.n == n0 + 1
        per_leaf = torch.cat([dp.diffpack_many([x], [i], bb)
                              for x, i in zip(leaves, dirty)])
        plain = torch.cat([ref.diffpack_ref(ops.as_u32_blocks(x, bb)[0],
                                            torch.from_numpy(i).cuda())
                           for x, i in zip(leaves, dirty)])
        assert torch.equal(got, per_leaf) and torch.equal(got, plain)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("base", ["zeros", "random"])
def test_diffunpack_matches_plain_version_on_card(base):
    """diffunpack, one leaf per launch, against diffunpack_ref on the card,
    bit for bit: 1, 7 and many dirty blocks, a ragged last block, every dtype width, a storage
    offset that breaks 16-byte alignment, a 0-byte leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(2)
    f = torch.randn(300_001, generator=g, device="cuda")
    if base == "zeros":
        f = torch.zeros_like(f)
    raw = (f * 1000).to(torch.int64).to(torch.uint8)
    # (buffer, view of it): the kernel writes into a fresh copy of the
    # buffer through the same view, so storage offsets are kept
    cases = [(f, lambda b: b[:1]), (f, lambda b: b), (f, lambda b: b[1:]),
             (raw, lambda b: b[3:70_000]),
             (f[:7].to(torch.bfloat16), lambda b: b),
             ((f * 100).to(torch.float16), lambda b: b),
             ((f * 1000).to(torch.int32), lambda b: b),
             (f.to(torch.float64), lambda b: b),
             ((f * 100).to(torch.int8), lambda b: b),
             (torch.zeros(0, device="cuda"), lambda b: b)]
    rng = np.random.default_rng(3)
    for buf, view in cases:
        for bb in (256, 65_536):
            x = view(buf)
            nbytes = x.numel() * x.element_size()
            blocks = ops.as_u32_blocks(x, bb)[0]
            n = blocks.shape[0]
            for k in sorted({1, min(7, n), n}):
                idx = np.sort(rng.choice(n, size=k, replace=False))
                idx[-1] = n - 1                     # the ragged last block
                idx_t = torch.from_numpy(idx.astype(np.int32)).cuda()
                rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (k, bb // 4),
                                     generator=g, device="cuda",
                                     dtype=torch.int32)
                want = ref.diffunpack_ref(blocks, rows, idx_t)
                got = view(buf.clone())
                assert ops.unpack_dirty_many([got], [idx], [rows], bb)[0] \
                    is got
                got_bytes = (got.reshape(-1).view(torch.uint8) if nbytes
                             else torch.zeros(0, dtype=torch.uint8,
                                              device="cuda"))
                assert torch.equal(
                    got_bytes, want.reshape(-1).view(torch.uint8)[:nbytes])
    with pytest.raises(ValueError, match="contiguous"):
        dp.diffunpack_many([f[:4096].reshape(64, 64).t()],
                           [np.zeros(1, np.int32)],
                           torch.zeros(1, 64, dtype=torch.int32,
                                       device="cuda"), 256)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("bb", [256, 65_536])
def test_diffunpack_many_mixed_table_matches_plain_version_on_card(bb):
    """One launch over a table mixing every case — f32, bf16, int8, a
    ragged last block, a 0-byte leaf, a view whose storage offset breaks
    16-byte alignment, a leaf with no dirty block, rows given in host
    memory and on the card — leaves each leaf as diffunpack_ref does, bit
    for bit, writes nothing outside the views, and a relaunch gives the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(5)
    f = torch.randn(300_001, generator=g, device="cuda")
    raw = (f * 1000).to(torch.int64).to(torch.uint8)
    rng = np.random.default_rng(6)

    def leaves():
        """Fresh leaves, and the buffers of the two offset views."""
        fb, rb = f.clone(), raw.clone()
        return [f.clone(), fb[1:], f[:7].to(torch.bfloat16),
                (f * 100).to(torch.int8), torch.zeros(0, device="cuda"),
                rb[3:70_003], (f * 100).to(torch.float16)], (fb, rb)

    base, _ = leaves()
    dirty, rows, want = [], [], []
    for i, x in enumerate(base):
        n = ops.as_u32_blocks(x, bb)[1]
        idx = np.zeros(0, np.int32) if i == 6 else np.unique(np.append(
            rng.choice(n, size=min(n, 5), replace=False), n - 1)
        ).astype(np.int32)
        r = torch.randint(-2 ** 31, 2 ** 31 - 1, (idx.size, bb // 4),
                          generator=g, device="cuda", dtype=torch.int32)
        nbytes = x.numel() * x.element_size()
        w = ref.diffunpack_ref(ops.as_u32_blocks(x, bb)[0], r,
                               torch.from_numpy(idx).cuda())
        want.append(w.reshape(-1).view(torch.uint8)[:nbytes])
        dirty.append(idx)
        # odd leaves' rows on the card, even leaves' in host memory
        rows.append(r if i % 2 else r.cpu().numpy().view(np.uint32))
    got = []
    for _ in range(2):
        n0 = dp.UNPACK_LAUNCHES.n
        ts, (fb, rb) = leaves()
        out = ops.unpack_dirty_many(ts, dirty, rows, bb)
        assert all(a is b for a, b in zip(out, ts))
        assert dp.UNPACK_LAUNCHES.n == n0 + 1
        torch.cuda.synchronize()
        got.append([t.reshape(-1).view(torch.uint8) if t.numel() else
                    torch.zeros(0, dtype=torch.uint8, device="cuda")
                    for t in ts])
        assert all(torch.equal(a, w) for a, w in zip(got[-1], want))
        # nothing written outside the views
        assert torch.equal(fb[:1], f[:1]) and torch.equal(rb[:3], raw[:3])
        assert torch.equal(rb[70_003:], raw[70_003:])
    assert all(torch.equal(a, b) for a, b in zip(*got))


@pytest.mark.gpu
def test_directive_path_on_card_goes_through_the_kernels(tmp_path):
    """FULL, an in-place update before the async tail, DIFF, restart — on
    CUDA tensors, through the kernels and never their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.context import (CHK_DIFF, CheckpointConfig,
                                          CheckpointContext)
    cfg = CheckpointConfig(dir=str(tmp_path / "ck"), backend="fti",
                           block_bytes=4096, objstore=False)
    g = torch.Generator(device="cuda").manual_seed(1)
    state = {"w": torch.randn(64, 1024, generator=g, device="cuda"),
             "h": torch.randn(999, generator=g, device="cuda").bfloat16()}
    ops.reset_launch_counts()
    ctx = CheckpointContext(cfg)
    ctx.store(state, id=1, level=1)
    state["w"][5].add_(1.0)
    state["h"][-1] = 3.0
    ctx.store(state, id=2, level=1, kind=CHK_DIFF)
    ctx.shutdown()
    # one pack for the DIFF store's two dirty leaves
    assert ops.launch_counts() == {"blockhash2": 4, "diffpack": 1,
                                   "diffunpack": 0, "flashattn": 0,
                                   "flashattn_bwd": 0}
    ctx2 = CheckpointContext(cfg)
    got = ctx2.load({k: torch.zeros_like(v) for k, v in state.items()})
    ctx2.shutdown()
    assert all(got[k].is_cuda and torch.equal(got[k], v)
               for k, v in state.items())
    # the DIFF replayed on the card: one scatter for both leaves of the link
    assert ops.launch_counts()["diffunpack"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_version_on_card(dtype, causal):
    """flashattn against flash_attention_ref on the card: f32 within 2e-5,
    bf16 within one bf16 ulp of the output (:func:`bf16_tolerance`); head dims 16 and 64, S = 64
    to 512, Sk ≠ S, a ragged 3-d view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(2)
    cases = [(8, 256, 256, 64), (4, 64, 64, 64), (6, 512, 512, 16),
             (2, 128, 384, 64), (3, 128, 128, 32)]
    for bh_, s, sk, dh in cases:
        q, k, v = (torch.randn(bh_, n, dh, generator=g, device="cuda")
                   .to(dtype) for n in (s, sk, sk))
        got = fa.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 2e-5, (bh_, s, sk, dh)
        else:
            assert bool((err <= bf16_tolerance(want)).all()), (bh_, s, sk, dh)
    # a strided view goes in as well (the wrapper makes it contiguous)
    x = torch.randn(4, 128, 2, 64, generator=g, device="cuda").to(dtype)
    q = x[:, :, 0]
    assert torch.allclose(fa.flash_attention(q, q, q, causal=causal).float(),
                          ref.flash_attention_ref(q, q, q,
                                                  causal=causal).float(),
                          atol=2e-5 if dtype == torch.float32 else 1e-2)
    r = torch.randn(2, 200, 64, generator=g, device="cuda").to(dtype)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(r, r, r)            # 200 is not a multiple of 128


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_flash_grouped_kernel_matches_plain_version_on_card(dh):
    """The tensor-core kernel reading grouped KV heads in place, bf16,
    against flash_attention_gqa_ref within one bf16 ulp of the output
    (:func:`bf16_tolerance`) and its rows' log-sum-exp within 1e-5: H/KV 1
    and 8, Sk ≠ S, S and Sk not multiples of the kernel's tiles, causal and
    not, and q, k, v as strided views of a fused projection; a second
    launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(dh)
    cases = [(2, 256, 256, 8, 8), (2, 256, 256, 8, 1), (1, 128, 384, 8, 1),
             (2, 384, 128, 4, 4), (1, 200, 136, 8, 1)]
    for b, s, sk, h, kv in cases:
        for causal in (True, False):
            q = torch.randn(b, s, h, dh, generator=g, device="cuda").bfloat16()
            k, v = (torch.randn(b, sk, kv, dh, generator=g, device="cuda")
                    .bfloat16() for _ in range(2))
            got, lse = fa._launch_tc(q, k, v, causal)
            want, lse_want = ref.flash_attention_gqa_lse_ref(q, k, v,
                                                             causal=causal)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == torch.bfloat16
            assert torch.allclose(lse, lse_want, rtol=1e-5, atol=1e-5)
            err = (got.float() - want.float()).abs()
            assert bool((err <= bf16_tolerance(want)).all()), \
                (b, s, sk, h, kv, causal, float(err.max()))
            assert torch.equal(got, fa._launch_tc(q, k, v, causal)[0])
    # strided views: q, k, v sliced out of one (B, S, H + 2 KV, dh) tensor
    fused = torch.randn(2, 256, 8 + 2, dh, generator=g,
                        device="cuda").bfloat16()
    q, k, v = fused[:, :, :8], fused[:, :, 8:9], fused[:, :, 9:]
    got = fa.flash_attention_gqa(q, k, v, causal=True)
    want = ref.flash_attention_gqa_ref(q, k, v, causal=True)
    assert bool(((got.float() - want.float()).abs()
                 <= bf16_tolerance(want)).all())


@pytest.mark.gpu
def test_flash_gradient_matches_plain_autograd_on_card():
    """The autograd.Function (kernel forward, plain backward) against
    autograd through the plain version, f32, within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(3)
    for causal in (True, False):
        q, k, v = (torch.randn(2, 256, 4, 64, generator=g, device="cuda")
                   for _ in range(3))
        w = torch.randn(2, 256, 4, 64, generator=g, device="cuda")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (ops.flash_attention_bshd(*leaves, causal=causal) * w).sum().backward()
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        flat = [fa.to_bh(t) for t in plain]
        (fa.from_bh(ref.flash_attention_ref(*flat, causal=causal), 2)
         * w).sum().backward()
        for a, b in zip(leaves, plain):
            assert float((a.grad - b.grad).abs().max()) <= 1e-4


def _plain_bwd(q, k, v, dout, causal):
    """The plain backward in f32 on the same (bf16) inputs: the vjp on K
    and V repeated to the query heads, dk and dv summed over each group."""
    b, s, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    dq, dk, dv = ref.flash_attention_vjp_ref(
        *(ref.to_bh(x.float()) for x in (q, ref.repeat_kv(k, rep),
                                         ref.repeat_kv(v, rep), dout)),
        causal=causal)
    dk = ref.from_bh(dk, b).reshape(b, sk, kv, rep, dh).sum(dim=3)
    dv = ref.from_bh(dv, b).reshape(b, sk, kv, rep, dh).sum(dim=3)
    return ref.from_bh(dq, b), dk, dv


def _check_bwd(q, k, v, dout, causal):
    """The backward kernel on bf16 inputs against :func:`_plain_bwd`: each
    of dq, dk and dv within 2^-7 of that tensor's largest reference
    element (two bf16 ulps at the top), and a second launch bit-equal.
    → the worst error over the largest element."""
    out, lse = fa.flash_attention_gqa_fwd(q, k, v, causal=causal, bq=4, bk=4)
    got = fa.flash_attention_gqa_bwd(q, k, v, lse, dout, causal=causal)
    again = fa.flash_attention_gqa_bwd(q, k, v, lse, dout,
                                       causal=causal)
    want = _plain_bwd(q, k, v, dout, causal)
    worst = 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        top = float(w.abs().max())
        err = float((a.float() - w).abs().max())
        assert err <= 2.0 ** -7 * top, (name, err, top)
        worst = max(worst, err / top)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return worst


# (B, S, Sk, H, KV, dh, causal).  Worst error over the largest reference
# element, of dq, dk and dv, measured on an H100 80GB HBM3 at 700 W (the
# limit is 2^-7 = 7.8e-3): the cell's shape 2.9e-3; GQA 32/4 2.3e-3, 24/8
# 2.9e-3; dh 16 2.5e-3, 32 3.1e-3, 128 2.6e-3 (full 2.4e-3); whisper's
# cross attention 2.9e-3; the three ragged shapes 2.4e-3, 2.9e-3, 2.5e-3;
# the extreme logits below, causal 2.8e-3 and full 2.5e-3
FLASH_BWD_SHAPES = [
    (2, 4096, 4096, 32, 32, 64, True),      # the benchmark cell's
    (2, 512, 512, 32, 4, 64, True),         # tinyllama's GQA
    (2, 512, 512, 24, 8, 64, True),         # granite's
    (2, 256, 256, 4, 4, 16, True),
    (2, 256, 256, 4, 4, 32, True),
    (2, 256, 256, 4, 4, 128, True),
    (2, 256, 256, 4, 4, 128, False),
    (2, 512, 1536, 12, 12, 64, False),      # whisper's cross attention
    (2, 200, 200, 4, 4, 64, True),          # ragged: no multiple of a tile
    (2, 100, 300, 4, 1, 64, False),
    (1, 300, 100, 6, 2, 32, True),          # causal with Sk < S
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES)
def test_flash_backward_kernel_matches_plain_vjp_on_card(shape):
    """The backward kernels against the plain f32 vjp on the same bf16
    inputs, within two bf16 ulps of each gradient's largest element; two
    launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, s, sk, h, kv, dh, causal = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q = torch.randn(b, s, h, dh, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(b, sk, kv, dh, generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    dout = torch.randn(b, s, h, dh, generator=g, device="cuda").bfloat16()
    _check_bwd(q, k, v, dout, causal)


@pytest.mark.gpu
def test_flash_backward_kernel_reads_strided_inputs_on_card():
    """q, k and v as column slices of one fused projection, and dout as a
    transposed view, the (B, S, H, dh) layout through their strides (as
    ``local_map`` passes shards): the same gradients as on contiguous
    copies, bit for bit, and within the plain vjp's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, s, h, kv, dh = 2, 384, 8, 2, 64
    g = torch.Generator(device="cuda").manual_seed(11)
    fused = torch.randn(b, s, h + 2 * kv, dh, generator=g,
                        device="cuda").bfloat16()
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kv], fused[:, :, h + kv:]
    dout = torch.randn(b, h, s, dh, generator=g,
                       device="cuda").bfloat16().transpose(1, 2)
    assert not any(x.is_contiguous() for x in (q, k, v, dout))
    for causal in (True, False):
        _check_bwd(q, k, v, dout, causal)
        out, lse = fa.flash_attention_gqa_fwd(q, k, v, causal=causal)
        strided = fa.flash_attention_gqa_bwd(q, k, v, lse, dout,
                                             causal=causal)
        dense = fa.flash_attention_gqa_bwd(
            *(x.contiguous() for x in (q, k, v)), lse, dout.contiguous(),
            causal=causal)
        assert all(torch.equal(a, c) for a, c in zip(strided, dense))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernel_holds_at_extreme_logits_on_card(causal):
    """Scores of about ±512 whose row maximum moves with the key (the
    forward's extreme-logit inputs, in bf16): the backward within two
    bf16 ulps of each gradient's largest element, bit-equal repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _rising_logits(2, 512, 8, 2, 64, seed=21)
    dout = torch.randn(2, 512, 8, 64, generator=torch.Generator(
        device="cuda").manual_seed(22), device="cuda")
    _check_bwd(*(x.bfloat16() for x in (q, k, v, dout)), causal)


@pytest.mark.gpu
def test_flash_backward_dispatch_and_launch_count_on_card():
    """Through the autograd path: bf16 launches the backward kernel once
    per backward call (with one forward launch), f32 takes the plain
    backward and launches none; the kernel refuses f32 and a head dim it
    has no tile for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(2, 256, 4, 64, generator=g, device="cuda")
               for _ in range(3))
    for dtype, want in ((torch.bfloat16, 1), (torch.float32, 0)):
        leaves = [x.to(dtype).requires_grad_(True) for x in (q, k, v)]
        ops.reset_launch_counts()
        ops.flash_attention_gqa(*leaves, causal=True).sum().backward()
        torch.cuda.synchronize()
        assert ops.launch_counts()["flashattn"] == 1
        assert ops.launch_counts()["flashattn_bwd"] == want
        assert all(x.grad is not None for x in leaves)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    out, lse = fa.flash_attention_gqa_fwd(qb, kb, vb)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_gqa_bwd(q, k, v, lse, out.float())
    odd = torch.zeros(2, 256, 4, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_gqa_bwd(odd, odd, odd, lse, odd)


def _rising_logits(b, s, h, kv, dh, seed):
    """q (B, S, H, dh), k, v (B, S, KV, dh) in f32 whose scores q·k/8 span
    about ±512 and rise with the key: q and k are integers in [-31, 31]
    (exact in bf16, so every partial sum of q·k is exact in f32 and the
    kernels see the plain version's scores in any order of summation),
    but dim 0, 32 in every query and rising from -88 to 88 over the keys
    (a ramp of ±352); v is randn."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def ints(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") * 6
                ).round().clamp(-31, 31)
    q, k = ints(b, s, h, dh), ints(b, s, kv, dh)
    q[..., 0] = 32
    k[..., 0] = torch.linspace(-88, 88, s, device="cuda").round()[None, :,
                                                                   None]
    return q, k, torch.randn(b, s, kv, dh, generator=g, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_hold_at_extreme_logits_on_card(causal):
    """The reference's ``test_flash_extreme_logits_stable`` on both
    kernels: (1, 128, 64), q = k = 8 (every score 512), v = 1, bq = bk =
    64 gives 1 within rtol 1e-5 in f32 (flash_fwd_kernel) and one bf16 ulp
    in bf16 (flash_tc_kernel).  Then scores of about ±512 whose row
    maximum rises from one key tile to the next (the rescaling the
    reference's equal scores never reach), at the training shape: bf16
    through the grouped entry within one bf16 ulp of
    flash_attention_gqa_ref, f32 through the BH entry within 2e-5 of
    flash_attention_ref, two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype, bound in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        q = torch.full((1, 128, 64), 8.0, device="cuda", dtype=dtype)
        o = fa.flash_attention(q, q, torch.ones_like(q), causal=causal,
                               bq=64, bk=64)
        torch.cuda.synchronize()
        assert o.dtype == dtype
        assert float((o.float() - 1.0).abs().max()) <= bound, dtype
    b, s, h, kv, dh = 4, 2048, 32, 4, 64
    q, k, v = _rising_logits(b, s, h, kv, dh, seed=5)
    sc = q[0, :, 0].double() @ k[0, :, 0].double().T / 8
    assert 400 < -float(sc.min()) < 600 and 400 < float(sc.max()) < 600
    tile_max = sc.reshape(s, -1, 128).amax(-1)
    rose = tile_max[:, 1:] > torch.cummax(tile_max, 1).values[:, :-1]
    assert float(rose.double().mean()) > 0.9
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    got = fa.flash_attention_gqa(qb, kb, vb, causal=causal)
    want = ref.flash_attention_gqa_ref(qb, kb, vb, causal=causal)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert bool((err <= bf16_tolerance(want)).all()), float(err.max())
    assert torch.equal(got, fa.flash_attention_gqa(qb, kb, vb, causal=causal))
    del qb, kb, vb, got, want, err
    qf, kf, vf = (fa.to_bh(x) for x in (q, ref.repeat_kv(k, h // kv),
                                        ref.repeat_kv(v, h // kv)))
    got = fa.flash_attention(qf, kf, vf, causal=causal)
    want = ref.flash_attention_ref(qf, kf, vf, causal=causal)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-5
    assert torch.equal(got, fa.flash_attention(qf, kf, vf, causal=causal))


@pytest.mark.gpu
def test_reduced_training_on_card_goes_through_flash(tmp_path, monkeypatch):
    """Reduced tinyllama on the card with REPRO_ATTN_IMPL=flash: each step
    launches the kernel twice per layer (forward and the remat recompute)
    and the backward kernel once;
    train → kill → resume ends bit-equal to the uninterrupted run, in
    deterministic mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_arch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.protect import flatten_named
    from repro_torch.data.synthetic import init_data_state
    from repro_torch.ft.failures import FaultInjector, SimulatedFault
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import LevelSchedule, LoopConfig, run_training
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.state import init_train_state, prng_key
    from repro_torch.train.step import (make_train_step,
                                        use_deterministic_algorithms)

    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    use_deterministic_algorithms()
    try:
        cfg = get_arch("tinyllama-1.1b").reduced()
        m = build_model(cfg)
        state0 = init_train_state(
            m.init(torch.Generator(device="cuda").manual_seed(0)),
            prng_key(1), init_data_state(0))
        step = make_train_step(m, AdamWConfig(total_steps=8, warmup_steps=1))
        loop = LoopConfig(total_steps=6, ckpt_every=2, levels=LevelSchedule(
            l2_every=0, l3_every=0, l4_every=0))

        def ctx(name):
            return CheckpointContext(CheckpointConfig(
                dir=str(tmp_path / name), backend="fti", objstore=False))

        ops.reset_launch_counts()
        c = ctx("a")
        out_a = run_training(m, step, state0, c, loop, 2, 64,
                             log=lambda *_: None)
        c.shutdown()
        assert ops.launch_counts()["flashattn"] == 6 * 2 * cfg.n_layers
        assert ops.launch_counts()["flashattn_bwd"] == 6 * cfg.n_layers
        c = ctx("b")
        with pytest.raises(SimulatedFault):
            run_training(m, step, state0, c, loop, 2, 64,
                         injector=FaultInjector(6, 5 / 6),
                         log=lambda *_: None)
        c.shutdown()
        c = ctx("b")
        out_b = run_training(m, step, state0, c, loop, 2, 64,
                             log=lambda *_: None)
        c.shutdown()
        assert out_b["restarted"] and np.isfinite(out_a["loss"])
        a, b = flatten_named(out_a["state"]), flatten_named(out_b["state"])
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert a["params/embed"].is_cuda
    finally:
        torch.use_deterministic_algorithms(False)


# --------------------------------------------------------------------------- #
# serving and deploy on the card
# --------------------------------------------------------------------------- #

def _serve_model(compute="bfloat16"):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.zoo import build_model
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").reduced(),
                              compute_dtype=compute)
    return cfg, build_model(cfg)


@pytest.mark.gpu
def test_decode_on_card_matches_the_cpu():
    """lm_decode_step on the card against the same step on the CPU, f32
    compute, 8 steps: logits within 1e-4 and the caches within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.protect import flatten_named, unflatten_named
    cfg, m = _serve_model("float32")
    params = m.init(torch.Generator().manual_seed(0))
    on_card = unflatten_named({k: v.cuda() for k, v in
                               flatten_named(params).items()}, params)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    c_cpu = m.init_caches(2, 16, device="cpu")
    c_gpu = m.init_caches(2, 16, device="cuda")
    for i in range(8):
        a, c_cpu = m.decode_step(params, toks[:, i:i + 1], c_cpu, i)
        b, c_gpu = m.decode_step(on_card, toks[:, i:i + 1].cuda(), c_gpu, i)
        assert float((a - b.cpu()).abs().max()) <= 1e-4
    for x, y in zip(flatten_named(c_cpu).values(),
                    flatten_named(c_gpu).values()):
        assert y.is_cuda and float((x - y.cpu()).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_serve_state_store_restore_on_card_goes_through_the_kernels(tmp_path):
    """A ServeState on the card: FULL after prefill, DIFF 4 tokens later,
    a restore into a cold cache on the card (the DIFF replayed with one
    diffunpack launch), generation resumed bit-equal to an uninterrupted
    engine, in deterministic mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.context import (CHK_DIFF, CheckpointConfig,
                                          CheckpointContext)
    from repro_torch.core.protect import flatten_named
    from repro_torch.serve.engine import ServeState, ServingEngine
    from repro_torch.train.step import use_deterministic_algorithms

    use_deterministic_algorithms()
    try:
        cfg, m = _serve_model()
        params = m.init(torch.Generator(device="cuda").manual_seed(0))
        prompts = torch.randint(0, cfg.vocab_size, (2, 6), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(1)
                                ).cuda()
        ref = ServingEngine(m, params, batch=2, max_len=32)
        ref.prefill(prompts)
        want = ref.generate(10)
        eng = ServingEngine(m, params, batch=2, max_len=32)
        eng.prefill(prompts)
        ckcfg = CheckpointConfig(dir=str(tmp_path / "ck"), backend="fti",
                                 block_bytes=256, objstore=False)
        ops.reset_launch_counts()
        ctx = CheckpointContext(ckcfg)
        ctx.store(eng.get_state(), id=6, level=1)
        first = eng.generate(4)
        ctx.store(eng.get_state(), id=10, level=1, kind=CHK_DIFF)
        ctx.shutdown()
        # k, v and last_token hashed on the card at each store (pos is a
        # host leaf), one pack for the DIFF
        assert ops.launch_counts() == {"blockhash2": 6, "diffpack": 1,
                                       "diffunpack": 0, "flashattn": 0,
                                       "flashattn_bwd": 0}
        cold = ServeState(m.init_caches(2, 32, device="cuda"),
                          torch.tensor(0, dtype=torch.int32),
                          torch.zeros((2, 1), dtype=torch.int32,
                                      device="cuda"))
        ctx = CheckpointContext(ckcfg)
        got = ctx.load(cold)
        ctx.shutdown()
        assert ops.launch_counts()["diffunpack"] == 1
        assert ctx.restarted and int(got.pos) == 10
        assert got.caches[0].k.is_cuda and got.last_token.is_cuda
        back = ServingEngine(m, params, batch=2, max_len=32)
        back.set_state(got)
        rest = back.generate(6)
        assert torch.equal(torch.cat([first, rest], dim=1), want)
        a, b = flatten_named(back.get_state()), flatten_named(ref.get_state())
        assert all(torch.equal(a[k], b[k]) for k in a)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.gpu
def test_fleet_swap_on_card_installs_the_published_tree(tmp_path):
    """A FULL L4 publish of params on the card, a FleetDeployer rolling it
    onto a replica on the card: the swapped params are on the card and
    torch.equal to the published ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.protect import flatten_named
    from repro_torch.objstore.client import make_object_store
    from repro_torch.serve.deploy import FleetDeployer, Replica
    from repro_torch.serve.engine import ServingEngine

    _cfg, m = _serve_model()
    pub = m.init(torch.Generator(device="cuda").manual_seed(2))
    ctx = CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / "pub"), backend="fti", dedicated_thread=False,
        objstore_cdc_min_bytes=1024, objstore_cdc_avg_bytes=4096,
        objstore_cdc_max_bytes=16384))
    ctx.store({"params": pub}, id=1, level=4)
    ctx.shutdown()
    eng = ServingEngine(m, m.init(torch.Generator(device="cuda").manual_seed(
        3)), batch=2, max_len=16)
    dep = FleetDeployer(make_object_store(
        "file:" + str(tmp_path / "pub" / "objstore")),
        [Replica(name="r0", engine=eng, cache_root=str(tmp_path / "cache"),
                 prefix="params")])
    assert dep.run_until_converged()["action"] == "converged"
    got, want = flatten_named(eng.params), flatten_named(pub)
    assert eng.weights.entry_id == 1
    assert all(got[k].is_cuda and torch.equal(got[k], want[k]) for k in want)


@pytest.mark.gpu
def test_chaos_matrix_cell_on_card_hashes_its_card_leaves(tmp_path):
    """One scenario cell with its payloads on the card: bit-exact, no loss,
    and one hash launch per card leaf of each FTI store it planned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.chaos.scenarios import run_scenario
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    r = run_scenario("node-loss-mid-store", "fti", str(tmp_path),
                     device="cuda")
    torch.cuda.synchronize()
    assert r.ok and r.data_loss_bytes == 0 and r.recovery_path == "partner"
    # ids 1 and 2 on 4 ranks plus rank 3's torn id 3, 3 card leaves each
    assert ops.launch_counts()["blockhash2"] == (4 + 4 + 1) * 3


@pytest.mark.gpu
def test_elastic_rescale_puts_each_new_ranks_rows_on_card(tmp_path):
    """Phase 8 (b) at a small size: card leaves saved as 4 axis-0 rank
    files of a committed checkpoint, rescaled onto worlds 2 and 3, each new
    rank's rows on the card equal to the source's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import manifest as mf
    from repro_torch.core.formats import numpy_to_tensor
    from repro_torch.core.resharding import save_sharded, shard_bounds
    from repro_torch.ft.elastic import rescale_restore
    g = torch.Generator(device="cuda").manual_seed(3)
    src = {"w": torch.randn(37, 64, generator=g, device="cuda"),
           "b": torch.randn(37, generator=g, device="cuda").to(torch.bfloat16),
           "n": torch.arange(9, device="cuda")}
    root = str(tmp_path)
    d = mf.begin(root, 1)
    for r in range(4):
        sl, offs, shapes = {}, {}, {}
        for k, v in src.items():
            lo, hi = shard_bounds(v.shape[0], 4, r)
            sl[k], offs[k], shapes[k] = v[lo:hi], lo, list(v.shape)
        save_sharded(os.path.join(d, f"rank{r}.chk5"), sl, offs, shapes)
    mf.write_manifest(root, 1, {"kind": "FULL", "level": 4, "world": 4})
    mf.commit(root, 1)
    for world in (2, 3):
        for rank in range(world):
            named, ckpt_id = rescale_restore([root], world, rank)
            assert ckpt_id == 1
            for k, v in src.items():
                lo, hi = shard_bounds(v.shape[0], world, rank)
                got = numpy_to_tensor(named[k], "cuda")
                assert got.dtype == v.dtype and torch.equal(got, v[lo:hi])


@pytest.mark.gpu
def test_sharded_container_restores_onto_card_through_the_directives(
        tmp_path):
    """Phase 8 (c) at a small size: a shard-local FULL (host chunks, 4
    shard files) restores into a zeros template on the card bit-exact, and
    a newer id that lost a shard file makes the walk fall back, saying so."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import warnings

    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.formats import tensor_to_numpy
    from repro_torch.core.pipeline import StoreRequest
    from repro_torch.core.resharding import (ShardChunk, ShardSnapshot,
                                             shard_bounds)
    g = torch.Generator(device="cuda").manual_seed(4)
    state = {"w": torch.randn(50, 32, generator=g, device="cuda"),
             "n": torch.randn(32, generator=g, device="cuda"),
             "step": torch.tensor(3, device="cuda")}
    cfg = CheckpointConfig(dir=str(tmp_path), backend="fti",
                           dedicated_thread=False)

    def store(ckpt_id, step):
        ctx = CheckpointContext(cfg)
        pipe = ctx.tcl.backend.pipeline
        plan = pipe.plan(StoreRequest(named={"n": state["n"], "step": step},
                                      ckpt_id=ckpt_id, level=1))
        a = tensor_to_numpy(state["w"])
        plan.sharded = {"w": ShardSnapshot("<f4", a.shape, [
            ShardChunk((lo, 0), (hi - lo, 32), a[lo:hi])
            for lo, hi in (shard_bounds(50, 4, j) for j in range(4))])}
        pipe.finish(plan)
        ctx.shutdown()

    def load():
        ctx = CheckpointContext(cfg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            got = ctx.load({k: torch.zeros_like(v) for k, v in state.items()})
        ctx.shutdown()
        return got, [str(w.message) for w in caught]

    store(1, state["step"])
    got, said = load()
    assert not said
    for k, v in state.items():
        assert got[k].device == v.device and torch.equal(got[k], v)
    store(2, state["step"] + 1)
    os.remove(os.path.join(str(tmp_path), "node-local", "ckpts", "ckpt-2",
                           "rank0.shard2.chk5"))
    got, said = load()
    assert int(got["step"]) == 3 and torch.equal(got["w"], state["w"])
    assert any("checkpoint 2: incomplete shard set" in m for m in said)


# --------------------------------------------------------------------------- #
# MoE models and the donated (in-place) AdamW update on the card
# --------------------------------------------------------------------------- #

@pytest.mark.gpu
def test_flash_group_of_three_matches_plain_version_on_card():
    """granite-moe-3b-a800m's attention: 24 query heads over 8 KV heads (a
    group of 3, not a power of two) at its training shape and a short one,
    bf16, causal and not: within one bf16 ulp of flash_attention_gqa_ref,
    two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(24)
    for b, s in ((4, 2048), (1, 384)):
        for causal in (True, False):
            q = torch.randn(b, s, 24, 64, generator=g,
                            device="cuda").bfloat16()
            k, v = (torch.randn(b, s, 8, 64, generator=g, device="cuda")
                    .bfloat16() for _ in range(2))
            got = fa.flash_attention_gqa(q, k, v, causal=causal)
            want = ref.flash_attention_gqa_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            assert bool((err <= bf16_tolerance(want)).all()), \
                (b, s, causal, float(err.max()))
            assert torch.equal(got, fa.flash_attention_gqa(q, k, v,
                                                           causal=causal))


@pytest.mark.gpu
def test_moe_forward_at_full_width_on_card_matches_the_cpu(monkeypatch):
    """Two layers of granite-moe-3b-a800m at its published widths (40
    experts of d_ff 512, top-8, 24 heads over 8), f32 compute: the card's
    logits within 1e-3 of the CPU's and the aux loss within 1e-5
    relative, on the same parameters and 256 tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.models.zoo import build_model
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m"), n_layers=2,
                              compute_dtype="float32")
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    on_card = unflatten_named({k: v.cuda() for k, v in
                               flatten_named(params).items()}, params)
    toks = torch.randint(0, cfg.vocab_size, (1, 256), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want, aux_w = m.forward(params, {"tokens": toks})
            got, aux_g = m.forward(on_card, {"tokens": toks.cuda()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.is_cuda and got.shape == (1, 256, cfg.vocab_size)
    assert float((got.cpu() - want).abs().max()) <= 1e-3
    assert abs(float(aux_g) - float(aux_w)) <= 1e-5 * abs(float(aux_w))


@pytest.mark.gpu
def test_donated_adamw_on_card_is_bit_equal_to_functional():
    """On the card: adamw_update_ against adamw_update over 3 steps (a
    matrix, a vector, a bf16 matrix; gradients past the clip), and three
    donated steps of a reduced granite against three functional ones in
    deterministic mode — every leaf bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_arch
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.data.synthetic import init_data_state, next_batch
    from repro_torch.models.zoo import build_model
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update, adamw_update_,
                                             tree_leaves)
    from repro_torch.train.state import init_train_state, prng_key
    from repro_torch.train.step import (make_train_step,
                                        use_deterministic_algorithms)
    g = torch.Generator(device="cuda").manual_seed(5)
    params = {"w": torch.randn(64, 96, generator=g, device="cuda"),
              "b": torch.randn(96, generator=g, device="cuda"),
              "h": torch.randn(32, 64, generator=g, device="cuda").bfloat16()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    fp = {k: v.clone() for k, v in params.items()}
    ip = {k: v.clone() for k, v in params.items()}
    fs, is_ = adamw_init(fp), adamw_init(ip)
    for _ in range(3):
        grads = {k: (torch.randn(v.shape, generator=g, device="cuda") * 10)
                 .to(v.dtype) for k, v in params.items()}
        fp, fs, _ = adamw_update(cfg, grads, fs, fp)
        is_, _ = adamw_update_(cfg, tree_leaves(
            {k: v.clone() for k, v in grads.items()}), is_, ip)
    for f, i in ((fp, ip), (fs.mu, is_.mu), (fs.nu, is_.nu)):
        for x, y in zip(tree_leaves(f), tree_leaves(i)):
            assert torch.equal(x, y)

    use_deterministic_algorithms()
    try:
        mcfg = get_arch("granite-moe-3b-a800m").reduced()
        model = build_model(mcfg)
        opt = AdamWConfig(total_steps=10, warmup_steps=1)
        fstate = init_train_state(
            model.init(torch.Generator(device="cuda").manual_seed(0)),
            prng_key(1), init_data_state(0))
        dstate = unflatten_named({k: v.clone() for k, v in
                                  flatten_named(fstate).items()}, fstate)
        functional = make_train_step(model, opt)
        donating = make_train_step(model, opt, donate=True)
        for _ in range(3):
            batch, nxt = next_batch(fstate.data_state, mcfg, 2, 64, "cuda")
            fstate, fm = functional(fstate, batch)
            dstate, dm = donating(dstate, batch)
            fstate = fstate._replace(data_state=nxt)
            dstate = dstate._replace(data_state=nxt)
            assert torch.equal(fm["loss"], dm["loss"])
        a, b = flatten_named(fstate), flatten_named(dstate)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert a["params/embed"].is_cuda
    finally:
        torch.use_deterministic_algorithms(False)


def _minicpm3_two_layers():
    """minicpm3-4b at its published widths (MLA: q_lora 768, kv_lora 256,
    qk nope/rope 64/32, v_head 64, 40 heads), two layers, f32 compute, and
    its parameters on the CPU and on the card (the same values)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.models.zoo import build_model
    cfg = dataclasses.replace(get_arch("minicpm3-4b"), n_layers=2,
                              compute_dtype="float32")
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    on_card = unflatten_named({k: v.cuda() for k, v in
                               flatten_named(params).items()}, params)
    return cfg, m, params, on_card


@pytest.mark.gpu
def test_mla_forward_backward_at_full_width_on_card_matches_the_cpu(
        monkeypatch):
    """Two layers of minicpm3-4b at full width, f32 compute, 256 tokens,
    forward and backward (the naive MLA form): the card's loss within 1e-5
    relative of the CPU's and each parameter's gradient within 1e-3 of
    that leaf's largest CPU gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.protect import flatten_named
    from repro_torch.models.layers import softmax_cross_entropy
    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")   # MLA runs blockwise
    cfg, m, params, on_card = _minicpm3_two_layers()
    toks = torch.randint(0, cfg.vocab_size, (1, 257), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses, grads = [], []
        for p, dev in ((params, "cpu"), (on_card, "cuda")):
            leaves = flatten_named(p)
            for v in leaves.values():
                v.requires_grad_(True)
            t = toks.to(dev)
            logits, _ = m.forward(p, {"tokens": t[:, :-1]})
            loss = softmax_cross_entropy(logits, t[:, 1:]).mean()
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({k: v.grad.cpu() for k, v in leaves.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    assert "groups/0/attn/w_uk" in grads[0]
    for k, g in grads[0].items():
        bound = 1e-3 * float(g.abs().max())
        assert float((grads[1][k] - g).abs().max()) <= bound, k


@pytest.mark.gpu
def test_mla_decode_on_card_matches_the_cpu():
    """lm_decode_step of two minicpm3-4b layers at full width on the card
    against the CPU, f32 compute, 8 steps into a 16-slot latent cache:
    logits within 1e-4 and both cache leaves within 1e-5; no flash
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.protect import flatten_named
    cfg, m, params, on_card = _minicpm3_two_layers()
    toks = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    c_cpu = m.init_caches(2, 16, device="cpu")
    c_gpu = m.init_caches(2, 16, device="cuda")
    ops.reset_launch_counts()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            for i in range(8):
                a, c_cpu = m.decode_step(params, toks[:, i:i + 1], c_cpu, i)
                b, c_gpu = m.decode_step(on_card, toks[:, i:i + 1].cuda(),
                                         c_gpu, i)
                assert float((a - b.cpu()).abs().max()) <= 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got = flatten_named(c_gpu)
    assert sorted(got) == ["0/c_kv", "0/k_rope"]
    for k, x in flatten_named(c_cpu).items():
        assert got[k].is_cuda and float((x - got[k].cpu()).abs().max()) \
            <= 1e-5
    assert ops.launch_counts()["flashattn"] == 0


@pytest.mark.gpu
def test_blockhash2_on_the_narrow_mla_cache_leaf_on_card():
    """minicpm3-4b's k_rope cache leaf at its serving shape (62, 4, 2048,
    32) bf16, 64-byte rows: blockhash2 equals blockhash2_ref bit for bit,
    and the blocks 16 decode positions dirty pack and scatter back into a
    cold leaf through diffpack / diffunpack bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(62)
    x = torch.randn(62, 4, 2048, 32, generator=g, device="cuda").bfloat16()
    bb = 65_536
    words, n = ops.as_u32_blocks(x, bb)
    assert torch.equal(bh.blockhash2(x, bb), ref.blockhash2_ref(words))
    row = 32 * x.element_size()
    idx = sorted({(s * 2048 + p) * row // bb for s in range(62 * 4)
                  for p in range(128, 144)})
    assert len(idx) == 248 and max(idx) < n
    idx = np.asarray(idx, np.int32)
    rows = dp.diffpack_many([x], [idx], bb)
    assert torch.equal(rows, ref.diffpack_ref(
        words, torch.from_numpy(idx.astype(np.int64)).cuda()))
    cold = torch.zeros_like(x)
    dp.diffunpack_many([cold], [idx], rows, bb)
    torch.cuda.synchronize()
    sel = torch.from_numpy(idx.astype(np.int64)).cuda()
    want = torch.zeros_like(words)
    want[sel] = words[sel]
    assert torch.equal(ops.as_u32_blocks(cold, bb)[0], want)


def _seeded_(params, seed: int):
    """Every floating leaf of ``params`` drawn afresh in place, non-zero, at
    the scale of its init: a random leaf keeps its spread, a constant one
    (zeros, ones) gets 0.2 of noise around its value, and RWKV's ``w0``
    (-6 at init) is drawn around -1.  The init's zeros (ddlerp's and the
    decay's LoRA B, the bonus u, every mu) would leave those paths
    untested."""
    from repro_torch.core.protect import flatten_named
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in flatten_named(params).items():
            noise = torch.randn(v.shape, generator=g)
            sd = float(v.std()) if v.numel() > 1 else 0.0
            if k.endswith("w0"):
                v.copy_(-1.0 + 0.5 * noise)
            elif sd > 0:
                v.copy_(noise * sd)
            else:
                v.add_(0.2 * noise)
    return params


def _rwkv6_two_layers():
    """rwkv6-3b at its published widths (d_model 2560, 40 WKV heads of
    64, d_ff 8960, vocab 65536), two layers, f32 compute, every leaf
    seeded (:func:`_seeded_`), on the CPU and on the card (the same
    values)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.models.zoo import build_model
    cfg = dataclasses.replace(get_arch("rwkv6-3b"), n_layers=2,
                              compute_dtype="float32")
    m = build_model(cfg)
    params = _seeded_(m.init(torch.Generator().manual_seed(0)), 1)
    on_card = unflatten_named({k: v.cuda() for k, v in
                               flatten_named(params).items()}, params)
    return cfg, m, params, on_card


@pytest.mark.gpu
def test_rwkv6_forward_backward_at_full_width_on_card_matches_the_cpu():
    """Two layers of rwkv6-3b at full width, f32 compute, B 1 × S 512
    (eight WKV chunks of 64), forward and backward: the card's loss within
    1e-5 relative of the CPU's; each parameter's gradient as close to the
    CPU's as the CPU's own is to a CPU run on weights perturbed by one
    part in 1e7 (one f32 rounding), within a factor of 4 (+ 1e-5), in
    relative norm ‖a − b‖ / ‖b‖.  These gradients are ill-conditioned in
    f32: that perturbation moves layer 0's by up to 6.1e-4 (``u``), one
    CPU thread in place of eight by 2.4e-4, the card by 1.07e-3 (an
    H100 at 700 W); no flash launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.models.layers import softmax_cross_entropy
    cfg, m, params, on_card = _rwkv6_two_layers()
    g = torch.Generator().manual_seed(7)
    perturbed = unflatten_named(
        {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g))
         for k, v in flatten_named(params).items()}, params)
    toks = torch.randint(0, cfg.vocab_size, (1, 513), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    ops.reset_launch_counts()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses, grads = [], []
        for p, dev in ((params, "cpu"), (perturbed, "cpu"),
                       (on_card, "cuda")):
            leaves = flatten_named(p)
            for v in leaves.values():
                v.requires_grad_(True)
            t = toks.to(dev)
            logits, _ = m.forward(p, {"tokens": t[:, :-1]})
            loss = softmax_cross_entropy(logits, t[:, 1:]).mean()
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({k: v.grad.cpu() for k, v in leaves.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(losses[2] - losses[0]) <= 1e-5 * abs(losses[0])
    assert "groups/0/mixer/lora_B" in grads[0]
    bad = {}
    for k, g0 in grads[0].items():
        assert float(g0.abs().max()) > 0, k
        noise = float((grads[1][k] - g0).norm() / g0.norm())
        card = float((grads[2][k] - g0).norm() / g0.norm())
        if card > 4 * noise + 1e-5:
            bad[k] = (card, noise)
    assert not bad, bad
    assert ops.launch_counts()["flashattn"] == 0


@pytest.mark.gpu
def test_rwkv6_decode_at_full_width_on_card_matches_the_cpu():
    """lm_decode_step of two rwkv6-3b layers at full width on the card
    against the CPU, f32 compute, B 2, 16 steps: logits within 1e-4 at
    every step; the WKV state and both shift rows after them, written in
    place, within 1e-5 of the CPU's in relative norm (‖card − cpu‖ /
    ‖cpu‖; the largest elementwise gap measured on an H100 at 700 W is
    6.5e-5); no flash launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.protect import flatten_named
    cfg, m, params, on_card = _rwkv6_two_layers()
    toks = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    c_cpu = m.init_caches(2, 16, device="cpu")
    c_gpu = m.init_caches(2, 16, device="cuda")
    wkv = c_gpu[0].wkv
    ops.reset_launch_counts()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            for i in range(16):
                a, c_cpu = m.decode_step(params, toks[:, i:i + 1], c_cpu, i)
                b, c_gpu = m.decode_step(on_card, toks[:, i:i + 1].cuda(),
                                         c_gpu, i)
                assert float((a - b.cpu()).abs().max()) <= 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got = flatten_named(c_gpu)
    assert sorted(got) == ["0/cm_shift", "0/tm_shift", "0/wkv"]
    assert c_gpu[0].wkv is wkv and bool(wkv.any())
    rel = {}
    for k, x in flatten_named(c_cpu).items():
        assert got[k].is_cuda
        rel[k] = (float((got[k].cpu() - x).norm() / x.norm()),
                  float((got[k].cpu() - x).abs().max()),
                  float(x.abs().max()))
    assert all(r[0] <= 1e-5 for r in rel.values()), rel
    assert ops.launch_counts()["flashattn"] == 0


@pytest.mark.gpu
def test_mamba_mixer_at_jamba_width_on_card_matches_the_cpu():
    """One Mamba mixer at jamba-1.5-large's widths (d_model 8192, d_inner
    16384, 256 heads of 64, d_state 16, conv 4, chunk 64), every leaf
    seeded, f32: ``mamba_block`` at B 1 × S 256 (four SSD chunks) and 8
    ``mamba_decode_step``s, card against CPU, each output within 1e-4 of
    the CPU's largest output magnitude, and the three state leaves within
    rtol = atol = 1e-5 after the decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm
    cfg = get_arch("jamba-1.5-large-398b")
    s = cfg.ssm
    assert (cfg.d_model, s.expand * cfg.d_model, s.head_dim, s.d_state,
            s.conv_width, s.chunk) == (8192, 16384, 64, 16, 4, 64)
    p = _seeded_(ssm.init_mamba_layer(torch.Generator().manual_seed(0), cfg,
                                      torch.float32), 2)
    pg = {k: v.cuda() for k, v in p.items()}
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 256, cfg.d_model, generator=g)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = ssm.mamba_block(p, x, cfg)
            got = ssm.mamba_block(pg, x.cuda(), cfg).cpu()
            assert float((got - want).abs().max()) <= \
                1e-4 * float(want.abs().max())
            st = ssm.init_mamba_state(1, cfg, torch.float32, "cpu")
            sg = ssm.init_mamba_state(1, cfg, torch.float32, "cuda")
            for i in range(8):
                a, st = ssm.mamba_decode_step(p, x[:, i:i + 1], st, cfg)
                b, sg = ssm.mamba_decode_step(pg, x[:, i:i + 1].cuda(), sg,
                                              cfg)
                assert float((b.cpu() - a).abs().max()) <= \
                    1e-4 * float(a.abs().max())
                assert float((a[:, 0] - want[:, i]).abs().max()) <= \
                    1e-4 * float(want.abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(st, sg):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5)


def _whisper_two_layers():
    """whisper-small at its published widths (d_model 768, 12 heads of 64,
    d_ff 3072, vocab 51865, tied, gelu), 2 encoder + 2 decoder layers, f32
    compute, every leaf seeded (:func:`_seeded_`: the init's norm scales
    are all 1), on the CPU and on the card (the same values)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.models.zoo import build_model
    cfg = dataclasses.replace(get_arch("whisper-small"), n_layers=2,
                              compute_dtype="float32")
    m = build_model(cfg)
    params = _seeded_(m.init(torch.Generator().manual_seed(0)), 1)
    on_card = unflatten_named({k: v.cuda() for k, v in
                               flatten_named(params).items()}, params)
    return cfg, m, params, on_card


@pytest.mark.gpu
def test_whisper_forward_backward_at_full_width_on_card_matches_the_cpu(
        monkeypatch):
    """Two + two layers of whisper-small at full width, f32 compute, B 1:
    512 tokens over 1,536 frames (whisper's 1,500 audio frames rounded up
    to the flash tile), forward and backward through flash (the f32
    CUDA-core kernel on the card: encoder self 1,536 × 1,536, decoder self
    causal, cross 512 × 1,536; the plain backward): the card's loss within
    1e-5 relative of the CPU's and each parameter's gradient within 1e-3
    of that leaf's largest CPU gradient; six flash launches (three per
    layer pair)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.protect import flatten_named
    from repro_torch.models.layers import softmax_cross_entropy
    monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    cfg, m, params, on_card = _whisper_two_layers()
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, 513), dtype=torch.int32,
                         generator=g)
    frames = torch.randn(1, 1536, cfg.d_model, generator=g) * 0.02
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses, grads = [], []
        for p, dev in ((params, "cpu"), (on_card, "cuda")):
            leaves = flatten_named(p)
            for v in leaves.values():
                v.requires_grad_(True)
            t = toks.to(dev)
            ops.reset_launch_counts()
            logits, _ = m.forward(p, {"tokens": t[:, :-1],
                                      "frames": frames.to(dev)})
            loss = softmax_cross_entropy(logits, t[:, 1:]).mean()
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({k: v.grad.cpu() for k, v in leaves.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert ops.launch_counts()["flashattn"] == 6
    assert ops.launch_counts()["flashattn_bwd"] == 0     # f32: plain
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    assert "dec_layers/cross_attn/wk" in grads[0]
    for k, g0 in grads[0].items():
        assert float(g0.abs().max()) > 0, k
        bound = 1e-3 * float(g0.abs().max())
        assert float((grads[1][k] - g0).abs().max()) <= bound, k


@pytest.mark.gpu
def test_whisper_decode_over_cross_kv_on_card_matches_the_cpu():
    """16 ``encdec_decode_step``s of two + two whisper-small layers at full
    width, f32 compute, B 2, over the cross K/V that
    ``precompute_cross_kv`` makes from 1,536 encoded frames, on the card
    against the CPU: the cross K/V within 1e-4 of the CPU's largest, the
    logits within 1e-4 at every step, the self-KV cache after them
    (written in place) within 1e-5; no flash launch in decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import encdec
    cfg, m, params, on_card = _whisper_two_layers()
    g = torch.Generator().manual_seed(2)
    frames = torch.randn(2, 1536, cfg.d_model, generator=g) * 0.02
    toks = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                         generator=g)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            caches = []
            for p, dev in ((params, "cpu"), (on_card, "cuda")):
                k, v = encdec.precompute_cross_kv(
                    p, encdec.encode(p, frames.to(dev), cfg), cfg)
                c = m.init_caches(2, 16, device=dev, enc_len=1536)
                c.cross_k.copy_(k)
                c.cross_v.copy_(v)
                caches.append(c)
            c_cpu, c_gpu = caches
            for a, b in ((c_cpu.cross_k, c_gpu.cross_k),
                         (c_cpu.cross_v, c_gpu.cross_v)):
                assert float((b.cpu() - a).abs().max()) <= \
                    1e-4 * float(a.abs().max())
            k_gpu = c_gpu.self_kv.k
            ops.reset_launch_counts()
            for i in range(16):
                a, c_cpu = m.decode_step(params, toks[:, i:i + 1], c_cpu, i)
                b, c_gpu = m.decode_step(on_card, toks[:, i:i + 1].cuda(),
                                         c_gpu, i)
                assert float((a - b.cpu()).abs().max()) <= 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert c_gpu.self_kv.k is k_gpu and bool(k_gpu.any())
    for a, b in ((c_cpu.self_kv.k, c_gpu.self_kv.k),
                 (c_cpu.self_kv.v, c_gpu.self_kv.v)):
        assert float((b.cpu() - a).abs().max()) <= 1e-5
    assert ops.launch_counts()["flashattn"] == 0


@pytest.mark.gpu
def test_two_ranks_on_one_card_store_shard_locally_and_restore(tmp_path):
    """Two processes share the one card (gloo: NCCL refuses two ranks on
    one GPU; on a machine of several cards only the first is made
    visible): reduced tinyllama on a (1, 2) mesh of ``DTensor`` leaves on
    the card, FULL + sparse update + DIFF, then two new processes restore
    onto (2, 1).  The checkpoint path moves host bytes between the ranks
    (digests and dirty rows); what gloo itself takes on the card is
    recorded.  Every box equals the source's, the DIFF's dirty blocks are
    the rows written, and the launches are the design's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch.meshckpt import compare
    one_card = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    src, got = _two_rank_store_restore(tmp_path, env=one_card)
    for r in src + got:
        assert r["process_group"] == "gloo" and r["card"] == 0
    for s in src:
        assert s["dirty_blocks"] == s["expected_dirty"]
        assert s["launches"] == s["designed_launches"]
        assert set(s["gloo_cuda"]) == {
            "all_reduce", "broadcast", "all_gather",
            "all_gather_into_tensor", "reduce_scatter_tensor",
            "all_to_all_single"}
    assert all(r["restarted"] and r["placements_kept"] for r in got)
    assert compare(src, got) > 0


@pytest.mark.gpu
def test_dtensor_forward_on_a_one_rank_mesh_at_full_width_equals_plain():
    """tinyllama-1.1b at full width (22 layers, bf16 compute, flash) on a
    one-rank (1, 1) mesh: the forward on ``DTensor`` parameters and
    tokens equals the forward on the plain tensors bit for bit, and
    launches the flash kernel once per layer, on the local heads (a
    ``DTensor`` never reaches the launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_arch
    from repro_torch.core.resharding import reshard_tree
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharding import batch_sharding, param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.zoo import build_model

    os.environ["REPRO_ATTN_IMPL"] = "flash"
    try:
        model = build_model(get_arch("tinyllama-1.1b"))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        toks = torch.randint(0, model.cfg.vocab_size, (2, 256),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32).cuda()
        with torch.no_grad():
            want, _ = model.forward(params, {"tokens": toks})
            mesh = make_host_mesh("cuda")
            sharded = reshard_tree(params,
                                   param_shardings(mesh, model.param_struct()))
            dtoks = reshard_tree({"t": toks},
                                 {"t": batch_sharding(mesh, 2)})["t"]
            ops.reset_launch_counts()
            with use_mesh(mesh):
                got, _ = model.forward(sharded, {"tokens": dtoks})
            torch.cuda.synchronize()
        assert ops.launch_counts()["flashattn"] == model.cfg.n_layers
        assert torch.equal(got.full_tensor(), want)
    finally:
        os.environ.pop("REPRO_ATTN_IMPL", None)


# --------------------------------------------------------------------------- #
# worlds with a card per rank: NCCL for the card's tensors, the checkpoint's
# host bytes on gloo beside it
# --------------------------------------------------------------------------- #


def _distributed_run(n: int, argv, env=None, timeout=300):
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ if env is None else env,
               PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), *argv],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)


def _nccl_one_rank_worker(d: str) -> None:
    """One rank on one card: join (NCCL), a (1, 1) mesh, a DTensor
    all-reduce and a ``dist.all_reduce`` on the card, then a FULL store of
    a DTensor and a card tensor through ``ProcessGroupComm`` (its gloo
    groups), with NCCL all-reduces on the main thread while the CP thread
    finishes the store, and a restore into zeros."""
    import json

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.resharding import reshard_tree, zeros_onto
    from repro_torch.dist.comm import ProcessGroupComm
    from repro_torch.dist.context import NamedSharding, P
    from repro_torch.launch import mesh as meshlib

    rank, world, device, backend = meshlib.join_from_env("cuda")
    res = {"rank": rank, "world": world, "backend": backend,
           "card": device.index, "default": str(dist.get_backend()),
           "card_backend": dist.distributed_c10d._get_default_group()
           ._get_backend(device).name(),
           "override": meshlib._GLOO_CUDA_LIB is not None}
    mesh = meshlib.make_mesh((1, 1), ("data", "model"), "cuda")
    x = torch.arange(12.0, device=device).reshape(3, 4)
    part = DTensor.from_local(x, mesh, [Partial(), Replicate()],
                              run_check=False)
    res["dtensor_all_reduce"] = bool(torch.equal(
        part.redistribute(mesh, [Replicate(), Replicate()]).to_local(), x))
    t = torch.full((4,), 2.0, device=device)
    dist.all_reduce(t)
    res["all_reduce"] = t.tolist()

    comm = ProcessGroupComm(os.path.join(d, "nodes"))
    res["comm_groups"] = [str(dist.get_backend(g))
                          for g in (comm._group, comm._plan_group)]
    sh = {"w": NamedSharding(mesh, P("data", "model"))}
    state = {"w": reshard_tree({"w": x}, sh)["w"],
             "b": torch.arange(5.0, device=device)}
    cfg = CheckpointConfig(dir=d, backend="fti", block_bytes=256,
                           objstore=False)
    ctx = CheckpointContext(cfg, comm)
    ctx.store(state, id=1, level=1)
    for _ in range(20):                 # NCCL beside the CP thread's tail
        dist.all_reduce(t)
    torch.cuda.synchronize(device)
    ctx.wait()
    ctx.shutdown()
    res["all_reduce_after"] = t.tolist()
    ctx = CheckpointContext(cfg, comm)
    template = {"w": zeros_onto({"w": torch.empty(3, 4, device="meta")},
                                sh)["w"],
                "b": torch.zeros(5, device=device)}
    got = ctx.load(template)
    ctx.shutdown()
    res["restored"] = ctx.restarted and bool(
        torch.equal(got["w"].to_local(), x)) and bool(
        torch.equal(got["b"], state["b"])) and got["b"].device == device
    res["exchanged_bytes"] = comm.exchanged_bytes
    with open(os.path.join(d, f"nccl-rank{rank}.json"), "w") as f:
        json.dump(res, f)
    meshlib.leave()


@pytest.mark.gpu
def test_one_rank_nccl_world_on_one_card_beside_gloo_checkpoint_groups(
        tmp_path):
    """A one-rank world on one card is NCCL (``cpu:gloo,cuda:nccl``, the
    card's tensors on NCCL, no gloo override); ``ProcessGroupComm``'s two
    groups are gloo beside it, and a store and a restore through them
    run while the main thread all-reduces on NCCL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    r = _distributed_run(1, [__file__, "nccl-one", str(tmp_path)])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    res = json.loads((tmp_path / "nccl-rank0.json").read_text())
    assert res["backend"] == res["default"] == "cpu:gloo,cuda:nccl"
    assert res["card_backend"] == "nccl" and res["card"] == 0
    assert not res["override"]
    assert res["dtensor_all_reduce"]
    assert res["all_reduce"] == [2.0] * 4 == res["all_reduce_after"]
    assert res["comm_groups"] == ["gloo", "gloo"]
    assert res["restored"]


def _two_rank_store_restore(tmp, env=None):
    """meshckpt's reduced tinyllama: store from (1, 2), restore onto
    (2, 1), two processes each → (store results, restore results)."""
    import json
    common = ["--reduced", "--device", "cuda", "--block-bytes", "256",
              "--dir", str(tmp / "ck"), "--out", str(tmp / "out")]
    for argv in (["store", "--mesh", "1,2", "--targets", "2,1"],
                 ["restore", "--mesh", "2,1", "--source-mesh", "1,2"]):
        r = _distributed_run(2, ["-m", "repro_torch.launch.meshckpt", *argv,
                                 *common], env=env)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return [[json.loads((tmp / "out" / f"{n}-rank{k}.json").read_text())
             for k in range(2)] for n in ("store", "restore-2x1")]


@pytest.mark.gpu
def test_two_ranks_on_two_cards_store_shard_locally_over_nccl(tmp_path):
    """Two processes on two cards join over NCCL, one rank per card: the
    shard-local store from (1, 2) and the restore onto (2, 1) hold every
    box, the DIFF's dirty blocks and the design's launches, ask gloo
    nothing on the card, and exchange per store the bytes that the same
    two ranks sharing one card over gloo exchange."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, {torch.cuda.device_count()} visible")
    from repro_torch.launch.meshckpt import compare
    src, got = _two_rank_store_restore(tmp_path / "nccl")
    for r in src + got:
        assert r["process_group"] == "cpu:gloo,cuda:nccl"
    assert [r["card"] for r in src] == [0, 1] == [r["card"] for r in got]
    for s in src:
        assert "gloo_cuda" not in s
        assert s["dirty_blocks"] == s["expected_dirty"]
        assert s["launches"] == s["designed_launches"]
    assert all(r["restarted"] and r["placements_kept"] for r in got)
    assert compare(src, got) > 0
    one_card = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    src1, _ = _two_rank_store_restore(tmp_path / "gloo", env=one_card)
    assert [r["process_group"] for r in src1] == ["gloo", "gloo"]
    assert [[st["exchanged_bytes"] for st in r["stores"]] for r in src] == \
        [[st["exchanged_bytes"] for st in r["stores"]] for r in src1]


if __name__ == "__main__":
    import sys
    if sys.argv[1] == "nccl-one":
        _nccl_one_rank_worker(sys.argv[2])

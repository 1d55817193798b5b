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
            idx = torch.from_numpy(np.unique(
                np.array([0, n - 1, n // 2], np.int32))).cuda()
            want_p = ref.diffpack_ref(ops.as_u32_blocks(x, bb)[0], idx)
            assert torch.equal(dp.diffpack(x, idx, bb), want_p)
    torch.cuda.synchronize()


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
    assert ops.launch_counts() == {"blockhash2": 4, "diffpack": 2,
                                   "flashattn": 0}
    ctx2 = CheckpointContext(cfg)
    got = ctx2.load({k: torch.zeros_like(v) for k, v in state.items()})
    ctx2.shutdown()
    assert all(got[k].is_cuda and torch.equal(got[k], v)
               for k, v in state.items())


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


@pytest.mark.gpu
def test_reduced_training_on_card_goes_through_flash(tmp_path, monkeypatch):
    """Reduced tinyllama on the card with REPRO_ATTN_IMPL=flash: each step
    launches the kernel twice per layer (forward and the remat recompute);
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

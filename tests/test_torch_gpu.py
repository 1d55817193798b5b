"""The hand-written Hopper kernels against their plain PyTorch versions,
on a card (marker ``gpu``; skipped where no CUDA device is present).

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import blockhash as bh
from repro_torch.kernels import diffpack as dp
from repro_torch.kernels import ops, ref


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
    assert ops.launch_counts() == {"blockhash2": 4, "diffpack": 2}
    ctx2 = CheckpointContext(cfg)
    got = ctx2.load({k: torch.zeros_like(v) for k, v in state.items()})
    ctx2.shutdown()
    assert all(got[k].is_cuda and torch.equal(got[k], v)
               for k, v in state.items())

"""``tests/test_async_data_reshard.py`` on the port: the CP-dedicated
thread's semantics (``repro_torch.core.async_engine``, a copy of the
reference's) and the data cursor through ``SyntheticDataset``."""
import threading
import time

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.async_engine import CPDedicatedThread
from repro_torch.data.synthetic import (SyntheticDataset, init_data_state,
                                        next_batch)


# ------------------------------ async engine ------------------------------ #


def test_async_runs_off_thread():
    cp = CPDedicatedThread()
    tid = {}
    cp.submit(1, lambda: tid.setdefault("worker", threading.get_ident()))
    cp.wait()
    assert tid["worker"] != threading.get_ident()
    cp.shutdown()


def test_async_error_surfaces_later_not_at_submit():
    cp = CPDedicatedThread()

    def boom():
        raise IOError("disk full")

    res = cp.submit(1, boom)
    res.done.wait()
    # FTI semantics: the *next* directive surfaces the failure
    with pytest.raises(RuntimeError, match="disk full"):
        cp.check_errors()
    cp.check_errors()          # cleared after surfacing
    cp.shutdown()


def test_async_inflight_fence():
    cp = CPDedicatedThread(max_inflight=1)
    order = []

    def slow(i):
        def f():
            time.sleep(0.05)
            order.append(i)
        return f

    cp.submit(1, slow(1))
    cp.submit(2, slow(2))      # blocks until 1 finishes (fence)
    cp.wait()
    assert order == [1, 2]
    cp.shutdown()


def test_async_shutdown_drains():
    cp = CPDedicatedThread()
    hits = []
    cp.submit(1, lambda: hits.append(1))
    cp.shutdown()
    assert hits == [1]
    with pytest.raises(RuntimeError):
        cp.submit(2, lambda: None)


# ------------------------------ data cursor ------------------------------- #


def test_cursor_restart_resumes_same_stream():
    cfg = get_arch("tinyllama-1.1b").reduced()
    ds = SyntheticDataset(cfg, 2, 16, seed=7)
    first = [next(ds) for _ in range(3)]
    saved = ds.get_state()
    a = next(ds)
    ds2 = SyntheticDataset(cfg, 2, 16, seed=7)
    ds2.set_state(saved)
    b = next(ds2)
    assert int(saved.position) == 3 and len(first) == 3
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], first[-1]["tokens"])


def test_vlm_batch_masks_patch_labels():
    cfg = get_arch("internvl2-1b").reduced()
    b, _ = next_batch(init_data_state(0), cfg, 2, 32)
    p = cfg.n_frontend_tokens
    assert b["labels"].shape == (2, 32)
    assert bool((b["labels"][:, :p] == -1).all())
    assert b["tokens"].shape == (2, 32 - p)


def test_dataset_puts_each_batch_on_its_device_and_iterates():
    """``SyntheticDataset`` is its own iterator; its batches (an
    encoder-decoder's frames included) are ``next_batch``'s at each
    cursor, on the device it was given."""
    cfg = get_arch("whisper-small").reduced()
    ds = SyntheticDataset(cfg, 2, 16, seed=3, device="cpu")
    assert iter(ds) is ds
    got = [b for _, b in zip(range(2), ds)]
    st = init_data_state(3)
    for b in got:
        want, st = next_batch(st, cfg, 2, 16)
        assert list(b) == ["frames", "tokens", "labels"]
        assert all(torch.equal(b[k], want[k]) and b[k].device.type == "cpu"
                   for k in want)
    assert int(ds.get_state().position) == 2

#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one H100 and check every kernel.

    python3 chip_smoke.py                 # on a machine with one H100

Phases (every failure exits non-zero; nothing falls back to the CPU):

1. Build: compile the Hopper kernels (``src/repro_torch/kernels/csrc``)
   with ``nvcc`` for sm_90a, one process per source, all at once.
2. Kernel vs plain version on the card: ``blockhash2`` against
   ``blockhash2_ref`` (the main path's leaf shapes, ragged lengths, every
   dtype width, unaligned storage offsets) and ``diffpack`` against
   ``diffpack_ref`` (1, 7 and ~2,000 dirty blocks, ragged last block), bit
   for bit; ``flashattn`` against ``flash_attention_ref`` at tinyllama's
   attention shape (B 4, S 2048, 32 heads of 64) causal and not, and at
   S 256: bf16 within one bf16 ulp of the output, f32 within 2e-5, and the
   autograd gradient (kernel forward, plain backward) within 1e-4 of
   autograd through the plain version, in f32.
3. The directive path at full width: a tinyllama-1.1b-shaped state
   (arXiv:2401.02385: 22 layers, d_model 2048, 32 heads / 4 KV heads, d_ff
   5632, vocab 32000, untied lm_head; 4.40 GB in f32) generated on the
   card from a seed goes through the directives with the FTI backend and a
   CP-dedicated thread: FULL, an in-place sparse update made before the
   FULL's tail ran, DIFF (exact dirty-block count), a dense update
   (promoted FULL), another sparse update and DIFF, shutdown, then a
   restart into a zeros template that must equal the final state bit for
   bit.  The kernels' launch counts are reset just before and read just
   after, and must match the leaves hashed and packed.
4. Timing on the card (CUDA events, median of 20 after warm-up) of each
   kernel, its plain version and, where one exists, a PyTorch call
   computing the same function, beside the bound: the larger of bytes over
   3.35 TB/s and the operations (the busiest integer pipe or the
   instruction dispatch rate, counted in the SASS of the hash as built;
   the attention's FLOPs over the dense bf16 peak).
5. Checkpointed training at full width: tinyllama-1.1b's TrainState
   (13.2 GB: params, mu, nu in f32) with ``REPRO_ATTN_IMPL=flash``, batch
   4 × 2048 tokens, remat, FTI level 1 with a CP-dedicated thread, in
   deterministic mode.  Run A: 3 steps, no store.  Run B: 3 steps, a FULL
   store at step 2 and an injected fault at step 3; a fresh context
   restores and runs step 3.  Both final states must be equal bit for bit
   and the loss finite; the flash kernel's launches (reset before, read
   after) must be two per layer and step.

The last lines are the card's name and power limit (``nvidia-smi``), one
JSON object with the kernels' numbers, and ``{"ok": true, "device": ...}``.

``--device cpu`` (with ``--width-div``/``--block-bytes`` to shrink it)
rehearses phases 3 and 5 on the CPU with the plain versions (phase 5 on
a reduced config) and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"

# H100 SXM rates the bounds divide by, at the card's maximum SM clock of
# 1.98 GHz x 132 SMs.  HBM: NVIDIA's data sheet.  Integer: the data sheet
# lists no INT32 rate outside the tensor cores; the CUDA programming guide
# gives 64 results per clock per SM on compute capability 9.0 for 32-bit
# integer add, multiply-add, shift and logic.  Integer multiplies (IMAD,
# IMUL) issue on the FMA pipe and the other integer instructions on the
# ALU pipe (Nsight Compute's pipe names: fmaheavy, alu), 64 lanes per clock
# per SM each, and the two co-issue; the four warp schedulers of an SM
# issue at most 4 x 32 = 128 lanes per clock, whatever the pipe (the same
# 128 lanes that give the data sheet's 67 TFLOP/s in float32).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12          # dense, tensor cores (data sheet)
PIPE_LANES_PER_S = 64 * 132 * 1.98e9
ISSUE_LANES_PER_S = 128 * 132 * 1.98e9

#: one SASS instruction: address, opcode, operands
_SASS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_FMA_PIPE_OPS = {"IMAD", "IMUL"}
# where VIADD issues is not documented; it is counted on the ALU pipe, the
# busier of the two, so the bound it sets is the larger one
_ALU_PIPE_OPS = {"IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
                 "LEA", "ISETP", "SEL", "PRMT", "IMNMX", "VIMNMX", "IABS",
                 "POPC", "FLO", "BMSK"}

BLOCK_BYTES = 65_536
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# the state: tinyllama-1.1b's parameters at their published widths
# --------------------------------------------------------------------------- #

def tinyllama_state(torch, n_layers: int, div: int, device, gen):
    d, kv, ff, vocab = 2048 // div, 256 // div, 5632 // div, 32_000 // div

    def w(*shape):
        return torch.randn(*shape, generator=gen, device=device) * 0.02

    def norm():
        return 1.0 + 0.1 * torch.randn(d, generator=gen, device=device)

    layers = [{"attn_norm": norm(), "wq": w(d, d), "wk": w(d, kv),
               "wv": w(d, kv), "wo": w(d, d), "mlp_norm": norm(),
               "w1": w(d, ff), "w3": w(d, ff), "w2": w(ff, d)}
              for _ in range(n_layers)]
    return {"params": {"embed": w(vocab, d), "layers": layers,
                       "final_norm": norm(), "lm_head": w(vocab, d)},
            "step": torch.zeros((), dtype=torch.int64, device=device)}


def norms_of(state):
    p = state["params"]
    return ([lyr[k] for lyr in p["layers"] for k in ("attn_norm", "mlp_norm")]
            + [p["final_norm"]])


def sparse_update(torch, state, gen, n_tokens: int = 1024):
    """In place: rows of embed and lm_head for seeded token ids, every norm
    vector, and the step counter.  → the token ids (host)."""
    p = state["params"]
    vocab, d = p["embed"].shape
    ids = torch.randint(0, vocab, (n_tokens,), generator=gen,
                        device=p["embed"].device)
    src = torch.full((n_tokens, d), 0.5, device=p["embed"].device)
    p["embed"].index_add_(0, ids, src)
    p["lm_head"].index_add_(0, ids, src)
    for n in norms_of(state):
        n.add_(0.25)
    state["step"] += 1
    return ids.cpu().numpy()


def touched_blocks(ids, row_bytes: int, block_bytes: int) -> list:
    """Hash blocks covering the given rows of a row-major matrix."""
    out = set()
    for r in set(int(i) for i in ids):
        lo, hi = r * row_bytes, (r + 1) * row_bytes - 1
        out.update(range(lo // block_bytes, hi // block_bytes + 1))
    return sorted(out)


def n_blocks(t, block_bytes: int) -> int:
    return max(1, -(-t.numel() * t.element_size() // block_bytes))


# --------------------------------------------------------------------------- #
# phase 3: the main path through the directives
# --------------------------------------------------------------------------- #

_STAGES = ("pipeline.plan", "pipeline.pack", "pipeline.place",
           "pipeline.commit")


def stage_seconds(events) -> dict:
    """{(ckpt_id, stage): seconds} from the pipeline's trace spans (B/E
    pairs nest per thread)."""
    open_spans, out = {}, {}
    for ev in events:
        if ev["ph"] == "B":
            open_spans.setdefault(ev["tid"], []).append(ev)
        elif ev["ph"] == "E":
            b = open_spans[ev["tid"]].pop()
            if b["name"] in _STAGES:
                key = (b["args"].get("ckpt_id"), b["name"].split(".")[1])
                out[key] = out.get(key, 0.0) + (ev["ts"] - b["ts"]) / 1e6
    return out


def main_path(torch, args, device, ops):
    from repro_torch.core.context import (CHK_DIFF, CHK_FULL,
                                          CheckpointConfig, CheckpointContext)
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.telemetry import trace as ttrace

    bb = args.block_bytes
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.time()
    state = tinyllama_state(torch, args.layers, args.width_div, device, gen)
    if device.type == "cuda":
        torch.cuda.synchronize()
    named = flatten_named(state)
    total_bytes = sum(t.numel() * t.element_size() for t in named.values())
    total_blocks = sum(n_blocks(t, bb) for t in named.values())
    n_elems = sum(t.numel() for t in named.values()) - 1       # minus step
    log(f"[main] state: {len(named)} leaves, {n_elems:,} parameters, "
        f"{total_bytes / 1e9:.2f} GB on {device}, {total_blocks:,} blocks of "
        f"{bb} B, made in {time.time() - t0:.1f} s")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    cfg = CheckpointConfig(dir=str(CKPT_DIR), backend="fti", block_bytes=bb,
                           dedicated_thread=True, objstore=False)
    p = state["params"]
    row_bytes = p["embed"].shape[1] * p["embed"].element_size()
    norm_blocks = sum(n_blocks(n, bb) for n in norms_of(state))
    sparse_leaves = 2 + len(norms_of(state)) + 1
    reports = []
    blocked = {}

    ttrace.reset()
    ttrace.enable()                 # the pipeline's stage spans, per store
    ops.reset_launch_counts()
    ctx = CheckpointContext(cfg).observe_store_reports(reports.append)

    def store(ckpt_id, kind):
        t = time.time()
        ctx.store(state, id=ckpt_id, level=1, kind=kind)
        blocked[ckpt_id] = time.time() - t

    store(1, CHK_FULL)
    # the deferred-digest hazard: update in place before the FULL's tail ran
    ids2 = sparse_update(torch, state, gen)
    want2 = 2 * len(touched_blocks(ids2, row_bytes, bb)) + norm_blocks + 1
    store(2, CHK_DIFF)
    for t in flatten_named(state).values():
        t.mul_(3)
    store(3, CHK_DIFF)
    ids4 = sparse_update(torch, state, gen)
    want4 = 2 * len(touched_blocks(ids4, row_bytes, bb)) + norm_blocks + 1
    store(4, CHK_DIFF)
    ctx.shutdown()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    stages = stage_seconds(ttrace.tracer().events())
    ttrace.disable()

    by_id = {r.ckpt_id: r for r in reports}
    if sorted(by_id) != [1, 2, 3, 4]:
        fail(f"committed stores {sorted(by_id)} != [1, 2, 3, 4]")
    for i in (1, 2, 3, 4):
        r = by_id[i]
        ratio = "-" if r.dirty_ratio is None else f"{r.dirty_ratio:.5f}"
        log(f"[main] store {i}: kind={r.kind} promoted={r.promoted_full} "
            f"bytes_payload={r.bytes_payload} dirty_ratio={ratio} "
            f"plan_s={r.plan_seconds:.4f} store_call_s={blocked[i]:.4f} "
            f"total_s={r.seconds:.4f}")
        log(f"[main] store {i} stages (s): " + " ".join(
            f"{st}={stages.get((i, st), 0.0):.4f}"
            for st in ("plan", "pack", "place", "commit")))
    got2 = round(by_id[2].dirty_ratio * total_blocks)
    got4 = round(by_id[4].dirty_ratio * total_blocks)
    log(f"[main] dirty blocks: store 2 {got2} (expected {want2}), "
        f"store 4 {got4} (expected {want4})")
    if by_id[1].kind != CHK_FULL or by_id[2].kind != CHK_DIFF:
        fail("stores 1/2 are not FULL/DIFF")
    if got2 != want2 or got4 != want4:
        fail("DIFF dirty-block count differs from the touched rows")
    if not (by_id[3].promoted_full and by_id[3].kind == CHK_FULL):
        fail("store 3 (every block dirty) was not promoted to FULL")
    if by_id[4].kind != CHK_DIFF:
        fail("store 4 is not a DIFF")

    # restart: a fresh context restores into a zeros template on the device
    t = time.time()
    ctx2 = CheckpointContext(cfg)
    template = {k: torch.zeros_like(v) for k, v in named.items()}
    restored = ctx2.load(unflatten_named(template, state))
    ctx2.shutdown()
    if device.type == "cuda":
        torch.cuda.synchronize()
    restore_s = time.time() - t
    if not ctx2.restarted:
        fail("restart found no checkpoint")
    bad = [k for k, v in flatten_named(restored).items()
           if v.device != named[k].device or not torch.equal(v, named[k])]
    if bad:
        fail(f"restored leaves differ from the final state: {bad[:5]}")
    log(f"[main] restore: {len(named)} leaves bit-exact on {device} "
        f"in {restore_s:.2f} s (restarted={ctx2.restarted})")

    want_launch = {"blockhash2": 4 * len(named),
                   "diffpack": 2 * sparse_leaves, "flashattn": 0}
    log(f"[main] kernel launches: {launches} (expected on the card: "
        f"{want_launch})")
    if device.type == "cuda" and launches != want_launch:
        fail("launch counts do not match the leaves hashed and packed")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return state, ids2, launches


# --------------------------------------------------------------------------- #
# phase 2: kernel vs plain version, bit-exact
# --------------------------------------------------------------------------- #

def u32_max_abs_diff(torch, a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    da = a.to(torch.int64) & 0xFFFFFFFF
    db = b.to(torch.int64) & 0xFFFFFFFF
    return int((da - db).abs().max().item()) if da.numel() else 0


def check_kernels(torch, device, ops, ref, bh, dp):
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    worst = {"blockhash2": 0, "diffpack": 0}

    def hash_case(name, x, bb=BLOCK_BYTES):
        got = bh.blockhash2(x, bb)
        want = ref.blockhash2_ref(ops.as_u32_blocks(x, bb)[0])
        torch.cuda.synchronize()
        err = u32_max_abs_diff(torch, got, want)
        worst["blockhash2"] = max(worst["blockhash2"], err)
        if err:
            fail(f"blockhash2 {name}: differs from blockhash2_ref")

    def rand_u32(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen,
                             device=device, dtype=torch.int64).to(torch.int32)

    # random u32 words at every leaf shape of the main path
    shapes = [(32_000, 2048), (2048, 2048), (2048, 256), (2048, 5632),
              (5632, 2048), (2048,), (2,)]
    for s in shapes:
        hash_case(f"u32{s}", rand_u32(*s))
    # ragged lengths, every dtype width, unaligned storage offsets
    hash_case("1 element", rand_u32(1))
    raw = torch.randint(0, 256, (BLOCK_BYTES + 1 + 64,), generator=gen,
                        device=device, dtype=torch.int64).to(torch.uint8)
    hash_case("one block + 1 byte", raw[:BLOCK_BYTES + 1])
    f = torch.randn(100_003, generator=gen, device=device)
    for n in (7, 32_769, 100_003):
        hash_case(f"bf16 x{n}", f[:n].to(torch.bfloat16))
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
               torch.float64, torch.uint8, torch.int8):
        x = (f * 100).to(dt) if dt.is_floating_point else \
            (f * 1000).to(torch.int64).to(dt)
        hash_case(f"{dt}", x)
    hash_case("offset 3 bytes", raw[3:3 + BLOCK_BYTES + 17])
    hash_case("offset 4 bytes (f32, +1 element)", f[1:])
    hash_case("block_bytes 256", f[:10_001], bb=256)

    def pack_case(name, x, idx, bb=BLOCK_BYTES):
        idx = torch.from_numpy(idx).to(device)
        got = dp.diffpack(x, idx, bb)
        want = ref.diffpack_ref(ops.as_u32_blocks(x, bb)[0], idx)
        torch.cuda.synchronize()
        err = u32_max_abs_diff(torch, got, want)
        worst["diffpack"] = max(worst["diffpack"], err)
        if err:
            fail(f"diffpack {name}: differs from diffpack_ref")

    import numpy as np
    rng = np.random.RandomState(SEED)
    emb = rand_u32(32_000, 2048)
    nb = 4000
    for k in (1, 7, 2000):
        idx = np.sort(rng.choice(nb, size=k, replace=False)).astype(np.int32)
        idx[-1] = nb - 1
        pack_case(f"{k} dirty of {nb}", emb, idx)
    rag = f[:100_003]                              # 7 blocks, the last ragged
    pack_case("ragged last block", rag, np.array([6, 0, 3], np.int32))
    pack_case("offset 3 bytes", raw[3:3 + BLOCK_BYTES + 17],
              np.array([1, 0], np.int32))
    pack_case("block_bytes 256", f[:10_001], np.arange(0, 157, 3,
                                                        dtype=np.int32), 256)
    log(f"[check] blockhash2 and diffpack equal their plain versions "
        f"bit for bit (tolerance 0): max_abs_err {worst}")
    return worst


def bf16_tolerance(torch, x):
    """One bf16 ulp at each element's magnitude (8 significant bits),
    floored at the f32 tolerance 2e-5: near zero, where the softmax
    average cancels, the f32 rounding of the terms outweighs a bf16 ulp."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7).clamp(min=2e-5)


#: (B, S, H, dh) of the training path's attention, and a short sequence
FLASH_SHAPES = ((4, 2048, 32, 64), (4, 256, 32, 64))


def check_flash(torch, device, ops, ref, fa) -> float:
    """flashattn against flash_attention_ref; the autograd.Function's
    gradient against autograd through the plain version.  → the largest
    absolute error of the bf16 outputs (the path's working type)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    worst_bf16 = 0.0
    for b, s, h, dh in FLASH_SHAPES:
        for causal in (True, False):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = (torch.randn(b * h, s, dh, generator=gen,
                                       device=device).to(dtype)
                           for _ in range(3))
                got = fa.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                case = f"B{b} S{s} H{h} dh{dh} causal={causal} {dtype}"
                if dtype == torch.bfloat16:
                    worst_bf16 = max(worst_bf16, float(err.max()))
                    if not bool((err <= bf16_tolerance(torch, want)).all()):
                        fail(f"flashattn {case}: beyond one bf16 ulp")
                elif float(err.max()) > 2e-5:
                    fail(f"flashattn {case}: max_abs_err "
                         f"{float(err.max()):.3g} > 2e-5")
                log(f"[check] flashattn {case}: max_abs_err "
                    f"{float(err.max()):.3g}")
                del q, k, v, got, want, err
    # the gradient, f32, at the training shape, causal
    b, s, h, dh = FLASH_SHAPES[0]
    q, k, v, w = (torch.randn(b, s, h, dh, generator=gen, device=device)
                  for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (ops.flash_attention_bshd(*leaves, causal=True) * w).sum().backward()
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (fa.from_bh(ref.flash_attention_ref(*(fa.to_bh(x) for x in plain),
                                        causal=True), b) * w).sum().backward()
    gerr = max(float((a.grad - c.grad).abs().max())
               for a, c in zip(leaves, plain))
    if gerr > 1e-4:
        fail(f"flash gradient differs from the plain autograd: {gerr:.3g}")
    log(f"[check] flashattn: bf16 within one bf16 ulp (max_abs_err "
        f"{worst_bf16:.3g}), f32 within 2e-5; gradient (f32, B{b} S{s}) "
        f"within {gerr:.3g} of autograd through the plain version (limit "
        f"1e-4)")
    return worst_bf16


# --------------------------------------------------------------------------- #
# phase 4: timing and bounds
# --------------------------------------------------------------------------- #

def blockhash_ops_per_word(build):
    """Instructions per u32 word in blockhash2's full-block loop, counted in
    the SASS of the library as built (``cuobjdump -sass``): the loop is the
    straight-line one (its back-edge its only branch) with the most 128-bit
    loads.  Loop and address overhead counts too: the card runs it.
    → ({"alu": .., "fma": .., "issue": ..} per word, body length, words)."""
    tool = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(
        "blockhash2"))], capture_output=True, text=True, timeout=120,
        check=True).stdout
    ins = [(int(a, 16), op, rest) for a, op, rest in _SASS.findall(sass)]
    best = None
    for e, (addr, op, rest) in enumerate(ins):
        if op != "BRA" or int(rest.split()[-1], 16) > addr:
            continue
        start = int(rest.split()[-1], 16)
        body = [o for a, o, _ in ins[: e + 1] if a >= start]
        vec = sum(o.startswith("LDG") and ".128" in o for o in body)
        if vec and sum(o == "BRA" for o in body) == 1 and (
                best is None or vec > best[0]):
            best = (vec, body)
    if best is None:
        fail("blockhash2 SASS: no straight-line loop of 128-bit loads")
    vec, body = best
    words = 4 * vec
    base = [o.split(".")[0] for o in body]
    per_word = {"alu": sum(o in _ALU_PIPE_OPS for o in base) / words,
                "fma": sum(o in _FMA_PIPE_OPS for o in base) / words,
                "issue": len(body) / words}
    return per_word, len(body), words


def bound(bytes_moved: float, words: float = 0.0, per_word=None):
    """The least time for the work, in ms, and what sets it: bytes over the
    HBM rate, or the integer instructions for ``words`` u32 words on the
    busiest pipe or at the issue rate, whichever is longest."""
    times = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3}
    if per_word:
        ops_ms = max(words * per_word["alu"] / PIPE_LANES_PER_S,
                     words * per_word["fma"] / PIPE_LANES_PER_S,
                     words * per_word["issue"] / ISSUE_LANES_PER_S) * 1e3
        times["operations"] = ops_ms
    by = max(times, key=times.get)
    return times[by], by


def pack_bytes(t, idx, block_bytes: int) -> int:
    """Bytes diffpack must move for dirty blocks ``idx`` (numpy) of leaf
    ``t``: the leaf's own bytes in each block read once, each full row of
    the output written once, and the indices read once."""
    nbytes = t.numel() * t.element_size()
    read = sum(min(block_bytes, nbytes - int(i) * block_bytes) for i in idx)
    return read + len(idx) * (block_bytes + 4)


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` (CUDA events).  A spin kernel queued
    ahead of each timed run keeps the card busy while the host enqueues
    ``fn``'s launches, so the events bracket device work only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_kernels(torch, state, ids2, ops, ref, bh, dp, per_word):
    from repro_torch.core.protect import flatten_named
    import numpy as np

    bb = BLOCK_BYTES
    leaves = list(flatten_named(state).values())
    blocks = [ops.as_u32_blocks(t, bb)[0] for t in leaves]
    torch.cuda.synchronize()
    out = {}

    def hash_bound(ts):
        nbl = sum(n_blocks(t, bb) for t in ts)
        nbytes = sum(t.numel() * t.element_size() for t in ts)
        return bound(nbytes + 8 * nbl, nbl * bb / 4, per_word)

    # blockhash2: one pass over the whole state, one launch per leaf
    words = sum(b.numel() for b in blocks)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    ms = device_ms(torch, lambda: [bh.blockhash2(t, bb) for t in leaves])
    plain = device_ms(torch, lambda: [ref.blockhash2_ref(b) for b in blocks])
    b_ms, b_by = hash_bound(leaves)
    out["blockhash2"] = dict(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        work=f"{len(leaves)} leaves, {nbytes} B, {words} u32 words")

    # diffpack: the dirty blocks of the first sparse update, per leaf
    p = state["params"]
    row_bytes = p["embed"].shape[1] * p["embed"].element_size()
    rows = np.asarray(touched_blocks(ids2, row_bytes, bb), np.int32)
    jobs = [(p["embed"], rows), (p["lm_head"], rows)]
    jobs += [(n, np.arange(n_blocks(n, bb), dtype=np.int32))
             for n in norms_of(state)]
    jobs.append((state["step"], np.zeros(1, np.int32)))
    n_dirty = sum(len(i) for _, i in jobs)
    moved = sum(pack_bytes(t, i, bb) for t, i in jobs)
    jobs = [(t, torch.from_numpy(i).cuda()) for t, i in jobs]
    jobs_b = [(ops.as_u32_blocks(t, bb)[0], i) for t, i in jobs]
    ms = device_ms(torch, lambda: [dp.diffpack(t, i, bb) for t, i in jobs])
    plain = device_ms(torch, lambda: [ref.diffpack_ref(b, i)
                                      for b, i in jobs_b])
    lib = device_ms(torch, lambda: [torch.index_select(b, 0, i)
                                    for b, i in jobs_b])
    b_ms, b_by = bound(moved)
    out["diffpack"] = dict(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        work=f"{len(jobs)} leaves, {n_dirty} dirty blocks, {moved} B")

    # where the time goes: one leaf alone, one launch each, against the
    # whole state's 202 (hash) and 48 (pack) launches above — the largest
    # leaf, and a norm vector (8 KiB: one partial block)
    for name, (t, idx), b in (("params/embed", jobs[0], jobs_b[0][0]),
                              ("a norm vector", jobs[2], jobs_b[2][0])):
        nbl = n_blocks(t, bb)
        h = device_ms(torch, lambda: bh.blockhash2(t, bb))
        h_plain = device_ms(torch, lambda: ref.blockhash2_ref(b))
        h_b, h_by = hash_bound([t])
        pk = device_ms(torch, lambda: dp.diffpack(t, idx, bb))
        pk_plain = device_ms(torch, lambda: ref.diffpack_ref(b, idx))
        pk_lib = device_ms(torch, lambda: torch.index_select(b, 0, idx))
        pk_b, _ = bound(pack_bytes(t, idx.cpu().numpy(), bb))
        log(f"[time] {name} alone ({nbl} blocks, "
            f"{t.numel() * t.element_size()} B): blockhash2 {h:.4f} ms "
            f"(bound {h_b:.3g} ms by {h_by}; plain {h_plain:.4f} ms); "
            f"diffpack of {idx.numel()} dirty blocks {pk:.4f} ms (bound "
            f"{pk_b:.3g} ms by bytes; plain {pk_plain:.4f} ms; index_select "
            f"{pk_lib:.4f} ms)")
    for name, r in out.items():
        log(f"[time] {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}; plain {r['plain_ms']:.4f} ms; library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms) over {r['work']}")
    return out


def time_flash(torch, device, ref, fa) -> dict:
    """flashattn at the training path's shape (bf16, causal) beside its
    bound, its plain version and scaled_dot_product_attention."""
    import torch.nn.functional as F

    b, s, h, dh = FLASH_SHAPES[0]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    q, k, v = (torch.randn(b * h, s, dh, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    q4, k4, v4 = (x.view(b, h, s, dh) for x in (q, k, v))
    out = {}
    for causal in (True, False):
        ms = device_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                         causal=causal))
        plain = device_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=causal))
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal))
        # the (query, key) pairs this input needs: the lower triangle with
        # its diagonal when causal; two products of dh MACs each per pair
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        flops = 4 * dh * pairs
        moved = 4 * q.numel() * q.element_size()       # q, k, v, o once
        times = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
                 "operations": flops / BF16_FLOPS_PER_S * 1e3}
        by = max(times, key=times.get)
        out[causal] = dict(
            ms=ms, plain_ms=plain, bound_ms=times[by], bound_by=by,
            library_ms=lib, work=f"B{b} S{s} H{h} dh{dh} bf16 "
            f"causal={causal}: {flops:.4g} FLOPs, {moved} B")
        log(f"[time] flashattn causal={causal}: {ms:.4f} ms (bound "
            f"{times[by]:.4f} ms by {by}: {flops:.4g} FLOPs at 989 TFLOP/s "
            f"{times['operations']:.4f} ms, {moved} B at 3.35 TB/s "
            f"{times['bytes']:.4f} ms; plain {plain:.4f} ms; "
            f"scaled_dot_product_attention {lib:.4f} ms)")
    return out[True]


# --------------------------------------------------------------------------- #
# phase 5: checkpointed training at full width
# --------------------------------------------------------------------------- #

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 3


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


#: device-time groups of a training step, by kernel name (first match)
_KERNEL_GROUPS = (
    ("flash attention kernel", ("flash_fwd_kernel",)),
    ("matrix products", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reductions", ("reduce_kernel",)),
    ("embedding / gather", ("embedding", "gather", "index", "scatter")),
    ("copies and casts", ("copy", "cat", "memcpy", "memset", "unrolled")),
    ("elementwise", ("elementwise", "foreach")),
)


def profile_step(torch, step) -> None:
    """One more training step under ``torch.profiler``: device time by
    kernel group and the device's idle share of the step.  Prints that no
    device time was recorded if the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        wall = time.time() - t0
    groups, top = {}, []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue                     # an operator, not a kernel
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0)) / 1e3   # ms
        if dev <= 0:
            continue
        name = ev.key.lower()
        group = next((g for g, keys in _KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + dev
        top.append((dev, ev.count, ev.key[:90]))
    busy = sum(groups.values())
    if busy == 0:
        log("[profile] torch.profiler recorded no device time")
        return
    log(f"[profile] one step under torch.profiler: {wall * 1e3:.1f} ms "
        f"wall, {busy:.1f} ms of device time, idle share "
        f"{max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"[profile]   {g}: {ms:.1f} ms ({ms / busy:.1%})")
    for ms, n, key in sorted(top, reverse=True)[:10]:
        log(f"[profile]   kernel {ms:.1f} ms x{n}: {key}")


def training_path(torch, args, device, ops) -> dict:
    """Run A: TRAIN_STEPS steps, no store.  Run B: a FULL store at step 2,
    an injected fault at step 3, then a fresh context restores and runs
    step 3.  The final TrainStates must be equal bit for bit."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.formats import tensor_to_numpy
    from repro_torch.core.protect import flatten_named
    from repro_torch.data.synthetic import init_data_state
    from repro_torch.ft.failures import FaultInjector, SimulatedFault
    from repro_torch.kernels import flashattn as fa
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import LevelSchedule, LoopConfig, run_training
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.state import init_train_state, prng_key
    from repro_torch.train.step import (make_train_step,
                                        use_deterministic_algorithms)

    on_card = device.type == "cuda"
    cfg, batch, seq = get_arch("tinyllama-1.1b"), TRAIN_BATCH, TRAIN_SEQ
    if not on_card:                                  # the CPU rehearsal
        cfg, batch, seq = cfg.reduced(), 2, 64
    os.environ["REPRO_ATTN_IMPL"] = "flash"
    if on_card:
        use_deterministic_algorithms()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t = time.time()
    state0 = init_train_state(
        model.init(torch.Generator(device=device).manual_seed(SEED)),
        prng_key(SEED + 1), init_data_state(SEED))
    sync(torch, device)
    named0 = flatten_named(state0)
    nbytes = sum(x.numel() * x.element_size() for x in named0.values())
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"TrainState {len(named0)} leaves, {nbytes / 1e9:.2f} GB on {device}, "
        f"made in {time.time() - t:.1f} s; batch {batch} x {seq}, remat, "
        f"REPRO_ATTN_IMPL=flash")
    del named0
    step_fn = make_train_step(
        model, AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=1),
        remat=True)
    steps = []

    def timed(run):
        def step(state, b):
            sync(torch, device)
            n0, t0 = fa.LAUNCHES.n, time.time()
            new, met = step_fn(state, b)
            sync(torch, device)
            steps.append((run, int(new.step), time.time() - t0,
                          fa.LAUNCHES.n - n0, float(met["loss"])))
            return new, met
        return step

    def ctx_cfg(name):
        return CheckpointConfig(dir=str(TRAIN_DIR / name), backend="fti",
                                dedicated_thread=True, objstore=False)

    def quiet(*_):
        pass

    levels = LevelSchedule(l2_every=0, l3_every=0, l4_every=0)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    ops.reset_launch_counts()

    # run A: straight through, no store
    ctx = CheckpointContext(ctx_cfg("a"))
    out = run_training(model, timed("A"), state0, ctx, LoopConfig(
        total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1, levels=levels),
        batch, seq, log=quiet)
    ctx.shutdown()
    named_a = flatten_named(out["state"])
    final_a = {k: tensor_to_numpy(v) for k, v in named_a.items()}
    device_a = {k: v.device for k, v in named_a.items()}
    del named_a
    loss_a = out["loss"]
    del out

    # run B: FULL store at step 2, fault at step 3, restore, step 3
    loop_b = LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=2, levels=levels)
    reports, blocked = [], {}
    ctx = CheckpointContext(ctx_cfg("b")).observe_store_reports(
        reports.append)
    store = ctx.store

    def timed_store(state, **kw):
        t0 = time.time()
        r = store(state, **kw)
        if kw.get("if_", True):
            blocked[kw["id"]] = time.time() - t0
        return r

    ctx.store = timed_store
    try:
        run_training(model, timed("B"), state0, ctx, loop_b, batch, seq,
                     injector=FaultInjector(TRAIN_STEPS, 1.0), log=quiet)
    except SimulatedFault as e:
        log(f"[train] run B: {e}")
    else:
        fail("run B: the injected fault did not fire")
    t = time.time()
    ctx.shutdown()                       # the FULL's tail finishes here
    drain_s = time.time() - t
    if [r.ckpt_id for r in reports] != [2]:
        fail(f"run B committed stores {[r.ckpt_id for r in reports]} != [2]")
    r = reports[0]
    log(f"[train] store 2: kind={r.kind} bytes_payload={r.bytes_payload} "
        f"plan_s={r.plan_seconds:.4f} store_call_s={blocked[2]:.4f} "
        f"total_s={r.seconds:.4f} (shutdown waited {drain_s:.2f} s for the "
        f"tail)")

    ctx = CheckpointContext(ctx_cfg("b"))
    load, restore = ctx.load, {}

    def timed_load(state, **kw):
        t0 = time.time()
        got = load(state, **kw)
        sync(torch, device)
        restore["s"] = time.time() - t0
        return got

    ctx.load = timed_load
    out = run_training(model, timed("B restarted"), state0, ctx, loop_b,
                       batch, seq, log=quiet)
    ctx.shutdown()
    launches = ops.launch_counts()
    if not out["restarted"]:
        fail("run B's restart found no checkpoint")
    log(f"[train] restore: {restore['s']:.2f} s (fresh context, FULL of "
        f"{r.bytes_payload} B onto {device})")

    for run, step, sec, n, loss in steps:
        log(f"[train] run {run} step {step}: {sec:.3f} s, "
            f"{batch * seq / sec:.0f} tokens/s, flash launches {n}, "
            f"loss {loss:.6f}")
    want_per_step = 2 * cfg.n_layers          # forward + remat recompute
    if not all(math.isfinite(x[4]) for x in steps):
        fail("a training loss is not finite")
    if [x[:2] for x in steps] != [("A", 1), ("A", 2), ("A", 3), ("B", 1),
                                   ("B", 2), ("B", 3),
                                   ("B restarted", 3)]:
        fail(f"unexpected step sequence {[x[:2] for x in steps]}")
    if on_card and (any(x[3] != want_per_step for x in steps) or
                    launches["flashattn"] != want_per_step * len(steps)):
        fail(f"flash launches {launches['flashattn']} (per step "
             f"{[x[3] for x in steps]}) != {want_per_step} per step")

    bad = []
    for k, v in flatten_named(out["state"]).items():
        got = tensor_to_numpy(v)
        if (v.device != device_a[k] or got.dtype != final_a[k].dtype
                or not np.array_equal(got.reshape(-1).view(np.uint8),
                                      final_a[k].reshape(-1).view(np.uint8))):
            bad.append(k)
    if bad:
        fail(f"resumed TrainState differs from run A: {bad[:5]}")
    if out["loss"] != loss_a:
        fail(f"resumed loss {out['loss']} != run A's {loss_a}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        from repro_torch.data.synthetic import next_batch
        b, _ = next_batch(out["state"].data_state, cfg, batch, seq, device)
        profile_step(torch, lambda: step_fn(out["state"], b))
    log(f"[train] resumed TrainState equals run A's bit for bit "
        f"({len(final_a)} leaves, step {int(out['state'].step)}, loss "
        f"{loss_a:.6f}); kernel launches {launches}; "
        f"max_memory_allocated {peak / 1e9:.2f} GB")
    del out, final_a, state0
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if on_card:
        torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "restore_s": restore["s"],
            "report": r, "peak_bytes": peak}


# --------------------------------------------------------------------------- #

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layers", type=int, default=22,
                    help="decoder layers (the only cut allowed on the card)")
    ap.add_argument("--width-div", type=int, default=1,
                    help="CPU rehearsal only: divide every width by this")
    ap.add_argument("--block-bytes", type=int, default=BLOCK_BYTES,
                    help="CPU rehearsal only: hash block size")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    # the fixed cuBLAS workspace of deterministic mode (phase 5), read when
    # cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from repro_torch.kernels import blockhash as bh
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import diffpack as dp
    from repro_torch.kernels import flashattn as fa

    if args.device == "cpu":
        main_path(torch, args, torch.device("cpu"), ops)
        training_path(torch, args, torch.device("cpu"), ops)
        log("chip_smoke: CPU rehearsal of the main paths passed "
            "(no kernel ran; no result)")
        return
    if args.width_div != 1 or args.block_bytes != BLOCK_BYTES:
        fail("--width-div and --block-bytes are for the CPU rehearsal")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[env] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False

    t = time.time()
    sources = ["blockhash2", "diffpack", "flashattn"]
    logs = build.compile_all(sources)
    log(f"[build] nvcc sm_90a, {len(sources)} sources in parallel: "
        f"{time.time() - t:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    per_word, n_ins, n_words = blockhash_ops_per_word(build)
    log(f"[build] blockhash2 SASS: {n_ins} instructions for {n_words} u32 "
        f"words in the full-block loop; per word: " + ", ".join(
            f"{k} {v:.4f}" for k, v in per_word.items()))

    t = time.time()
    worst = check_kernels(torch, device, ops, ref, bh, dp)
    worst["flashattn"] = check_flash(torch, device, ops, ref, fa)
    log(f"[phase] kernel checks: {time.time() - t:.1f} s")
    t = time.time()
    state, ids2, launches = main_path(torch, args, device, ops)
    log(f"[phase] directive path: {time.time() - t:.1f} s")
    t = time.time()
    times = time_kernels(torch, state, ids2, ops, ref, bh, dp, per_word)
    times["flashattn"] = time_flash(torch, device, ref, fa)
    log(f"[phase] timing: {time.time() - t:.1f} s")
    del state
    t = time.time()
    train = training_path(torch, args, device, ops)
    log(f"[phase] checkpointed training: {time.time() - t:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    # each kernel's launches come from the path that runs it, counted from
    # zero over that path: the directive path (phase 3) for the hash and
    # the pack, the training path (phase 5) for attention
    paths = {"directive": launches, "training": train["launches"]}
    meta = {
        "blockhash2": ("src/repro_torch/kernels/csrc/blockhash2.cu",
                       "src/repro/kernels/blockhash.py:34", "directive"),
        "diffpack": ("src/repro_torch/kernels/csrc/diffpack.cu",
                     "src/repro/kernels/diffpack.py:22", "directive"),
        "flashattn": ("src/repro_torch/kernels/csrc/flashattn.cu",
                      "src/repro/kernels/flashattn.py:35", "training"),
    }
    kernels = []
    for name, (source, replaces, path) in meta.items():
        r = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[path][name],
            "max_abs_err": worst[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "work": r["work"], "path": path,
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "layers": args.layers if path == "directive" else 22})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

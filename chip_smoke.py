#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one H100 and check every kernel.

    python3 chip_smoke.py                 # on a machine with one H100

Phases (every failure exits non-zero; nothing falls back to the CPU):

1. Build: compile the Hopper kernels (``src/repro_torch/kernels/csrc``)
   with ``nvcc`` for sm_90a, one process per source, all at once.
2. Kernel vs plain version on the card, bit-exact: ``blockhash2`` against
   ``blockhash2_ref`` (the main path's leaf shapes, ragged lengths, every
   dtype width, unaligned storage offsets) and ``diffpack`` against
   ``diffpack_ref`` (1, 7 and ~2,000 dirty blocks, ragged last block).
3. Main path at full width: a tinyllama-1.1b-shaped state (arXiv:2401.02385:
   22 layers, d_model 2048, 32 heads / 4 KV heads, d_ff 5632, vocab 32000,
   untied lm_head; 4.40 GB in f32) generated on the card from a seed goes
   through the directives with the FTI backend and a CP-dedicated thread:
   FULL, an in-place sparse update made before the FULL's tail ran, DIFF
   (exact dirty-block count), a dense update (promoted FULL), another
   sparse update and DIFF, shutdown, then a restart into a zeros template
   that must equal the final state bit for bit.  The kernels' launch counts
   are reset just before and read just after, and must match the leaves
   hashed and packed.
4. Timing on the card (CUDA events, median of 20 after warm-up) of each
   kernel, its plain version and, where one exists, a PyTorch call
   computing the same function, beside the bound: the larger of bytes over
   3.35 TB/s and the busiest integer pipe (or the issue rate), counted in
   the SASS of the kernel as built.

The last lines are the card's name and power limit (``nvidia-smi``), one
JSON object with the kernels' numbers, and ``{"ok": true, "device": ...}``.

``--device cpu`` (with ``--width-div``/``--block-bytes`` to shrink it)
rehearses phase 3 on the CPU with the plain versions and prints no result.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"

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
                   "diffpack": 2 * sparse_leaves}
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
    import torch

    from repro_torch.kernels import blockhash as bh
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import diffpack as dp

    if args.device == "cpu":
        main_path(torch, args, torch.device("cpu"), ops)
        log("chip_smoke: CPU rehearsal of the main path passed "
            "(no kernel ran; no result)")
        return
    if args.width_div != 1 or args.block_bytes != BLOCK_BYTES:
        fail("--width-div and --block-bytes are for the CPU rehearsal")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[env] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    t = time.time()
    logs = build.compile_all(["blockhash2", "diffpack"])
    log(f"[build] nvcc sm_90a, 2 sources in parallel: {time.time() - t:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    per_word, n_ins, n_words = blockhash_ops_per_word(build)
    log(f"[build] blockhash2 SASS: {n_ins} instructions for {n_words} u32 "
        f"words in the full-block loop; per word: " + ", ".join(
            f"{k} {v:.4f}" for k, v in per_word.items()))

    worst = check_kernels(torch, device, ops, ref, bh, dp)
    state, ids2, launches = main_path(torch, args, device, ops)
    times = time_kernels(torch, state, ids2, ops, ref, bh, dp, per_word)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    meta = {
        "blockhash2": ("src/repro_torch/kernels/csrc/blockhash2.cu",
                       "src/repro/kernels/blockhash.py:34"),
        "diffpack": ("src/repro_torch/kernels/csrc/diffpack.cu",
                     "src/repro/kernels/diffpack.py:22"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "work": r["work"], "layers": args.layers})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

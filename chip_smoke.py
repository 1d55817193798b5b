#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one H100 and check every kernel.

    python3 chip_smoke.py                 # on a machine with one H100

Phases (every failure exits non-zero; nothing falls back to the CPU):

1. Build: compile the Hopper kernels (``src/repro_torch/kernels/csrc``)
   with ``nvcc`` for sm_90a, one process per source, all at once.
2. Kernel vs plain version on the card: ``blockhash2`` against
   ``blockhash2_ref`` (the main path's leaf shapes, ragged lengths, every
   dtype width, unaligned storage offsets), ``diffpack_many`` against
   ``diffpack_ref`` (1, 7 and ~2,000 dirty blocks, ragged last block; one
   leaf per launch, and every case in one table) and ``diffunpack_many``
   against ``diffunpack_ref`` (the same counts into a zeros and a random
   base, ragged last block, every dtype width, unaligned storage offsets,
   a 0-byte leaf; one leaf per launch, and every case in one table), bit
   for bit, and a round trip from ``ops.pack_dirty_many`` through the host
   to ``ops.unpack_dirty_many``; the serve paths' cache leaves (phase 7's
   (22, 4, 2048, 4, 64) KV leaves, minicpm3-4b's full-depth (62, 4,
   2048, 256) latent and (62, 4, 2048, 32) rotary-key leaves, bf16)
   hashed, and the blocks
   16 decode positions dirty packed and scattered into a cold cache;
   phase 11's recurrent state (the (32, 4, 40, 64, 64) f32 WKV state and
   the (32, 4, 1, 2560) bf16 shift rows) hashed;
   ``flashattn`` against ``flash_attention_ref`` at
   tinyllama's attention shape (B 4, S 2048, 32 heads of 64) causal and
   not, and at S 256, and its grouped entry against
   ``flash_attention_gqa_ref`` at the training shape (32 heads over 4 KV
   heads), at the MoE training shape (B 4, S 2048, 24 heads over 8 KV
   heads: a group of 3), at dh 128, H/KV 1 and 8, Sk ≠ S, at the
   supervised kill workers' shape (B 2, S 32, 32 heads over 4) and at
   the encoder-decoder's (B 16, S 512, 12 heads over 12 of 64): bf16
   within one bf16 ulp of
   the output and two launches bit-equal, f32 within 2e-5, and the
   autograd gradient (kernel forward, plain backward) within 1e-4 of
   autograd through the plain version, in f32.
3. The directive path at full width: a tinyllama-1.1b-shaped state
   (arXiv:2401.02385: 22 layers, d_model 2048, 32 heads / 4 KV heads, d_ff
   5632, vocab 32000, untied lm_head; 4.40 GB in f32) generated on the
   card from a seed goes through the directives with the FTI backend and a
   CP-dedicated thread: FULL, an in-place sparse update made before the
   FULL's tail ran, DIFF (exact dirty-block count), a dense update
   (promoted FULL), another sparse update and DIFF, shutdown, then a
   restart into a zeros template on the card, which replays the last DIFF
   there (one ``diffunpack`` launch for every leaf of the link) and must
   equal the final state bit for bit.  The kernels' launch counts are
   reset just before and read just after, and must match the leaves hashed,
   the DIFF stores packed (one ``diffpack`` launch per store) and the DIFF
   links replayed.
4. Timing on the card (CUDA events, median of 20 after warm-up) of each
   kernel, its plain version and, where one exists, a PyTorch call
   computing the same function, beside the bound: the larger of bytes over
   3.35 TB/s and the operations (the busiest integer pipe or the
   instruction dispatch rate, counted in the SASS of the hash as built;
   the attention's FLOPs over the dense bf16 peak), the attention at the
   training shape, at the MoE training shape and at the encoder-decoder's.
5. Checkpointed training at full width: tinyllama-1.1b's TrainState
   (13.2 GB: params, mu, nu in f32) with ``REPRO_ATTN_IMPL=flash``, batch
   4 × 2048 tokens, remat, FTI level 1 with a CP-dedicated thread, in
   deterministic mode, functional steps.  Run A: 3 steps, no store; each
   leaf's SHA-256.  Run B, from the same seed: a FULL store at step 2 and
   an injected fault at step 3; the faulted state is freed, a fresh
   context restores into a template that holds no device memory and runs
   step 3.  Its leaves' SHA-256 must equal run A's and the loss be
   finite; the kernels' launches (reset before, read after): flash two
   per layer and step, blockhash2 one per card leaf of the FULL, diffpack
   and diffunpack none.
6. The rest of the main path, with the default ``CheckpointConfig``
   (object-store L4 on), the FTI backend and a CP-dedicated thread, on the
   same tinyllama-1.1b-shaped state (depth ``--layers``, at most 4 of 22:
   its FULL L4's single-threaded CDC scan is cut for the time phase 9
   takes): a FULL
   L4 store, a sparse update, a DIFF L4 store (the second store's uploaded
   bytes against the first's); the node-local and global directories
   wiped, a fresh context restores from the object store alone, replaying
   the DIFF on the card, bit-exact.  Then an incremental store in two
   parts, a DIFF with the exact dirty-block count and a bit-exact restore;
   and one SCR FULL store and restart, bit-exact.  The CDC chunker's rate
   on this host is measured on 256 MiB of random bytes.
7. Serving and checkpoint-as-deployment at full width: tinyllama-1.1b
   (22 layers, bf16 compute) serves a batch of 4 seeded prompts of 128
   tokens with a 2048-slot KV cache (184.5 MB), deterministic.  Run A
   prefills and generates 64 tokens.  Run B stores a FULL ``ServeState``
   after prefill (FTI, level 1, CP-dedicated thread), a DIFF every 16
   tokens (each with the dirty-block count the written positions give),
   faults after 48 tokens; a fresh context restores into a cold cache on
   the card (the DIFF chain replayed with ``diffunpack``) and generation
   goes on.  B's tokens and final state must equal A's bit for bit.  Then,
   at ``DEPLOY_LAYERS`` (8) of the 22 layers (the first FULL L4's
   single-threaded CDC scan is cut for the time phase 10 takes), a
   publisher (default ``CheckpointConfig``: object store on) stores the
   params as a FULL at L4, a ``FleetDeployer`` rolls them onto two
   replicas on the card, one per poll; a fine-tune in place (1,024
   tokens' rows of embed and columns of lm_head, every norm) is published
   and rolled the same way.  After each swap the replica's params must be
   ``torch.equal`` to the published tree, the fleet must show at most two
   entries, the second rollout must fetch under 0.30 of the entry's
   bytes, and a swapped replica must generate the tokens of an engine
   built on the published tree.  The kernels' launches over the phase
   must match the leaves hashed, the DIFF stores packed and the links
   replayed.

8. Chaos and elastic restore: the fault-scenario matrix (8 scenarios x 3
   backends, ``repro_torch.chaos.scenarios``) with its payloads on the
   card, 24/24 with no data loss and each cell's recovery path equal to
   the CPU run's; the hash launches over it (reset before, read after)
   must equal the card leaves of the FTI stores it planned.  A seeded
   tinyllama-1.1b parameter state (202 leaves, 4.40 GB) is saved as 4
   axis-0 rank files of a committed checkpoint and ``rescale_restore``
   puts each rank's rows of new worlds 2 and 3 on the card, equal to the
   source's; the same state is stored as a shard-local FULL (4 host
   chunks per 2-D leaf, 4 shard files, FTI level 1) and a fresh context
   restores it into zeros on the card, bit-exact; a newer sharded id that
   lost a shard file makes the walk fall back to it and say so.  Last,
   the supervised kill: ``launch.train --supervise`` workers train
   tinyllama-1.1b at full width (22 layers, flash attention, each FULL
   kept until the next commits) and are killed at step 8; the restart
   resumes from step 6, once, and ends at step 12, and its flash launches
   (written by the worker) must be two per layer and step it trained.

9. Checkpointed MoE training at full width: granite-moe-3b-a800m
   (hf:ibm-granite/granite-3.0-1b-a400m-base: d_model 1536, 24 heads / 8
   KV heads of 64, 40 experts of d_ff 512, top-8, capacity factor 1.5,
   groups of 256, einsum dispatch, tied embed, vocab 49155; its depth cut
   from 32 to ``MOE_LAYERS`` (16) for the time phase 10 takes), its
   TrainState of 20.2 GB (params, mu, nu in f32; 36 leaves on the card),
   bf16 compute, run as phase 5 with donated steps (the
   parameters and moments updated in place, as the launcher does), with
   the same checks; the profiled step also reports the MoE dispatch and
   combine einsums' device time.

10. MLA served at full width: minicpm3-4b (hf:openbmb/MiniCPM3-4B: 62
   layers, d_model 2560, 40 heads; q_lora 768, kv_lora 256, qk nope/rope
   64/32, v_head 64; d_ff 6400, vocab 73448, untied lm_head; its depth
   cut to ``MLA_LAYERS`` (16) for the time phase 12 takes), f32
   parameters, bf16 compute, deterministic, decoding in the absorbed form
   over its latent cache (c_kv (16, 4, 2048, 256) and k_rope (16, 4,
   2048, 32), 75.5 MB), with phase 7's batch, prompts, cache length,
   DIFF cadence and fault: run A uninterrupted, run B with a FULL
   ServeState after prefill, a DIFF every 16 tokens (each with the
   dirty-block count the written positions give), the fault after 48, a
   restore into a cold cache on the card and generation on; B's tokens
   and final state must equal A's bit for bit, and the launches over the
   phase must match the leaves hashed, the DIFF stores packed and the
   links replayed (``flashattn`` none).  No deploy runs here.

11. RWKV6 served at full width: rwkv6-3b (arXiv:2404.05892: 32 layers,
   d_model 2560, 40 WKV heads of 64, d_ff 8960, vocab 65536, untied; no
   cut), f32 parameters made on the card, bf16 compute, deterministic,
   as phase 10 with phase 7's batch, prompts, tokens, store cadence and
   fault.  Its state is recurrent (``wkv`` (32, 4, 40, 64, 64) f32,
   ``tm_shift`` and ``cm_shift`` (32, 4, 1, 2560) bf16: 85.2 MB, whatever
   the cache length), and every decode step rewrites all of it: each
   cadence store must find every block dirty and be promoted to a FULL,
   the restore must read the newest FULL and replay no link, B's tokens
   and final state must equal A's bit for bit, and the launches over the
   phase must be ``blockhash2`` once per store and card leaf and no
   ``diffpack``, ``diffunpack`` or ``flashattn``.

12. The encoder-decoder trained at full width: whisper-small
   (arXiv:2212.04356: 12 encoder + 12 decoder layers, d_model 768, 12
   heads of 64, d_ff 3072, vocab 51865, tied, gelu, no rope; the audio
   frontend a stub that takes frame embeddings; no cut), its TrainState
   of 3.54 GB (294,683,904 parameters and both moments in f32; 78 leaves
   on the card), bf16 compute, batch 16 × 512 tokens and 512 frames
   (whisper's text context of 448 rounded up to the flash tile of 128),
   run as phase 5 with the same checks; flash runs 36 times per step and
   pass (12 encoder self, 12 decoder self causal, 12 cross).

The last lines are the card's name and power limit (``nvidia-smi``), one
JSON object with the kernels' numbers, and ``{"ok": true, "device": ...}``.

``--device cpu`` (with ``--width-div``/``--block-bytes`` to shrink it)
rehearses phases 3, 5, 6, 7, 8, 9, 10, 11 and 12 on the CPU with the
plain versions (phases 5, 7, 9, 10, 11, 12 and 8's supervised kill on a
reduced config) and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
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
OBJ_DIR = ROOT / "build" / "chip_smoke_objstore"
SERVE_DIR = ROOT / "build" / "chip_smoke_serve"

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
#: phase 6's depth: its FULL L4's CDC scan is single-threaded numpy
#: (~155 s at 22 layers on an H100 host), cut for the time phase 9 takes
OBJSTORE_LAYERS = 4
#: the depth of phase 7's deploy half, cut from 22 for the same scan (its
#: first publish took 153–205 s) and the time phase 10 takes.  At 4 layers
#: the fine-tune's embed and lm_head rows are 0.42 of the entry, over the
#: fetch gate of 0.30; at 8 they are 0.27.
DEPLOY_LAYERS = 8
#: phase 9's depth, cut from granite's 32 for the time phase 10 takes (its
#: 39.6 GB FULL restored in 108–176 s)
MOE_LAYERS = 16
#: phase 10's depth, cut from minicpm3-4b's 62 for the time phase 12 takes:
#: with all 62 the script took 985.1 s of its 1,200 on an H100 host, and
#: host-bound phases run up to 1.25x slower on some hosts
MLA_LAYERS = 16


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
    store_launches = ops.launch_counts()
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

    # restart: a fresh context restores into a zeros template on the device;
    # the FULL (store 3) is decoded on the host and placed once, store 4's
    # delta is scattered into it on the device
    t = time.time()
    ctx2 = CheckpointContext(cfg)
    template = {k: torch.zeros_like(v) for k, v in named.items()}
    restored = ctx2.load(unflatten_named(template, state))
    ctx2.shutdown()
    if device.type == "cuda":
        torch.cuda.synchronize()
    restore_s = time.time() - t
    launches = ops.launch_counts()
    if not ctx2.restarted:
        fail("restart found no checkpoint")
    bad = [k for k, v in flatten_named(restored).items()
           if v.device != named[k].device or not torch.equal(v, named[k])]
    if bad:
        fail(f"restored leaves differ from the final state: {bad[:5]}")
    log(f"[main] restore: {len(named)} leaves bit-exact on {device} "
        f"in {restore_s:.2f} s (FULL 3 + DIFF 4, the DIFF replayed on "
        f"{device}) (restarted={ctx2.restarted})")

    # one pack launch per DIFF store (stores 2 and 4), one unpack launch
    # for the DIFF link the restore replays (store 4)
    want_launch = {"blockhash2": 4 * len(named), "diffpack": 2,
                   "diffunpack": 1, "flashattn": 0}
    log(f"[main] kernel launches: stores {store_launches}, stores and "
        f"restore {launches} (expected on the card: {want_launch})")
    if device.type == "cuda" and launches != want_launch:
        fail("launch counts do not match the leaves hashed and unpacked "
             "and the DIFF stores packed")
    compare_replay(torch, cfg, named, device)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return state, ids2, ids4, launches, restore_s


def compare_replay(torch, cfg, named, device) -> None:
    """The same restore (FULL 3 + DIFF 4) two ways, in turns host, device,
    device, host: the numpy replay on the host, every leaf then copied to
    the device (the JAX package's restore, and this port's before it
    replayed on the device), against the replay on the device.  Both must
    give the final state's bytes.  Prints the seconds of each."""
    from repro_torch.core.context import CheckpointContext
    from repro_torch.core.formats import numpy_to_tensor

    def restore(on_device: bool) -> float:
        sync(torch, device)
        t = time.time()
        ctx = CheckpointContext(cfg)
        got, _ = ctx.tcl.backend.engine.load_latest(
            devices={k: device for k in named} if on_device else None)
        got = {k: v if isinstance(v, torch.Tensor)
               else numpy_to_tensor(v, device) for k, v in got.items()}
        ctx.shutdown()
        sync(torch, device)
        seconds = time.time() - t
        bad = [k for k, v in named.items() if not torch.equal(got[k], v)]
        if bad:
            fail(f"{'device' if on_device else 'host'} replay differs from "
                 f"the final state: {bad[:5]}")
        return seconds

    secs = {True: [], False: []}
    for on_device in (False, True, True, False):
        secs[on_device].append(restore(on_device))
    log(f"[main] restore of FULL 3 + DIFF 4 in turns (s): host replay "
        f"{secs[False][0]:.2f}, {secs[False][1]:.2f}; device replay "
        f"{secs[True][0]:.2f}, {secs[True][1]:.2f} (same bytes)")


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
    worst = {"blockhash2": 0, "diffpack": 0, "diffunpack": 0}

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
        got = dp.diffpack_many([x], [idx], bb)
        want = ref.diffpack_ref(ops.as_u32_blocks(x, bb)[0],
                                torch.from_numpy(idx).to(device))
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

    def pack_many_case(name, cases, bb=BLOCK_BYTES):
        """diffpack_many over every (leaf, indices) of ``cases`` in one
        launch, against one launch per leaf and diffpack_ref."""
        n0 = dp.LAUNCHES.n
        got = dp.diffpack_many([x for x, _ in cases], [i for _, i in cases],
                               bb)
        if dp.LAUNCHES.n != n0 + 1:
            fail(f"diffpack_many {name}: not one launch")
        per_leaf = torch.cat([dp.diffpack_many([x], [i], bb)
                              for x, i in cases])
        plain = torch.cat([ref.diffpack_ref(ops.as_u32_blocks(x, bb)[0],
                                            torch.from_numpy(i).to(device))
                           for x, i in cases])
        torch.cuda.synchronize()
        err = max(u32_max_abs_diff(torch, got, per_leaf),
                  u32_max_abs_diff(torch, got, plain))
        worst["diffpack"] = max(worst["diffpack"], err)
        if err:
            fail(f"diffpack_many {name}: differs from one launch per leaf "
                 f"or diffpack_ref")

    many = []
    for k in (1, 7, 2000):
        idx = np.sort(rng.choice(nb, size=k, replace=False)).astype(np.int32)
        idx[-1] = nb - 1
        many.append((emb, idx))
    many += [(rag, np.array([6, 0, 3], np.int32)),           # ragged block
             (raw[3:3 + BLOCK_BYTES + 17], np.array([1, 0], np.int32)),
             (torch.zeros(0, device=device), np.array([0], np.int32)),
             (f[:7].to(torch.bfloat16), np.zeros(0, np.int32))]
    pack_many_case("the pack cases in one table (unaligned view, 0-byte "
                   "leaf, ragged last block, a leaf with no dirty block)",
                   many)
    pack_many_case("block_bytes 256", [
        (f[:10_001], np.arange(0, 157, 3, dtype=np.int32)),
        (raw[3:1003], np.array([3, 0], np.int32))], 256)

    def unpack_check(name, cases, bb=BLOCK_BYTES):
        """Scatter the rows of every case (leaf, indices, rows) into its
        leaf, in place, with one launch; the plain version scatters into
        the padded block copy of the same base; each leaf's bytes must be
        the first bytes of that result."""
        wants = []
        for x, idx, rows in cases:
            nbytes = x.numel() * x.element_size()
            want = ref.diffunpack_ref(ops.as_u32_blocks(x, bb)[0], rows,
                                      torch.from_numpy(idx).to(device))
            wants.append(want.reshape(-1).view(torch.uint8)[:nbytes])
        n0 = dp.UNPACK_LAUNCHES.n
        dp.diffunpack_many([x for x, _, _ in cases], [i for _, i, _ in cases],
                           torch.cat([r for _, _, r in cases]), bb)
        if dp.UNPACK_LAUNCHES.n != n0 + 1:
            fail(f"diffunpack_many {name}: not one launch")
        torch.cuda.synchronize()
        for (x, _, _), want_leaf in zip(cases, wants):
            nbytes = x.numel() * x.element_size()
            got_u32 = ops.as_u32_blocks(x, bb)[0]
            want_u32 = torch.zeros_like(got_u32).reshape(-1).view(torch.uint8)
            want_u32[:nbytes] = want_leaf
            err = u32_max_abs_diff(torch, got_u32,
                                   want_u32.view(torch.int32).reshape(
                                       got_u32.shape))
            worst["diffunpack"] = max(worst["diffunpack"], err)
            if err:
                fail(f"diffunpack_many {name}: differs from diffunpack_ref")

    # every unpack case: (name, a function making its leaf afresh, indices,
    # rows); the leaves of the views keep their storage offsets
    emb_words = rand_u32(32_000, 2048)
    ucases = []
    for k in (1, 7, 2000):
        idx = np.sort(rng.choice(nb, size=k, replace=False)).astype(np.int32)
        idx[-1] = nb - 1
        ucases.append((f"{k} dirty of {nb} into zeros",
                       lambda: torch.zeros(32_000, 2048, device=device), idx))
        ucases.append((f"{k} dirty of {nb} into random words",
                       emb_words.clone, idx))
    ucases.append(("ragged last block", f[:100_003].clone,
                   np.array([0, 3, 6], np.int32)))
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
               torch.float64, torch.uint8, torch.int8):
        def make(dt=dt):
            return (f * 100).to(dt) if dt.is_floating_point else \
                (f * 1000).to(torch.int64).to(dt)
        nbl = n_blocks(make(), BLOCK_BYTES)
        ucases.append((f"{dt}", make, np.arange(0, nbl, 2, dtype=np.int32)))
        ucases.append((f"{dt}, last block", make,
                       np.array([nbl - 1], np.int32)))
    ucases += [
        ("offset 3 bytes", lambda: raw.clone()[3:3 + BLOCK_BYTES + 17],
         np.array([0, 1], np.int32)),
        ("offset 4 bytes (f32, +1 element)", lambda: f.clone()[1:],
         np.array([0, 1, 6], np.int32)),
        ("0-byte leaf", lambda: torch.zeros(0, device=device),
         np.array([0], np.int32))]
    ucases = [(name, make, idx, rand_u32(len(idx), BLOCK_BYTES // 4))
              for name, make, idx in ucases]
    for name, make, idx, rows in ucases:
        unpack_check(name, [(make(), idx, rows)])
    unpack_check("every case above in one table",
                 [(make(), idx, rows) for _, make, idx, rows in ucases])
    small = [(f[:10_001].clone(), np.arange(0, 157, 3, dtype=np.int32)),
             (raw.clone()[3:1003], np.array([0, 3], np.int32))]
    unpack_check("block_bytes 256, an unaligned view beside an aligned "
                 "leaf", [(x, i, rand_u32(len(i), 64)) for x, i in small],
                 bb=256)
    # a round trip through the two batched entries: the rows
    # pack_dirty_many gathers from several leaves, shipped to the host as a
    # DIFF store ships them, then scattered by unpack_dirty_many into zeros
    # leaves of the same shapes, rebuild those blocks and nothing else
    srcs = [rand_u32(32_000, 2048), f[:100_003], raw[3:3 + BLOCK_BYTES + 17],
            (f * 100).to(torch.bfloat16)]
    idxs = [np.arange(0, nb, 5, dtype=np.int32), np.array([0, 3, 6]),
            np.array([1]), np.arange(n_blocks(srcs[3], BLOCK_BYTES))]
    host = ops.u32_numpy(ops.pack_dirty_many(srcs, idxs, BLOCK_BYTES))
    cut = np.cumsum([0] + [len(i) for i in idxs])
    dsts = [torch.zeros_like(srcs[0]), torch.zeros_like(srcs[1]),
            torch.zeros_like(raw)[3:3 + BLOCK_BYTES + 17],
            torch.zeros_like(srcs[3])]
    ops.unpack_dirty_many(dsts, idxs, [host[a:b] for a, b in
                                       zip(cut[:-1], cut[1:])], BLOCK_BYTES)
    torch.cuda.synchronize()
    for src, dst, idx in zip(srcs, dsts, idxs):
        want = torch.zeros_like(ops.as_u32_blocks(src, BLOCK_BYTES)[0])
        sel = torch.from_numpy(np.asarray(idx, np.int64)).to(device)
        want[sel] = ops.as_u32_blocks(src, BLOCK_BYTES)[0][sel]
        if not torch.equal(ops.as_u32_blocks(dst, BLOCK_BYTES)[0], want):
            fail("unpack_dirty_many of pack_dirty_many's rows does not "
                 "rebuild the blocks")
    # the serve paths' leaves (phase 7's GQA KV cache, phase 10's MLA
    # latent cache: c_kv with 512-byte rows, k_rope with 64-byte rows):
    # each stacked bf16 cache leaf and last_token hashed; the rows that one
    # DIFF store makes dirty (the positions of SERVE_EVERY decode steps in
    # each cache leaf, and last_token) packed in one launch, then scattered
    # into a cold cache
    from repro_torch.configs import get_arch
    from repro_torch.core.protect import flatten_named
    from repro_torch.models.zoo import build_model
    last = torch.randint(0, 32_000, (SERVE_BATCH, 1), generator=gen,
                         device=device, dtype=torch.int32)
    hash_case(f"serve last_token {tuple(last.shape)}", last)
    steps = range(SERVE_PROMPT, SERVE_PROMPT + SERVE_EVERY)
    for arch in ("tinyllama-1.1b", MLA_ARCH):
        meta = flatten_named(build_model(get_arch(arch)).cache_struct(
            SERVE_BATCH, SERVE_MAX_LEN))
        serve = []
        for name, m in meta.items():
            x = torch.randn(m.shape, generator=gen, device=device).to(m.dtype)
            hash_case(f"{arch} cache leaf {name} {tuple(x.shape)} {x.dtype}",
                      x)
            serve.append((x, np.asarray(
                cache_dirty_blocks(x, steps, BLOCK_BYTES), np.int32)))
        serve.append((last, np.array([0], np.int32)))
        pack_many_case(f"{arch} serve DIFF ({sum(len(i) for _, i in serve)} "
                       f"rows over its cache leaves and last_token)", serve)
        rows = dp.diffpack_many([x for x, _ in serve], [i for _, i in serve],
                                BLOCK_BYTES)
        cut = np.cumsum([0] + [len(i) for _, i in serve])
        unpack_check(f"{arch} serve DIFF into a cold cache",
                     [(torch.zeros_like(x), i, rows[a:b])
                      for (x, i), a, b in zip(serve, cut[:-1], cut[1:])])
        del serve, rows
    # phase 11's recurrent state (rwkv6-3b): the f32 WKV state and both
    # bf16 token-shift rows, hashed; every step rewrites every block, so
    # its stores are promoted to FULL and pack nothing
    for name, m in flatten_named(build_model(get_arch(SSM_ARCH)).cache_struct(
            SERVE_BATCH, SERVE_MAX_LEN)).items():
        x = torch.randn(m.shape, generator=gen, device=device).to(m.dtype)
        hash_case(f"{SSM_ARCH} state leaf {name} {tuple(x.shape)} {x.dtype}",
                  x)
        del x
    try:
        dp.diffunpack_many([torch.zeros(64, 64, device=device).t()],
                           [np.zeros(1, np.int32)],
                           rand_u32(1, BLOCK_BYTES // 4), BLOCK_BYTES)
        fail("diffunpack_many wrote into a non-contiguous tensor")
    except ValueError:
        pass
    log(f"[check] blockhash2, diffpack_many and diffunpack_many (one leaf "
        f"and many per launch) equal their plain versions bit for bit "
        f"(tolerance 0): "
        f"max_abs_err {worst}")
    return worst


def bf16_tolerance(torch, x):
    """One bf16 ulp at each element's magnitude (8 significant bits),
    floored at the f32 tolerance 2e-5: near zero, where the softmax
    average cancels, the f32 rounding of the terms outweighs a bf16 ulp."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7).clamp(min=2e-5)


#: (B, S, H, dh) of the training path's attention, and a short sequence
FLASH_SHAPES = ((4, 2048, 32, 64), (4, 256, 32, 64))
#: (B, S, Sk, H, KV, dh) of the grouped entry: the training path's shape,
#: the MoE training path's (phase 9: 24 heads over 8, a group of 3, the
#: first that is not a power of two), dh 128 with H/KV 8 and 1, Sk != S,
#: the supervised kill's workers' shape (phase 8 (d)), whose 32 rows are
#: under one 128-row tile, and the encoder-decoder's (phase 12: encoder
#: self, decoder self and cross attention all take it)
GQA_SHAPES = ((4, 2048, 2048, 32, 4, 64), (4, 2048, 2048, 24, 8, 64),
              (2, 1024, 1024, 16, 2, 128), (2, 512, 512, 8, 8, 128),
              (2, 512, 1536, 8, 1, 64), (2, 1024, 256, 8, 8, 32),
              (2, 32, 32, 32, 4, 64), (16, 512, 512, 12, 12, 64))
MOE_GQA_SHAPE = GQA_SHAPES[1]
ENCDEC_GQA_SHAPE = GQA_SHAPES[-1]


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
    # the grouped entry (the training path's): KV heads read in place
    for b, s, sk, h, kv, dh in GQA_SHAPES:
        for causal in (True, False):
            q = torch.randn(b, s, h, dh, generator=gen,
                            device=device).bfloat16()
            k, v = (torch.randn(b, sk, kv, dh, generator=gen, device=device)
                    .bfloat16() for _ in range(2))
            got = fa.flash_attention_gqa(q, k, v, causal=causal)
            want = ref.flash_attention_gqa_ref(q, k, v, causal=causal)
            again = fa.flash_attention_gqa(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            case = (f"grouped B{b} S{s} Sk{sk} H{h}/KV{kv} dh{dh} "
                    f"causal={causal} bf16")
            worst_bf16 = max(worst_bf16, float(err.max()))
            if not bool((err <= bf16_tolerance(torch, want)).all()):
                fail(f"flashattn {case}: beyond one bf16 ulp")
            if not torch.equal(got, again):
                fail(f"flashattn {case}: two launches differ")
            log(f"[check] flashattn {case}: max_abs_err "
                f"{float(err.max()):.3g}, two launches bit-equal")
            del q, k, v, got, want, again, err
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
        f"{worst_bf16:.3g}), two launches bit-equal, f32 within 2e-5; "
        f"gradient (f32, B{b} S{s}) "
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


def leaf_bytes_in(t, idx, block_bytes: int) -> int:
    """The bytes of leaf ``t`` that lie in its blocks ``idx`` (numpy)."""
    nbytes = t.numel() * t.element_size()
    return sum(min(block_bytes, nbytes - int(i) * block_bytes) for i in idx)


def pack_bytes(t, idx, block_bytes: int) -> int:
    """Bytes diffpack must move for dirty blocks ``idx`` of leaf ``t``: the
    leaf's own bytes in each block read once, each full row of the output
    written once, and the indices read once."""
    return leaf_bytes_in(t, idx, block_bytes) + len(idx) * (block_bytes + 4)


def unpack_bytes(t, idx, block_bytes: int) -> int:
    """Bytes diffunpack must move for dirty blocks ``idx`` of leaf ``t``:
    of each packed row only the part below the leaf's end is read, the
    leaf's own bytes in each block are written once, and each row's
    24-byte table entry is read once."""
    return 2 * leaf_bytes_in(t, idx, block_bytes) + 24 * len(idx)



def dirty_jobs(torch, state, ids, block_bytes: int):
    """(leaf, dirty block indices) of every leaf a sparse update with
    token ids ``ids`` touched: rows of embed and lm_head, every norm
    vector, the step counter."""
    import numpy as np
    p = state["params"]
    row_bytes = p["embed"].shape[1] * p["embed"].element_size()
    rows = np.asarray(touched_blocks(ids, row_bytes, block_bytes), np.int32)
    jobs = [(p["embed"], rows), (p["lm_head"], rows)]
    jobs += [(n, np.arange(n_blocks(n, block_bytes), dtype=np.int32))
             for n in norms_of(state)]
    jobs.append((state["step"], np.zeros(1, np.int32)))
    return jobs


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


def time_kernels(torch, state, ids2, ids4, ops, ref, bh, dp, per_word):
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
    jobs = dirty_jobs(torch, state, ids2, bb)
    n_dirty = sum(len(i) for _, i in jobs)
    moved = sum(pack_bytes(t, i, bb) for t, i in jobs)
    # as a DIFF store packs them: one launch over all the leaves (the time
    # includes building the table on the host and its copy to the card)
    ms = device_ms(torch, lambda: dp.diffpack_many(
        [t for t, _ in jobs], [i for _, i in jobs], bb))
    per_leaf = device_ms(torch, lambda: [dp.diffpack_many([t], [i], bb)
                                         for t, i in jobs])
    jobs_b = [(ops.as_u32_blocks(t, bb)[0], torch.from_numpy(i).cuda())
              for t, i in jobs]
    plain = device_ms(torch, lambda: [ref.diffpack_ref(b, i)
                                      for b, i in jobs_b])
    lib = device_ms(torch, lambda: [torch.index_select(b, 0, i)
                                    for b, i in jobs_b])
    b_ms, b_by = bound(moved)
    out["diffpack"] = dict(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        work=f"{len(jobs)} leaves in one launch, {n_dirty} dirty blocks, "
        f"{moved} B")
    log(f"[time] diffpack of the same {n_dirty} blocks one launch per leaf "
        f"({len(jobs)} launches): {per_leaf:.4f} ms")

    # diffunpack: store 4's delta as the restart replays it, every leaf in
    # one launch (the time includes building the table on the host and its
    # copy to the card) — the rows diffpack_many gathers from the leaves,
    # scattered back into them (the same bytes, so the state stays as it
    # is), on the card as after the link's one H2D
    ujobs = dirty_jobs(torch, state, ids4, bb)
    uleaves, uidx = [t for t, _ in ujobs], [i for _, i in ujobs]
    u_dirty = sum(len(i) for i in uidx)
    u_moved = sum(unpack_bytes(t, i, bb) for t, i in ujobs)
    urows = dp.diffpack_many(uleaves, uidx, bb)
    cut = np.cumsum([0] + [len(i) for i in uidx])
    rows_of = [urows[a:b] for a, b in zip(cut[:-1], cut[1:])]
    ms = device_ms(torch, lambda: dp.diffunpack_many(uleaves, uidx, urows,
                                                     bb))
    per_leaf = device_ms(torch, lambda: [
        dp.diffunpack_many([t], [i], r, bb)
        for t, i, r in zip(uleaves, uidx, rows_of)])
    ujobs_b = [(ops.as_u32_blocks(t, bb)[0], torch.from_numpy(i).cuda(), r)
               for t, i, r in zip(uleaves, uidx, rows_of)]
    ujobs_b = [(b, i, r, i.to(torch.int64)) for b, i, r in ujobs_b]
    plain = device_ms(torch, lambda: [ref.diffunpack_ref(b, r, i)
                                      for b, i, r, _ in ujobs_b])
    lib = device_ms(torch, lambda: [b.index_copy_(0, i64, r)
                                    for b, _, r, i64 in ujobs_b])
    b_ms, b_by = bound(u_moved)
    out["diffunpack"] = dict(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        work=f"{len(uleaves)} leaves in one launch, {u_dirty} dirty blocks, "
        f"{u_moved} B")
    log(f"[time] diffunpack of the same {u_dirty} blocks one launch per leaf "
        f"({len(uleaves)} launches of the same entry): {per_leaf:.4f} ms")
    t, i, r = uleaves[0], uidx[0], rows_of[0]
    b, _, _, i64 = ujobs_b[0]
    u = device_ms(torch, lambda: dp.diffunpack_many([t], [i], r, bb))
    u_plain = device_ms(torch, lambda: ref.diffunpack_ref(b, r, i64))
    u_lib = device_ms(torch, lambda: b.index_copy_(0, i64, r))
    u_b, _ = bound(unpack_bytes(t, i, bb))
    log(f"[time] params/embed alone: diffunpack of {len(i)} dirty blocks "
        f"{u:.4f} ms (bound {u_b:.3g} ms by bytes; plain {u_plain:.4f} ms; "
        f"index_copy_ {u_lib:.4f} ms)")
    del ujobs, ujobs_b, urows, rows_of

    # where the time goes: one leaf alone, one launch each, against the
    # whole state's 202 (hash) and 48 (pack) launches above — the largest
    # leaf, and a norm vector (8 KiB: one partial block)
    for name, (t, idx_np), (b, idx) in (
            ("params/embed", jobs[0], jobs_b[0]),
            ("a norm vector", jobs[2], jobs_b[2])):
        nbl = n_blocks(t, bb)
        h = device_ms(torch, lambda: bh.blockhash2(t, bb))
        h_plain = device_ms(torch, lambda: ref.blockhash2_ref(b))
        h_b, h_by = hash_bound([t])
        pk = device_ms(torch, lambda: dp.diffpack_many([t], [idx_np], bb))
        pk_plain = device_ms(torch, lambda: ref.diffpack_ref(b, idx))
        pk_lib = device_ms(torch, lambda: torch.index_select(b, 0, idx))
        pk_b, _ = bound(pack_bytes(t, idx_np, bb))
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


def time_flash(torch, device, ref, fa, shape) -> dict:
    """flashattn's grouped entry at a training path's ``shape`` (bf16,
    causal and not) beside its bound, its plain version and
    scaled_dot_product_attention on the same grouped inputs
    (``enable_gqa=True``, or KV repeated to H heads where this torch lacks
    the argument).  → the causal numbers."""
    import torch.nn.functional as F

    b, s, sk, h, kv, dh = shape
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    q = torch.randn(b, s, h, dh, generator=gen, device=device).bfloat16()
    k, v = (torch.randn(b, sk, kv, dh, generator=gen, device=device)
            .bfloat16() for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))    # (B, heads, S, dh)
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
        grouped = True
    except TypeError:                      # a torch without the argument
        grouped = False
        kt, vt = (x.repeat_interleave(h // kv, dim=1) for x in (kt, vt))
    sdpa_kw = {"enable_gqa": True} if grouped else {}
    out = {}
    for causal in (True, False):
        ms = device_ms(torch, lambda: fa.flash_attention_gqa(
            q, k, v, causal=causal))
        plain = device_ms(torch, lambda: ref.flash_attention_gqa_ref(
            q, k, v, causal=causal))
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, **sdpa_kw))
        # the (query, key) pairs this input needs: the lower triangle with
        # its diagonal when causal; two products of dh MACs each per pair
        pairs = b * h * (s * (s + 1) // 2 if causal else s * sk)
        flops = 4 * dh * pairs
        moved = 2 * q.numel() * q.element_size() + \
            2 * k.numel() * k.element_size()         # q, k, v read; o written
        times = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
                 "operations": flops / BF16_FLOPS_PER_S * 1e3}
        by = max(times, key=times.get)
        out[causal] = dict(
            ms=ms, plain_ms=plain, bound_ms=times[by], bound_by=by,
            library_ms=lib, work=f"B{b} S{s} H{h}/KV{kv} dh{dh} bf16 "
            f"causal={causal}: {flops:.4g} FLOPs, {moved} B; library: "
            f"scaled_dot_product_attention with "
            f"{'enable_gqa=True' if grouped else 'KV repeated to H heads'}")
        log(f"[time] flashattn grouped B{b} S{s} H{h}/KV{kv} dh{dh} "
            f"causal={causal}: {ms:.4f} ms (bound "
            f"{times[by]:.4f} ms by {by}: {flops:.4g} FLOPs at 989 TFLOP/s "
            f"{times['operations']:.4f} ms, {moved} B at 3.35 TB/s "
            f"{times['bytes']:.4f} ms; plain {plain:.4f} ms; "
            f"scaled_dot_product_attention "
            f"({'enable_gqa=True' if grouped else 'KV repeated'}) "
            f"{lib:.4f} ms)")
    del q, k, v, qt, kt, vt
    return out[True]


# --------------------------------------------------------------------------- #
# phases 5 and 9: checkpointed training at full width
# --------------------------------------------------------------------------- #

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 3
#: phase 12: whisper-small trained at full width, B 16 × S 512 tokens and
#: as many frames (the reference's batch ties the frame count to the
#: sequence).  whisper's text context of 448 is rounded up to the flash
#: tile of 128 (S and Sk must each divide by it or be at most 128): 8,192
#: decoder tokens a step, as phase 5's 4 × 2048
ENCDEC_ARCH = "whisper-small"
ENCDEC_DIR = ROOT / "build" / "chip_smoke_encdec"
ENCDEC_BATCH, ENCDEC_SEQ = 16, 512
MOE_ARCH = "granite-moe-3b-a800m"
MOE_DIR = ROOT / "build" / "chip_smoke_moe"
#: record_function ranges of models/moe.py whose device time phase 9's
#: profile reports
MOE_RANGES = ("moe.dispatch_einsum", "moe.combine_einsum")


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


#: device-time groups of a training step, by kernel name (first match)
_KERNEL_GROUPS = (
    ("flash attention kernel", ("flash_fwd_kernel", "flash_tc_kernel")),
    ("matrix products", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reductions", ("reduce_kernel",)),
    ("embedding / gather", ("embedding", "gather", "index", "scatter")),
    ("copies and casts", ("copy", "cat", "memcpy", "memset", "unrolled")),
    ("elementwise", ("elementwise", "foreach")),
)


def profile_step(torch, step, ranges=()) -> None:
    """One more step (of training, or of decode) under ``torch.profiler``:
    device time by kernel group and the device's idle share of the step.
    Prints that no device time was recorded if the profiler sees none.
    ``ranges``: ``record_function`` names whose device time (the kernels
    launched inside them, which their groups also count) is printed too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        wall = time.time() - t0
    groups, top, ranged = {}, [], {}
    for ev in prof.events():             # each range: its kernels' time
        if ev.name in ranges and str(ev.device_type).endswith("CPU"):
            ranged[ev.name] = ranged.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
    for ev in prof.key_averages():
        if ev.key in ranges:             # the range's span on the card
            continue
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
        f"wall, {busy:.1f} ms of device time in {sum(x[1] for x in top)} "
        f"kernels, idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"[profile]   {g}: {ms:.1f} ms ({ms / busy:.1%})")
    for name in ranges:
        ms = ranged.get(name, 0.0)
        log(f"[profile]   range {name} (forward and remat recompute; its "
            f"backward is in the groups above): "
            + (f"{ms:.1f} ms ({ms / busy:.1%})" if ms else "not measured"))
    for ms, n, key in sorted(top, reverse=True)[:10]:
        log(f"[profile]   kernel {ms:.1f} ms x{n}: {key}")


def state_digests(torch, state) -> dict:
    """{leaf path: (dtype, shape, device, SHA-256 of its bytes)}.  A card
    leaf is copied into one pinned host buffer, one leaf at a time; its
    bytes are hashed in 64 MiB pieces on 8 threads, and the leaf's digest
    is the SHA-256 of the pieces' digests.  No kernel of the port runs."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.protect import flatten_named

    named = flatten_named(state)
    on_card = [v for v in named.values() if v.is_cuda]
    staging = torch.empty(max(v.numel() * v.element_size() for v in on_card),
                          dtype=torch.uint8, pin_memory=True) \
        if on_card else None
    piece = 64 << 20
    out = {}
    with ThreadPoolExecutor(8) as pool:
        for k, v in named.items():
            n = v.numel() * v.element_size()
            flat = v.detach().reshape(-1).view(torch.uint8)
            if v.is_cuda:
                staging[:n].copy_(flat)
                host = memoryview(staging[:n].numpy())
            else:
                host = memoryview(flat.contiguous().numpy())
            parts = pool.map(lambda a: hashlib.sha256(host[a:a + piece])
                             .digest(), range(0, n, piece))
            out[k] = (str(v.dtype), tuple(v.shape), str(v.device),
                      hashlib.sha256(b"".join(parts)).hexdigest())
    del staging
    return out


def host_mem_total() -> int:
    """The host's MemTotal in bytes (``/proc/meminfo``)."""
    with open("/proc/meminfo", encoding="ascii") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    return 0


def training_path(torch, args, device, ops, arch: str, tag: str, root: Path,
                  donate: bool = False, ranges=(), layers=None,
                  batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """Phases 5, 9 and 12.  Run A: TRAIN_STEPS steps, no store; each leaf's
    SHA-256.  Run B, from the same seed: a FULL store at step 2, an
    injected fault at step 3; the faulted state is freed, and a fresh
    context restores into a template that holds no device memory and runs
    step 3.  Its leaves' SHA-256 must equal run A's.  ``donate``: the
    steps update the state in place (the launcher's step); ``ranges``:
    ``record_function`` ranges the profiled step reports; ``layers``: a
    cut of the config's depth on the card; ``batch`` × ``seq``: the
    tokens of a step on the card (an encoder-decoder's frames as many)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.data.synthetic import init_data_state, next_batch
    from repro_torch.ft.failures import FaultInjector, SimulatedFault
    from repro_torch.kernels import flashattn as fa
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import LevelSchedule, LoopConfig, run_training
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.state import init_train_state, prng_key
    from repro_torch.train.step import (make_train_step,
                                        use_deterministic_algorithms)

    on_card = device.type == "cuda"
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if not on_card:                                  # the CPU rehearsal
        cfg, batch, seq = cfg.reduced(), 2, 64
    os.environ["REPRO_ATTN_IMPL"] = "flash"
    if on_card:
        use_deterministic_algorithms()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    step_fn = make_train_step(
        model, AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=1),
        remat=True, donate=donate)

    def fresh_state():
        return init_train_state(
            model.init(torch.Generator(device=device).manual_seed(SEED)),
            prng_key(SEED + 1), init_data_state(SEED))

    steps = []

    def timed(run):
        def step(state, b):
            sync(torch, device)
            n0, t0 = fa.LAUNCHES.n, time.time()
            new, met = step_fn(state, b)
            sync(torch, device)
            steps.append((run, int(new.step), time.time() - t0,
                          fa.LAUNCHES.n - n0, float(met["loss"]),
                          float(met["aux"])))
            return new, met
        return step

    def ctx_cfg(name):
        return CheckpointConfig(dir=str(root / name), backend="fti",
                                dedicated_thread=True, objstore=False)

    def quiet(*_):
        pass

    levels = LevelSchedule(l2_every=0, l3_every=0, l4_every=0)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ops.reset_launch_counts()

    # run A: straight through, no store
    t = time.time()
    state = fresh_state()
    sync(torch, device)
    made_s = time.time() - t
    named = flatten_named(state)
    nbytes = sum(x.numel() * x.element_size() for x in named.values())
    n_card = sum(x.device == device for x in named.values())
    largest = max(named, key=lambda k: named[k].numel())
    n_params = sum(v.numel() for k, v in named.items()
                   if k.startswith("params/"))
    m = cfg.moe
    depth = (f"{cfg.n_layers} encoder + {cfg.n_layers} decoder layers"
             if cfg.encdec else f"{cfg.n_layers} layers")
    log(f"[{tag}] {cfg.name}: {depth}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, "
        + (f"{m.n_experts} experts of d_ff {cfg.d_ff}, top-{m.top_k}, "
           f"capacity factor {m.capacity_factor}, group {m.group_size}, "
           f"{m.dispatch} dispatch, " if m else f"d_ff {cfg.d_ff}, ")
        + f"vocab {cfg.vocab_size}"
        + (", tied embed" if cfg.tie_embeddings else "")
        + (f", {cfg.act}, no rope" if cfg.encdec else "")
        + f"; {n_params:,} parameters; TrainState {len(named)} leaves "
        f"({n_card} on {device}), "
        f"{nbytes / 1e9:.2f} GB, largest {largest} "
        f"{tuple(named[largest].shape)}; made in {made_s:.1f} s; batch "
        f"{batch} x {seq}" + (" tokens and frames" if cfg.encdec else "")
        + ", remat, REPRO_ATTN_IMPL=flash, "
        f"{'donated' if donate else 'functional'} steps; host MemTotal "
        f"{host_mem_total() / 1e9:.1f} GB")
    del named
    ctx = CheckpointContext(ctx_cfg("a"))
    out = run_training(model, timed("A"), state, ctx, LoopConfig(
        total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1, levels=levels),
        batch, seq, log=quiet)
    ctx.shutdown()
    if donate and out["state"].params["embed"] is not state.params["embed"]:
        fail("run A: the donated step did not keep the state's tensors")
    t = time.time()
    want = state_digests(torch, out["state"])
    digest_s = time.time() - t
    loss_a = out["loss"]
    del out, state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # run B: the same seed; FULL store at step 2, fault at step 3
    state = fresh_state()
    # the restore's template: the state's structure, shapes, dtypes and
    # devices; its card leaves are one-element views (stride 0)
    template = unflatten_named(
        {k: (v.new_empty(()).expand(v.shape) if v.is_cuda else v.clone())
         for k, v in flatten_named(state).items()}, state)
    free_disk = shutil.disk_usage(root).free
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
        run_training(model, timed("B"), state, ctx, loop_b, batch, seq,
                     injector=FaultInjector(TRAIN_STEPS, 1.0), log=quiet)
    except SimulatedFault as e:
        log(f"[{tag}] run B: {e}")
    else:
        fail("run B: the injected fault did not fire")
    t = time.time()
    ctx.shutdown()                       # the FULL's tail finishes here
    drain_s = time.time() - t
    if [r.ckpt_id for r in reports] != [2]:
        fail(f"run B committed stores {[r.ckpt_id for r in reports]} != [2]")
    r = reports[0]
    log(f"[{tag}] store 2 (free disk before it {free_disk / 1e9:.1f} GB): "
        f"kind={r.kind} bytes_payload={r.bytes_payload} "
        f"plan_s={r.plan_seconds:.4f} store_call_s={blocked[2]:.4f} "
        f"total_s={r.seconds:.4f} (shutdown waited {drain_s:.2f} s for the "
        f"tail)")
    # the faulted state goes before the restore allocates the restored one
    del state, ctx, store
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated()
        if left > 1e9:
            fail(f"{left / 1e9:.2f} GB still allocated on the card after "
                 f"the faulted state was freed")
        log(f"[{tag}] faulted state freed: {left / 1e6:.1f} MB allocated on "
            f"the card before the restore")

    ctx = CheckpointContext(ctx_cfg("b"))
    load, restore = ctx.load, {}

    def timed_load(state, **kw):
        t0 = time.time()
        got = load(state, **kw)
        sync(torch, device)
        restore["s"] = time.time() - t0
        return got

    ctx.load = timed_load
    out = run_training(model, timed("B restarted"), template, ctx, loop_b,
                       batch, seq, log=quiet)
    ctx.shutdown()
    launches = ops.launch_counts()
    shutil.rmtree(root, ignore_errors=True)       # the FULL
    if not out["restarted"]:
        fail("run B's restart found no checkpoint")
    log(f"[{tag}] restore: {restore['s']:.2f} s (fresh context, FULL of "
        f"{r.bytes_payload} B into a template on {device} that holds no "
        f"device memory)")

    for run, step, sec, n, loss, aux in steps:
        log(f"[{tag}] run {run} step {step}: {sec:.3f} s, "
            f"{batch * seq / sec:.0f} tokens/s, flash launches {n}, "
            f"loss {loss:.6f}" + (f" (router aux {aux:.6f})" if m else ""))
    # forward + remat recompute, per layer: one attention, or three for an
    # encoder-decoder's layer pair (encoder self, decoder self, cross)
    want_per_step = 2 * cfg.n_layers * (3 if cfg.encdec else 1)
    if not all(math.isfinite(x[4]) for x in steps):
        fail("a training loss is not finite")
    if [x[:2] for x in steps] != [("A", 1), ("A", 2), ("A", 3), ("B", 1),
                                   ("B", 2), ("B", 3),
                                   ("B restarted", 3)]:
        fail(f"unexpected step sequence {[x[:2] for x in steps]}")
    if on_card and (any(x[3] != want_per_step for x in steps) or
                    launches["flashattn"] != want_per_step * len(steps) or
                    launches["blockhash2"] != n_card or
                    launches["diffpack"] or launches["diffunpack"]):
        fail(f"{tag} launches {launches} (flash per step "
             f"{[x[3] for x in steps]}): expected flashattn "
             f"{want_per_step} per step, blockhash2 {n_card} (one FULL of "
             f"the card leaves), no diffpack or diffunpack")
    t = time.time()
    got = state_digests(torch, out["state"])
    bad = [k for k in want if got.get(k) != want[k]]
    if bad or list(got) != list(want):
        fail(f"resumed TrainState differs from run A: {bad[:5]}")
    if out["loss"] != loss_a:
        fail(f"resumed loss {out['loss']} != run A's {loss_a}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"[{tag}] resumed TrainState equals run A's bit for bit "
        f"({len(want)} leaves, SHA-256 of each leaf's bytes, {digest_s:.1f} "
        f"+ {time.time() - t:.1f} s; step {int(out['state'].step)}, loss "
        f"{loss_a:.6f}); kernel launches {launches}; max_memory_allocated "
        f"{peak / 1e9:.2f} GB (TrainState {nbytes / 1e9:.2f} GB)")
    if on_card:
        b, _ = next_batch(out["state"].data_state, cfg, batch, seq, device)
        profile_step(torch, lambda: step_fn(out["state"], b), ranges=ranges)
    del out, template
    gc.collect()
    if on_card:
        torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "restore_s": restore["s"],
            "report": r, "peak_bytes": peak, "layers": cfg.n_layers}


# --------------------------------------------------------------------------- #
# phase 6: the object-store L4, incremental stores and SCR
# --------------------------------------------------------------------------- #

def cdc_rate(n_bytes: int = 256 << 20) -> float:
    """MB/s of the CDC chunker (default bounds) over ``n_bytes`` of random
    bytes pushed in 4 MiB pieces, on this host."""
    import numpy as np

    from repro_torch.objstore.cdc import CDCParams, Chunker
    data = np.random.default_rng(SEED).integers(
        0, 256, n_bytes, dtype=np.uint8).tobytes()
    t = time.time()
    c = Chunker(CDCParams())
    for off in range(0, n_bytes, 4 << 20):
        c.push(data[off:off + (4 << 20)])
    c.finish()
    return n_bytes / (time.time() - t) / 1e6


def wipe_dirs(root: Path) -> None:
    """Everything but the object-store bucket: the node-local storage
    (L1–L3) and the global directory's checkpoints (L4)."""
    shutil.rmtree(root / "node-local", ignore_errors=True)
    for d in (root / "global").glob("ckpt-*"):
        shutil.rmtree(d)
    latest = root / "global" / "latest"
    if latest.exists():
        latest.unlink()


def objstore_path(torch, args, device, ops) -> dict:
    """Phase 6.  → {"launches": counts over the phase, "depth": layers,
    and the numbers printed}."""
    from repro_torch.core.context import (CHK_DIFF, CHK_FULL,
                                          CheckpointConfig, CheckpointContext)
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.telemetry import trace as ttrace

    bb = args.block_bytes
    on_card = device.type == "cuda"
    rate = cdc_rate(256 << 20 if on_card else 8 << 20)
    log(f"[obj] CDC chunker on this host: {rate:.1f} MB/s (default bounds "
        f"256 KiB / 1 MiB / 4 MiB, {256 if on_card else 8} MiB of random "
        f"bytes)")
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    depth = min(args.layers, OBJSTORE_LAYERS)
    state = tinyllama_state(torch, depth, args.width_div, device, gen)
    sync(torch, device)
    named = flatten_named(state)
    nbytes = sum(t.numel() * t.element_size() for t in named.values())
    total_blocks = sum(n_blocks(t, bb) for t in named.values())
    p = state["params"]
    row_bytes = p["embed"].shape[1] * p["embed"].element_size()
    norm_blocks = sum(n_blocks(n, bb) for n in norms_of(state))
    log(f"[obj] state: {depth} of 22 layers, {len(named)} "
        f"leaves, {nbytes / 1e9:.2f} GB on {device}")

    def want_dirty(ids):
        return 2 * len(touched_blocks(ids, row_bytes, bb)) + norm_blocks + 1

    def zeros_like_state():
        return unflatten_named({k: torch.zeros_like(v)
                                for k, v in named.items()}, state)

    def check_equal(restored, what):
        bad = [k for k, v in flatten_named(restored).items()
               if v.device != named[k].device or not torch.equal(v, named[k])]
        if bad:
            fail(f"{what}: restored leaves differ from the state: {bad[:5]}")

    def timed_load(cfg):
        """A fresh context restores into zeros on the device → (tree, the
        restored checkpoint's metadata, seconds)."""
        template = zeros_like_state()
        sync(torch, device)
        t = time.time()
        ctx = CheckpointContext(cfg)
        eng, seen = ctx.tcl.backend.engine, {}
        load_latest = eng.load_latest

        def keep_meta(*a, **kw):
            got = load_latest(*a, **kw)
            seen["meta"] = got[1] if got else {}
            return got

        eng.load_latest = keep_meta
        got = ctx.load(template)
        ctx.shutdown()
        sync(torch, device)
        if not ctx.restarted:
            fail(f"{cfg.dir}: the restart found no checkpoint")
        return got, seen["meta"], time.time() - t

    shutil.rmtree(OBJ_DIR, ignore_errors=True)
    out = {"depth": depth, "cdc_mb_s": rate}
    ttrace.reset()
    ttrace.enable()
    ops.reset_launch_counts()

    # 6a: FULL and DIFF at L4 through the object store, CP-dedicated thread
    cfg = CheckpointConfig(dir=str(OBJ_DIR / "l4"), backend="fti",
                           block_bytes=bb)
    reports, uploaded = [], {}
    ctx = CheckpointContext(cfg)
    tier = ctx.tcl.backend.engine.objstore_tier()
    if tier is None:
        fail("the default CheckpointConfig composed no object-store tier")

    def note(rep):
        reports.append(rep)
        uploaded[rep.ckpt_id] = tier.uploader.stats["bytes_uploaded"]

    ctx.observe_store_reports(note)
    t = time.time()
    ctx.store(state, id=1, level=4, kind=CHK_FULL)
    call1 = time.time() - t
    ids = sparse_update(torch, state, gen)     # before the FULL's tail ran
    t = time.time()
    ctx.store(state, id=2, level=4, kind=CHK_DIFF)
    call2 = time.time() - t
    ctx.shutdown()
    stages = stage_seconds(ttrace.tracer().events())
    by_id = {r.ckpt_id: r for r in reports}
    if sorted(by_id) != [1, 2] or by_id[2].kind != CHK_DIFF:
        fail(f"L4 stores committed {[(r.ckpt_id, r.kind) for r in reports]}")
    got = round(by_id[2].dirty_ratio * total_blocks)
    if got != want_dirty(ids):
        fail(f"L4 DIFF: {got} dirty blocks, expected {want_dirty(ids)}")
    up1, up2 = uploaded[1], uploaded[2] - uploaded[1]
    for i, call in ((1, call1), (2, call2)):
        r = by_id[i]
        log(f"[obj] L4 store {i}: kind={r.kind} bytes_payload="
            f"{r.bytes_payload} plan_s={r.plan_seconds:.4f} store_call_s="
            f"{call:.4f} total_s={r.seconds:.4f}; stages (s): " + " ".join(
                f"{st}={stages.get((i, st), 0.0):.4f}"
                for st in ("plan", "pack", "place", "commit")))
    log(f"[obj] uploaded: store 1 {up1} B, store 2 {up2} B (ratio "
        f"{up2 / max(up1, 1):.5f}); DIFF dirty blocks {got} (expected "
        f"{want_dirty(ids)}); catalog ids {tier.catalog.ids()}; uploader "
        f"{dict(tier.uploader.stats)}")
    out.update(l4_reports={i: (r.bytes_payload, r.plan_seconds, r.seconds)
                           for i, r in by_id.items()},
               l4_pack_s={i: stages.get((i, "pack"), 0.0) for i in by_id},
               uploaded=(up1, up2))

    wipe_dirs(OBJ_DIR / "l4")
    n0 = ops.launch_counts()["diffunpack"]
    restored, meta, out["l4_restore_s"] = timed_load(cfg)
    if meta.get("recovered_via") != "objstore":
        fail(f"after the wipe the restore came via "
             f"{meta.get('recovered_via')}, not the object store")
    check_equal(restored, "object-store restore")
    replayed = ops.launch_counts()["diffunpack"] - n0
    log(f"[obj] restore from the object store alone: {len(named)} leaves "
        f"bit-exact on {device} in {out['l4_restore_s']:.2f} s "
        f"(recovered_via={meta['recovered_via']}, DIFF replayed with "
        f"{replayed} diffunpack launches)")
    del restored
    shutil.rmtree(OBJ_DIR / "l4", ignore_errors=True)

    # 6b: an incremental store in two parts, then a DIFF with the exact
    # dirty-block count, then a restore
    cfg = CheckpointConfig(dir=str(OBJ_DIR / "inc"), backend="fti",
                           block_bytes=bb)
    reports = []
    ctx = CheckpointContext(cfg).observe_store_reports(reports.append)
    t = time.time()
    inc = ctx.store_begin(id=1, level=1)
    inc.add({"params": {k: v for k, v in p.items() if k != "layers"}})
    inc.add({"params": {"layers": p["layers"]}, "step": state["step"]})
    inc.commit()
    inc_call = time.time() - t
    ids = sparse_update(torch, state, gen)    # before the commit's tail ran
    ctx.store(state, id=2, level=1, kind=CHK_DIFF)
    ctx.shutdown()
    by_id = {r.ckpt_id: r for r in reports}
    if sorted(by_id) != [1, 2] or by_id[2].kind != CHK_DIFF:
        fail(f"incremental chain committed "
             f"{[(r.ckpt_id, r.kind) for r in reports]}")
    got = round(by_id[2].dirty_ratio * total_blocks)
    if got != want_dirty(ids):
        fail(f"DIFF after the incremental store: {got} dirty blocks, "
             f"expected {want_dirty(ids)}")
    restored, meta, out["inc_restore_s"] = timed_load(cfg)
    if meta.get("id") != 2 or meta.get("kind") != CHK_DIFF:
        fail(f"incremental chain: restored {meta.get('id')} "
             f"{meta.get('kind')}, not the DIFF 2")
    check_equal(restored, "incremental + DIFF restore")
    del restored
    log(f"[obj] incremental store (2 parts, {inc_call:.2f} s to commit, "
        f"total_s {by_id[1].seconds:.2f}), then DIFF with {got} dirty blocks "
        f"(expected {want_dirty(ids)}); restore bit-exact in "
        f"{out['inc_restore_s']:.2f} s")
    shutil.rmtree(OBJ_DIR / "inc", ignore_errors=True)

    # 6c: one SCR FULL store and restart
    cfg = CheckpointConfig(dir=str(OBJ_DIR / "scr"), backend="scr",
                           block_bytes=bb)
    ctx = CheckpointContext(cfg)
    t = time.time()
    rep = ctx.store(state, id=1, level=1)
    scr_s = time.time() - t
    ctx.shutdown()
    restored, meta, out["scr_restore_s"] = timed_load(cfg)
    check_equal(restored, "SCR restore")
    del restored
    log(f"[obj] SCR FULL store {rep.bytes_payload} B in {scr_s:.2f} s "
        f"(file mode); restart bit-exact in {out['scr_restore_s']:.2f} s")
    shutil.rmtree(OBJ_DIR, ignore_errors=True)
    sync(torch, device)
    out["launches"] = ops.launch_counts()
    ttrace.disable()
    want = {"blockhash2": 4 * len(named), "diffpack": 2,
            "diffunpack": 2, "flashattn": 0}
    log(f"[obj] kernel launches over the phase: {out['launches']} (expected "
        f"on the card: {want})")
    if on_card and out["launches"] != want:
        fail("phase 6 launch counts do not match the leaves hashed and "
             "unpacked and the DIFF stores packed")
    del state, named
    if on_card:
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phase 7: serving and checkpoint-as-deployment
# --------------------------------------------------------------------------- #

#: batch, prompt tokens, cache length, tokens generated, a DIFF store every
#: SERVE_EVERY tokens and the fault after SERVE_FAULT (on the card; the CPU
#: rehearsal divides them)
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN = 4, 128, 2048
SERVE_GEN, SERVE_EVERY, SERVE_FAULT = 64, 16, 48
SERVE_TUNED_TOKENS = 1024


def cache_dirty_blocks(k, positions, block_bytes: int) -> list:
    """Hash blocks, sorted, of one stacked (n_groups, B, C, *rest) cache
    leaf that the decode steps at ``positions`` wrote: one row of
    prod(rest) elements (GQA: KV·dh; MLA: the latent's r, or the rotary
    key's rope_dim) per (layer, sequence) slab and position."""
    n_groups, batch, c = k.shape[:3]
    row = math.prod(k.shape[3:]) * k.element_size()
    out = set()
    for slab in range(n_groups * batch):
        for pos in positions:
            lo = (slab * c + pos % c) * row
            out.update(range(lo // block_bytes,
                             (lo + row - 1) // block_bytes + 1))
    return sorted(out)


def state_dirty_blocks(caches, positions, block_bytes: int) -> int:
    """Hash blocks of a decode state that the steps at ``positions``
    rewrite: the rows at those positions of a KV or latent cache leaf
    (:func:`cache_dirty_blocks`), every block of a recurrent state (RWKV,
    Mamba), which each step rewrites whole."""
    from repro_torch.models.attention import KVCache, MLACache
    return sum(len(cache_dirty_blocks(x, positions, block_bytes))
               if isinstance(c, (KVCache, MLACache))
               else n_blocks(x, block_bytes) for c in caches for x in c)


def cache_nbytes(model, batch: int, max_len: int) -> dict:
    """{cache leaf: bytes} of the model's decode cache (from its meta
    structure: no memory)."""
    from repro_torch.core.protect import flatten_named
    return {k: v.numel() * v.element_size() for k, v in
            flatten_named(model.cache_struct(batch, max_len)).items()}


def serve_resume(torch, device, ops, model, handle, prompts, dims, bb: int,
                 tag: str, root: Path) -> dict:
    """Serve and resume one model.  Run A prefills and generates ``gen_n``
    tokens uninterrupted (one more decode step profiled on the card); run B
    stores a FULL ServeState after prefill (FTI, level 1, CP-dedicated
    thread) and a DIFF every ``every`` tokens, faults after ``fault``,
    restores into a cold cache on the device (the DIFF chain after the
    newest FULL replayed there) and generates on; both must agree bit for
    bit.  Each cadence store's dirty-block count must be the one the model
    rewrote (:func:`state_dirty_blocks`): a store whose count passes the
    pipeline's promote threshold must be promoted and committed as a FULL,
    any other must be a DIFF.  ``dims``: (max_len, gen_n, every, fault).
    → {"st_prefill": the state after prefill, "n_dev": ServeState leaves
    on the device, "stores": stores made, "diffs": stores committed as
    DIFF, "promoted": cadence stores promoted to FULL, "links": DIFF links
    after the newest FULL, "replayed": diffunpack launches of the
    restore}"""
    from repro_torch.core.context import (CHK_DIFF, CHK_FULL,
                                          CheckpointConfig,
                                          CheckpointContext)
    from repro_torch.core.formats import tensor_to_numpy
    from repro_torch.core.protect import flatten_named
    from repro_torch.serve.engine import ServeState, ServingEngine

    batch, prompt = prompts.shape
    max_len, gen_n, every, fault = dims

    # run A: prefill, then gen_n tokens uninterrupted
    eng = ServingEngine(model, handle, batch, max_len)
    sync(torch, device)
    t = time.time()
    eng.prefill(prompts)
    sync(torch, device)
    prefill_s = time.time() - t
    st_prefill = eng.get_state()
    t = time.time()
    toks_a = eng.generate(gen_n)
    sync(torch, device)
    gen_s = time.time() - t
    decode_ms = gen_s / gen_n * 1e3
    tokens_per_s = batch * gen_n / gen_s
    final_a = {k: tensor_to_numpy(v)
               for k, v in flatten_named(eng.get_state()).items()}
    log(f"[{tag}] run A: prefill {prompt} tokens in {prefill_s:.3f} s "
        f"({prefill_s / prompt * 1e3:.2f} ms per step); {gen_n} "
        f"tokens in {gen_s:.3f} s: {decode_ms:.2f} ms per decode "
        f"step, {tokens_per_s:.1f} tokens/s")
    if device.type == "cuda":          # one more decode step, profiled
        profile_step(torch, lambda: eng.generate(1))
    del eng

    # run B: FULL after prefill, a DIFF every `every` tokens, a fault after
    # `fault`, a restore into a cold cache on the device, generate on
    ckpt_cfg = CheckpointConfig(dir=str(root / "b"), backend="fti",
                                block_bytes=bb, dedicated_thread=True,
                                objstore=False)
    reports, blocked, want_dirty = [], {}, {}
    ctx = CheckpointContext(ckpt_cfg).observe_store_reports(reports.append)
    eng = ServingEngine(model, handle, batch, max_len)
    eng.set_state(st_prefill)

    def store(kind):
        st = eng.get_state()
        t = time.time()
        ctx.store(st, id=int(st.pos), level=1, kind=kind)
        blocked[int(st.pos)] = time.time() - t
        return st

    prev = store("FULL")
    named = flatten_named(prev)
    total_blocks = sum(n_blocks(v, bb) for v in named.values())
    toks_b = []
    while int(eng.state.pos) - prompt < fault:
        p0 = int(eng.state.pos)
        toks_b.append(eng.generate(every))
        st = store(CHK_DIFF)
        moved = int(not torch.equal(st.last_token, prev.last_token))
        want_dirty[int(st.pos)] = 1 + moved + state_dirty_blocks(
            st.caches, range(p0, p0 + every), bb)
        prev = st
    log(f"[{tag}] run B: fault after {fault} tokens (the engine and its "
        f"caches are dropped)")
    del eng, prev, st
    t = time.time()
    ctx.shutdown()
    drain_s = time.time() - t
    by_id = {r.ckpt_id: r for r in reports}
    cadence = sorted(want_dirty)
    promote = {i: want_dirty[i] / total_blocks > ckpt_cfg.promote_threshold
               for i in cadence}
    want_kind = {prompt: CHK_FULL, **{
        i: CHK_FULL if promote[i] else CHK_DIFF for i in cadence}}
    if sorted(by_id) != [prompt] + cadence or any(
            by_id[i].kind != k for i, k in want_kind.items()) or any(
            by_id[i].promoted_full != promote[i] for i in cadence):
        fail(f"run B committed {[(r.ckpt_id, r.kind, r.promoted_full) for r in reports]}, "
             f"expected {want_kind} (promoted: {promote})")
    for i in [prompt] + cadence:
        r = by_id[i]
        got = None if r.dirty_ratio is None else \
            round(r.dirty_ratio * total_blocks)
        log(f"[{tag}] store {i}: kind={r.kind} promoted_full="
            f"{r.promoted_full} bytes_payload={r.bytes_payload} plan_s="
            f"{r.plan_seconds:.4f} store_call_s={blocked[i]:.4f} total_s="
            f"{r.seconds:.4f}" + (
                "" if got is None else
                f" dirty blocks {got} of {total_blocks} (expected "
                f"{want_dirty[i]})"))
        if got is not None and got != want_dirty[i]:
            fail(f"{tag} store {i}: {got} dirty blocks, expected "
                 f"{want_dirty[i]} from what the model rewrote")
    log(f"[{tag}] shutdown waited {drain_s:.2f} s for the last tail")
    fulls = [i for i in [prompt] + cadence if want_kind[i] == CHK_FULL]
    links = sum(i > fulls[-1] for i in cadence)

    template = ServeState(model.init_caches(batch, max_len, device=device),
                          torch.tensor(0, dtype=torch.int32),
                          torch.zeros((batch, 1), dtype=torch.int32,
                                      device=device))
    n0 = ops.launch_counts()["diffunpack"]
    sync(torch, device)
    t = time.time()
    ctx = CheckpointContext(ckpt_cfg)
    restored = ctx.load(template)
    ctx.shutdown()
    sync(torch, device)
    restore_s = time.time() - t
    replayed = ops.launch_counts()["diffunpack"] - n0
    if not ctx.restarted or int(restored.pos) != prompt + fault:
        fail(f"the {tag} restore found pos "
             f"{int(restored.pos) if ctx.restarted else None}, not "
             f"{prompt + fault}")
    eng = ServingEngine(model, handle, batch, max_len)
    eng.set_state(restored)
    del restored, template
    toks_b.append(eng.generate(gen_n - fault))
    got_b = torch.cat(toks_b, dim=1)
    if not torch.equal(got_b, toks_a):
        fail(f"{tag} run B's tokens differ from run A's after the restore")
    bad = [k for k, v in flatten_named(eng.get_state()).items()
           if tensor_to_numpy(v).tobytes() != final_a[k].tobytes()]
    if bad:
        fail(f"{tag} run B's final ServeState differs from run A's: {bad}")
    del eng
    log(f"[{tag}] restore: {restore_s:.3f} s (the FULL at {fulls[-1]} + "
        f"{links} DIFF links into a cold cache on {device}, {replayed} "
        f"diffunpack launches); run B's {gen_n} tokens and final ServeState "
        f"equal run A's bit for bit")
    return {"st_prefill": st_prefill, "stores": 1 + len(cadence),
            "diffs": sum(not promote[i] for i in cadence),
            "promoted": sum(promote.values()), "links": links,
            "replayed": replayed,
            "n_dev": sum(x.device.type == device.type
                         for x in named.values())}


def serve_path(torch, args, device, ops) -> dict:
    """Phase 7.  Serve and resume tinyllama-1.1b (:func:`serve_resume`).
    Then a rolling deploy: a publisher stores two FULL param trees at L4
    through the object store, a FleetDeployer rolls each onto two
    replicas, one per poll.  → the kernels' launch counts over the
    phase."""
    from repro_torch.configs import get_arch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.protect import flatten_named
    from repro_torch.models.zoo import build_model
    from repro_torch.objstore.client import make_object_store
    from repro_torch.serve.deploy import FleetDeployer, Replica
    from repro_torch.serve.engine import ServingEngine, WeightsHandle
    from repro_torch.train.step import use_deterministic_algorithms

    on_card = device.type == "cuda"
    bb = args.block_bytes
    cfg = get_arch("tinyllama-1.1b")
    batch, prompt, max_len = SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN
    gen_n, every, fault = SERVE_GEN, SERVE_EVERY, SERVE_FAULT
    n_tuned = SERVE_TUNED_TOKENS
    if not on_card:                                  # the CPU rehearsal
        cfg, batch, prompt, max_len = cfg.reduced(), 2, 8, 64
        gen_n, every, fault, n_tuned = 16, 4, 12, 2
    if on_card:
        use_deterministic_algorithms()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    handle = WeightsHandle(params=model.init(
        torch.Generator(device=device).manual_seed(SEED + 7)))
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator().manual_seed(SEED + 8),
                            dtype=torch.int32).to(device)
    cache_bytes = sum(cache_nbytes(model, batch, max_len).values())
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of {cfg.head_dim}, "
        f"{cfg.compute_dtype} compute; batch {batch}, prompts of {prompt} "
        f"tokens, max_len {max_len}: KV cache {cache_bytes / 1e6:.1f} MB")
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    log(f"[serve] free disk under {SERVE_DIR.parent}: "
        f"{shutil.disk_usage(SERVE_DIR).free / 1e9:.1f} GB")
    ops.reset_launch_counts()
    run = serve_resume(torch, device, ops, model, handle, prompts,
                       (max_len, gen_n, every, fault), bb, "serve",
                       SERVE_DIR)
    del handle, run["st_prefill"]

    # rolling deploy at DEPLOY_LAYERS of depth: publish v1, roll it;
    # fine-tune in place, publish v2, roll it; one replica per poll
    model = build_model(dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, DEPLOY_LAYERS)))
    log(f"[serve] deploy: {model.cfg.n_layers} of {cfg.n_layers} layers at "
        f"the same widths")
    pub_kw = {} if on_card else dict(     # the CPU rehearsal's tiny tree
        objstore_cdc_min_bytes=1024, objstore_cdc_avg_bytes=4096,
        objstore_cdc_max_bytes=16384, objstore_chunk_bytes=4096)
    pub = CheckpointContext(CheckpointConfig(
        dir=str(SERVE_DIR / "pub"), backend="fti", block_bytes=bb, **pub_kw))
    pub_reports = []
    pub.observe_store_reports(pub_reports.append)
    v = model.init(torch.Generator(device=device).manual_seed(SEED + 9))
    other = WeightsHandle(params=model.init(
        torch.Generator(device=device).manual_seed(SEED + 10)))
    replicas = [Replica(name=f"r{i}", cache_root=str(SERVE_DIR / f"cache-{i}"),
                        prefix="params",
                        engine=ServingEngine(model, other, batch, max_len))
                for i in range(2)]
    del other
    dep = FleetDeployer(make_object_store(
        "file:" + str(SERVE_DIR / "pub" / "objstore")), replicas)
    published = {}

    def publish(entry):
        t = time.time()
        pub.store({"params": v}, id=entry, level=4)
        call = time.time() - t
        pub.wait()
        published[entry] = {k: x.clone() for k, x in flatten_named(v).items()}
        r = pub_reports[-1]
        log(f"[serve] publish {entry}: FULL L4 bytes_payload "
            f"{r.bytes_payload}, store_call_s {call:.3f}, plan_s "
            f"{r.plan_seconds:.3f}, total_s {r.seconds:.3f}")

    def rollout(entry):
        before = dict(dep.stats)
        actions, swap_s = [], []
        while True:
            t = time.time()
            st = dep.poll()
            actions.append(st["action"])
            if len(set(dep.fleet_epochs().values())) > 2:
                fail(f"the fleet shows {dep.fleet_epochs()}: more than two "
                     f"entries")
            if st["action"] == "swapped":
                sync(torch, device)
                swap_s.append(time.time() - t)
                r = next(x for x in replicas if x.name == st["replica"])
                got = flatten_named(r.engine.params)
                bad = [k for k, x in published[entry].items()
                       if got[k].device != x.device
                       or not torch.equal(got[k], x)]
                if bad:
                    fail(f"replica {r.name} after the swap to entry {entry}: "
                         f"{bad[:5]} differ from the published tree")
            if st["action"] in ("converged", "pinned") or len(actions) > 8:
                break
        if actions != ["started", "swapped", "swapped", "converged"]:
            fail(f"rollout of entry {entry}: polls gave {actions}")
        fetched = dep.stats["bytes_fetched"] - before["bytes_fetched"]
        cached = dep.stats["bytes_cached"] - before["bytes_cached"]
        ratio = fetched / max(fetched + cached, 1)
        log(f"[serve] rollout of entry {entry}: polls {actions}; swaps "
            f"{', '.join(f'{x:.3f}' for x in swap_s)} s; fetched {fetched} "
            f"B, cached {cached} B (fetch ratio {ratio:.5f}); fleet "
            f"{dep.fleet_epochs()}")
        return ratio, swap_s

    publish(1)
    rollout(1)
    del published[1]
    # a fine-tune in place: distinct token ids, so each row moves once
    ids = torch.randperm(cfg.vocab_size, generator=torch.Generator(
        ).manual_seed(SEED + 11))[:n_tuned].to(device)
    with torch.no_grad():
        v["embed"][ids] += 0.5
        v["lm_head"][:, ids] += 0.5
        for k, x in flatten_named(v).items():
            if k.endswith("/scale"):
                x.add_(0.25)
    publish(2)
    ratio2, _ = rollout(2)
    pub.shutdown()
    log(f"[serve] free disk after both rollouts: "
        f"{shutil.disk_usage(SERVE_DIR).free / 1e9:.1f} GB; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9 if on_card else 0:.2f} GB")
    if ratio2 >= 0.30:
        fail(f"the second rollout fetched {ratio2:.5f} of the entry's "
             f"bytes, not below 0.30")

    # a swapped replica serves what an engine born with v2 serves
    n_cmp = every
    r0 = replicas[0].engine
    direct = ServingEngine(model, v, batch, max_len)
    direct.prefill(prompts)
    r0.set_state(direct.get_state())
    if not torch.equal(r0.generate(n_cmp), direct.generate(n_cmp)):
        fail("a replica swapped to entry 2 generates other tokens than an "
             "engine built on the published tree")
    log(f"[serve] replica r0 (entry {r0.weights.entry_id}, epoch "
        f"{r0.weights.epoch}) generates the {n_cmp} tokens of an engine "
        f"built on the published tree")
    n_param_leaves = len(published[2])
    del replicas, dep, direct, r0, v, published
    sync(torch, device)
    launches = ops.launch_counts()
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    if on_card:
        torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()

    # every store hashes the ServeState's leaves on the card (pos lives on
    # the host), each publish the param tree's; one pack per DIFF store and
    # one unpack per DIFF link replayed
    want = serve_launches(run)
    want["blockhash2"] += 2 * n_param_leaves
    log(f"[serve] kernel launches over the phase: {launches} "
        f"(expected on the card: {want})")
    if on_card and (launches != want or run["replayed"] != run["links"]):
        fail("phase 7 launch counts do not match the leaves hashed, the "
             "DIFF stores packed and the DIFF links replayed")
    return launches


def serve_launches(run: dict) -> dict:
    """The launches :func:`serve_resume`'s stores and restore make on the
    card: a hash of every card leaf of the ServeState per store (a
    promoted store hashes once), a pack per store committed as DIFF, an
    unpack per DIFF link replayed, no attention."""
    return {"blockhash2": run["stores"] * run["n_dev"],
            "diffpack": run["diffs"], "diffunpack": run["links"],
            "flashattn": 0}

# --------------------------------------------------------------------------- #
# phase 10: MLA served at full width, its latent cache checkpointed
# --------------------------------------------------------------------------- #

MLA_ARCH = "minicpm3-4b"
MLA_DIR = ROOT / "build" / "chip_smoke_mla"


def served_phase(torch, args, device, ops, arch: str, tag: str, root: Path,
                 seed: int, phase: int, widths, state: str, layers=None):
    """Phases 10 and 11: ``arch`` at its published widths (reduced on the
    CPU) serves and resumes as phase 7's first half (:func:`serve_resume`,
    phase 7's batch, prompt, cache length, tokens, store cadence and
    fault), f32 parameters made on the device from ``seed``, bf16
    compute, deterministic on the card; the launches over the phase must
    be :func:`serve_launches`'.  ``widths(cfg)``: the architecture's
    widths, for the log; ``state``: what the ServeState's caches are;
    ``layers``: a cut of the config's depth on the card.
    → (cfg, serve_resume's result, the launches over the phase)"""
    from repro_torch.configs import get_arch
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import WeightsHandle
    from repro_torch.train.step import use_deterministic_algorithms

    on_card = device.type == "cuda"
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    batch, prompt, max_len = SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN
    gen_n, every, fault = SERVE_GEN, SERVE_EVERY, SERVE_FAULT
    if not on_card:                                  # the CPU rehearsal
        cfg, batch, prompt, max_len = cfg.reduced(), 2, 8, 64
        gen_n, every, fault = 16, 4, 12
    if on_card:
        use_deterministic_algorithms()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    handle = WeightsHandle(params=model.init(
        torch.Generator(device=device).manual_seed(seed)))
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator().manual_seed(seed + 1),
                            dtype=torch.int32).to(device)
    leaves = cache_nbytes(model, batch, max_len)
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{widths(cfg)}; d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{cfg.param_count():,} parameters in {cfg.param_dtype}, "
        f"{cfg.compute_dtype} compute; batch {batch}, prompts of {prompt} "
        f"tokens, max_len {max_len}: {state} "
        f"{sum(leaves.values()) / 1e6:.2f} MB (" + ", ".join(
            f"{k} {v / 1e6:.2f} MB" for k, v in leaves.items()) + ")")
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ops.reset_launch_counts()
    run = serve_resume(torch, device, ops, model, handle, prompts,
                       (max_len, gen_n, every, fault), args.block_bytes,
                       tag, root)
    del handle, run["st_prefill"]
    sync(torch, device)
    launches = ops.launch_counts()
    shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    if on_card:
        torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()
    want = serve_launches(run)
    log(f"[{tag}] kernel launches over the phase: {launches} (expected on "
        f"the card: {want}); max_memory_allocated {peak:.2f} GB")
    if on_card and (launches != want or run["replayed"] != run["links"]):
        fail(f"phase {phase} launch counts do not match the leaves hashed, "
             f"the DIFF stores packed and the DIFF links replayed")
    return cfg, run, launches


def mla_path(torch, args, device, ops) -> dict:
    """Phase 10.  minicpm3-4b (:func:`served_phase`) decodes in the
    absorbed form over its latent cache.  → {"launches": counts over the
    phase, "layers": its depth}"""
    def widths(cfg):
        m = cfg.mla
        return (f"{cfg.n_heads} heads; MLA q_lora {m.q_lora_rank}, kv_lora "
                f"{m.kv_lora_rank}, qk nope/rope {m.qk_nope_dim}/"
                f"{m.qk_rope_dim}, v_head {m.v_head_dim}")

    cfg, _, launches = served_phase(torch, args, device, ops, MLA_ARCH,
                                    "mla", MLA_DIR, SEED + 12, 10, widths,
                                    "latent cache", layers=MLA_LAYERS)
    return {"launches": launches, "layers": cfg.n_layers}

# --------------------------------------------------------------------------- #
# phase 11: RWKV6 served at full width, its recurrent state checkpointed
# --------------------------------------------------------------------------- #

SSM_ARCH = "rwkv6-3b"
SSM_DIR = ROOT / "build" / "chip_smoke_ssm"


def ssm_path(torch, args, device, ops) -> dict:
    """Phase 11.  rwkv6-3b (:func:`served_phase`) decodes over its
    recurrent state, whose every block each step rewrites: each cadence
    store must be promoted to a FULL, and the restore must read the
    newest FULL with no link to replay.  → {"launches": counts over the
    phase, "layers": its depth}"""
    def widths(cfg):
        return f"{cfg.d_model // cfg.ssm.head_dim} WKV heads of " \
            f"{cfg.ssm.head_dim}"

    cfg, run, launches = served_phase(torch, args, device, ops, SSM_ARCH,
                                      "ssm", SSM_DIR, SEED + 14, 11, widths,
                                      "recurrent state (whatever max_len)")
    cadence = run["stores"] - 1
    if run["promoted"] != cadence or run["links"] or run["replayed"]:
        fail(f"phase 11: {run['promoted']} of {cadence} cadence stores "
             f"promoted, {run['links']} DIFF links after the newest FULL, "
             f"{run['replayed']} replayed: a recurrent state must promote "
             f"every store and replay none")
    log(f"[ssm] every cadence store promoted to FULL ({cadence}); the "
        f"restore read the newest FULL and replayed no link")
    return {"launches": launches, "layers": cfg.n_layers}

# --------------------------------------------------------------------------- #
# phase 8: the chaos matrix, elastic rescale and a sharded container
# --------------------------------------------------------------------------- #

CHAOS_DIR = ROOT / "build" / "chip_smoke_chaos"
#: new world sizes of the elastic rescale; 3 splits the rows raggedly
RESCALE_WORLDS = (2, 3)
SHARDS = 4
#: steps the restarted worker of the supervised kill trains (6 to 12)
RESUMED_STEPS = 6


def chaos_path(torch, args, device, ops) -> dict:
    """Phase 8.  (a) the scenario matrix on ``device`` (8 scenarios x 3
    backends), each cell's recovery path equal to the CPU run's and the
    hash launches equal to the card leaves its FTI stores planned; (b) a
    tinyllama-1.1b state saved as 4 axis-0 rank files and rescaled onto new
    worlds of 2 and 3 ranks, bit-exact; (c) the same state as a shard-local
    FULL through the directives, restored into zeros on the device, and
    the fall back past a newer id with a lost shard file; (d) the
    supervised kill (full width on a card).  → {"launches": counts over
    (a), and the numbers printed}."""
    import warnings

    from repro_torch.chaos.scenarios import run_matrix, run_scenario
    from repro_torch.core import manifest as mf
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.formats import numpy_to_tensor, tensor_to_numpy
    from repro_torch.core.pipeline import CheckpointPipeline, StoreRequest
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.core.resharding import (ShardChunk, ShardSnapshot,
                                             save_sharded, shard_bounds)
    from repro_torch.ft.elastic import rescale_restore

    on_card = device.type == "cuda"
    out: dict = {}
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)

    # (a) the matrix: the CPU run first, then the device's with the hash
    # launches counted from zero; the phase counts the leaves on the card
    # of every store planned by a backend that keeps digests (FTI)
    t = time.time()
    if on_card:
        cpu = run_matrix(str(CHAOS_DIR / "cpu"), device="cpu")
    planned = {"stores": 0, "card_leaves": 0}
    real_plan = CheckpointPipeline.plan

    def counting_plan(self, req):
        if req.diff_supported and req.named:
            planned["stores"] += 1
            planned["card_leaves"] += sum(
                isinstance(v, torch.Tensor) and v.is_cuda
                for v in req.named.values())
        return real_plan(self, req)

    sync(torch, device)
    ops.reset_launch_counts()
    CheckpointPipeline.plan = counting_plan
    try:
        report = run_matrix(str(CHAOS_DIR / "matrix"), device=device)
    finally:
        CheckpointPipeline.plan = real_plan
    sync(torch, device)
    out["launches"] = ops.launch_counts()
    out["matrix_s"] = time.time() - t
    if not on_card:
        cpu = report
    bad = [f"{c['name']}x{c['backend']}: {c['detail']}"
           for c in report["scenarios"] if not c["ok"]]
    if bad or report["passed"] != 24 or report["data_loss_bytes"] != 0:
        fail(f"chaos matrix on {device}: {report['passed']}/"
             f"{report['total']} passed, data loss "
             f"{report['data_loss_bytes']} B; {bad[:3]}")
    paths = {(c["name"], c["backend"]): c["recovery_path"]
             for c in cpu["scenarios"]}
    differ = [k for k in paths
              if paths[k] != {(c["name"], c["backend"]): c["recovery_path"]
                              for c in report["scenarios"]}.get(k)]
    if differ:
        fail(f"chaos matrix on {device}: recovery paths differ from the CPU "
             f"run's in {differ}")
    want = {"blockhash2": planned["card_leaves"], "diffpack": 0,
            "diffunpack": 0, "flashattn": 0}
    log(f"[chaos] matrix on {device}: {report['passed']}/{report['total']} "
        f"passed, data loss {report['data_loss_bytes']} B, max mttr "
        f"{report['max_mttr_s']} s, recovery paths equal the CPU run's; "
        f"{out['matrix_s']:.1f} s with the CPU run")
    log(f"[chaos] kernel launches over the matrix: {out['launches']} "
        f"(expected on the card: {want}: {planned['card_leaves']} card "
        f"leaves in {planned['stores']} FTI stores)")
    if on_card and out["launches"] != want:
        fail("phase 8 launch counts do not match the card leaves of the "
             "matrix's stores")
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)

    # the state of (b) and (c): tinyllama-1.1b's parameters at full width
    n_layers = 22 if on_card else args.layers
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    state = tinyllama_state(torch, n_layers, args.width_div, device, gen)
    sync(torch, device)
    named = flatten_named(state)
    nbytes = sum(v.numel() * v.element_size() for v in named.values())
    gb = nbytes / 1e9
    log(f"[chaos] state: {n_layers} layers, {len(named)} leaves, {gb:.2f} "
        f"GB on {device}")

    # (b) elastic rescale: 4 rank files of axis-0 slices in a committed
    # checkpoint, restored for new worlds of 2 and 3 ranks; a 0-d leaf
    # travels as one row
    root = str(CHAOS_DIR / "elastic")
    rows = {k: (v.reshape(1) if v.dim() == 0 else v) for k, v in named.items()}
    t = time.time()
    d = mf.begin(root, 1)
    for r in range(SHARDS):
        sl, offs, shapes = {}, {}, {}
        for k, v in rows.items():
            lo, hi = shard_bounds(v.shape[0], SHARDS, r)
            sl[k], offs[k], shapes[k] = v[lo:hi], lo, list(v.shape)
        save_sharded(os.path.join(d, f"rank{r}.chk5"), sl, offs, shapes,
                     {"world": SHARDS})
    mf.write_manifest(root, 1, {"kind": "FULL", "level": 4,
                                "world": SHARDS})
    mf.commit(root, 1)
    out["elastic_write_s"] = time.time() - t
    log(f"[chaos] elastic: {SHARDS} rank files written in "
        f"{out['elastic_write_s']:.2f} s "
        f"({gb / out['elastic_write_s']:.2f} GB/s)")
    for world in RESCALE_WORLDS:
        secs = []
        for rank in range(world):
            t = time.time()
            got = rescale_restore([root], world, rank)
            if got is None or got[1] != 1:
                fail(f"elastic: rescale_restore({world}, {rank}) found "
                     f"{got and got[1]}")
            placed = {k: numpy_to_tensor(a, device) for k, a in got[0].items()}
            sync(torch, device)
            secs.append(time.time() - t)
            for k, v in rows.items():
                lo, hi = shard_bounds(v.shape[0], world, rank)
                if k not in placed or not torch.equal(placed[k], v[lo:hi]):
                    fail(f"elastic: world {world} rank {rank}: {k} differs "
                         f"from rows {lo}:{hi} of the source")
            del placed, got
        out[f"elastic_read_s_world{world}"] = secs
        log(f"[chaos] elastic: new world {world}: every rank's rows on "
            f"{device} equal the source's; read + place per rank "
            + ", ".join(f"{s:.2f} s" for s in secs)
            + f" ({gb / sum(secs):.2f} GB/s over the {world} ranks)")
    shutil.rmtree(root, ignore_errors=True)

    # (c) a shard-local FULL through the directives: 4 host chunks per 2-D
    # leaf, 1-D and 0-d leaves as data/, shard_writers 4, FTI level 1
    cfg = CheckpointConfig(dir=str(CHAOS_DIR / "sharded"), backend="fti",
                           dedicated_thread=False, block_bytes=args.block_bytes)
    host = {k: tensor_to_numpy(v) for k, v in named.items() if v.dim() == 2}

    def store_sharded(ckpt_id: int, step) -> float:
        ctx = CheckpointContext(cfg)
        pipe = ctx.tcl.backend.pipeline
        t0 = time.time()
        plan = pipe.plan(StoreRequest(
            named={k: (step if k == "step" else v)
                   for k, v in named.items() if k not in host},
            ckpt_id=ckpt_id, level=1))
        plan.sharded = {}
        for k, a in host.items():
            chunks = []
            for j in range(SHARDS):
                lo, hi = shard_bounds(a.shape[0], SHARDS, j)
                chunks.append(ShardChunk(offset=(lo, 0),
                                         shape=(hi - lo, a.shape[1]),
                                         data=a[lo:hi]))
            plan.sharded[k] = ShardSnapshot(dtype=a.dtype.str,
                                            global_shape=a.shape,
                                            chunks=chunks)
        rep = pipe.finish(plan)
        secs = time.time() - t0
        ctx.shutdown()
        if rep.ckpt_id != ckpt_id or pipe.cfg.shard_writers != SHARDS:
            fail(f"sharded store {ckpt_id}: report {rep}")
        return secs

    def restore():
        template = unflatten_named(
            {k: torch.zeros_like(v) for k, v in named.items()}, state)
        sync(torch, device)
        t0 = time.time()
        ctx = CheckpointContext(cfg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            got = ctx.load(template)
        sync(torch, device)
        secs = time.time() - t0
        ctx.shutdown()
        return got, secs, [str(w.message) for w in caught]

    out["sharded_store_s"] = store_sharded(1, named["step"])
    ck = Path(cfg.dir) / "node-local" / "ckpts" / "ckpt-1"
    n_files = len(list(ck.glob("rank0.shard*.chk5")))
    got, out["sharded_restore_s"], said = restore()
    flat = flatten_named(got)
    bad = [k for k, v in named.items()
           if flat[k].device != v.device or not torch.equal(flat[k], v)]
    if bad or n_files != SHARDS or said:
        fail(f"sharded restore: {len(bad)} leaves differ ({bad[:3]}), "
             f"{n_files} shard files, warnings {said[:2]}")
    del got, flat
    log(f"[chaos] sharded FULL: {len(host)} leaves in {SHARDS} chunks over "
        f"{n_files} shard files + {len(named) - len(host)} data/ leaves, "
        f"stored in {out['sharded_store_s']:.2f} s; a fresh context "
        f"restores it into zeros on {device} bit-exact in "
        f"{out['sharded_restore_s']:.2f} s")
    # a newer sharded id (its step one on) loses a shard file
    store_sharded(2, named["step"] + 1)
    lost = Path(cfg.dir) / "node-local" / "ckpts" / "ckpt-2" / \
        "rank0.shard1.chk5"
    lost.unlink()
    got, _secs, said = restore()
    fell_back = torch.equal(flatten_named(got)["step"], named["step"])
    del got
    if not fell_back or not any("checkpoint 2: incomplete shard set" in m
                                for m in said):
        fail(f"lost shard file of id 2: restored step is id 2's or the walk "
             f"did not say why it fell back ({said})")
    log(f"[chaos] shard file {lost.name} of id 2 deleted: the walk fell back "
        f"to id 1 and said: {said[0]}")
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    del state, named, rows, host
    if on_card:
        torch.cuda.empty_cache()

    # (d) the supervised kill: worker processes on the device, tinyllama
    # at full width on a card, the reduced config here.  The restarted
    # worker writes its launches: flash runs forward and in the remat
    # recompute of every layer, each of the 6 steps it trains
    from repro_torch.configs import get_arch
    cfg = get_arch("tinyllama-1.1b")
    if not on_card:
        cfg = cfg.reduced()
    t = time.time()
    r = run_scenario("supervised-kill", "fti", str(CHAOS_DIR / "sup"),
                     device=device)
    out["supervised_s"] = time.time() - t
    out["mttr_s"] = r.mttr_s
    out["supervised_layers"] = cfg.n_layers
    det = r.detail
    if not (r.ok and det.get("resumed_from_step_6")
            and det.get("exactly_one_restart") and det.get("backoff_paced")
            and det.get("finished") and det.get("feed", {}).get("deaths") == 1):
        fail(f"supervised kill on {device}: {det}")
    want_flash = 2 * cfg.n_layers * RESUMED_STEPS if on_card else 0
    got = det["worker_launches"]
    if len(got) != 1 or got[0]["flashattn"] != want_flash or \
            got[0]["diffpack"] or got[0]["diffunpack"]:
        fail(f"supervised kill: the restarted worker's launches {got}, "
             f"expected flashattn {want_flash} and no diffpack/diffunpack")
    out["worker_launches"] = got[0]
    log(f"[chaos] supervised kill ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {device}): resumed from step 6, one restart, backed "
        f"off, finished at step 12, MTBF feed deaths 1; wall "
        f"{out['supervised_s']:.1f} s, MTTR {r.mttr_s:.2f} s; the restarted "
        f"worker's launches {got[0]} (flashattn expected {want_flash})")
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    return out

# --------------------------------------------------------------------------- #

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layers", type=int, default=22,
                    help="decoder layers of phases 3 and 6, phase 6 at most "
                         f"{OBJSTORE_LAYERS} (a cut of depth; training and "
                         "serving keep all their layers)")
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
        training_path(torch, args, torch.device("cpu"), ops,
                      "tinyllama-1.1b", "train", TRAIN_DIR)
        objstore_path(torch, args, torch.device("cpu"), ops)
        serve_path(torch, args, torch.device("cpu"), ops)
        chaos_path(torch, args, torch.device("cpu"), ops)
        training_path(torch, args, torch.device("cpu"), ops, MOE_ARCH, "moe",
                      MOE_DIR, donate=True)
        mla_path(torch, args, torch.device("cpu"), ops)
        ssm_path(torch, args, torch.device("cpu"), ops)
        training_path(torch, args, torch.device("cpu"), ops, ENCDEC_ARCH,
                      "encdec", ENCDEC_DIR)
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

    t = t_start = time.time()
    sources = ["blockhash2", "diffpack", "diffunpack", "flashattn"]
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
    state, ids2, ids4, launches, _ = main_path(torch, args, device, ops)
    log(f"[phase] directive path: {time.time() - t:.1f} s")
    t = time.time()
    times = time_kernels(torch, state, ids2, ids4, ops, ref, bh, dp,
                         per_word)
    times["flashattn"] = time_flash(torch, device, ref, fa, GQA_SHAPES[0])
    times["flashattn"]["at_moe_shape"] = time_flash(torch, device, ref, fa,
                                                    MOE_GQA_SHAPE)
    times["flashattn"]["at_encdec_shape"] = time_flash(
        torch, device, ref, fa, ENCDEC_GQA_SHAPE)
    log(f"[phase] timing: {time.time() - t:.1f} s")
    del state
    t = time.time()
    train = training_path(torch, args, device, ops, "tinyllama-1.1b",
                          "train", TRAIN_DIR)
    log(f"[phase] checkpointed training: {time.time() - t:.1f} s")
    t = time.time()
    obj = objstore_path(torch, args, device, ops)
    log(f"[phase] object store, incremental, SCR ({obj['depth']} of 22 "
        f"layers): {time.time() - t:.1f} s")
    t = time.time()
    serve_launches = serve_path(torch, args, device, ops)
    log(f"[phase] serve and deploy (deploy at {DEPLOY_LAYERS} of 22 layers): "
        f"{time.time() - t:.1f} s")
    t = time.time()
    chaos = chaos_path(torch, args, device, ops)
    log(f"[phase] chaos matrix, elastic and sharded restore, supervised "
        f"kill: {time.time() - t:.1f} s")
    t = time.time()
    moe = training_path(torch, args, device, ops, MOE_ARCH, "moe", MOE_DIR,
                        donate=True, ranges=MOE_RANGES, layers=MOE_LAYERS)
    log(f"[phase] checkpointed MoE training ({MOE_LAYERS} of 32 layers): "
        f"{time.time() - t:.1f} s")
    t = time.time()
    mla = mla_path(torch, args, device, ops)
    log(f"[phase] MLA serve and resume ({MLA_LAYERS} of 62 layers): "
        f"{time.time() - t:.1f} s")
    t = time.time()
    ssm = ssm_path(torch, args, device, ops)
    log(f"[phase] RWKV6 serve and resume: {time.time() - t:.1f} s")
    t = time.time()
    encdec = training_path(torch, args, device, ops, ENCDEC_ARCH, "encdec",
                           ENCDEC_DIR, batch=ENCDEC_BATCH, seq=ENCDEC_SEQ)
    log(f"[phase] checkpointed encoder-decoder training: "
        f"{time.time() - t:.1f} s")
    log(f"[phase] all phases, the build included: "
        f"{time.time() - t_start:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    # each kernel's launches come from the path that runs it, counted from
    # zero over that path: the directive path (phase 3) for the hash, the
    # pack and the unpack, the training path (phase 5) for attention; every
    # path's own counts stand in launches_by_path
    paths = {"directive": launches, "training": train["launches"],
             "objstore": obj["launches"], "serve": serve_launches,
             "chaos": chaos["launches"],
             "supervised": chaos["worker_launches"],
             "moe": moe["launches"], "mla": mla["launches"],
             "ssm": ssm["launches"], "encdec": encdec["launches"]}
    meta = {
        "blockhash2": ("src/repro_torch/kernels/csrc/blockhash2.cu",
                       "src/repro/kernels/blockhash.py:34", "directive"),
        "diffpack": ("src/repro_torch/kernels/csrc/diffpack.cu",
                     "src/repro/kernels/diffpack.py:22", "directive"),
        "diffunpack": ("src/repro_torch/kernels/csrc/diffunpack.cu",
                       "src/repro/kernels/diffpack.py:45", "directive"),
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
            "layers": args.layers if path == "directive" else 22,
            "layers_by_path": {"directive": args.layers, "training": 22,
                               "objstore": obj["depth"], "serve": 22,
                               "chaos": None,
                               "supervised": chaos["supervised_layers"],
                               "moe": moe["layers"], "mla": mla["layers"],
                               "ssm": ssm["layers"],
                               "encdec": encdec["layers"]}})
        for key in ("at_moe_shape", "at_encdec_shape"):
            if key in r:                 # flashattn at phases 9's and 12's
                kernels[-1][key] = r[key]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

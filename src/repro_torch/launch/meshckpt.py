"""Store a model's parameters from a multi-process mesh, restore them onto
another mesh or another number of processes: the worker that ``python -m
torch.distributed.run`` starts on every rank.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.meshckpt store --mesh 2,2 --dir D --out O
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.meshckpt restore --mesh 2,1 --source-mesh 2,2 \\
        --dir D --out O

``store`` draws the model's parameters from one seed on every rank,
places them on the mesh by the sharding rules (each rank keeps its box)
— with ``--train-steps N``, as the parameters of a ``TrainState`` laid
out by the ZeRO-1 shardings, which N sharded train steps update
(bf16, remat, flash on each rank's local heads, deterministic) — stores
a FULL checkpoint (id 1), updates the global tree in place (each
rank its own part: ``--update sparse`` writes rows of ``embed``, columns
of ``lm_head`` and every norm scale for seeded token ids; ``embed00``
sets ``embed[0, 0] = -3``), stores a DIFF (id 2; a FULL on backends with
no checkpoint kinds), and exits.  ``restore`` restores the newest
checkpoint into zero ``DTensor`` templates of its own mesh, each rank
allocating and reading only its box; with ``--decode-steps N`` it then
decodes from the restored parameters twice — over a cache sharded along
its sequence over the data axis, and over a plain cache on each rank —
after a batched prefill, and holds the first to the second.

Each rank writes ``<out>/<command>-rank<r>.json``: its world's backend
(``process_group``: ``cpu:gloo,cuda:nccl`` where every rank of the
machine has a card of its own, else ``gloo``) and its card (``card``),
store reports, bytes written and exchanged (the checkpoint's host bytes
go over gloo either way), kernel launches, peak device memory, and SHA-256
digests of the state's values per box — for every intersection of a box
the source mesh writes with a box of each ``--targets`` mesh (store), or
of this rank's box with every box the source mesh writes (restore) — so
a restore is checked bit for bit against the source without any global
array.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.context import (
    CHK_DIFF,
    CHK_FULL,
    CheckpointConfig,
    CheckpointContext,
)
from repro_torch.core.diff import MAX_PACK_BYTES, shard_part
from repro_torch.core.formats import CHK5Reader, as_numpy
from repro_torch.core.protect import flatten_named, unflatten_named
from repro_torch.core.resharding import (
    box_owners,
    mesh_boxes,
    reshard_tree,
    shardable,
    sharding_of,
    zeros_onto,
)
from repro_torch.dist.comm import ProcessGroupComm
from repro_torch.dist.context import AbstractMesh, shard_box
from repro_torch.dist.sharding import param_shardings
from repro_torch.kernels import ops
from repro_torch.launch.mesh import join_from_env, leave, make_mesh
from repro_torch.models.zoo import build_model

AXES = ("data", "model")
#: threads that hash box intersections (SHA-256 releases the GIL)
HASH_THREADS = 4


def _shape(text: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in text.split(","))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model(args):
    cfg = get_arch(args.arch)
    return build_model(cfg.reduced() if args.reduced else cfg)


def _abstract_boxes(struct: Dict[str, Any], shape: Sequence[int],
                    ) -> Dict[str, Dict[Tuple[int, ...], Any]]:
    """leaf → mesh coordinate → box, for a mesh of ``shape`` laid out by
    the sharding rules (no process behind it)."""
    mesh = AbstractMesh(tuple(shape), AXES)
    specs = flatten_named(param_shardings(mesh, struct))
    out: Dict[str, Dict[Tuple[int, ...], Any]] = {}
    for p, leaf in struct.items():
        out[p] = {c: shard_box(tuple(leaf.shape), mesh, specs[p].spec, c)
                  for c in np.ndindex(*shape)}
    return out


def _source_boxes(struct: Dict[str, Any], shape: Sequence[int]
                  ) -> Dict[str, List[Any]]:
    """leaf → the distinct boxes a mesh of ``shape`` writes."""
    return {p: sorted(set(b.values()))
            for p, b in _abstract_boxes(struct, shape).items()}


def _intersect(a, b):
    box = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return box if all(hi > lo for lo, hi in box) else None


def _key(path: str, box) -> str:
    return f"{path}|{json.dumps([list(b) for b in box])}"


def _sha(local: np.ndarray, mine, box) -> str:
    rel = tuple(slice(lo - m0, hi - m0) for (lo, hi), (m0, _) in zip(box, mine))
    return hashlib.sha256(np.ascontiguousarray(local[rel]).tobytes()) \
        .hexdigest()


def box_hashes(named: Dict[str, Any], others: Dict[str, List[Any]],
               owned_only: bool) -> Dict[str, str]:
    """``"leaf|box"`` → SHA-256 of this rank's values on every non-empty
    intersection of its box with ``others`` (only of the leaves whose box
    it writes, with ``owned_only``), hashed on a few threads."""
    me = torch.distributed.get_rank()
    tasks = []
    for p, leaf in named.items():
        sh = sharding_of(leaf)
        boxes = mesh_boxes(sh.mesh, sh.spec, leaf.shape)
        if owned_only and box_owners(boxes).get(boxes[me]) != me:
            continue
        local = as_numpy(leaf.to_local())
        for other in others[p]:
            box = _intersect(boxes[me], other)
            if box is not None:
                tasks.append((_key(p, box), local, boxes[me], box))
    with ThreadPoolExecutor(max_workers=HASH_THREADS) as ex:
        return dict(zip([t[0] for t in tasks],
                        ex.map(lambda t: _sha(*t[1:]), tasks)))


def sparse_update(named: Dict[str, Any], seed: int, n_tokens: int = 1024
                  ) -> Dict[str, np.ndarray]:
    """In place, each rank on its own box: +0.5 on the rows of ``embed``
    and the columns of ``lm_head`` of ``n_tokens`` seeded token ids, and
    +0.25 on every norm scale → the token ids."""
    vocab = named["embed"].shape[0]
    ids = torch.randint(0, vocab, (n_tokens,),
                        generator=torch.Generator().manual_seed(seed))
    for path, dim in (("embed", 0), ("lm_head", 1)):
        if path not in named:
            continue
        leaf = named[path]
        sh = sharding_of(leaf)
        lo, hi = shard_box(tuple(leaf.shape), sh.mesh, sh.spec,
                           leaf.device_mesh.get_coordinate())[dim]
        local = leaf.to_local()
        mine = ids[(ids >= lo) & (ids < hi)] - lo
        shape = list(local.shape)
        shape[dim] = mine.numel()
        local.index_add_(dim, mine.to(local.device),
                         torch.full(shape, 0.5, dtype=local.dtype,
                                    device=local.device))
    for path, leaf in named.items():
        if path.endswith("/scale"):
            leaf.to_local().add_(0.25)
    return ids.numpy()


def expected_dirty(struct: Dict[str, Any], ids: np.ndarray,
                   block_bytes: int) -> int:
    """The dirty blocks :func:`sparse_update` leaves, counted on the host
    from the rows and columns it wrote."""
    n = 0
    for path, leaf in struct.items():
        shape = tuple(int(d) for d in leaf.shape)
        isz = leaf.element_size()
        if path == "embed":
            rows = np.unique(ids).astype(np.int64)
            lo = rows * shape[1] * isz // block_bytes
            hi = ((rows + 1) * shape[1] * isz - 1) // block_bytes
            n += len(set(np.concatenate([np.arange(a, b + 1)
                                         for a, b in zip(lo, hi)]).tolist()))
        elif path == "lm_head":
            cols = np.unique(ids).astype(np.int64)
            elems = (np.arange(shape[0], dtype=np.int64)[:, None] * shape[1]
                     + cols[None, :])
            n += np.unique(elems * isz // block_bytes).size
        elif path.endswith("/scale"):
            n += -(-int(np.prod(shape)) * isz // block_bytes)
    return n


def _deltas_in_container(path: str) -> Dict[str, np.ndarray]:
    """Leaf → the dirty block indices of a DIFF container."""
    rd = CHK5Reader(path)
    try:
        return {ds[len("delta/"):-len("/idx")]: rd.read_dataset(ds)
                for ds in rd.datasets()
                if ds.startswith("delta/") and ds.endswith("/idx")}
    finally:
        rd.close()


def designed_launches(named: Dict[str, Any], deltas: Dict[str, np.ndarray],
                      block_bytes: int, stores: int) -> Dict[str, int]:
    """The kernel launches this rank's stores make by design: one
    ``blockhash2`` per store and leaf part hashed (every replicated leaf,
    every sharded leaf whose box this rank writes), and one ``diffpack``
    per group of at most ``MAX_PACK_BYTES`` of the DIFF store's rows — the
    replicated leaves' dirty blocks and this rank's part of each sharded
    leaf's (all of them for a zero-buffered column shard)."""
    me = torch.distributed.get_rank()
    hashed = rows = 0
    for p, leaf in named.items():
        dirty = deltas.get(p, np.zeros(0, np.int64))
        if not shardable(leaf):
            hashed += 1
            rows += dirty.size
            continue
        part = shard_part(p, leaf, block_bytes)
        if part.local is None:
            continue
        hashed += 1
        rows += (np.isin(dirty, part.blocks_of(me)).sum() if part.aligned
                 else dirty.size)
    cap = max(1, MAX_PACK_BYTES // block_bytes)
    return {"blockhash2": stores * hashed,
            "diffpack": -(-int(rows) // cap) if deltas else 0,
            "diffunpack": 0, "flashattn": 0, "flashattn_bwd": 0}


def gloo_cuda_collectives(device: torch.device) -> Dict[str, str]:
    """Which gloo collectives take a tensor on the card: name → "ok" or
    the error (on a group of their own).  DTensor's redistributions use
    the last three.  Asked on gloo worlds only: an NCCL world sends the
    card's tensors over NCCL."""
    import torch.distributed as dist
    group = dist.new_group(backend="gloo")
    t = torch.ones(4, device=device)
    world = dist.get_world_size()
    calls = {
        "all_reduce": lambda: dist.all_reduce(t, group=group),
        "broadcast": lambda: dist.broadcast(t, 0, group=group),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t, group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=device), t, group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(1, device=device),
            torch.ones(world, device=device), group=group),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(world, device=device),
            torch.ones(world, device=device), group=group),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize(device)
            out[name] = "ok"
        except Exception as e:          # the answer, whatever it is
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def _rank_bytes(d: str, rank: int) -> int:
    """Bytes of this rank's files (its container and shard files) in a
    checkpoint dir."""
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if f.startswith(f"rank{rank}.")) if os.path.isdir(d) else 0


def _context(args, comm) -> CheckpointContext:
    return CheckpointContext(CheckpointConfig(
        dir=args.dir, backend=args.backend, block_bytes=args.block_bytes,
        objstore=args.objstore), comm)


def _emit(args, name: str, result: Dict[str, Any]) -> None:
    """Write (or rewrite) this rank's result file."""
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{name}-rank{result['rank']}.json")
    with open(path + ".part", "w") as f:
        json.dump(result, f)
    os.replace(path + ".part", path)


def store(args, device: torch.device, process_group: str) -> Dict[str, Any]:
    rank = torch.distributed.get_rank()
    model = _model(args)
    meta = model.param_struct()
    struct = flatten_named(meta)
    mesh = make_mesh(_shape(args.mesh), AXES, device.type)
    t = time.time()
    seed = args.train_seed if args.train_steps else args.seed
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    out: Dict[str, Any] = {"rank": rank}
    if args.train_steps:
        params, out["train"] = train(args, model, mesh, params, device)
    else:
        params = reshard_tree(params, param_shardings(mesh, meta))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _sync(device)
    out["init_s"] = time.time() - t
    if device.type == "cuda" and process_group == "gloo":
        out["gloo_cuda"] = gloo_cuda_collectives(device)
    comm = ProcessGroupComm(os.path.join(args.dir, "nodes"))
    ctx = _context(args, comm)
    reports: List[Any] = []
    ctx.observe_store_reports(reports.append)
    pipe = ctx.tcl.backend.pipeline
    diff = args.backend == "fti" and args.second == "diff"
    ops.reset_launch_counts()
    stores = []
    for ckpt_id, kind in ((1, CHK_FULL), (2, CHK_DIFF if diff else CHK_FULL)):
        if ckpt_id == 2:
            named = flatten_named(params)
            if args.update == "sparse":
                ids = sparse_update(named, args.seed)
                out["expected_dirty"] = expected_dirty(struct, ids,
                                                       args.block_bytes)
            else:
                leaf = named["embed"]
                sh = sharding_of(leaf)
                if all(lo == 0 for lo, _ in shard_box(
                        tuple(leaf.shape), sh.mesh, sh.spec,
                        leaf.device_mesh.get_coordinate())):
                    leaf.to_local()[0, 0] = -3.0
        if ckpt_id in args.hash_after:
            out[f"hashes_{ckpt_id}"] = box_hashes(
                flatten_named(params), _merge_boxes(struct, args.targets),
                owned_only=True)
            _emit(args, "store", out)       # before a fault can strike
        sent0 = comm.exchanged_bytes
        _sync(device)
        torch.distributed.barrier()         # every rank starts the store
        t = time.time()
        ctx.store(params, id=ckpt_id, level=args.level, kind=kind)
        call_s = time.time() - t
        ctx.wait()
        stores.append({"id": ckpt_id, "kind": kind, "call_s": call_s,
                       "exchanged_bytes": comm.exchanged_bytes - sent0,
                       "inventory": {
                           "host": pipe.last_plan_inventory.get("host", []),
                           "boxes": {p: [[list(o), list(s)] for o, s in b]
                                     for p, b in pipe.last_plan_inventory
                                     .get("boxes", {}).items()}}})
    ctx.shutdown()
    out["launches"] = ops.launch_counts()
    for s, rep in zip(stores, reports):
        s.update(plan_s=rep.plan_seconds, total_s=rep.seconds,
                 kind=rep.kind, bytes_payload=rep.bytes_payload,
                 dirty_ratio=rep.dirty_ratio)
    out["stores"] = stores
    root = pipe.tier_root(args.level)
    out["bytes_written"] = {
        i: _rank_bytes(os.path.join(root, f"ckpt-{i}"), rank) for i in (1, 2)}
    container = os.path.join(root, "ckpt-2", f"rank{rank}.chk5")
    deltas = _deltas_in_container(container) if diff else {}
    if diff:
        out["dirty_blocks"] = int(sum(d.size for d in deltas.values()))
    if args.backend == "fti":           # the backend that keeps digests
        out["designed_launches"] = designed_launches(
            flatten_named(params), deltas, args.block_bytes, stores=2)
    out["shardable"] = sorted(p for p, x in flatten_named(params).items()
                              if shardable(x))
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def train(args, model, mesh, params, device) -> Tuple[Any, Dict[str, Any]]:
    """``args.train_steps`` sharded train steps from ``params`` (the global
    values, the same on every rank): a ``TrainState`` laid out by
    ``train_state_shardings(zero1=True)`` (parameters by the rules,
    moments also sharded over data), the batches of ``next_batch`` from
    ``args.train_seed`` on the data axis → (the trained parameter
    ``DTensor``s, a report: per step the loss, the global gradient norm,
    seconds, flash and flash backward launches, and the last step's
    collectives)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.synthetic import (data_state_struct,
                                            init_data_state, next_batch)
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharding import (batch_sharding,
                                           train_state_shardings)
    from repro_torch.kernels import flashattn as fa
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.state import (init_sharded_train_state, prng_key,
                                         train_state_struct)
    from repro_torch.train.step import (make_train_step,
                                        use_deterministic_algorithms)

    os.environ["REPRO_ATTN_IMPL"] = "flash"
    if device.type == "cuda":
        use_deterministic_algorithms()
    cfg = model.cfg
    struct = train_state_struct(model.param_struct(), data_state_struct())
    sh = train_state_shardings(mesh, struct, zero1=True, fsdp=False)
    state = init_sharded_train_state(params, sh,
                                     prng_key(args.train_seed + 1),
                                     init_data_state(args.train_seed))
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    step_fn = make_train_step(model, AdamWConfig(
        total_steps=args.total_steps, warmup_steps=1), remat=True)
    steps = []
    comm = {}
    with use_mesh(mesh):
        for i in range(args.train_steps):
            batch, next_ds = next_batch(state.data_state, cfg,
                                        args.train_batch, args.train_seq,
                                        device)
            batch = reshard_tree(batch, {k: batch_sharding(mesh, v.ndim)
                                         for k, v in batch.items()})
            last = i == args.train_steps - 1
            debug = CommDebugMode() if last else contextlib.nullcontext()
            _sync(device)
            n0, b0, t0 = fa.LAUNCHES.n, fa.BWD_LAUNCHES.n, time.time()
            with debug:
                state, met = step_fn(state, batch)
            _sync(device)
            steps.append({"step": int(state.step), "s": time.time() - t0,
                          "flash": fa.LAUNCHES.n - n0,
                          "flash_bwd": fa.BWD_LAUNCHES.n - b0,
                          "loss": float(met["loss"]),
                          "grad_norm": float(met["grad_norm"])})
            state = state._replace(data_state=next_ds)
            if last:
                comm = {str(k): v for k, v in debug.get_comm_counts().items()}
    placements = {p: [repr(q) for q in x.placements] for p, x in
                  flatten_named(state.opt.mu).items()}
    report = {"steps": steps, "collectives_last_step": comm,
              "mu_placements": placements,
              "designed_flash_per_step": 2 * cfg.n_layers,
              "designed_flash_bwd_per_step": cfg.n_layers}
    if device.type == "cuda":
        report["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        torch.use_deterministic_algorithms(False)
    return state.params, report


def seq_decode(args, model, params, mesh, device) -> Dict[str, Any]:
    """Decode from the restored ``params`` (replicated over data) on this
    rank, in each compute dtype of ``DECODE_DTYPES``: over a cache of
    ``args.decode_slots`` sequence-sharded on the data axis
    (``cache_shardings(seq_axis_sharded=True)``) and over a plain cache,
    each after a batched prefill of ``args.decode_prompt`` seeded tokens
    (batch 1), then ``args.decode_steps`` steps fed the same seeded tokens
    (not the greedy ones: the store's sparse update lifts 1,024 rows of
    ``embed`` and columns of ``lm_head`` by 0.5, so a greedy run feeds
    itself those tokens, whose logits of ~550 tie in bf16), so each step's
    logits of every run come from the same context.  → per dtype the
    report of :func:`_decode_both`; the bf16 one also holds
    ``kl_own``, each step's KL divergence of the plain bf16 softmax from
    the plain f32 one (bf16's own error on this context)."""
    import dataclasses

    from repro_torch.models.zoo import build_model

    os.environ["REPRO_ATTN_IMPL"] = "flash"
    named = flatten_named(params)
    if any(tuple(x.to_local().shape) != tuple(x.shape)
           for x in named.values()):
        raise ValueError("seq_decode takes parameters every rank holds "
                         "whole (a (data, 1) mesh)")
    plain = unflatten_named({k: x.to_local() for k, x in named.items()},
                            params)
    gen = torch.Generator().manual_seed(args.seed + 7)
    vocab = model.cfg.vocab_size
    prompt = torch.randint(0, vocab, (1, args.decode_prompt),
                           dtype=torch.int32, generator=gen).to(device)
    feed = torch.randint(0, vocab, (args.decode_steps, 1, 1),
                         dtype=torch.int32, generator=gen).to(device)
    other = torch.randint(0, vocab, (1, args.decode_prompt),
                          dtype=torch.int32, generator=gen).to(device)
    out, want = {}, {}
    for dt in DECODE_DTYPES:
        m = build_model(dataclasses.replace(model.cfg, compute_dtype=dt))
        out[dt], want[dt] = _decode_both(args, m, plain, params, mesh,
                                         device, prompt, feed, other)
    out["bfloat16"]["kl_own"] = [kl_div(a, b) for a, b in
                                 zip(want["float32"], want["bfloat16"])]
    return out


#: the decode's compute (and cache) dtypes, each run sharded and plain
DECODE_DTYPES = ("bfloat16", "float32")


def kl_div(want: torch.Tensor, got: torch.Tensor) -> float:
    """KL(softmax(want) ‖ softmax(got)) over the whole row (batch 1), in
    f64 (nats)."""
    lw = torch.log_softmax(want.double().reshape(-1), -1)
    lg = torch.log_softmax(got.double().reshape(-1), -1)
    return float((lw.exp() * (lw - lg)).sum())


def _ulp(x: float, dtype: torch.dtype) -> float:
    """The spacing of ``dtype``'s values at ``x``."""
    x = max(abs(x), torch.finfo(dtype).tiny)
    return torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(x))


def _decode_both(args, model, plain, sharded, mesh, device, prompt, feed,
                 other) -> Tuple[Dict[str, Any], List[torch.Tensor]]:
    """One dtype's plain and sequence-sharded runs after ``prompt``, and a
    plain run after ``other`` (the control) → (the report: per step both
    logits' largest difference, the row's largest logit, whether they are
    within the reference's tolerance, the KL divergences of the sharded
    softmax and of the control's from the plain one, the plain top-two
    margin and the spacing of the dtype's values at the plain top logit,
    both greedy tokens; seconds each way; the collectives of one sharded
    step (no gather of a cache leaf may be among them); the plain run's
    logits)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.core.resharding import zeros_onto
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharding import cache_shardings
    from repro_torch.launch.dryrun import CollectiveRecorder
    from repro_torch.models.layers import cast_floating
    from repro_torch.models.transformer import dtype_of, lm_prefill

    cfg = model.cfg
    cdt = dtype_of(cfg.compute_dtype)
    n, slots = args.decode_prompt, args.decode_slots
    plain, sharded = cast_floating(plain, cdt), cast_floating(sharded, cdt)

    def run(p, caches, token, wrap=lambda x: x):
        """Prefill, then a step for each token of ``feed`` (``wrap``ped as
        the run's tokens are)."""
        out, secs = [], []
        _sync(device)
        t = time.time()
        lm_prefill(p, token, caches, cfg)
        _sync(device)
        prefill_s = time.time() - t
        for i in range(args.decode_steps):
            _sync(device)
            t = time.time()
            logits, caches = model.decode_step(p, wrap(feed[i]), caches,
                                               n + i)
            _sync(device)
            secs.append(time.time() - t)
            out.append((logits.full_tensor() if isinstance(logits, DTensor)
                        else logits).float())
        return out, secs, prefill_s

    with torch.no_grad():
        want, plain_s, plain_prefill = run(
            plain, model.init_caches(1, slots, device=device), prompt)
        control, _, _ = run(plain, model.init_caches(1, slots, device=device),
                            other)
        struct = model.cache_struct(1, slots)
        cshard = cache_shardings(mesh, struct, 1, seq_axis_sharded=True,
                                 protects=model.cache_protects())
        caches = zeros_onto(struct, cshard)

        def replicated(x):
            return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        with use_mesh(mesh):
            got, sharded_s, sharded_prefill = run(sharded, caches,
                                                  replicated(prompt),
                                                  replicated)
            rec = CollectiveRecorder()
            with rec:
                model.decode_step(sharded, replicated(feed[0]), caches,
                                  n + args.decode_steps)
    leaf = flatten_named(caches)
    cache_leaf_bytes = min(x.numel() * x.element_size() // x.shape[0]
                           for x in leaf.values())
    top2 = [torch.topk(b.reshape(-1), 2).values for b in want]
    return {
        "max_abs_diff": [float((a - b).abs().max()) for a, b in
                         zip(got, want)],
        "row_max": [float(b.abs().max()) for b in want],
        "close": all(torch.allclose(a, b, rtol=DECODE_RTOL, atol=DECODE_ATOL)
                     for a, b in zip(got, want)),
        "kl": [kl_div(b, a) for a, b in zip(got, want)],
        "kl_context": [kl_div(b, c) for b, c in zip(want, control)],
        "margin": [float(t[0] - t[1]) for t in top2],
        "top_ulp": [_ulp(float(t[0]), cdt) for t in top2],
        # each step's greedy token, each run's own
        "tokens_sharded": [int(_greedy(x).reshape(-1)[0]) for x in got],
        "tokens_plain": [int(_greedy(x).reshape(-1)[0]) for x in want],
        "step_s_sharded": sharded_s, "step_s_plain": plain_s,
        "prefill_s_sharded": sharded_prefill,
        "prefill_s_plain": plain_prefill,
        "collectives": rec.counts,
        "cache_gathers": [d for d in rec.details if d[0] == "all-gather"
                          and d[1] >= cache_leaf_bytes],
        "cache_placements": {k: [repr(q) for q in x.placements]
                             for k, x in leaf.items()},
        "cache_dtype": str(next(iter(leaf.values())).dtype),
    }, want


#: the sequence-sharded decode's hold to the plain one (the reference's
#: ``tests/test_distributed_decode.py`` tolerance)
DECODE_RTOL, DECODE_ATOL = 5e-2, 2e-2


def _greedy(logits) -> torch.Tensor:
    from repro_torch.serve.engine import gather_vocab
    return torch.argmax(gather_vocab(logits[:, -1:]), dim=-1).to(
        torch.int32)


def _merge_boxes(struct: Dict[str, Any], meshes: Sequence[Tuple[int, ...]]
                 ) -> Dict[str, List[Any]]:
    out: Dict[str, set] = {p: set() for p in struct}
    for shape in meshes:
        for p, boxes in _source_boxes(struct, shape).items():
            out[p].update(boxes)
    return {p: sorted(b) for p, b in out.items()}


def restore(args, device: torch.device, shape: Tuple[int, ...]
            ) -> Dict[str, Any]:
    rank = torch.distributed.get_rank()
    model = _model(args)
    struct = model.param_struct()
    mesh = make_mesh(shape, AXES, device.type)
    shardings = param_shardings(mesh, struct)
    template = zeros_onto(struct, shardings)
    comm = ProcessGroupComm(os.path.join(args.dir, "nodes"))
    ctx = _context(args, comm)
    ops.reset_launch_counts()
    _sync(device)
    t = time.time()
    got = ctx.load(template)
    _sync(device)
    out: Dict[str, Any] = {"rank": rank, "mesh": list(shape),
                           "restore_s": time.time() - t,
                           "restarted": ctx.restarted,
                           "launches": ops.launch_counts()}
    ctx.shutdown()
    named, want = flatten_named(got), flatten_named(template)
    out["placements_kept"] = all(
        named[p].placements == want[p].placements
        and named[p].device_mesh == want[p].device_mesh for p in want)
    # every rank checks its own values, replicas included
    out["hashes"] = box_hashes(
        named, _source_boxes(flatten_named(struct), _shape(args.source_mesh)),
        owned_only=False)
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if args.decode_steps and shape[1] == 1:
        out["decode"] = seq_decode(args, model, got, mesh, device)
    return out


def compare(store_results: Sequence[Dict[str, Any]],
            restore_results: Sequence[Dict[str, Any]],
            after: int = 2) -> int:
    """Every restore rank's box hashes against the source's (from the
    store ranks' results) → the number of boxes compared; raises on any
    mismatch or any box the source did not hash."""
    source: Dict[str, str] = {}
    for r in store_results:
        source.update(r[f"hashes_{after}"])
    n = 0
    for r in restore_results:
        for key, h in r["hashes"].items():
            if key not in source:
                raise AssertionError(f"rank {r['rank']}: no source hash "
                                     f"for {key}")
            if source[key] != h:
                raise AssertionError(f"rank {r['rank']}: {key} differs "
                                     "from the source")
            n += 1
    return n


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("command", choices=("store", "restore"))
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's small same-family config")
    ap.add_argument("--mesh", default="2,2",
                    help="data,model; restore: ';'-joined meshes, restored "
                         "one after another")
    ap.add_argument("--source-mesh", default="2,2",
                    help="restore: the mesh the checkpoint was stored from")
    ap.add_argument("--targets", default="1,4;2,1",
                    help="store: the meshes a restore will check, ';'-joined")
    ap.add_argument("--hash-after", default="2",
                    help="store: hash the state before these ids' stores")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="fti")
    ap.add_argument("--level", type=int, default=1)
    ap.add_argument("--objstore", action="store_true",
                    help="compose the object store at level 4 (its bucket "
                         "under <dir>/objstore)")
    ap.add_argument("--block-bytes", type=int, default=65_536)
    ap.add_argument("--update", default="sparse",
                    choices=("sparse", "embed00"))
    ap.add_argument("--second", default="diff", choices=("diff", "full"),
                    help="store: the kind of the second store (a DIFF only "
                         "where the backend has checkpoint kinds)")
    ap.add_argument("--then-restore", default="",
                    help="store: ';'-joined meshes to restore onto in the "
                         "same processes afterwards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=0,
                    help="store: sharded train steps before the stores")
    ap.add_argument("--train-seed", type=int, default=0,
                    help="store: the seed of the parameters, the rng and "
                         "the data cursor of a trained state")
    ap.add_argument("--train-batch", type=int, default=4)
    ap.add_argument("--train-seq", type=int, default=2048)
    ap.add_argument("--total-steps", type=int, default=3,
                    help="store: AdamW's schedule length (warm-up 1)")
    ap.add_argument("--decode-steps", type=int, default=0,
                    help="restore onto a (data, 1) mesh: greedy steps of "
                         "the sequence-sharded decode after the restore")
    ap.add_argument("--decode-prompt", type=int, default=1536)
    ap.add_argument("--decode-slots", type=int, default=2048)
    t_main = time.time()
    args = ap.parse_args(argv)
    args.targets = [_shape(t) for t in args.targets.split(";") if t]
    args.hash_after = [int(x) for x in args.hash_after.split(",") if x]
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("meshckpt: no card (pass --device cpu)")
    _rank, _world, device, process_group = join_from_env(args.device)
    # wall-clock marks (time.time()): the launcher's start-up is what comes
    # before "main", the join what comes before "joined"
    timeline = {"main": t_main, "joined": time.time()}
    world = {"process_group": process_group, "card": device.index}
    meshes = args.mesh
    if args.command == "store":
        result = store(args, device, process_group)
        result.update(world, timeline=dict(timeline, done=time.time()))
        _emit(args, "store", result)
        args.source_mesh, meshes = args.mesh, args.then_restore
    for text in filter(None, meshes.split(";")):
        shape = _shape(text)
        result = restore(args, device, shape)
        result.update(world, timeline=dict(timeline, done=time.time()))
        _emit(args, "restore-" + "x".join(map(str, shape)), result)
    leave()


if __name__ == "__main__":
    main()

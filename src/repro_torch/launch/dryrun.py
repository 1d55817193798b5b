"""Multi-pod dry-run: trace every (arch × shape) cell's sharded step on
the production mesh, with no device, and extract its memory, FLOPs and
collectives for the roofline tables.

The reference forces 512 host devices and has XLA lower and compile the
step.  The port builds a ``"fake"`` process group of 256 (16 × 16) or 512
(2 × 16 × 16) ranks in one process and runs the same sharded step (train,
prefill or decode) on rank 0's local shapes under ``FakeTensorMode``:
every tensor is a shape without storage, every collective a no-op that is
still recorded.

- FLOPs: ``FlopCounterMode``'s formulas on every local operator (the
  flash forward's by a formula of its own; it runs as a shape-only fake
  operator, never as the plain version);
- collectives, their counts and bytes: ``CommDebugMode`` and a recorder of
  the functional collectives' tensors (the reference parses HLO text);
- peak memory: ``torch.distributed._tools.mem_tracker.MemTracker``;
- bytes accessed: every operator's input and output bytes.

The recorder (:class:`CollectiveRecorder`) is the trace's counter and
lives here with it; the mesh worker (``launch/meshckpt.py``) and the
multi-process tests use it to count one step's collectives on a real
world.  The ``TrainState`` layouts are the sharding layer's
(``dist.sharding.train_state_shardings``); ``_build_shardings`` keeps the
reference's name over them.

The JSON report has the reference's keys; ``compile_seconds`` holds the
trace's time and ``hlo_diagnostics`` the trace's counts under the same
names.  The analytic model (``roofline/analytic.py``) gives the primary
roofline terms, as in the reference.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out reports/dryrun]
  (--all spawns one subprocess per cell for isolation/progress persistence)

Perf knobs:
  --zero1          shard optimizer moments over the data axes (ZeRO-1)
  --fsdp           additionally shard parameters over data (weight gather)
  --dp-only        no tensor parallelism: the model axis is more data
  --param-dtype    bfloat16|float32 parameter storage
  --moe-dispatch   einsum|scatter
  --no-remat       disable activation checkpointing
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.context import is_dtensor

#: report names of the functional collectives, as the reference's HLO ops
_COLLECTIVE_NAMES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _build_shardings(mesh, model, state_struct, zero1: bool, fsdp: bool,
                     dp_only: bool = False):
    """TrainState shardings: params per rules (+FSDP), moments (+ZeRO-1);
    the reference's name and signature over
    :func:`repro_torch.dist.sharding.train_state_shardings`."""
    from repro_torch.dist.sharding import train_state_shardings
    return train_state_shardings(mesh, state_struct, zero1, fsdp, dp_only)


class _FakeState:
    """Adapter so _build_shardings can shard bare params."""

    def __init__(self, params):
        from repro_torch.data.synthetic import data_state_struct
        from repro_torch.train.optimizer import AdamWState
        s = torch.empty((), dtype=torch.int32, device="meta")
        self.params = params
        self.opt = AdamWState(s, params, params)
        self.step = s
        self.rng = torch.empty((2,), dtype=torch.uint32, device="meta")
        self.data_state = data_state_struct()


# --------------------------------------------------------------------------- #
# the fake world and what a trace records
# --------------------------------------------------------------------------- #


def fake_world(world: int) -> None:
    """This process as rank 0 of a ``"fake"`` process group of ``world``
    ranks (collectives return at once, moving nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


class CollectiveRecorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Per rank: each functional collective's bytes and modeled wire bytes
    (ring: all-gather out·(n−1)/n, reduce-scatter out·(n−1), all-reduce
    2·out·(n−1)/n, all-to-all out·(n−1)/n; the reference's model), every
    local operator's input and output bytes ("bytes accessed") and its
    FLOPs by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``).  An operator on
    ``DTensor`` operands (global shapes) is not counted: the local
    operators it runs on each rank's shards are.  (``FlopCounterMode``
    itself, stacked with DTensor under autograd, counts both.)"""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops = 0
        self.counts: Dict[str, int] = {}
        self.out_bytes: Dict[str, int] = {}
        self.wire = 0.0
        #: (op, output bytes, group size, output shape) of each collective
        self.details: list = []

    @staticmethod
    def _nbytes(tree) -> int:
        return sum(x.numel() * x.element_size()
                   for x in torch.utils._pytree.tree_leaves(tree)
                   if isinstance(x, torch.Tensor))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name.startswith("_c10d_functional::"):
            op = _COLLECTIVE_NAMES.get(name.split("::", 1)[1])
            if op is not None:
                self._collective(op, args, out)
            return out
        leaves = [x for x in torch.utils._pytree.tree_leaves((args, kwargs))
                  if isinstance(x, torch.Tensor)]
        if any(is_dtensor(x) for x in leaves):
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name.startswith("aten::") and func not in _FREE:
            self.bytes += self._nbytes(args) + self._nbytes(kwargs) \
                + self._nbytes(out)
        return out

    def _collective(self, op: str, args, out) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(args[-1]).size()
        if group <= 1:
            return
        nbytes = self._nbytes(out)
        frac = (group - 1) / group
        self.counts[op] = self.counts.get(op, 0) + 1
        self.out_bytes[op] = self.out_bytes.get(op, 0) + nbytes
        self.details.append((op, nbytes, group, tuple(out.shape)))
        self.wire += {"all-reduce": 2.0 * nbytes * frac,
                      "all-gather": nbytes * frac,
                      "reduce-scatter": float(nbytes * (group - 1)),
                      "all-to-all": nbytes * frac}[op]


#: operators that move no bytes (views, metadata)
_FREE = {getattr(torch.ops.aten, n).default for n in (
    "view", "_unsafe_view", "t", "transpose", "permute", "expand",
    "unsqueeze", "squeeze", "select", "slice", "detach", "alias",
    "as_strided", "split", "unbind") if hasattr(getattr(torch.ops.aten, n),
                                                 "default")}


@contextlib.contextmanager
def _unrecorded_propagation():
    """DTensor derives a new operator's output shape by running it once at
    the global shape on fake tensors, under every dispatch mode, so the
    counters and the memory tracker would take each layer's first
    operators for a rank's work at the global size.  Within this context
    those runs happen under a fake mode of their own with no other mode
    active: only the local operators are recorded."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes(), FakeTensorMode():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _register_flash_flops() -> None:
    """The flash forward's FLOPs for ``FlopCounterMode``: 4·B·H·S·Sk·dh
    (the two products of a dense attention, as ``sdpa_flop`` counts)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    op = torch.ops.repro_torch.flash_attention_fwd
    if op in flop_registry:
        return

    @register_flop_formula(op)
    def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                     **kwargs) -> int:
        b, s, h, dh = q_shape
        return 4 * b * h * s * k_shape[1] * dh


# --------------------------------------------------------------------------- #
# one cell
# --------------------------------------------------------------------------- #


def _mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(n) for n in shape)


def _fake_tree(struct: Any, shardings: Any) -> Any:
    from repro_torch.core.resharding import zeros_onto
    return zeros_onto(struct, shardings)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             zero1: bool = False, fsdp: bool = False,
             dp_only: bool = False,
             param_dtype: Optional[str] = None,
             moe_dispatch: Optional[str] = None,
             remat: bool = True,
             q_block: Optional[int] = None,
             out_path: Optional[str] = None,
             verbose: bool = True,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             reduced: bool = False) -> Dict[str, Any]:
    """Trace one cell.  ``mesh_shape`` (with ``("pod",)`` + data, model
    axes when it has three dims) replaces the production mesh and
    ``reduced`` takes the architecture's small config: the tests' cells.
    ``q_block`` is accepted for the reference's signature and unused, as
    there."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import SHAPE_BY_NAME, get_arch
    from repro_torch.core.protect import flatten_named
    from repro_torch.data.synthetic import data_state_struct, init_data_state
    from repro_torch.dist.context import (
        NamedSharding,
        P,
        axis_sizes,
        constraint_hints,
        data_axes,
        use_mesh,
    )
    from repro_torch.dist.sharding import batch_sharding, cache_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import _attn_impl
    from repro_torch.models.zoo import batch_struct, build_model
    from repro_torch.roofline.analyze import build_report
    from repro_torch.serve.engine import gather_vocab, make_serve_step
    from repro_torch.roofline.analytic import analytic_report
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.state import TrainState, prng_key, \
        train_state_struct
    from repro_torch.train.step import make_train_step

    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    if param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    if moe_dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch))
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    names = ("pod", "data", "model") if len(mesh_shape) == 3 else \
        ("data", "model")
    mesh_name = _mesh_name(mesh_shape)
    shape = SHAPE_BY_NAME[shape_name]
    if shape not in cfg.shapes():
        out = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped",
               "reason": "full-attention arch: long-context decode N/A "
                         "(DESIGN.md §5)"}
        _write(out, out_path)
        return out

    model = build_model(cfg)
    chips = math.prod(mesh_shape)
    fake_world(chips)
    mesh = make_mesh(mesh_shape, names, "cpu")
    sizes = axis_sizes(mesh)
    _register_flash_flops()
    t0 = time.time()

    def _batch_shard(ndim: int):
        if not dp_only:
            return batch_sharding(mesh, ndim)
        # greedy: extend the batch axes only while the batch stays divisible
        axes: list = []
        n = 1
        for a in ("pod", "data", "model"):
            if a in names and shape.global_batch % (n * sizes[a]) == 0:
                axes.append(a)
                n *= sizes[a]
        if not axes:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(tuple(axes), *([None] * (ndim - 1))))

    hint_ctx = constraint_hints(not dp_only) if dp_only else \
        contextlib.nullcontext()
    comm = CommDebugMode()
    rec = CollectiveRecorder()
    tracker = MemTracker()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    rng = prng_key(0)            # host bookkeeping: real values
    with use_mesh(mesh), hint_ctx, fake:
        if shape.kind == "train":
            struct = train_state_struct(model.param_struct(),
                                        data_state_struct())
            sh = _build_shardings(mesh, model, struct, zero1, fsdp,
                                  dp_only=dp_only)
            bstruct = batch_struct(cfg, shape.global_batch, shape.seq_len)
            inputs = (
                TrainState(
                    step=torch.zeros((), dtype=torch.int32),
                    params=_fake_tree(struct.params, sh.params),
                    opt=struct.opt._replace(
                        count=torch.zeros((), dtype=torch.int32),
                        mu=_fake_tree(struct.opt.mu, sh.opt.mu),
                        nu=_fake_tree(struct.opt.nu, sh.opt.nu)),
                    rng=rng, data_state=init_data_state(0)),
                _fake_tree(bstruct, {k: _batch_shard(s.ndim)
                                     for k, s in bstruct.items()}))
            run = make_train_step(model, AdamWConfig(), remat=remat)
        elif shape.kind == "prefill":
            pstruct = model.param_struct()
            pshard = _build_shardings(
                mesh, model, _FakeState(pstruct), zero1=False,
                fsdp=fsdp).params
            bstruct = batch_struct(cfg, shape.global_batch, shape.seq_len)
            bstruct.pop("labels")
            inputs = (_fake_tree(pstruct, pshard),
                      _fake_tree(bstruct, {k: batch_sharding(mesh, s.ndim)
                                           for k, s in bstruct.items()}))

            def run(params, batch):
                with torch.no_grad():
                    logits, _ = model.forward(params, batch, remat=False)
                    return torch.argmax(gather_vocab(logits[:, -1]), dim=-1)
        else:  # decode
            pstruct = model.param_struct()
            pshard = _build_shardings(
                mesh, model, _FakeState(pstruct), zero1=False,
                fsdp=fsdp).params
            cstruct = model.cache_struct(shape.global_batch, shape.seq_len)
            seq_sharded = shape.global_batch == 1
            cshard = cache_shardings(mesh, cstruct, shape.global_batch,
                                     seq_axis_sharded=seq_sharded,
                                     protects=model.cache_protects())
            tstruct = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                  device="meta")
            tshard = batch_sharding(
                mesh, 2, batch_divisible=shape.global_batch > 1)
            inputs = (_fake_tree(pstruct, pshard), _fake_tree(
                {"t": tstruct}, {"t": tshard})["t"],
                _fake_tree(cstruct, cshard))
            serve_step = make_serve_step(model)

            def run(params, token, caches):
                with torch.no_grad():
                    return serve_step(params, token, caches, 0)

        arg_bytes = _local_bytes(inputs)
        compile_t0 = time.time()
        with _unrecorded_propagation(), rec, tracker, comm:
            result = run(*inputs)
        compile_s = time.time() - compile_t0
        out_bytes = _local_bytes(result)

    peak = sum(int(d.get("Total", 0)) for d in
               tracker.get_tracker_snapshot("peak").values())
    mem_detail = {
        "temp_size_in_bytes": None if peak is None else peak - arg_bytes,
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": 0,
    }
    total_flops = float(rec.flops)
    rep = build_report(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
        cost={"flops": total_flops, "bytes accessed": float(rec.bytes)},
        hlo_text="", model_flops_total=cfg.model_flops(shape),
        peak_memory=peak)
    hlo_diag = rep.to_dict()

    dp = math.prod(sizes[a] for a in data_axes(mesh))
    tp = sizes.get("model", 1)
    if dp_only:
        dp, tp = min(dp * tp, shape.global_batch), 1
    ana = analytic_report(cfg, shape, dp=dp, tp=tp, remat=remat,
                          zero1=zero1, fsdp=fsdp)

    out = dict(ana)
    out.update(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        status="ok", compile_seconds=compile_s,
        total_seconds=time.time() - t0, memory=mem_detail,
        peak_memory_per_device=peak,
        hlo_diagnostics={
            "flops_body_once": hlo_diag["flops_per_device"],
            "bytes_body_once": hlo_diag["bytes_per_device"],
            "wire_body_once": rec.wire,
            "collectives": {"counts": dict(rec.counts),
                            "out_bytes": dict(rec.out_bytes),
                            "comm_debug_counts": {
                                str(k): v for k, v in
                                comm.get_comm_counts().items()}},
        },
        attention={"impl": _attn_impl(),
                   "flash": "shape-only fake operator; FLOPs by formula"
                   if _attn_impl() == "flash" else "not used"},
        knobs={"zero1": zero1, "fsdp": fsdp, "dp_only": dp_only,
               "param_dtype": param_dtype or cfg.param_dtype,
               "moe_dispatch": moe_dispatch, "remat": remat})
    if verbose:
        print(json.dumps({k: out[k] for k in (
            "arch", "shape", "mesh", "bottleneck", "t_compute", "t_memory",
            "t_collective", "roofline_fraction", "useful_flops_ratio")},
            indent=1))
    _write(out, out_path)
    return out


def _local_bytes(tree: Any) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    from repro_torch.dist.context import is_dtensor
    total = 0
    for x in torch.utils._pytree.tree_leaves(tree):
        if is_dtensor(x):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _write(out: Dict[str, Any], out_path: Optional[str]) -> None:
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1, default=float)


def _all_cells(args) -> int:
    from repro_torch.configs import ALL_ARCHS, ALL_SHAPES
    failures = []
    for arch in ALL_ARCHS:
        for shape in [s.name for s in ALL_SHAPES]:
            for mp in ([False, True] if args.both_meshes else [args.multi_pod]):
                mesh_name = "multi" if mp else "single"
                out = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_name}.json")
                if os.path.exists(out) and not args.force:
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out-file", out]
                if mp:
                    cmd.append("--multi-pod")
                for flag in ("zero1", "fsdp"):
                    if getattr(args, flag):
                        cmd.append(f"--{flag}")
                if args.param_dtype:
                    cmd += ["--param-dtype", args.param_dtype]
                print(f"=== {arch} × {shape} × {mesh_name}", flush=True)
                r = subprocess.run(cmd, capture_output=True, text=True)
                if r.returncode != 0:
                    failures.append((arch, shape, mesh_name))
                    print(r.stdout[-2000:])
                    print(r.stderr[-3000:])
    print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--dp-only", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--param-dtype")
    ap.add_argument("--moe-dispatch")
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--out-file")
    args = ap.parse_args()

    if args.all:
        return _all_cells(args)
    assert args.arch and args.shape, "--arch/--shape or --all"
    out = run_cell(args.arch, args.shape, args.multi_pod,
                   zero1=args.zero1, fsdp=args.fsdp, dp_only=args.dp_only,
                   param_dtype=args.param_dtype,
                   moe_dispatch=args.moe_dispatch,
                   remat=not args.no_remat,
                   out_path=args.out_file)
    return 0 if out.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())

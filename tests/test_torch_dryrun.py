"""The port's dry-run against the JAX package's, on the CPU.

- ``_build_shardings`` (rules, ZeRO-1, FSDP, dp-only) gives the
  reference's spec for every leaf of the ``TrainState``, on
  ``AbstractMesh`` (16, 16) and (2, 16, 16), for every architecture.
- ``run_cell`` traces a train, a prefill and a decode cell of a reduced
  model on a fake (4, 4) world (one process, a ``"fake"`` process group,
  ``FakeTensorMode``; no device, no jax) and writes the reference's report
  keys, with counted FLOPs, collectives and a peak.  It runs in a
  subprocess with ``sys.modules["jax"] = None``, so the fake process group
  never outlives it.
- The dry-run's inputs (``train_state_struct``, ``data_state_struct``,
  ``batch_struct``) have the reference's paths, shapes and dtypes;
  ``make_dummy_batch`` and ``make_fused_data_train_step``.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ALL_ARCHS
from repro_torch.core.protect import flatten_named
from repro_torch.data.synthetic import data_state_struct
from repro_torch.dist.context import AbstractMesh
from repro_torch.launch.dryrun import _build_shardings
from repro_torch.models.zoo import build_model
from repro_torch.train.state import train_state_struct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
KNOBS = [dict(zero1=False, fsdp=False), dict(zero1=True, fsdp=False),
         dict(zero1=False, fsdp=True), dict(zero1=True, fsdp=True),
         dict(zero1=False, fsdp=False, dp_only=True),
         dict(zero1=True, fsdp=False, dp_only=True)]


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module; its import sets ``XLA_FLAGS`` (512
    host devices) for jax's first start, which this process's jax has
    had: the variable is put back so no later subprocess inherits it."""
    prev = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as rd
    if prev is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = prev
    return rd


def _norm(spec) -> tuple:
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = None if not e else e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_build_shardings_equal_reference(ref_dryrun, arch):
    from jax.sharding import AbstractMesh as JAbstractMesh
    from repro.configs import get_arch as jget_arch
    from repro.core.protect import flatten_named as jflatten
    from repro.data.synthetic import data_state_struct as jdata_struct
    from repro.models.zoo import build_model as jbuild
    from repro.train.state import train_state_struct as jstate_struct
    from repro_torch.configs import get_arch

    jmodel, model = jbuild(jget_arch(arch)), build_model(get_arch(arch))
    jstruct = jstate_struct(jmodel.param_struct(), jdata_struct())
    struct = train_state_struct(model.param_struct(), data_state_struct())
    n = 0
    for sizes, names in MESHES:
        jmesh = JAbstractMesh(sizes, names)
        mesh = AbstractMesh(sizes, names)
        for knobs in KNOBS:
            want, _ = jflatten(ref_dryrun._build_shardings(
                jmesh, jmodel, jstruct, **knobs))
            got = flatten_named(_build_shardings(mesh, model, struct,
                                                 **knobs))
            assert list(got) == list(want), (arch, sizes, knobs)
            for k in want:
                assert _norm(got[k].spec) == _norm(want[k].spec), (
                    arch, sizes, knobs, k, got[k].spec, want[k].spec)
                n += 1
    assert n > 0


_CELLS = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.launch.dryrun import run_cell
out = {}
for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
    out[shape] = run_cell("tinyllama-1.1b", shape, False, zero1=True,
                          mesh_shape=(4, 4), reduced=True, verbose=False,
                          out_path=sys.argv[1] + f"/{shape}.json")
print(json.dumps({k: v["status"] for k, v in out.items()}))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun"))
    r = subprocess.run([sys.executable, "-c", _CELLS, d], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=SRC,
                                OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return {s: json.load(open(f"{d}/{s}.json"))
            for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")}


def _ref_keys() -> set:
    from repro.configs import SHAPE_BY_NAME, get_arch as jget_arch
    from repro.roofline.analytic import analytic_report
    ana = analytic_report(jget_arch("tinyllama-1.1b").reduced(),
                          SHAPE_BY_NAME["train_4k"], dp=4, tp=4)
    return set(ana) | {"arch", "shape", "mesh", "chips", "status",
                       "compile_seconds", "total_seconds", "memory",
                       "peak_memory_per_device", "hlo_diagnostics", "knobs"}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_writes_the_reference_report(cells, shape):
    """A fake (4, 4) world traces each kind of step: the report holds
    every key of the reference's, with the reference's memory and
    diagnostics keys, counted FLOPs, a peak, and the trace's time."""
    out = cells[shape]
    assert out["status"] == "ok" and out["mesh"] == "4x4"
    assert out["chips"] == 16
    assert _ref_keys() <= set(out), _ref_keys() - set(out)
    assert set(out["memory"]) == {
        "temp_size_in_bytes", "argument_size_in_bytes",
        "output_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes"}
    diag = out["hlo_diagnostics"]
    assert set(diag) == {"flops_body_once", "bytes_body_once",
                         "wire_body_once", "collectives"}
    assert diag["flops_body_once"] > 0 and diag["bytes_body_once"] > 0
    assert out["peak_memory_per_device"] > out["memory"][
        "argument_size_in_bytes"] > 0
    assert out["compile_seconds"] > 0
    assert out["knobs"]["zero1"] is True


def test_train_cell_counts_the_sharded_step(cells):
    """The train cell's trace is rank 0's share of a (4, 4) step: its
    FLOPs within 0.8–1.25 of the analytic model's per device (the
    calibration band), and its collectives are the data-parallel
    gradient reduction and the tensor-parallel products'."""
    out = cells["train_4k"]
    ratio = out["flops_per_device"] / out["hlo_diagnostics"][
        "flops_body_once"]
    assert 0.8 < ratio < 1.25, ratio
    counts = out["hlo_diagnostics"]["collectives"]["counts"]
    assert counts.get("reduce-scatter", 0) > 0          # ZeRO-1 gradients
    assert counts.get("all-gather", 0) > 0              # ... and params
    assert out["hlo_diagnostics"]["wire_body_once"] > 0


def test_long_context_cell_skipped_on_full_attention(cells):
    out = cells["long_500k"]
    assert out["status"] == "skipped" and out["mesh"] == "4x4"


# --------------------------------------------------------------------------- #
# the dry-run's inputs against the reference's
# --------------------------------------------------------------------------- #


def _ref_named(tree) -> dict:
    from repro.core.protect import flatten_named as jflatten
    named, _ = jflatten(tree)
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in named.items()}


def _port_named(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flatten_named(tree).items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_state_and_batch_structs_equal_reference(arch):
    """``train_state_struct`` (with ``data_state_struct``) and
    ``batch_struct``: the reference's leaf paths, shapes and dtypes."""
    from repro.configs import get_arch as jget_arch
    from repro.data.synthetic import data_state_struct as jdata_struct
    from repro.models.zoo import batch_struct as jbatch_struct
    from repro.models.zoo import build_model as jbuild
    from repro.train.state import train_state_struct as jstate_struct
    from repro_torch.configs import get_arch
    from repro_torch.models.zoo import batch_struct

    jcfg, cfg = jget_arch(arch), get_arch(arch)
    want = _ref_named(jstate_struct(jbuild(jcfg).param_struct(),
                                    jdata_struct()))
    got = _port_named(train_state_struct(build_model(cfg).param_struct(),
                                         data_state_struct()))
    assert got == want
    assert _port_named(batch_struct(cfg, 8, 512)) == _ref_named(
        jbatch_struct(jcfg, 8, 512))


def test_dummy_batch_and_fused_data_step():
    """``make_dummy_batch`` fills ``batch_struct``'s shapes (tokens in the
    vocab); the fused-data step is ``make_train_step``'s, with the data
    cursor advanced past the batch."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import init_data_state
    from repro_torch.models.zoo import make_dummy_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.state import init_train_state, prng_key
    from repro_torch.train.step import (make_fused_data_train_step,
                                        make_train_step)

    cfg = get_arch("tinyllama-1.1b").reduced()
    batch = make_dummy_batch(cfg, 2, 32)
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        "tokens": (2, 32), "labels": (2, 32)}
    assert 0 <= int(batch["tokens"].min()) <= int(batch["tokens"].max()) \
        < cfg.vocab_size
    model = build_model(cfg)

    def state():
        return init_train_state(model.init(torch.Generator().manual_seed(0)),
                                prng_key(1), init_data_state(3))
    a, _ = make_train_step(model, AdamWConfig())(state(), batch)
    b, _ = make_fused_data_train_step(model, AdamWConfig(), 2, 32)(state(),
                                                                  batch)
    assert int(b.data_state.position) == 1 and int(b.data_state.seed) == 3
    assert all(torch.equal(x, y) for x, y in zip(
        flatten_named(a.params).values(), flatten_named(b.params).values()))

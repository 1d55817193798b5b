"""The port's examples and its serving launcher, run as a user runs them,
with ``--device cpu`` in a subprocess (their default device is ``cuda``);
the four that mirror the reference's clause, portability, telemetry and
training programs also against those programs' bodies in this process."""
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def run(args, cwd=ROOT, timeout=240, env=ENV):
    out = subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr


def test_quickstart_runs_and_restarts(tmp_path):
    args = [str(ROOT / "examples" / "torch_quickstart.py"), "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "qs")]
    rc, out, err = run(args)
    assert rc == 0, err[-3000:]
    assert "done at step 50, w[0]=5.00 on cpu" in out
    assert "transparent restart" not in out
    rc, out, err = run(args)
    assert rc == 0, err[-3000:]
    assert "transparent restart: resuming from step 50" in out


def test_differential_demo_ships_a_delta_and_promotes(tmp_path):
    rc, out, err = run([str(ROOT / "examples" / "torch_differential_demo.py"),
                        "--device", "cpu", "--ckpt-dir", str(tmp_path / "dd")])
    assert rc == 0, err[-3000:]
    assert "id=2 DIFF" in out and "promoted=True" in out
    assert "replayed restore exact on cpu" in out


def test_serve_resilient_resumes_without_prefill(tmp_path):
    rc, out, err = run([str(ROOT / "examples" / "torch_serve_resilient.py"),
                        "--device", "cpu", "--ckpt-dir", str(tmp_path / "sr")])
    assert rc == 0, err[-3000:]
    assert "server 2 resumed at pos 22" in out
    assert "resumed continuation matches uninterrupted generation" in out


def test_serve_launcher_kill_and_resume(tmp_path):
    """``python -m repro_torch.launch.serve --device cpu``: a run killed
    after 12 tokens (its last store at 8), then a rerun that resumes at
    the stored position without prefill and finishes."""
    base = ["-m", "repro_torch.launch.serve", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "sv"), "--gen", "20"]
    rc, out, err = run(base + ["--kill-after", "12"])
    assert rc == 39, err[-3000:]
    assert "simulated failure after 12 tokens" in out
    rc, out, err = run(base)
    assert rc == 0, err[-3000:]
    assert "resumed at pos 24" in out and "generated 12 tokens/req" in out


def test_serve_launcher_follows_the_catalog(tmp_path):
    """``--follow-catalog``: a FULL params tree published at L4 into an
    object store is pulled and swapped into the serving engine between
    batches."""
    from repro_torch.configs import get_arch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.models.zoo import build_model
    model = build_model(get_arch("tinyllama-1.1b").reduced())
    ctx = CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / "pub"), backend="fti", dedicated_thread=False,
        objstore_cdc_min_bytes=1024, objstore_cdc_avg_bytes=4096,
        objstore_cdc_max_bytes=16384))
    ctx.store({"params": model.init(torch.Generator().manual_seed(5))},
              id=1, level=4)
    ctx.shutdown()
    rc, out, err = run(["-m", "repro_torch.launch.serve", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path / "sv"), "--gen", "4",
                        "--follow-catalog",
                        "file:" + str(tmp_path / "pub" / "objstore")])
    assert rc == 0, err[-3000:]
    assert "deploying catalog entry 1" in out
    assert "weights swapped: epoch 0 -> 1 (catalog entry 1)" in out


def test_serve_launcher_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would really serve")
    rc, _out, err = run(["-m", "repro_torch.launch.serve",
                         "--ckpt-dir", str(tmp_path / "sv")])
    assert rc != 0 and "pass --device cpu" in err


# --------------------------------------------------------------------------- #
# the reference's four remaining programs on the port
# --------------------------------------------------------------------------- #

NEW_EXAMPLES = ("torch_clause_protection.py", "torch_multibackend_portability.py",
                "torch_telemetry_trace.py", "torch_train_checkpointed.py")


def test_clause_protection_runs_and_restarts(tmp_path):
    args = [str(ROOT / "examples" / "torch_clause_protection.py"),
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "cl")]
    rc, out, err = run(args)
    assert rc == 0, err[-3000:]
    assert "last store: kind=DIFF bytes=18,383 dirty_ratio=0.0625" in out
    assert "done at step 30" in out and "transparent restart" not in out
    rc, out, err = run(args)
    assert rc == 0, err[-3000:]
    assert "transparent restart: resuming from step 30" in out
    assert "done at step 30" in out and "last store" not in out


def test_multibackend_portability_runs_on_three_backends(tmp_path):
    rc, out, err = run([str(ROOT / "examples" /
                             "torch_multibackend_portability.py"),
                        "--device", "cpu", "--ckpt-dir", str(tmp_path / "p")])
    assert rc == 0, err[-3000:]
    for backend in ("fti", "scr", "veloc"):
        assert f"{backend:6s} x0=20 restart-detected=True stats=" in out
    assert "same source, three backends" in out


def test_telemetry_trace_runs(tmp_path):
    rc, out, err = run([str(ROOT / "examples" / "torch_telemetry_trace.py"),
                        "--device", "cpu", "--ckpt-dir", str(tmp_path / "t")])
    assert rc == 0, err[-3000:]
    assert "StoreReport.span_id=" in out
    assert "dominant stage = " in out
    assert "openchk_store_total{'kind': 'FULL', 'level': '4'} = 1.0" in out
    assert "/readyz while ready=False: HTTP 503" in out
    assert "/readyz while ready=True: HTTP 200" in out
    assert (tmp_path / "t" / "trace.json").is_file()


def test_train_checkpointed_faults_and_restarts(tmp_path):
    """The reduced config, 20 steps of DIFF stores: the fault at 90 %
    progress (step 18), the restart from the store at step 10, the end at
    step 20."""
    rc, out, err = run([str(ROOT / "examples" / "torch_train_checkpointed.py"),
                        "--device", "cpu", "--steps", "20", "--differential",
                        "--ckpt-dir", str(tmp_path / "tr")],
                       env=dict(ENV, OMP_NUM_THREADS="2"))
    assert rc == 0, err[-3000:]
    assert "!! injected fault at step 18 (90% progress)" in out
    assert "[openchk] restart detected → resuming from step 10" in out
    assert "finished: step=20 " in out and "restarted=True" in out


@pytest.mark.parametrize("name", NEW_EXAMPLES)
def test_new_examples_refuse_to_run_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would really run")
    rc, out, err = run([str(ROOT / "examples" / name),
                        "--ckpt-dir", str(tmp_path / "x")])
    assert rc != 0 and "pass --device cpu" in err
    assert not (tmp_path / "x").exists() or name == "torch_train_checkpointed.py"


# --------------------------------------------------------------------------- #
# parity with the reference's programs: their bodies, run in this process
# against ``repro`` into tmp_path (the reference files write under /tmp)
# --------------------------------------------------------------------------- #


def _example(name: str) -> dict:
    """The port example's module namespace (its main is not run)."""
    return runpy.run_path(str(ROOT / "examples" / name))


def _reference_clause_body(ckpt_dir: str) -> list:
    """``examples/clause_protection.py``'s first run, on ``ckpt_dir`` →
    the report of each store."""
    import jax.numpy as jnp
    from repro.core.context import (CHK_DIFF, CheckpointConfig,
                                    CheckpointContext, Protect)

    state = {"params": {"w": jnp.zeros(4096)},
             "opt": {"m": jnp.zeros(4096), "v": jnp.zeros(4096)},
             "step": jnp.int32(0)}

    def update(s):
        return {"params": {"w": s["params"]["w"].at[:256].add(0.1)},
                "opt": {"m": s["opt"]["m"] * 0.9, "v": s["opt"]["v"] * 0.99},
                "step": s["step"] + 1}

    ctx = CheckpointContext(CheckpointConfig(dir=ckpt_dir,
                                             dedicated_thread=False,
                                             block_bytes=1024))
    ctx.protect(
        Protect("params/**", kind=CHK_DIFF, compress="int8", max_error=0.05),
        Protect("opt/**", format="chk5", precision="bf16"),
        Protect("step"),
    )
    state = ctx.load(state)
    reports = []
    for t in range(int(state["step"]), 30):
        state = update(state)
        rep = ctx.store(state, id=t + 1, level=1, if_=(t + 1) % 10 == 0)
        if rep is not None:
            reports.append(rep)
    ctx.shutdown()
    return reports


def _port_clause_reports(ckpt_dir: str, monkeypatch) -> list:
    """The port example's first run on the CPU → the report of each store
    (collected from ``CheckpointContext.store``)."""
    from repro_torch.core.context import CheckpointContext
    reports = []
    store = CheckpointContext.store

    def recording(self, *a, **kw):
        rep = store(self, *a, **kw)
        if rep is not None:
            reports.append(rep)
        return rep

    monkeypatch.setattr(CheckpointContext, "store", recording)
    _example("torch_clause_protection.py")["main"](
        ["--device", "cpu", "--ckpt-dir", ckpt_dir])
    monkeypatch.setattr(CheckpointContext, "store", store)
    return reports


def test_clause_protection_reports_match_the_reference(tmp_path, monkeypatch):
    """Each store's kind, container bytes and dirty ratio, as the
    reference's program reports them."""
    want = _reference_clause_body(str(tmp_path / "ref"))
    got = _port_clause_reports(str(tmp_path / "port"), monkeypatch)
    assert [(r.ckpt_id, r.kind, r.bytes_payload, r.dirty_ratio)
            for r in got] == \
        [(r.ckpt_id, r.kind, r.bytes_payload, r.dirty_ratio) for r in want]
    assert [r.kind for r in got] == ["FULL", "DIFF", "DIFF"]


def _restore_both(ckpt_dir: str):
    """One clause checkpoint restored by both packages into zeros →
    (the reference's leaves, the port's leaves) as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.core.context import CheckpointConfig as RefConfig
    from repro.core.context import CheckpointContext as RefContext
    from repro.core.protect import flatten_named as ref_flatten
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.formats import tensor_to_numpy
    from repro_torch.core.protect import flatten_named

    ref_ctx = RefContext(RefConfig(dir=ckpt_dir, dedicated_thread=False,
                                   block_bytes=1024))
    ref = ref_ctx.load({"params": {"w": jnp.zeros(4096)},
                        "opt": {"m": jnp.zeros(4096), "v": jnp.zeros(4096)},
                        "step": jnp.int32(0)})
    assert ref_ctx.restarted
    ref_ctx.shutdown()
    ctx = CheckpointContext(CheckpointConfig(dir=ckpt_dir,
                                             dedicated_thread=False,
                                             block_bytes=1024))
    port = ctx.load(_example("torch_clause_protection.py")["init_state"](
        torch.device("cpu")))
    assert ctx.restarted
    ctx.shutdown()
    return ({k: np.asarray(jax.device_get(v))
             for k, v in ref_flatten(ref)[0].items()},
            {k: tensor_to_numpy(v) for k, v in flatten_named(port).items()})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_clause_container_cross_reads(writer, tmp_path, monkeypatch):
    """The mixed-kind clause container (int8 DIFF params over a promoted
    FULL, bf16 moments, a clause-less step) written by one package restores
    in the other bit for bit as in its writer, within the clause's
    max_error of the state stored, moments equal to the stored ones cast to
    bf16 and back."""
    d = str(tmp_path / writer)
    if writer == "port":
        _port_clause_reports(d, monkeypatch)
    else:
        _reference_clause_body(d)
    ref, port = _restore_both(d)
    assert sorted(ref) == sorted(port) == ["opt/m", "opt/v", "params/w",
                                           "step"]
    for k in ref:
        assert ref[k].dtype == port[k].dtype, k
        np.testing.assert_array_equal(ref[k], port[k], err_msg=k)
    mod = _example("torch_clause_protection.py")
    s = mod["init_state"](torch.device("cpu"))
    for _ in range(30):
        s = mod["update"](s)
    assert int(port["step"]) == 30
    assert np.abs(port["params/w"] - s["params"]["w"].numpy()).max() <= 0.05
    for k in ("m", "v"):
        np.testing.assert_array_equal(
            port[f"opt/{k}"], s["opt"][k].to(torch.bfloat16).float().numpy())


def test_multibackend_portability_matches_the_reference(tmp_path):
    """x0, the restart and the backend's stats on FTI, SCR and VeloC: the
    reference's ``application`` (its module loaded, its main not run)
    against the port example's, each on its own directory."""
    ref_app = runpy.run_path(str(ROOT / "examples" /
                                 "multibackend_portability.py"))["application"]
    port_app = _example("torch_multibackend_portability.py")["application"]
    saved = os.environ.get("OPENCHK_BACKEND")
    try:
        for backend in ("fti", "scr", "veloc"):
            os.environ["OPENCHK_BACKEND"] = backend
            want = [ref_app(str(tmp_path / f"ref-{backend}"))
                    for _ in range(2)]
            got = [port_app(str(tmp_path / f"port-{backend}"),
                            torch.device("cpu")) for _ in range(2)]
            for w, g in zip(want, got):
                assert (g["x0"], g["restarted"], g["stats"]) == \
                    (w["x0"], w["restarted"], w["stats"]), backend
            assert got[0]["x0"] == 20.0 and got[1]["restarted"]
    finally:
        if saved is None:
            os.environ.pop("OPENCHK_BACKEND", None)
        else:
            os.environ["OPENCHK_BACKEND"] = saved


def _trace_summary(trace_path, metrics_mod, chktrace) -> tuple:
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    spans = chktrace.build_spans(events)
    return ({s["name"] for s in spans},
            [row["dominant_stage"] for row in
             chktrace.store_critical_paths(spans)],
            set(metrics_mod.snapshot()))


def test_telemetry_trace_matches_the_reference(tmp_path, capsys):
    """The reference's walkthrough (its store on tmp_path, its health
    endpoint) and the port example: the same span names in the trace, the
    same dominant stage of the store, the same metric names — but for the
    port's own spans of the directive call and of Plan, and its D2H
    counter, which the reference does not have."""
    import jax.numpy as jnp
    from repro.core.context import CheckpointConfig as RefConfig
    from repro.core.context import CheckpointContext as RefContext
    from repro.telemetry import metrics as ref_metrics
    from repro.telemetry.health import HealthServer, HealthState
    from repro.telemetry import trace as ref_trace
    from repro.tools import chktrace as ref_chktrace
    from repro_torch.telemetry import metrics, trace
    from repro_torch.tools import chktrace

    ref_path = tmp_path / "ref" / "trace.json"
    ref_metrics.reset()
    ref_trace.reset()
    ref_trace.enable(str(ref_path))
    try:
        ctx = RefContext(RefConfig(dir=str(tmp_path / "ref" / "ckpt"),
                                   backend="fti", dedicated_thread=False))
        ctx.store({"params": {"w": jnp.asarray(
            np.arange(1 << 20, dtype=np.float32))}}, id=1, level=4)
        ctx.shutdown()
        ref_trace.flush()
        health = HealthState(name="demo")
        srv = HealthServer(health).start()
        for ready in (False, True):
            health.set_ready(ready, epoch=1)
        srv.stop()
        want = _trace_summary(ref_path, ref_metrics, ref_chktrace)
    finally:
        ref_trace.disable()
        ref_trace.reset()
        ref_metrics.reset()
    metrics.reset()
    trace.reset()
    try:
        _example("torch_telemetry_trace.py")["main"](
            ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
        got = _trace_summary(tmp_path / "port" / "trace.json", metrics,
                             chktrace)
    finally:
        trace.disable()
        trace.reset()
        metrics.reset()
    assert "HTTP 503" in capsys.readouterr().out
    assert {"pipeline.store", "pipeline.plan", "pipeline.pack",
            "pipeline.place", "pipeline.commit"} <= got[0]
    port_only = ({"chk.init", "chk.store", "plan.digests", "plan.d2h",
                  "chk.shutdown"}, {"openchk_d2h_bytes_total"})
    assert got[0] - want[0] == port_only[0]
    assert got[2] - want[2] == port_only[1]
    assert (got[0] - port_only[0], got[1], got[2] - port_only[1]) == want


def test_examples_import_neither_jax_nor_the_reference():
    """Every import statement of the port's examples, lazy ones included."""
    import ast
    paths = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(paths) == 7
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path.name}: {n}"

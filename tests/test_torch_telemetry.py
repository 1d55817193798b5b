"""The port's telemetry plane, mirroring the JAX package's
tests/test_telemetry.py: span tracer round-trip, the disabled no-op fast
path, metrics registry + Prometheus exposition, metrics ↔ StoreReport
parity, live /healthz /readyz /metrics endpoints flipping across a rolling
fleet hot-swap, and the chktrace summarizer (``repro_torch.tools``)."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry.health import HealthServer, HealthState, attach_engine
from repro_torch.tools import chktrace


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Tracer + registry are process-wide singletons; leave them as other
    tests expect them — disabled, empty, env already checked."""
    ttrace.enabled()                    # settle the one-shot env check
    ttrace.disable()
    ttrace.reset()
    tmetrics.reset()
    yield
    ttrace.disable()
    ttrace.reset()
    tmetrics.reset()


# ------------------------------------------------------------------ #
# trace: export round-trip
# ------------------------------------------------------------------ #


def test_span_export_roundtrip_balanced_monotonic_thread_tracks(tmp_path):
    ttrace.enable()
    with ttrace.span("outer", ckpt_id=7) as sp:
        assert sp.id is not None
        with ttrace.span("inner", level=4):
            ttrace.instant("marker", step=3)

    def worker():
        with ttrace.span("thread-span"):
            pass
    t = threading.Thread(target=worker, name="cp-thread")
    t.start()
    t.join()

    out = str(tmp_path / "trace.json")
    ttrace.export(out)
    doc = json.loads(open(out).read())
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]

    # B/E balanced per (pid, tid), timestamps non-decreasing per track
    by_track = {}
    for ev in events:
        by_track.setdefault((ev["pid"], ev.get("tid")), []).append(ev)
    assert len([k for k, evs in by_track.items()
                if any(e["ph"] in "BE" for e in evs)]) == 2  # two threads
    for evs in by_track.values():
        ts = [e["ts"] for e in evs if e["ph"] in ("B", "E", "i")]
        assert ts == sorted(ts)
        depth = 0
        for e in evs:
            if e["ph"] == "B":
                depth += 1
            elif e["ph"] == "E":
                depth -= 1
                assert depth >= 0
        assert depth == 0

    # every track that recorded spans is named; the process is named
    names = [e for e in events if e["ph"] == "M"]
    assert any(e["name"] == "process_name" for e in names)
    thread_tids = {e["tid"] for e in names if e["name"] == "thread_name"}
    span_tids = {e["tid"] for e in events if e["ph"] == "B"}
    assert span_tids <= thread_tids
    assert any(e["args"]["name"] == "cp-thread" for e in names
               if e["name"] == "thread_name")

    # args survive the round trip; every B carries its span id
    outer = next(e for e in events if e.get("name") == "outer")
    assert outer["args"]["ckpt_id"] == 7 and outer["args"]["span_id"] >= 1
    marker = next(e for e in events if e.get("name") == "marker")
    assert marker["ph"] == "i" and marker["args"]["step"] == 3


def test_disabled_path_is_a_shared_noop():
    sp = ttrace.span("ignored", big_arg="x" * 1000)
    assert sp is ttrace.NULL_SPAN and sp.id is None
    with sp:
        sp.event("also-ignored")
    ttrace.instant("ignored-too", step=1)
    assert ttrace.tracer().events() == []
    # and the same calls record once enabled
    ttrace.enable()
    with ttrace.span("real"):
        pass
    assert any(e.get("name") == "real" for e in ttrace.tracer().events())


def test_env_dir_protocol_and_merge(tmp_path, monkeypatch):
    d = str(tmp_path / "traces")
    os.makedirs(d)
    monkeypatch.setenv(ttrace.TRACE_DIR_ENV, d)
    # a fresh Tracer models a fresh process: lazy env check on first use
    t = ttrace.Tracer()
    with t.span("from-env"):
        pass
    assert t.enabled and t.trace_dir() == d
    assert t.flush() == os.path.join(d, f"trace-{os.getpid()}.json")
    # a second process's file (hand-written) merges in; trace.json is the
    # merged output and must not be re-consumed by a second merge
    with open(os.path.join(d, "trace-99999.json"), "w") as f:
        json.dump({"traceEvents": [
            {"ph": "i", "name": "other-proc", "ts": 1, "pid": 99999,
             "tid": 1, "args": {}}]}, f)
    merged = ttrace.merge_dir(d)
    assert merged == os.path.join(d, "trace.json")
    ev = json.load(open(merged))["traceEvents"]
    assert {e["name"] for e in ev if e.get("name")} >= {"from-env",
                                                        "other-proc"}
    n = len(ev)
    assert len(json.load(open(ttrace.merge_dir(d)))["traceEvents"]) == n


# ------------------------------------------------------------------ #
# metrics: registry + exposition
# ------------------------------------------------------------------ #


def test_metrics_registry_snapshot_and_prometheus():
    tmetrics.counter("openchk_store_total", level=4, kind="FULL").inc()
    tmetrics.counter("openchk_store_total", level=4, kind="FULL").inc(2)
    tmetrics.gauge("openchk_serve_ready", replica="r0").set(1)
    h = tmetrics.histogram("openchk_store_seconds", level=4)
    h.observe(0.003)
    h.observe(42.0)

    snap = tmetrics.snapshot()
    c = snap["openchk_store_total"]
    assert c["kind"] == "counter"
    assert c["series"] == [{"labels": {"level": "4", "kind": "FULL"},
                            "value": 3.0}]
    hs = snap["openchk_store_seconds"]["series"][0]
    assert hs["count"] == 2 and hs["sum"] == pytest.approx(42.003)
    buckets = dict((le, n) for le, n in hs["buckets"])
    assert buckets[0.005] == 1 and buckets["+Inf"] == 2  # cumulative

    text = tmetrics.to_prometheus()
    assert "# TYPE openchk_store_total counter" in text
    assert 'openchk_store_total{kind="FULL",level="4"} 3.0' in text
    assert 'openchk_serve_ready{replica="r0"} 1.0' in text
    assert '_bucket{level="4",le="0.005"} 1' in text
    assert 'openchk_store_seconds_count{level="4"} 2' in text
    assert 'le="+Inf"' in text

    # one name, one kind — forever
    with pytest.raises(TypeError, match="already registered"):
        tmetrics.gauge("openchk_store_total")


# ------------------------------------------------------------------ #
# pipeline: traced store span tree + metrics parity
# ------------------------------------------------------------------ #


def test_traced_store_span_tree_and_metrics_parity(tmp_path):
    import torch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext

    ttrace.enable()
    ctx = CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / "ckpt"), backend="fti", dedicated_thread=False))
    state = {"params": {"w": torch.from_numpy(
        np.arange(1 << 16, dtype=np.float32))}}
    report = ctx.store(state, id=1, level=4)
    ctx.shutdown()

    events = ttrace.tracer().events()
    names = {e["name"] for e in events if e["ph"] == "B"}
    assert {"pipeline.store", "pipeline.plan", "pipeline.pack",
            "pipeline.place", "pipeline.commit",
            "pipeline.commit.tier"} <= names
    assert "chunk.upload" in names            # the L4 objstore path
    assert sum(e["ph"] == "B" for e in events) == \
        sum(e["ph"] == "E" for e in events)

    # the report is correlated to its trace span
    store_b = next(e for e in events if e.get("name") == "pipeline.store")
    assert report.span_id == store_b["args"]["span_id"]
    assert store_b["args"]["ckpt_id"] == 1

    # and to the canonical store metrics, exactly
    assert tmetrics.counter("openchk_store_total",
                            level=4, kind="FULL").value == 1.0
    assert tmetrics.counter("openchk_store_bytes_total",
                            level=4, kind="FULL").value == \
        float(report.bytes_payload)
    hist = tmetrics.histogram("openchk_store_seconds", level=4)
    assert hist.count == 1 and hist.sum == pytest.approx(report.seconds,
                                                         abs=1e-6)
    assert tmetrics.counter("openchk_chunks_uploaded_total").value >= 1


def _restart(tmp_path, trace_on):
    """A FULL store handed to the CP thread, the context shut down, a
    fresh one restoring into an empty template: the benchmark's restart
    cell at the CPU's size → (state, report, container bytes)."""
    import torch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext

    cfg = CheckpointConfig(dir=str(tmp_path / "ckpt"), backend="fti",
                           dedicated_thread=True, objstore=False)
    state = {"params": {"w": torch.arange(1 << 14, dtype=torch.float32),
                        "b": torch.ones(100, dtype=torch.bfloat16)},
             "step": torch.tensor(3)}
    if trace_on:
        ttrace.enable()
    reports = []
    ctx = CheckpointContext(cfg).observe_store_reports(reports.append)
    ctx.store(state, id=3, level=1)
    ctx.shutdown()
    ctx = CheckpointContext(cfg)
    got = ctx.load({"params": {k: torch.zeros_like(v) for k, v in
                               state["params"].items()},
                    "step": torch.tensor(0)})
    ctx.shutdown()
    for k in ("w", "b"):
        assert torch.equal(got["params"][k], state["params"][k])
    (report,) = reports
    container = tmp_path / "ckpt" / "node-local" / "ckpts" / "ckpt-3" / \
        "rank0.chk5"
    return state, report, container.stat().st_size


def _counter(name, **labels):
    return tmetrics.counter(name, **labels).value


def test_traced_restart_span_tree_parent_links_and_counters(tmp_path):
    state, report, container = _restart(tmp_path, trace_on=True)
    events = ttrace.tracer().events()
    for tid in {e["tid"] for e in events}:
        track = [e["ph"] for e in events if e["tid"] == tid]
        assert track.count("B") == track.count("E")
    spans = chktrace.build_spans(events)
    assert len(spans) == sum(e["ph"] == "B" for e in events)

    def one(name):
        (sp,) = [s for s in spans if s["name"] == name]
        return sp

    def kids(sp):
        return {c["name"] for c in sp["children"]}

    store, plan, tail = one("chk.store"), one("pipeline.plan"), \
        one("pipeline.store")
    assert store["args"]["ckpt_id"] == 3
    assert kids(store) == {"pipeline.plan", "cp.submit", "pipeline.store"}
    assert kids(plan) == {"plan.digests", "plan.d2h"}
    # the CP thread's tail names the store call that submitted it
    assert tail["tid"] != store["tid"]
    assert tail["args"]["parent"] == store["args"]["span_id"]
    assert report.span_id == tail["args"]["span_id"]
    assert {"pipeline.pack", "pipeline.place", "pipeline.commit"} <= \
        kids(tail)
    inits = [s for s in spans if s["name"] == "chk.init"]
    downs = [s for s in spans if s["name"] == "chk.shutdown"]
    assert len(inits) == len(downs) == 2
    assert store["ts"] < downs[0]["ts"] < inits[1]["ts"]
    load = one("chk.load")
    assert inits[1]["ts"] < load["ts"] < downs[1]["ts"]
    assert kids(load) == {"restore.scan", "restore.read", "restore.decode",
                          "restore.h2d"}       # no DIFF link: no replay

    # the counters count what the spans carry: the tensors' bytes each
    # way, the container's bytes read
    leaf_bytes = sum(v.nbytes for v in
                     (*state["params"].values(), state["step"]))
    assert one("plan.d2h")["args"]["bytes"] == leaf_bytes
    assert one("restore.h2d")["args"]["bytes"] == leaf_bytes
    read = one("restore.read")["args"]
    assert read["bytes"] == container == report.bytes_payload
    assert read["tier"] == "local"
    assert _counter("openchk_d2h_bytes_total", memory="pageable") == \
        leaf_bytes
    assert _counter("openchk_h2d_bytes_total", memory="pageable") == \
        leaf_bytes
    assert _counter("openchk_restore_read_bytes_total", tier="local") == \
        container
    text = tmetrics.to_prometheus()
    assert f'openchk_restore_read_bytes_total{{tier="local"}} ' \
        f'{float(container)}' in text

    # chktrace puts each directive call's inner time under its name
    calls = chktrace.directive_calls(spans)
    assert [c["name"] for c in calls] == [
        "chk.init", "chk.store", "chk.shutdown", "chk.init", "chk.load",
        "chk.shutdown"]
    assert {"plan.d2h", "cp.submit", "pipeline.pack"} <= \
        set(calls[1]["within_us"])
    assert set(calls[4]["within_us"]) == kids(load)


def test_disabled_tracing_records_nothing_while_counters_count(tmp_path):
    state, report, container = _restart(tmp_path, trace_on=False)
    assert ttrace.tracer().events() == []
    assert ttrace.current_id() is None
    leaf_bytes = sum(v.nbytes for v in
                     (*state["params"].values(), state["step"]))
    assert _counter("openchk_d2h_bytes_total", memory="pageable") == \
        leaf_bytes
    assert _counter("openchk_h2d_bytes_total", memory="pageable") == \
        leaf_bytes
    assert _counter("openchk_restore_read_bytes_total", tier="local") == \
        container == report.bytes_payload


def test_traced_diff_restore_reads_each_link_and_replays(tmp_path):
    """A FULL and a DIFF of it: the restore reads and decodes both links
    and replays the delta on the template's device, under its own span."""
    import torch
    from repro_torch.core.context import (CHK_DIFF, CheckpointConfig,
                                          CheckpointContext)

    cfg = CheckpointConfig(dir=str(tmp_path / "ckpt"), backend="fti",
                           dedicated_thread=False, objstore=False,
                           block_bytes=256)
    w = torch.arange(1 << 14, dtype=torch.float32)
    ctx = CheckpointContext(cfg)
    ctx.store({"w": w}, id=1, level=1)
    w[:10] = -1.0
    ctx.store({"w": w}, id=2, level=1, kind=CHK_DIFF)
    ctx.shutdown()
    ttrace.enable()
    ctx = CheckpointContext(cfg)
    got = ctx.load({"w": torch.zeros_like(w)})
    ctx.shutdown()
    assert torch.equal(got["w"], w)
    spans = chktrace.build_spans(ttrace.tracer().events())
    (load,) = [s for s in spans if s["name"] == "chk.load"]
    names = [c["name"] for c in load["children"]]
    assert names.count("restore.read") == names.count("restore.decode") == 2
    assert {c["args"]["ckpt_id"] for c in load["children"]
            if c["name"] == "restore.decode"} == {1, 2}
    assert names[-2:] == ["restore.replay", "restore.h2d"]


def test_span_parent_links_hand_off_and_end_args():
    ttrace.enable()
    with ttrace.span("outer") as outer:
        with ttrace.span("inner") as inner:
            inner.set(bytes=12)
            cause = ttrace.current_id()

    def worker():
        with ttrace.caused_by(cause):
            with ttrace.span("tail"):
                pass
        with ttrace.span("alone"):
            pass
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert ttrace.current_id() is None
    b = {e["name"]: e["args"] for e in ttrace.tracer().events()
         if e["ph"] == "B"}
    assert "parent" not in b["outer"] and "parent" not in b["alone"]
    assert b["inner"]["parent"] == outer.id
    assert b["tail"]["parent"] == inner.id == cause
    ends = [e for e in ttrace.tracer().events() if e["ph"] == "E"]
    assert [e.get("args") for e in ends].count({"bytes": 12}) == 1
    spans = {s["name"]: s for s in
             chktrace.build_spans(ttrace.tracer().events())}
    assert spans["inner"]["args"]["bytes"] == 12
    assert [c["name"] for c in spans["inner"]["children"]] == ["tail"]
    # a trace without parent args nests by thread, as before
    assert [c["name"] for c in spans["outer"]["children"]] == ["inner"]


# ------------------------------------------------------------------ #
# health: live endpoints
# ------------------------------------------------------------------ #


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:   # 503 still carries the body
        return e.code, e.read().decode()


def test_health_endpoints_flip_with_state():
    state = HealthState(name="r0")
    srv = HealthServer(state).start()
    try:
        assert _get(srv.url + "/healthz")[0] == 200
        code, body = _get(srv.url + "/readyz")
        assert code == 503 and json.loads(body)["ready"] is False
        state.set_ready(True, epoch=3, entry_id=9)
        code, body = _get(srv.url + "/readyz")
        d = json.loads(body)
        assert code == 200 and d["epoch"] == 3 and d["entry_id"] == 9
        tmetrics.counter("openchk_store_total", level=1, kind="FULL").inc()
        code, body = _get(srv.url + "/metrics")
        assert code == 200 and "openchk_store_total" in body
        assert 'openchk_serve_ready{replica="r0"} 1.0' in body
        assert _get(srv.url + "/nope")[0] == 404
    finally:
        srv.stop()


# ------------------------------------------------------------------ #
# deploy: readiness across a rolling hot-swap
# ------------------------------------------------------------------ #


def _tiny():
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.zoo import build_model
    cfg = get_arch("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def _publisher(tmp_path):
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.storage import StorageConfig, StorageEngine
    cfg = StorageConfig(root=str(tmp_path / "shared"), block_bytes=256,
                        objstore_chunk_bytes=4096,
                        objstore_cdc_min_bytes=1024,
                        objstore_cdc_avg_bytes=4096,
                        objstore_cdc_max_bytes=16384)
    return StorageEngine(cfg, LocalComm(str(tmp_path / "nl-pub")))


def test_rolling_swap_drops_readiness_for_the_pull_window(tmp_path,
                                                          monkeypatch):
    """/readyz observed over real HTTP: 503 exactly while the replica is
    pulling, 200 with the new entry after the flip, and 200 again after a
    FAILED pull (the old epoch never stopped serving)."""
    from repro_torch.core.protect import flatten_named, to_host
    from repro_torch.objstore.client import ObjectStoreError, make_object_store
    from repro_torch.serve.deploy import EntryPuller, FleetDeployer, Replica
    from repro_torch.serve.engine import ServingEngine

    model, params = _tiny()
    pub = _publisher(tmp_path)
    named = flatten_named({"params": params})
    state = to_host(named)
    pub.store(state, ckpt_id=1, level=4)

    eng = ServingEngine(model, params, batch=2, max_len=32)
    health = attach_engine(eng, name="r0", port=0)
    url = health.server.url
    assert _get(url + "/readyz")[0] == 200        # serving local params

    seen = {}
    real_pull = EntryPuller.pull

    def spying_pull(self, entry):
        code, body = _get(url + "/readyz")
        seen["mid_pull"] = (code, json.loads(body))
        return real_pull(self, entry)

    monkeypatch.setattr(EntryPuller, "pull", spying_pull)
    store = make_object_store(
        "file:" + os.path.join(str(tmp_path / "shared"), "objstore"))
    r = Replica(name="r0", engine=eng,
                cache_root=str(tmp_path / "cache-0"), prefix="params",
                health=health)
    dep = FleetDeployer(store, [r], time_fn=lambda: 0.0)
    try:
        assert dep.poll()["action"] == "started"
        assert dep.poll()["action"] == "swapped"
        # mid-pull: not ready, and the body says why
        assert seen["mid_pull"][0] == 503
        assert seen["mid_pull"][1]["reason"] == "pulling"
        assert seen["mid_pull"][1]["target_entry"] == 1
        # after the flip: ready with the new entry (via the swap hook)
        code, body = _get(url + "/readyz")
        d = json.loads(body)
        assert code == 200 and d["entry_id"] == 1 and d["reason"] == "swapped"
        assert dep.fleet_epochs() == {"r0": 1}
        assert tmetrics.gauge("openchk_serve_ready",
                              replica="r0").value == 1.0

        # a failed pull re-asserts readiness — the old epoch still serves
        pub.store(dict(state, **{sorted(state)[0]:
                                 state[sorted(state)[0]] + 1.0}),
                  ckpt_id=2, level=4)
        assert dep.poll()["action"] == "converged"
        assert dep.poll()["action"] == "started"

        def dying_pull(self, entry):
            code, _body = _get(url + "/readyz")
            seen["mid_fail"] = code
            raise ObjectStoreError("replica killed mid-pull (injected)")

        monkeypatch.setattr(EntryPuller, "pull", dying_pull)
        st = dep.poll()
        assert st["action"] == "pinned" and seen["mid_fail"] == 503
        code, body = _get(url + "/readyz")
        d = json.loads(body)
        assert code == 200 and d["entry_id"] == 1
        assert "previous epoch" in d["reason"]
        assert dep.fleet_epochs() == {"r0": 1}    # nothing torn
    finally:
        health.server.stop()


# ------------------------------------------------------------------ #
# chktrace: the trace summarizer
# ------------------------------------------------------------------ #


def _synthetic_trace(tmp_path, with_resume=True):
    def b(name, ts, tid=1, **args):
        return {"ph": "B", "name": name, "ts": ts, "pid": 10, "tid": tid,
                "args": args}

    def e(ts, tid=1):
        return {"ph": "E", "ts": ts, "pid": 10, "tid": tid}

    ev = [
        b("pipeline.store", 0, ckpt_id=5, level=4, kind="FULL", span_id=1),
        b("pipeline.plan", 0, span_id=2), e(10),
        b("pipeline.pack", 10, span_id=3), e(40),
        b("pipeline.place", 40, tier="local", span_id=4), e(60),
        b("pipeline.place", 60, tier="pfs", span_id=5), e(160),
        b("pipeline.commit", 160, ckpt_id=5, bytes=4096, span_id=6), e(200),
        e(210),
        {"ph": "i", "name": "chaos.fault", "ts": 1_000, "pid": 20, "tid": 9,
         "args": {"site": "train.step", "mode": "exit"}},
    ]
    if with_resume:
        ev.append({"ph": "i", "name": "train.resume", "ts": 3_501_000,
                   "pid": 21, "tid": 9, "args": {"step": 6}})
    p = str(tmp_path / "synth.json")
    with open(p, "w") as f:
        json.dump({"traceEvents": ev}, f)
    return p


def test_chktrace_summary_critical_path_goodput_mttr(tmp_path, capsys):
    p = _synthetic_trace(tmp_path)
    assert chktrace.main([p, "--json", "--check", "fault-before-resume"]) == 0
    s = json.loads(capsys.readouterr().out)
    (store,) = s["stores"]
    assert store["ckpt_id"] == 5 and store["dur_us"] == 210
    assert store["dominant_stage"] == "place"
    assert store["dominant_tier"] == "pfs"
    assert store["stages_us"]["pack"] == 30
    assert s["goodput"] == [{"t_us": 40, "ckpt_id": 5, "bytes": 4096}]
    (pair,) = s["mttr"]["pairs"]
    assert pair["mttr_s"] == pytest.approx(3.5)
    assert pair["resume_step"] == 6
    assert s["processes"] == [10, 20, 21]


def test_chktrace_check_fails_without_resume(tmp_path, capsys):
    p = _synthetic_trace(tmp_path, with_resume=False)
    assert chktrace.main([p, "--check", "fault-before-resume"]) == 1
    assert "no train.resume" in capsys.readouterr().err


def test_chktrace_reads_a_trace_dir(tmp_path, capsys):
    _synthetic_trace(tmp_path)
    os.rename(str(tmp_path / "synth.json"), str(tmp_path / "trace-10.json"))
    assert chktrace.main([str(tmp_path), "--json"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["n_events"] > 0 and s["stores"][0]["ckpt_id"] == 5

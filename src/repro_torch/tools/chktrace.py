"""``python -m repro_torch.tools.chktrace <trace.json | trace-dir>`` — summarize
an OpenCHK telemetry trace.

The trace plane (repro_torch.telemetry.trace) exports Chrome trace-event JSON;
perfetto renders it, this tool *answers questions* about it:

- **directive calls** — per ``chk.*`` span (init, store, load,
  shutdown): its duration and the time of each span under it, the CP
  thread's tail included (it names the store call as its ``parent``): a
  restore's scan, read, decode, replay and H2D, a store's Plan, digests,
  D2H and hand-off;
- **store critical path** — per ``pipeline.store`` span: total duration,
  the dominant stage (plan/pack/place/commit) and, within Place, the
  dominant tier — CRAFT's per-phase overhead accounting read straight
  off the timeline;
- **goodput timeline** — committed bytes per store over wall time
  (from the ``pipeline.commit`` span args);
- **span-measured MTTR** — for every ``chaos.fault`` → ``train.resume``
  pair across (possibly several) processes: the observed gap between the
  fault firing and the restarted worker resuming from its checkpoint,
  plus the supervisor's own ``supervisor.recovered`` samples.

``--json`` emits the machine-readable summary for CI.  ``--check
fault-before-resume`` exits nonzero unless the trace contains a
``chaos.fault`` instant *strictly before* a ``train.resume`` event — the
end-to-end assertion that a supervised kill actually produced the
fault → death → restart → resume narrative.

Pointed at a *directory*, per-process ``trace-*.json`` files are merged
in memory first (same rule as ``trace.merge_dir``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

#: pipeline stages ranked in the critical-path breakdown
_STAGES = ("pipeline.plan", "pipeline.pack", "pipeline.place",
           "pipeline.commit")


def load_events(path: str) -> List[Dict[str, Any]]:
    """Events from a trace file, or the merged events of a trace dir."""
    if os.path.isdir(path):
        events: List[Dict[str, Any]] = []
        for fn in sorted(os.listdir(path)):
            if fn.startswith("trace") and fn.endswith(".json"):
                with open(os.path.join(path, fn), encoding="utf-8") as f:
                    events.extend(json.load(f).get("traceEvents", []))
        return events
    with open(path, encoding="utf-8") as f:
        return json.load(f).get("traceEvents", [])


def build_spans(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Pair B/E events per (pid, tid) stack → closed spans with
    ``dur_us`` and parent links: the ``parent`` arg where the tracer
    recorded one (a CP thread's tail names the store call that submitted
    it), else the trace-event nesting contract.  An ``E`` event's args
    join its span's."""
    spans: List[Dict[str, Any]] = []
    stacks: Dict[tuple, List[Dict[str, Any]]] = {}
    by_id: Dict[tuple, Dict[str, Any]] = {}
    for ev in sorted(events, key=lambda e: e.get("ts", 0)):
        key = (ev.get("pid"), ev.get("tid"))
        if ev.get("ph") == "B":
            sp = {"name": ev.get("name"), "ts": ev["ts"], "pid": ev.get("pid"),
                  "tid": ev.get("tid"), "args": dict(ev.get("args", {})),
                  "children": [], "dur_us": None}
            stack = stacks.setdefault(key, [])
            parent = by_id.get((sp["pid"], sp["args"].get("parent")))
            if parent is None and stack:
                parent = stack[-1]
            if parent is not None:
                parent["children"].append(sp)
            if "span_id" in sp["args"]:
                by_id[(sp["pid"], sp["args"]["span_id"])] = sp
            stack.append(sp)
            spans.append(sp)
        elif ev.get("ph") == "E":
            stack = stacks.get(key)
            if stack:
                sp = stack.pop()
                sp["dur_us"] = ev["ts"] - sp["ts"]
                sp["args"].update(ev.get("args", {}))
    return [s for s in spans if s["dur_us"] is not None]


def store_critical_paths(spans: List[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    out = []
    for sp in spans:
        if sp["name"] != "pipeline.store":
            continue
        # per-stage totals: Place emits one span per tier, so aggregate
        stages: Dict[str, int] = {}
        for c in sp["children"]:
            if c["name"] in _STAGES:
                k = c["name"].split(".")[-1]
                stages[k] = stages.get(k, 0) + c["dur_us"]
        dom = max(stages, key=stages.get) if stages else None
        row = {"ckpt_id": sp["args"].get("ckpt_id"),
               "level": sp["args"].get("level"),
               "kind": sp["args"].get("kind"),
               "dur_us": sp["dur_us"], "stages_us": stages,
               "dominant_stage": dom}
        if dom == "place":
            tier = max((c for c in sp["children"]
                        if c["name"] == "pipeline.place"),
                       key=lambda c: c["dur_us"])
            if tier["args"].get("tier") is not None:
                row["dominant_tier"] = tier["args"]["tier"]
        out.append(row)
    return out


def directive_calls(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per directive call (``chk.init``, ``chk.store``, ``chk.load``,
    ``chk.shutdown``): its duration and the time of every span under it by
    name — a store's ``pipeline.plan``, ``plan.digests``, ``plan.d2h``,
    ``cp.submit`` and the CP thread's tail it caused; a load's
    ``restore.scan``, ``.read``, ``.decode``, ``.replay`` and ``.h2d``.
    Nested spans count in their own name and in each ancestor's."""
    out = []
    for sp in spans:
        if not (sp["name"] or "").startswith("chk."):
            continue
        within: Dict[str, int] = {}
        todo = list(sp["children"])
        while todo:
            c = todo.pop()
            if c["dur_us"] is not None:
                within[c["name"]] = within.get(c["name"], 0) + c["dur_us"]
            todo.extend(c["children"])
        out.append({"name": sp["name"], "ckpt_id": sp["args"].get("ckpt_id"),
                    "ts": sp["ts"], "dur_us": sp["dur_us"],
                    "within_us": within})
    return sorted(out, key=lambda r: r["ts"])


def goodput_timeline(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """(t_us since first event, ckpt_id, bytes) per committed store."""
    commits = [s for s in spans if s["name"] == "pipeline.commit"
               and s["args"].get("bytes") is not None]
    if not commits:
        return []
    t0 = min(c["ts"] for c in commits)
    return [{"t_us": c["ts"] + c["dur_us"] - t0,
             "ckpt_id": c["args"].get("ckpt_id"),
             "bytes": c["args"].get("bytes")}
            for c in sorted(commits, key=lambda c: c["ts"])]


def mttr_from_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pair each ``chaos.fault`` with the next ``train.resume`` (across
    processes — wall-clock timestamps share one timebase)."""
    faults = sorted(e["ts"] for e in events
                    if e.get("ph") == "i" and e.get("name") == "chaos.fault")
    resumes = sorted((e["ts"], e.get("args", {}).get("step"))
                     for e in events
                     if e.get("ph") == "i" and e.get("name") == "train.resume")
    pairs = []
    ri = 0
    for ft in faults:
        while ri < len(resumes) and resumes[ri][0] <= ft:
            ri += 1
        if ri < len(resumes):
            pairs.append({"fault_ts": ft, "resume_ts": resumes[ri][0],
                          "resume_step": resumes[ri][1],
                          "mttr_s": (resumes[ri][0] - ft) / 1e6})
            ri += 1
    sup = [e.get("args", {}).get("mttr_s") for e in events
           if e.get("ph") == "i" and e.get("name") == "supervisor.recovered"]
    return {"n_faults": len(faults), "n_resumes": len(resumes),
            "pairs": pairs,
            "supervisor_mttr_s": [s for s in sup if s is not None]}


def summarize(path: str) -> Dict[str, Any]:
    events = load_events(path)
    spans = build_spans(events)
    instants = {}
    for e in events:
        if e.get("ph") == "i":
            instants[e["name"]] = instants.get(e["name"], 0) + 1
    return {
        "path": path,
        "n_events": len(events),
        "n_spans": len(spans),
        "processes": sorted({e.get("pid") for e in events
                             if e.get("pid") is not None}),
        "instants": instants,
        "stores": store_critical_paths(spans),
        "directives": directive_calls(spans),
        "goodput": goodput_timeline(spans),
        "mttr": mttr_from_trace(events),
    }


def check_fault_before_resume(summary: Dict[str, Any]) -> Optional[str]:
    """→ None when the trace shows fault → resume in order, else why not."""
    m = summary["mttr"]
    if m["n_faults"] == 0:
        return "no chaos.fault instant in trace"
    if m["n_resumes"] == 0:
        return "no train.resume event in trace"
    if not m["pairs"]:
        return ("chaos.fault and train.resume present but no fault "
                "precedes a resume")
    return None


def _human(s: Dict[str, Any]) -> str:
    lines = [f"trace: {s['path']}",
             f"  events={s['n_events']} spans={s['n_spans']} "
             f"processes={s['processes']}"]
    if s["instants"]:
        marks = " ".join(f"{k}×{v}" for k, v in sorted(s["instants"].items()))
        lines.append(f"  instants: {marks}")
    for st in s["stores"]:
        extra = (f" tier={st['dominant_tier']}"
                 if st.get("dominant_tier") else "")
        lines.append(
            f"  store ckpt={st['ckpt_id']} L{st['level']} {st['kind']}: "
            f"{(st['dur_us'] or 0) / 1e3:.1f}ms "
            f"dominant={st['dominant_stage']}{extra}")
    for d in s["directives"]:
        inner = ", ".join(f"{k} {v / 1e3:.1f}" for k, v in
                          sorted(d["within_us"].items()))
        lines.append(f"  {d['name']}: {d['dur_us'] / 1e3:.1f}ms"
                     + (f" ({inner} ms)" if inner else ""))
    if s["goodput"]:
        total = sum(g["bytes"] or 0 for g in s["goodput"])
        span_s = s["goodput"][-1]["t_us"] / 1e6 or 1e-9
        lines.append(f"  goodput: {len(s['goodput'])} commits, "
                     f"{total} bytes over {span_s:.2f}s")
    m = s["mttr"]
    for p in m["pairs"]:
        lines.append(f"  mttr: fault→resume(step {p['resume_step']}) "
                     f"{p['mttr_s']:.2f}s")
    if m["supervisor_mttr_s"]:
        lines.append(f"  supervisor mttr samples: "
                     f"{[round(x, 2) for x in m['supervisor_mttr_s']]}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize an OpenCHK telemetry trace")
    ap.add_argument("path", help="trace.json or a dir of trace-*.json")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--check", choices=["fault-before-resume"], default=None,
                    help="exit nonzero unless the trace satisfies the "
                         "named property")
    args = ap.parse_args(argv)
    s = summarize(args.path)
    if args.as_json:
        print(json.dumps(s, indent=1, sort_keys=True))
    else:
        print(_human(s))
    if args.check == "fault-before-resume":
        why = check_fault_before_resume(s)
        if why is not None:
            print(f"[chktrace] CHECK FAILED ({args.check}): {why}",
                  file=sys.stderr)
            return 1
        print(f"[chktrace] check ok: {args.check}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

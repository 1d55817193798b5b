"""Pack's rate on the CP thread: the store's payload bytes over the
duration of the program's ``pipeline.pack`` span, in GB/s.  Spans nest
per thread; an end event closes the innermost span its thread opened."""


def read(run):
    stacks, spans = {}, []
    for ev in run.spans:
        if ev["ph"] == "B":
            stacks.setdefault(ev["tid"], []).append((ev["name"], ev["ts"]))
        elif ev["ph"] == "E" and stacks.get(ev["tid"]):
            name, ts = stacks[ev["tid"]].pop()
            if name == "pipeline.pack":
                spans.append((ev["ts"] - ts) / 1e6)
    reports = [s["report"] for s in run.stores if s["report"] is not None]
    if not spans or len(spans) != len(reports):
        return None
    return sum(r.bytes_payload for r in reports) / sum(spans) / 1e9

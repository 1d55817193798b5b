"""A store call's time less its Plan (``StoreReport.plan_seconds``):
what the caller waits for outside Plan (the directive and TCL layers, the
hand-off to the CP thread, a wait on the store before it)."""


def read(run):
    got = [s["call_s"] - s["report"].plan_seconds for s in run.stores
           if s["report"] is not None]
    return sum(got) / len(got) if got else None

"""The time the training loop was blocked in ``ctx.store`` calls, over the
number of stores in the window."""


def read(run):
    calls = [s["call_s"] for s in run.stores]
    return sum(calls) / len(calls) if calls else None

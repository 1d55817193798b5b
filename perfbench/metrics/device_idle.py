"""The share of the traced window in which no operation ran on the card,
from ``torch.profiler``'s device activities, in %."""


def read(run):
    t = run.device_trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

"""Plan's rate: the store's payload bytes over ``plan_seconds`` (Plan ends
only when every device read of the snapshot has completed), in GB/s."""


def read(run):
    got = [s["report"].bytes_payload / s["report"].plan_seconds / 1e9
           for s in run.stores
           if s["report"] is not None and s["report"].plan_seconds > 0]
    return sum(got) / len(got) if got else None

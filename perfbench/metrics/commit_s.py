"""From a store's call to its commit (the moment it can be restored), as
the program reports the commit to ``observe_store_reports``: the window of
exposure."""


def read(run):
    got = [s["commit_s"] for s in run.stores if s["commit_s"] is not None]
    return sum(got) / len(got) if got else None

"""The mean duration of the program's ``chk.load`` spans: the restore
directive from inside, ``recover_s`` less the shutdown, the fresh
context and the synchronisation after it."""
from perfbench.spans import seconds


def read(run):
    got = seconds(run.spans, "chk.load")
    return sum(got) / len(got) if got else None

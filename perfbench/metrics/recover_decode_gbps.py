"""The restore's CRC verify and decode: the container bytes read (the
``restore.read`` spans' ``bytes``) over the summed duration of the
program's ``restore.decode`` spans, in GB/s."""
from perfbench.spans import gbps


def read(run):
    return gbps(run.spans, "restore.decode", counted="restore.read")

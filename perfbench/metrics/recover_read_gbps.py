"""The restore's container read: the bytes the program's ``restore.read``
spans returned (their ``bytes`` arg, what
``openchk_restore_read_bytes_total`` counts) over the spans' summed
duration, in GB/s."""
from perfbench.spans import gbps


def read(run):
    return gbps(run.spans, "restore.read")

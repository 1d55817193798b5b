"""The restore's placement on the card: the bytes of the host arrays the
program's ``restore.h2d`` spans put on the template's devices (their
``bytes`` arg, what ``openchk_h2d_bytes_total`` counts) over the spans'
summed duration, in GB/s."""
from perfbench.spans import gbps


def read(run):
    return gbps(run.spans, "restore.h2d")

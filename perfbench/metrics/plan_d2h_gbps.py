"""Plan's device-to-host snapshot rate: the bytes of the tensors the
program's ``plan.d2h`` spans copied (their ``bytes`` arg, what
``openchk_d2h_bytes_total`` counts) over the spans' summed duration, in
GB/s."""
from perfbench.spans import gbps


def read(run):
    return gbps(run.spans, "plan.d2h")

"""The flash kernel's share of its roofline: the least time of every
launch in the traced window (``perfbench/work.py``, at the shapes of the
cell's attention calls) over the device time of the kernels named
``flash_tc_kernel``, in %.  Nothing when the launches are not a whole
number of forward passes."""

from perfbench.devtrace import kernel_time
from perfbench.work import flash_bound_s

KERNEL = "flash_tc_kernel"


def read(run):
    if run.device_trace is None:
        return None
    n, secs = kernel_time(run.device_trace, KERNEL)
    one = run.family.attention_launches(run.cfg, run.job)
    if n == 0 or secs <= 0 or n % len(one):
        return None
    return 100.0 * (n // len(one)) * sum(map(flash_bound_s, one)) / secs

"""The block hash's share of its roofline in the stores' Plan: the bytes
of every leaf of the state on the card, read once, and their digests at
3.35 TB/s, over the device time of the kernels named
``blockhash2_kernel``, in %.  Nothing unless each store launched it once
per leaf on the card."""

from perfbench.devtrace import kernel_time
from perfbench.peaks import HBM_BYTES_PER_S
from perfbench.work import blockhash_bytes

KERNEL = "blockhash2_kernel"


def read(run):
    if run.device_trace is None or not run.stores:
        return None
    n, secs = kernel_time(run.device_trace, KERNEL)
    leaves = run.card_leaf_bytes
    if secs <= 0 or n != len(leaves) * len(run.stores):
        return None
    moved = len(run.stores) * sum(map(blockhash_bytes, leaves))
    return 100.0 * moved / HBM_BYTES_PER_S / secs

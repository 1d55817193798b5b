"""The flash backward kernels' share of their roofline: the least time of
every backward in the traced window, at the shapes of the cell's attention
calls, over the device time of the kernels whose name holds ``flash_bwd``,
in %.  One backward launches each of its kernels once; the backwards are
counted from ``flash_bwd_dq_kernel``'s launches.  Nothing where no such
kernel ran (the plain backward), or when the launches are not a whole
number of backward passes.

The bound of one backward is the larger of its operations at the dense
bf16 peak and its bytes at the memory bandwidth: five products of dh
multiply-adds per (query, key) pair, 10·dh FLOPs, over the forward's pairs
(the lower triangle with its diagonal where causal); q, k, v and the
output's gradient read, dq, dk and dv written, and each query row's
log-sum-exp and D (f32) once each."""

from perfbench.devtrace import kernel_time
from perfbench.work import bound_s

KERNELS = "flash_bwd"
ONE_PER_PASS = "flash_bwd_dq_kernel"


def flash_bwd_work(b: int, s: int, sk: int, h: int, kv: int, dh: int,
                   causal: bool, elem_bytes: int = 2):
    """One backward at (B, S, Sk, H, KV, dh, causal) → (FLOPs, bytes)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * sk)
    flops = 10.0 * dh * pairs
    nbytes = elem_bytes * (3 * b * s * h * dh + 4 * b * sk * kv * dh) \
        + 8 * b * h * s
    return flops, nbytes


def flash_bwd_bound_s(shape) -> float:
    return bound_s(*flash_bwd_work(*shape))[0]


def read(run):
    if run.device_trace is None:
        return None
    n, _ = kernel_time(run.device_trace, ONE_PER_PASS)
    _, secs = kernel_time(run.device_trace, KERNELS)
    one = run.family.attention_launches(run.cfg, run.job)
    if n == 0 or secs <= 0 or n % len(one):
        return None
    return 100.0 * (n // len(one)) * sum(map(flash_bwd_bound_s, one)) / secs

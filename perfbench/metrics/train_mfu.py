"""The training step's share of the card's bf16 peak: the model FLOPs of
the steps run in the traced window (forward and backward, without remat's
recompute; ``perfbench/reference/<family>.py``) over their synchronised
time, in %."""

from perfbench.peaks import BF16_FLOPS_PER_S


def read(run):
    if not run.step_times or run.device_trace is None:
        return None
    flops = run.model_flops * len(run.step_times)
    return 100.0 * flops / sum(run.step_times) / BF16_FLOPS_PER_S

"""Loss tokens of the steps the final state holds, counted from the state
at the window's start, over the whole window: work lost to a fault, the
store's stall and the recovery all count against it."""


def read(run):
    return (run.final_step - run.step0) * run.loss_tokens / run.window_s

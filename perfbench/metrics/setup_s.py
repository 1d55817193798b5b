"""From process start to the first timed step: imports, the card's
start-up, the kernels' build where the checkout has none, the weights and
batches, the first steps and the warm-up."""


def read(run):
    return run.setup_s

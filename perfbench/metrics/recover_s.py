"""From the fault to the restored state on the card, synchronised: the
faulted state dropped, the context shut down, a fresh context and its
``load`` into a template that holds no device memory."""


def read(run):
    return run.recover_s

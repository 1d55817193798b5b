"""repro_torch.chaos — the fault-injection plane (:mod:`.inject`): named
fault sites at the seams the stack already has (tier place/commit, …),
armed in-process or via the ``OPENCHK_CHAOS`` env/JSON spec, and the
Daly-optimal cadence controller (:mod:`.cadence`).  The scenario matrix
and runner of the JAX package are not ported yet.
"""
from repro_torch.chaos.inject import (  # noqa: F401
    ChaosRegistry,
    FaultSpec,
    InjectedFault,
    arm,
    fire,
    registry,
    reset,
)

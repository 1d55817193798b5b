"""repro_torch.chaos — fault-scenario harness + Daly-optimal checkpoint cadence.

Four modules (ROADMAP "adaptive cadence + fault-scenario harness"):

    inject.py     the injection plane: named fault sites at the seams the
                  stack already has (tier place/commit, objstore put/get,
                  chunk-stream boundaries, heartbeat, deploy polls, train
                  steps), armed in-process or via the ``OPENCHK_CHAOS``
                  env/JSON spec so subprocess children arm the same faults
                  without code changes.
    scenarios.py  declarative end-to-end fault scenarios (node loss
                  mid-store, straggler demotion, mesh shrink, objstore
                  outage, corrupt chunk, and three compound ones), each run
                  as store → inject → restart → verify-bit-exact, with the
                  payloads on an explicit device.
    runner.py     drives the scenario matrix across backends and emits a
                  machine-readable report (faults fired, recovery path,
                  recovery wall time, data loss).
    cadence.py    Daly's optimum-interval equations: per-tier checkpoint
                  intervals from measured store cost, recovery cost and an
                  online MTBF estimate — frequent L1, Daly-optimal L4 —
                  plus progress-rate / checkpoint-efficiency datapoints.
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

"""``correct`` comes out false when the timed path is broken underneath: a
run on the CPU at a tiny size (the harness's look for a card skipped)
with a fault planted under it, judged against each cell's own limits —
the faults a one-chip training cell can have: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, and a restored leaf altered where the restore produces it.  The
sound run beside them comes out correct."""
import time

import pytest
import torch

from perfbench import harness, spec, tiny

BENCH = spec.load()
FAULTS = {
    "smollm2-1.7b.train-restart": [None, "unchanged", "half_batch",
                                   "corrupt_restore"],
    "smollm2-1.7b.train-steady": [None, "unchanged", "half_batch"],
}
CASES = [(c, f) for c, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_planted_fault_is_not_correct(tmp_path, cell, fault):
    torch.set_num_threads(2)
    out = harness.run_cell(BENCH, spec.cell(BENCH, cell), 2**31 + 7, 1.0,
                           False, torch.device("cpu"), time.time(),
                           workdir=tmp_path, shrink=tiny.shrink, fault=fault)
    assert out["correct"] is (fault is None), out["checks"]


def test_every_cell_is_covered():
    assert set(FAULTS) == {w["name"] for w in BENCH["workloads"]}

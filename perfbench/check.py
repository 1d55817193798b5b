"""The numbers that decide ``correct``, and their judgement against the
configuration's limits (``perfbench/limits/<config>.json``).

Training: the program's first steps, run in set-up through the window's
own step on rows that all differ, against the plain reference's same
steps from the same weights and batches.

- ``loss_gap``: the widest gap of a step's loss, over the reference's.
- ``grad_gap``: the first step's gradient as the optimizer got it (the
  program's from its first moment, m / (1 - b1)), by the worst leaf: the
  gap between the two norms of a leaf over the larger of the reference's
  norm of that leaf and of the median leaf.
- ``change_gap``: the parameters' change over the first three steps, by
  the worst leaf, measured alike.  Leaves whose reference gradient is
  under a thousandth of the median leaf's move under Adam by rounding
  alone and are left out.

A restart's checkpoint and resume:

- ``restore_mismatch``: leaves of the restored state not equal, bit for
  bit, to the benchmark's own copy of the state taken at the store.
- ``replay_mismatch``: steps after the restore, re-run from the
  checkpoint, whose loss is not bit for bit the loss the same step had
  before the fault (the kernels run deterministically).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[List[str]] = None) -> Dict[str, float]:
    """{leaf: gap between the two norms over the larger of the reference's
    norm of the leaf and of the median leaf}."""
    keys = leaves if leaves is not None else list(ref)
    med = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[List[str]] = None) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= 1e-3 * med]


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [per step], "grad": {leaf: norm},
    "change": {leaf: norm}} → the gaps."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                       ref["loss"]))
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": leaf_gap(prog["change"], ref["change"],
                                   counted_leaves(ref["grad"]))}


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]
          ) -> Tuple[bool, Dict[str, Dict]]:
    """→ (every number within its limit, {name: {"value", "limit"}})."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits[name]["limit"]
        out[name] = {"value": value, "limit": lim}
        if not value <= lim:
            ok = False
    return ok, out

"""A cell's configuration cut to a size the CPU runs in seconds, for the
harness's tests: the same families, paths and schedule, in float32 (so the
program and the reference agree to rounding, and a planted fault stands
out against the cell's own limits)."""
from __future__ import annotations

from typing import Dict, Tuple

TINY = {
    "dense_lm": {"hidden_size": 64, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "num_key_value_heads": 2,
                 "intermediate_size": 128, "vocab_size": 512},
}
JOB = {"dense_lm": {"batch": 4, "tokens": 64, "reference_rows": 2}}


def shrink(cfg: Dict, job: Dict) -> Tuple[Dict, Dict]:
    fam = cfg["reference"]
    cfg = dict(cfg, **TINY[fam], compute_dtype="float32")
    job = dict(job, **JOB[fam])
    return cfg, job

"""Roofline analysis from the compiled dry-run artifact (no real hardware).

Three terms per (arch × shape × mesh), in seconds:

    compute    = HLO_FLOPs / peak_FLOP/s            (per-device program)
    memory     = HLO_bytes / HBM_bw
    collective = wire_bytes / link_bw

``cost_analysis()`` provides FLOPs/bytes of the per-device SPMD module.
Collective bytes are not in cost_analysis: we parse the compiled HLO text,
classify every collective op, and apply a ring-algorithm wire-cost model
per participating device:

    all-gather      out·(n−1)/n         reduce-scatter  in·(n−1)/n
    all-reduce      2·out·(n−1)/n       all-to-all      out·(n−1)/n
    collective-permute  out

where n = replica-group size parsed from the op. This is the bytes each
device puts on its ICI link(s); one active link direction is assumed
(conservative — a 2D torus overlaps axes).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.roofline import hw

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_PAIRS_RE = re.compile(r"source_target_pairs=\{")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    out_bytes: Dict[str, int] = field(default_factory=dict)
    wire_bytes: float = 0.0
    details: List[Dict[str, Any]] = field(default_factory=list)

    def add(self, op: str, nbytes: int, group: int, wire: float, line_no: int):
        self.counts[op] = self.counts.get(op, 0) + 1
        self.out_bytes[op] = self.out_bytes.get(op, 0) + nbytes
        self.wire_bytes += wire
        if len(self.details) < 400:
            self.details.append({"op": op, "bytes": nbytes, "group": group,
                                 "wire": wire, "line": line_no})


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Scan compiled HLO for collective ops; sum modeled wire bytes."""
    stats = CollectiveStats()
    for ln, line in enumerate(hlo_text.splitlines()):
        s = line.strip()
        m = re.match(r"%?[\w.\-]+ = (.+?) (all-reduce|all-gather|"
                     r"reduce-scatter|all-to-all|collective-permute)"
                     r"(-start|-done)?\(", s)
        if not m:
            continue
        type_str, op, phase = m.group(1), m.group(2), m.group(3)
        if phase == "-done":        # counted at -start
            continue
        nbytes = _shape_bytes(type_str)
        if nbytes == 0:
            continue
        g = _GROUPS_RE.search(s)
        if g:
            group = len(g.group(1).split(","))
        else:
            gi = _GROUPS_IOTA_RE.search(s)
            group = int(gi.group(2)) if gi else 2
        if group <= 1:
            continue
        frac = (group - 1) / group
        if op == "all-reduce":
            wire = 2.0 * nbytes * frac
        elif op == "collective-permute":
            wire = float(nbytes)
        elif op == "all-gather":
            wire = nbytes * frac           # nbytes is the gathered output
        elif op == "reduce-scatter":
            wire = nbytes * (group - 1)    # nbytes is the scattered output
        else:                              # all-to-all
            wire = nbytes * frac
        stats.add(op, nbytes, group, wire, ln)
    return stats


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops_total: float
    peak_memory_per_device: Optional[float] = None
    collectives: Optional[Dict[str, Any]] = None

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs × chips) — remat/dispatch/padding waste."""
        total_hlo = self.flops_per_device * self.chips
        return self.model_flops_total / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time / bound time — the score the perf loop drives up."""
        t_useful = self.model_flops_total / (self.chips * hw.PEAK_FLOPS_BF16)
        return t_useful / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in (
            "arch", "shape", "mesh", "chips", "flops_per_device",
            "bytes_per_device", "wire_bytes_per_device", "t_compute",
            "t_memory", "t_collective", "model_flops_total",
            "peak_memory_per_device")}
        d.update(bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction,
                 collectives=self.collectives)
        return d


def build_report(arch: str, shape: str, mesh_name: str, chips: int,
                 cost: Dict[str, float], hlo_text: str,
                 model_flops_total: float,
                 peak_memory: Optional[float] = None) -> RooflineReport:
    coll = parse_collectives(hlo_text)
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops,
        bytes_per_device=nbytes,
        wire_bytes_per_device=coll.wire_bytes,
        t_compute=flops / hw.PEAK_FLOPS_BF16,
        t_memory=nbytes / hw.HBM_BW,
        t_collective=coll.wire_bytes / hw.ICI_LINK_BW,
        model_flops_total=model_flops_total,
        peak_memory_per_device=peak_memory,
        collectives={"counts": coll.counts, "out_bytes": coll.out_bytes},
    )

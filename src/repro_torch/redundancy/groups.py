"""Node groups for redundancy schemes.

FTI/VeloC detect topology automatically and pick partners; SCR additionally
lets users define custom groups (e.g. all nodes on one power supply). Both
models are supported: ``auto_groups`` (ring partners + contiguous erasure
groups) and explicit group maps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class Topology:
    world: int
    ranks_per_node: int = 1
    group_size: int = 4            # erasure-group width (FTI default 4)
    custom_groups: Optional[Dict[str, List[List[int]]]] = None  # SCR-style

    @property
    def n_nodes(self) -> int:
        return self.world // self.ranks_per_node

    def node_of(self, rank: int) -> int:
        return rank // self.ranks_per_node

    def partner_of(self, rank: int) -> int:
        """Ring partner on a *different node* where possible (FTI L2)."""
        step = self.ranks_per_node
        if self.world <= step:      # single node: fall back to ring
            step = 1
        return (rank + step) % self.world

    def erasure_group(self, rank: int) -> List[int]:
        """Contiguous group of ``group_size`` ranks containing ``rank``."""
        g = self.group_size
        if self.custom_groups and "erasure" in self.custom_groups:
            for grp in self.custom_groups["erasure"]:
                if rank in grp:
                    return list(grp)
        start = (rank // g) * g
        return [r for r in range(start, min(start + g, self.world))]

    def group_index(self, rank: int) -> int:
        return rank // self.group_size

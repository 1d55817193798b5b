"""Backend selection — the portability mechanism of the paper.

The backend is chosen at *runtime* from config or the ``OPENCHK_BACKEND``
environment variable; application code is identical for all three
(``examples/multibackend_portability.py`` runs the same training script
under each backend with zero source changes).
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.backends.base import Backend
from repro_torch.backends.fti import FTIBackend
from repro_torch.backends.scr import SCRBackend
from repro_torch.backends.veloc import VeloCBackend
from repro_torch.core.comm import Communicator
from repro_torch.core.storage import StorageConfig

BACKENDS = {
    "fti": FTIBackend,
    "scr": SCRBackend,
    "veloc": VeloCBackend,
}

ENV_VAR = "OPENCHK_BACKEND"


def make_backend(cfg: StorageConfig, comm: Communicator,
                 name: Optional[str] = None, **kw) -> Backend:
    name = name or os.environ.get(ENV_VAR, "fti")
    if name not in BACKENDS:
        raise KeyError(f"unknown backend {name!r}; have {sorted(BACKENDS)}")
    return BACKENDS[name](cfg, comm, **kw)

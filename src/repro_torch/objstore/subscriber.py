"""Catalog subscriber — the watch side of checkpoint-as-deployment.

A serving fleet follows the training run's object store, not a push
channel: the catalog's CAS epoch counts every publish, so "is there a
new checkpoint?" is one integer comparison per poll
(:meth:`~repro_torch.objstore.catalog.Catalog.read_if_newer`), and "which one
should we serve?" is a :class:`DeploySelector` query over the typed
:class:`~repro_torch.objstore.inspect.CatalogView`.  The subscriber never
parses ``catalog.json`` by hand and never downloads anything — it only
decides *what* to deploy; the chunk-delta pull and the rolling swap live
in ``repro_torch.serve.deploy``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.objstore.catalog import Catalog
from repro_torch.objstore.client import ObjectStore
from repro_torch.objstore.inspect import CatalogView, ChunkDelta, EntryInfo


@dataclass(frozen=True)
class DeploySelector:
    """Which published entries a fleet is willing to serve.  The default
    tracks the newest ``kind=FULL`` checkpoint — diffs are partial trees
    and never deployable on their own."""
    kind: Optional[str] = "FULL"
    level: Optional[int] = None
    min_id: int = 0

    def matches(self, e: EntryInfo) -> bool:
        return ((self.kind is None or e.kind == self.kind)
                and (self.level is None or e.level == self.level)
                and e.id >= self.min_id)

    def resolve(self, view: CatalogView) -> Optional[EntryInfo]:
        return view.latest(kind=self.kind, level=self.level,
                           min_id=self.min_id or None)


class CatalogSubscriber:
    """Polls catalog epochs and surfaces newly published entries that
    match the selector.

    State is two fields: ``last_epoch`` (the newest catalog epoch
    already examined — stale polls return without parsing entries) and
    ``deployed`` (the entry the fleet currently serves — the *base* of
    every chunk delta).  ``deployed`` only advances via
    :meth:`mark_deployed`, i.e. after the fleet actually converged; a
    failed rollout keeps the old base so the retry recomputes the same
    delta.  Object-store outages propagate as ``ObjectStoreError`` from
    :meth:`poll` — backoff policy belongs to the deployer, not here.
    """

    def __init__(self, store: ObjectStore,
                 selector: DeploySelector = DeploySelector()):
        self.catalog = Catalog(store)
        self.selector = selector
        self.last_epoch = -1           # first poll always reads
        self.deployed: Optional[EntryInfo] = None

    def poll(self) -> Optional[EntryInfo]:
        """One watch step: → the entry the fleet *should* be serving, or
        ``None`` when the catalog has nothing newer to offer (no epoch
        movement, no selector match, or the match is already deployed)."""
        got = self.catalog.read_if_newer(self.last_epoch)
        if got is None:
            return None
        cat, epoch = got
        self.last_epoch = epoch
        target = self.selector.resolve(CatalogView.from_json(cat))
        if target is None:
            return None
        if self.deployed is not None and target.id == self.deployed.id:
            return None
        return target

    def delta(self, target: EntryInfo) -> ChunkDelta:
        """The chunk pull moving the fleet from its deployed entry to
        ``target`` costs (the whole entry for a cold fleet)."""
        return CatalogView.diff(self.deployed, target)

    def mark_deployed(self, entry: EntryInfo) -> None:
        """The fleet converged on ``entry`` — it becomes the delta base."""
        self.deployed = entry

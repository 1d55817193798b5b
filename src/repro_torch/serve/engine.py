"""Serving engine: batched prefill + incremental decode with KV caches (or
MLA latent caches, or the recurrent states of SSM layers).

The PyTorch counterpart of ``repro.serve.engine``.  The engine's state
(caches + position + last token) is a tree of tensors, so OpenCHK can
checkpoint a *serving* process too — a failed server resumes decoding
without re-running prefill (examples/torch_serve_resilient.py).  Its leaf
names, dtypes and shapes are the reference's (``caches/0/k`` or, for
MLA, ``caches/0/c_kv`` and ``caches/0/k_rope``, for RWKV6
``caches/0/tm_shift``, ``caches/0/cm_shift`` and ``caches/0/wkv``; ``pos``
int32 scalar, ``last_token`` (B, 1) int32), so a serving checkpoint
written by either package restores in the other.

Weights are an explicit :class:`WeightsHandle` — an epoch-tagged,
provenance-carrying immutable record — not a bare attribute.
:meth:`ServingEngine.set_weights` is the **only** mutation path, and the
flip is atomic (one attribute assignment of an immutable handle):
``generate()`` captures the handle once per batch, so an in-flight batch
finishes entirely on the weights it started with and the next batch picks
up the new epoch — the zero-downtime hot-swap contract the deploy
subscriber (``repro_torch.serve.deploy``) builds on.

What differs from the reference, for eager PyTorch:

- The parameters are cast to the compute dtype once per handle
  (:meth:`WeightsHandle.compute_params`), not once per token; the decode
  step's own cast is then a no-op, so the result is bit-identical.
- Decode runs under ``torch.inference_mode()`` and writes the caches in
  place.  The engine owns its cache buffers: :meth:`ServingEngine.set_state`
  copies the state it is given and :meth:`ServingEngine.get_state` returns
  a copy, so no two engines (and no caller) share a buffer.  ``pos`` is a
  0-d int32 tensor on the host, so a step never waits on the device for
  it; ``last_token`` lives with the parameters.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.protect import flatten_named, unflatten_named
from repro_torch.dist.context import bounded_placements, is_dtensor, \
    to_placements
from repro_torch.models.layers import cast_floating
from repro_torch.models.transformer import dtype_of
from repro_torch.models.zoo import Model
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace


class ServeState(NamedTuple):
    caches: Any
    pos: torch.Tensor            # 0-d int32 on the host — next write position
    last_token: torch.Tensor     # (B, 1) int32


@dataclass(frozen=True)
class WeightsHandle:
    """The weights a serving engine holds, with their provenance: the
    param tree plus the deploy epoch that installed it, the catalog
    entry it came from, and the placement it was assembled onto.  Frozen —
    a swap replaces the whole handle, never a leaf inside one, so a
    reader holding a handle can never observe a torn tree."""
    params: Any
    epoch: int = 0                       # monotonic per-engine swap count
    entry_id: Optional[int] = None       # catalog entry id (None = local)
    sharding: Any = None                 # leaf → device map (or None)
    _cast: Any = field(default=None, init=False, repr=False, compare=False)

    def compute_params(self, dtype: torch.dtype) -> Any:
        """The params with every floating leaf in ``dtype``, cast once per
        handle (a leaf already in ``dtype`` is the same tensor)."""
        got = self._cast
        if got is None or got[0] != dtype:
            got = (dtype, cast_floating(self.params, dtype))
            object.__setattr__(self, "_cast", got)
        return got[1]


def make_serve_step(model: Model
                    ) -> Callable[..., Tuple[torch.Tensor, Any]]:
    """serve_step(params, token (B,1), caches, pos) → (next_token, caches).

    Greedy argmax sampling (deterministic — serving benchmarks measure the
    system, not the sampler).  On ``DTensor`` parameters, caches and token
    (the caches batch- or sequence-sharded by ``dist/sharding.
    cache_shardings``) the step runs sharded and returns a ``DTensor``
    token with the logits' batch layout.
    """

    def serve_step(params, token, caches, pos):
        logits, caches = model.decode_step(params, token, caches, pos)
        nxt = torch.argmax(gather_vocab(logits[:, -1:]), dim=-1).to(
            torch.int32)
        return nxt, caches

    return serve_step


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Logits whose vocab dim is sharded (a ``DTensor``) with every rank
    holding the whole vocab of its rows, for an argmax; others as they
    are."""
    if not is_dtensor(logits):
        return logits
    return to_placements(logits, bounded_placements(logits, (0,)))


def _copy_state(st: ServeState) -> ServeState:
    """A ServeState that shares no buffer with ``st``."""
    caches = unflatten_named({k: v.clone() for k, v in
                              flatten_named(st.caches).items()}, st.caches)
    pos = torch.as_tensor(st.pos, dtype=torch.int32).to("cpu", copy=True)
    return ServeState(caches, pos, st.last_token.clone())


class ServingEngine:
    """Minimal batched serving loop over a fixed request batch."""

    def __init__(self, model: Model, params: Any, batch: int, max_len: int,
                 name: str = "serve"):
        self.model = model
        #: telemetry label for this engine's swap events and gauges; a
        #: FleetDeployer re-stamps it with the replica name it manages
        self.name = name
        if not isinstance(params, WeightsHandle):
            params = WeightsHandle(params=params)
        self._weights = params
        self._swap_lock = threading.Lock()
        self.batch = batch
        self.max_len = max_len
        self._cdt = dtype_of(model.cfg.compute_dtype)
        self._step = make_serve_step(model)
        self._decode_warm = model.decode_step
        self.state: Optional[ServeState] = None
        #: called as ``swap_hook(old_handle, new_handle)`` after every
        #: successful set_weights — deploy readiness reporting
        self.swap_hook: Optional[Callable[[WeightsHandle, WeightsHandle],
                                          None]] = None

    # --- the weights surface --------------------------------------------- #

    @property
    def weights(self) -> WeightsHandle:
        return self._weights

    @property
    def params(self) -> Any:
        """The current param tree (read-only view of the handle —
        mutation goes through :meth:`set_weights`)."""
        return self._weights.params

    def set_weights(self, handle: WeightsHandle) -> WeightsHandle:
        """The only weights mutation path: atomically flip the engine to
        ``handle``.  A zero/unset epoch is stamped monotonically so every
        swap is observable.  In-flight ``generate()`` batches captured the
        old handle and finish on it; the next batch serves the new one."""
        if not isinstance(handle, WeightsHandle):
            raise TypeError(
                f"set_weights takes a WeightsHandle, not "
                f"{type(handle).__name__} — wrap the tree: "
                f"WeightsHandle(params=...)")
        with self._swap_lock:
            old = self._weights
            if handle.epoch <= old.epoch:
                handle = WeightsHandle(
                    params=handle.params, epoch=old.epoch + 1,
                    entry_id=handle.entry_id, sharding=handle.sharding)
            self._weights = handle       # the atomic flip
        # every swap is a telemetry event + gauge update: the fleet-wide
        # epoch/entry view (fleet_epochs, /readyz payloads, dashboards)
        # reads these instead of bespoke dicts
        ttrace.instant("serve.swap", replica=self.name, epoch=handle.epoch,
                       entry=handle.entry_id)
        tmetrics.gauge("openchk_serve_epoch",
                       replica=self.name).set(handle.epoch)
        tmetrics.gauge("openchk_fleet_entry_id", replica=self.name).set(
            -1 if handle.entry_id is None else handle.entry_id)
        if self.swap_hook is not None:
            self.swap_hook(old, handle)
        return handle

    # --- serving --------------------------------------------------------- #

    def _device(self, params: Any) -> torch.device:
        return params["embed"].device

    def prefill(self, prompts: torch.Tensor) -> None:
        """Sequential prefill through the decode path (cache-exact, as the
        reference does it)."""
        b, s = prompts.shape
        if s == 0:
            raise ValueError(
                "prefill needs at least one prompt token per sequence "
                f"(got prompt_len=0 for batch {b}) — there are no logits "
                "to seed decoding from an empty prompt")
        handle = self._weights          # one capture — swap-consistent
        with torch.inference_mode():
            params = handle.compute_params(self._cdt)
            caches = self.model.init_caches(b, self.max_len,
                                            device=self._device(params))
            for i in range(s):
                logits, caches = self._decode_warm(
                    params, prompts[:, i: i + 1], caches, i)
            nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        self.state = ServeState(caches, torch.tensor(s, dtype=torch.int32),
                                nxt)

    def generate(self, n_tokens: int) -> torch.Tensor:
        assert self.state is not None, "prefill first (or restore a checkpoint)"
        toks = []
        st = self.state
        # capture the handle once: this batch runs to completion on the
        # weights it started with, even if set_weights flips mid-loop —
        # a swap is only ever observable at a batch boundary
        handle = self._weights
        with torch.inference_mode():
            params = handle.compute_params(self._cdt)
            for _ in range(n_tokens):
                nxt, caches = self._step(params, st.last_token, st.caches,
                                         st.pos)
                st = ServeState(caches, st.pos + 1, nxt)
                toks.append(nxt)
        self.state = st
        return torch.cat(toks, dim=1)

    # --- checkpointable serving state (OpenCHK integration) -------------- #
    def get_state(self) -> Optional[ServeState]:
        """A copy of the engine's state: later decode steps (which write
        the engine's caches in place) do not reach it."""
        return None if self.state is None else _copy_state(self.state)

    def set_state(self, st: ServeState) -> None:
        """Serve from a copy of ``st`` (a restored checkpoint, or another
        engine's state)."""
        self.state = _copy_state(st)

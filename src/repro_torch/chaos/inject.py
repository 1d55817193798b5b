"""Injection plane: named fault sites over the stack's existing seams.

The pipeline already has well-defined failure boundaries — tier place/commit
loops in ``core/pipeline.py``, ``ObjectStore.put/get``, ``ChunkStream``
chunk-boundary emits, the heartbeat write, ``FleetDeployer`` swap attempts,
and the per-step hook in ``train/loop.py``. Each of those calls
:func:`fire` with a dotted site name; a site is inert (one dict lookup)
until a :class:`FaultSpec` is armed against it.

Specs generalize ``ft/failures.FaultInjector`` from one-fault-at-90% to:

* scheduled  — ``at=N`` fires on the N-th hit of the site
* repeating  — ``every=K`` fires on every K-th hit, up to ``times`` fires
* probabilistic — ``prob=p`` fires each hit with probability ``p``
  (seeded; deterministic per spec)

and four modes: ``error`` (raise the site's natural exception type),
``exit`` (``os._exit(39)``, same hard-kill contract as FaultInjector),
``delay`` (sleep ``delay_s`` — stragglers), ``corrupt`` (flip bytes in the
payload passing through the site), ``skip`` (suppress the operation — e.g.
a heartbeat write that never lands).

Process-safe activation: ``OPENCHK_CHAOS`` holds either a JSON list of spec
dicts or ``@/path/to/spec.json``. The registry loads it lazily on first
use, so subprocess children of ``launch/train.py`` and the forced-16-device
lanes arm the same faults without code changes. Malformed specs warn and
are ignored — a bad env var must never crash a launcher at import time.

Restart-durable counters: ``OPENCHK_CHAOS_STATE`` names a JSON file where
each spec's hit/fired counters (and RNG state, for ``prob`` specs) persist
across process deaths — written atomically on every counted hit and, for
``exit`` mode, *before* ``os._exit``. A restarted child reloads the file
and resumes each spec mid-schedule: an exhausted ``every=8, times=1`` kill
spec stays exhausted instead of re-killing every restart at the same hit
count. Specs declare ``rearm`` (default True = stay armed across
restarts); :func:`restart_env` applies those semantics for supervisors,
replacing the old blanket ``env.pop(OPENCHK_CHAOS)``. Malformed state
warns and is ignored, like the env protocol.

Stdlib-only on purpose: every instrumented module (objstore client, chunk
streams, pipeline, detector) can import this leaf without cycles.  The one
repro import is :mod:`repro.telemetry` — itself a stdlib-only leaf — so
every fired fault is also a trace instant and a fault counter.
"""
from __future__ import annotations

import fnmatch
import hashlib
import json
import os
import random
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# telemetry is the one permitted repro import: like this module it is a
# stdlib-only leaf, so the no-cycle rule holds.  Every fired fault lands
# on the trace timeline (the fault → kill → restart → resume narrative
# chktrace reconstructs) and on the fault counters.
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace

CHAOS_ENV = "OPENCHK_CHAOS"
CHAOS_STATE_ENV = "OPENCHK_CHAOS_STATE"
LEGACY_INJECT_ENV = "OPENCHK_INJECT_AT"
EXIT_CODE = 39  # matches ft.failures.FaultInjector's hard-kill contract

_MODES = ("error", "exit", "delay", "corrupt", "skip")


class InjectedFault(RuntimeError):
    """Raised by an ``error``-mode spec when the site has no natural type."""


@dataclass
class FaultSpec:
    """One armed fault: where it triggers, when, and what it does."""

    site: str  # dotted site name; fnmatch globs allowed ("objstore.*")
    mode: str = "error"
    at: Optional[int] = None  # fire on the at-th hit (1-based)
    every: Optional[int] = None  # fire on every every-th hit
    prob: Optional[float] = None  # fire each hit with this probability
    times: Optional[int] = 1  # max fires (None = unlimited)
    delay_s: float = 0.0  # sleep length for mode="delay"
    seed: int = 0  # rng seed for prob specs
    match: Dict[str, Any] = field(default_factory=dict)  # ctx filter
    message: str = ""
    rearm: bool = True  # stay armed across supervised restarts

    def __post_init__(self) -> None:
        if self.mode not in _MODES:
            raise ValueError(f"unknown chaos mode {self.mode!r} (want one of {_MODES})")
        if self.at is None and self.every is None and self.prob is None:
            self.at = 1  # default: fire on the first hit
        self._hits = 0
        self._fired = 0
        self._rng = random.Random(self.seed)

    def matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        if not fnmatch.fnmatchcase(site, self.site):
            return False
        for k, want in self.match.items():
            if str(ctx.get(k)) != str(want):
                return False
        return True

    def should_fire(self) -> bool:
        """Count a hit; decide whether this spec fires on it."""
        if self.times is not None and self._fired >= self.times:
            return False
        self._hits += 1
        fire = False
        if self.at is not None and self._hits == self.at:
            fire = True
        if self.every is not None and self._hits % self.every == 0:
            fire = True
        if self.prob is not None and self._rng.random() < self.prob:
            fire = True
        if fire:
            self._fired += 1
        return fire

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"site": self.site, "mode": self.mode}
        for k in ("at", "every", "prob"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.times != 1:
            d["times"] = self.times
        if self.delay_s:
            d["delay_s"] = self.delay_s
        if self.seed:
            d["seed"] = self.seed
        if self.match:
            d["match"] = self.match
        if self.message:
            d["message"] = self.message
        if not self.rearm:
            d["rearm"] = False
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        known = {
            "site", "mode", "at", "every", "prob", "times",
            "delay_s", "seed", "match", "message", "rearm",
        }
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown chaos spec keys {sorted(extra)}")
        return cls(**d)

    # -- restart-durable counters -----------------------------------------
    def state_key(self) -> str:
        """Stable content hash naming this spec in the durable state file.

        Keyed on the serialized spec, not its position in the env list, so
        a supervisor that rewrites ``OPENCHK_CHAOS`` (dropping a
        ``rearm=False`` sibling) still matches the surviving specs to
        their persisted counters."""
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def counters(self) -> Dict[str, Any]:
        st: Dict[str, Any] = {"hits": self._hits, "fired": self._fired}
        if self.prob is not None:
            version, ints, gauss = self._rng.getstate()
            st["rng"] = [version, list(ints), gauss]
        return st

    def restore_counters(self, st: Dict[str, Any]) -> None:
        self._hits = int(st.get("hits", 0))
        self._fired = int(st.get("fired", 0))
        rng = st.get("rng")
        if rng is not None and self.prob is not None:
            version, ints, gauss = rng
            self._rng.setstate(
                (int(version), tuple(int(i) for i in ints), gauss))


@dataclass
class FiredFault:
    """History record of one fired fault — feeds the MTBF estimator."""

    site: str
    mode: str
    t: float  # time.monotonic() at fire
    ctx: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Outcome:
    """What :func:`fire` decided: possibly-corrupted payload + skip flag."""

    data: Any = None
    skipped: bool = False
    fired: int = 0


_NOOP = Outcome()


def _corrupt_bytes(data: Any) -> Any:
    """Flip the first byte (and a mid byte) of a bytes-like payload."""
    if data is None:
        return None
    b = bytearray(bytes(data))
    if not b:
        return bytes(b)
    b[0] ^= 0xFF
    b[len(b) // 2] ^= 0xFF
    return bytes(b)


class ChaosRegistry:
    """Armed fault specs + per-site counters + fired-fault history.

    Thread-safe: chunk uploads fire from worker threads. The fast path
    (nothing armed) is a single attribute read.
    """

    def __init__(self, env: Optional[Dict[str, str]] = None) -> None:
        self._lock = threading.Lock()
        self._specs: List[FaultSpec] = []
        self._env = env  # None -> os.environ, resolved lazily
        self._env_loaded = False
        self.enabled = False
        self.history: List[FiredFault] = []
        self.site_hits: Dict[str, int] = {}
        self._state_path: Optional[str] = None
        self._persisted: Dict[str, Dict[str, Any]] = {}

    # -- arming -----------------------------------------------------------
    def arm(self, spec: FaultSpec) -> FaultSpec:
        with self._lock:
            self._apply_state_locked(spec)
            self._specs.append(spec)
            self.enabled = True
        return spec

    def disarm_all(self) -> None:
        with self._lock:
            self._specs = []
            self.enabled = False

    def reset(self) -> None:
        """Drop specs, counters, and history; env will be re-read."""
        with self._lock:
            self._specs = []
            self._env_loaded = False
            self.enabled = False
            self.history = []
            self.site_hits = {}
            self._state_path = None
            self._persisted = {}

    # -- restart-durable state file ---------------------------------------
    def set_state_path(self, path: Optional[str]) -> None:
        """Point at the durable counter file; reload + apply to armed specs."""
        with self._lock:
            self._state_path = path
            self._persisted = self._read_state(path) if path else {}
            for spec in self._specs:
                self._apply_state_locked(spec)

    @staticmethod
    def _read_state(path: str) -> Dict[str, Dict[str, Any]]:
        try:
            with open(path, "r", encoding="utf-8") as f:
                st = json.load(f)
            if not isinstance(st, dict):
                raise ValueError("state root must be a JSON object")
            return {str(k): dict(v) for k, v in st.items()}
        except FileNotFoundError:
            return {}
        except (OSError, ValueError, TypeError, AttributeError) as e:
            warnings.warn(
                f"ignoring malformed chaos state at {path}: {e}",
                RuntimeWarning, stacklevel=2)
            return {}

    def _apply_state_locked(self, spec: FaultSpec) -> None:
        st = self._persisted.get(spec.state_key())
        if st is None:
            return
        try:
            spec.restore_counters(st)
        except (ValueError, TypeError) as e:
            warnings.warn(
                f"ignoring malformed chaos state for spec {spec.site!r}: {e}",
                RuntimeWarning, stacklevel=2)

    def _persist_state_locked(self) -> None:
        """Atomically write every armed spec's counters (tmp + replace).

        Called on each counted hit while a state path is set, and — the
        load-bearing case — immediately before an ``exit``-mode
        ``os._exit``, so the kill the spec just dealt is on disk before
        the process dies."""
        if self._state_path is None:
            return
        state = dict(self._persisted)
        for spec in self._specs:
            state[spec.state_key()] = spec.counters()
        tmp = self._state_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(state, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._state_path)
        except OSError as e:
            warnings.warn(
                f"could not persist chaos state to {self._state_path}: {e}",
                RuntimeWarning, stacklevel=2)

    def specs(self) -> List[FaultSpec]:
        self._ensure_env_loaded()
        with self._lock:
            return list(self._specs)

    # -- env activation protocol ------------------------------------------
    def load_env(self, env: Optional[Dict[str, str]] = None) -> int:
        """Parse ``OPENCHK_CHAOS`` and arm its specs. Returns count armed.

        Malformed values warn and arm nothing — never raise at launch time.
        """
        environ = env if env is not None else (self._env if self._env is not None else os.environ)
        raw = environ.get(CHAOS_ENV, "")
        self._env_loaded = True
        state_path = environ.get(CHAOS_STATE_ENV, "")
        if state_path:
            # durable counters load before arming so each armed spec
            # resumes mid-schedule instead of replaying from hit zero
            self.set_state_path(state_path)
        if not raw:
            return 0
        try:
            specs = _parse_specs(raw)
        except (OSError, ValueError, TypeError) as e:
            warnings.warn(
                f"ignoring malformed {CHAOS_ENV}: {e}", RuntimeWarning, stacklevel=2
            )
            return 0
        for s in specs:
            self.arm(s)
        return len(specs)

    def _ensure_env_loaded(self) -> None:
        if not self._env_loaded:
            self.load_env()

    # -- firing ------------------------------------------------------------
    def fire(
        self,
        site: str,
        exc: type = InjectedFault,
        data: Any = None,
        **ctx: Any,
    ) -> Outcome:
        """Hit a fault site. Raises / exits / sleeps / corrupts per armed specs.

        Call sites pass their natural exception type via ``exc`` so the
        injected failure flows through the same handling as a real one
        (e.g. ``ObjectStoreError`` for objstore sites). Returns the payload
        (corrupted if a corrupt-mode spec fired) and a ``skipped`` flag.
        """
        self._ensure_env_loaded()
        if not self.enabled:
            if data is None:
                return _NOOP
            return Outcome(data=data)

        to_raise: Optional[BaseException] = None
        out = Outcome(data=data)
        with self._lock:
            self.site_hits[site] = self.site_hits.get(site, 0) + 1
            mutated = False
            for spec in self._specs:
                if not spec.matches(site, ctx):
                    continue
                mutated = True                 # should_fire counts the hit
                if not spec.should_fire():
                    continue
                out.fired += 1
                self.history.append(
                    FiredFault(site=site, mode=spec.mode, t=time.monotonic(), ctx=dict(ctx))
                )
                # ctx keys are renamed where they would shadow the
                # instant()'s own parameters (e.g. chunkstream's "name")
                ttrace.instant("chaos.fault", site=site, mode=spec.mode,
                               **{(k if k not in ("name", "cat", "scope",
                                                  "site", "mode")
                                   else f"ctx_{k}"): v
                                  for k, v in ctx.items()})
                tmetrics.counter("openchk_faults_fired_total",
                                 site=site, mode=spec.mode).inc()
                if spec.mode == "delay":
                    # sleep outside the lock would be nicer, but delays are
                    # short and scenario-scoped; keep firing atomic.
                    time.sleep(spec.delay_s)
                elif spec.mode == "skip":
                    out.skipped = True
                elif spec.mode == "corrupt":
                    out.data = _corrupt_bytes(out.data)
                elif spec.mode == "exit":
                    # the kill must be on disk before the process dies —
                    # a restarted child that reloads stale counters would
                    # be re-killed at the same hit count.  Same for the
                    # trace: os._exit skips atexit, so flush now — the
                    # fault instant above must survive its own kill
                    self._persist_state_locked()
                    ttrace.flush()
                    os._exit(EXIT_CODE)
                else:  # error
                    msg = spec.message or f"[chaos] injected fault at {site}"
                    to_raise = exc(msg)
            if mutated:
                self._persist_state_locked()
        if to_raise is not None:
            raise to_raise
        return out

    def fired_count(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is None:
                return len(self.history)
            return sum(1 for f in self.history if fnmatch.fnmatchcase(f.site, site))

    def fault_times(self) -> List[float]:
        """Monotonic timestamps of fired faults (MTBF estimator input)."""
        with self._lock:
            return [f.t for f in self.history]


# -- module-level singleton -------------------------------------------------
_REGISTRY = ChaosRegistry()


def registry() -> ChaosRegistry:
    return _REGISTRY


def fire(site: str, exc: type = InjectedFault, data: Any = None, **ctx: Any) -> Outcome:
    return _REGISTRY.fire(site, exc=exc, data=data, **ctx)


def arm(spec_or_site, **kw) -> FaultSpec:
    """``arm(FaultSpec(...))`` or shorthand ``arm("site.name", mode=..., ...)``."""
    if isinstance(spec_or_site, FaultSpec):
        return _REGISTRY.arm(spec_or_site)
    return _REGISTRY.arm(FaultSpec(site=spec_or_site, **kw))


def reset() -> None:
    _REGISTRY.reset()


def _parse_specs(raw: str) -> List[FaultSpec]:
    """Parse an ``OPENCHK_CHAOS`` value (JSON list/dict or ``@file``)."""
    if raw.startswith("@"):
        with open(raw[1:], "r", encoding="utf-8") as f:
            raw = f.read()
    parsed = json.loads(raw)
    if isinstance(parsed, dict):
        parsed = [parsed]
    return [FaultSpec.from_dict(d) for d in parsed]


def env_for_specs(specs: List[FaultSpec],
                  state_path: Optional[str] = None) -> Dict[str, str]:
    """Env fragment arming *specs* in a child process.

    With *state_path*, the child persists per-spec hit/fired counters (and
    RNG state) there, so a restarted child resumes each spec mid-schedule
    instead of replaying it from hit zero."""
    env = {CHAOS_ENV: json.dumps([s.to_dict() for s in specs])}
    if state_path:
        env[CHAOS_STATE_ENV] = state_path
    return env


def restart_env(env: Dict[str, str]) -> Dict[str, str]:
    """Spec-declared rearm semantics for a restarted child's env.

    Replaces the supervisor's old blanket ``env.pop(OPENCHK_CHAOS)``:
    ``rearm=True`` specs (the default) stay armed — the durable state file
    keeps an exhausted spec from re-killing every restarted child at the
    same hit count — while ``rearm=False`` specs are dropped.  The legacy
    one-shot ``OPENCHK_INJECT_AT`` is always dropped.  Malformed values
    warn and are dropped (the load_env contract).  Returns a new dict;
    *env* is not mutated."""
    out = dict(env)
    out.pop(LEGACY_INJECT_ENV, None)
    raw = out.get(CHAOS_ENV, "")
    if not raw:
        return out
    try:
        specs = _parse_specs(raw)
    except (OSError, ValueError, TypeError) as e:
        warnings.warn(
            f"dropping malformed {CHAOS_ENV} on restart: {e}",
            RuntimeWarning, stacklevel=2)
        out.pop(CHAOS_ENV, None)
        return out
    keep = [s for s in specs if s.rearm]
    if not keep:
        out.pop(CHAOS_ENV, None)
        out.pop(CHAOS_STATE_ENV, None)
    elif len(keep) != len(specs):
        out[CHAOS_ENV] = json.dumps([s.to_dict() for s in keep])
    return out


def legacy_inject_at(env: Optional[Dict[str, str]] = None) -> Optional[float]:
    """Back-compat reader for ``OPENCHK_INJECT_AT`` (progress fraction).

    The legacy protocol predates the chaos spec: a single float in [0, 1]
    meaning "one hard fault at this training progress". Malformed values
    warn and return None instead of raising at launcher import time.
    ``ft.failures.should_inject_from_env`` is a shim over this.
    """
    environ = env if env is not None else os.environ
    v = environ.get(LEGACY_INJECT_ENV, "")
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        warnings.warn(
            f"ignoring malformed {LEGACY_INJECT_ENV}={v!r} (want a float progress "
            "fraction; use OPENCHK_CHAOS for scheduled/probabilistic faults)",
            RuntimeWarning,
            stacklevel=2,
        )
        return None


@dataclass
class SiteNames:
    """Canonical site names, for discoverability (docs + scenario specs)."""

    TIER_PLACE = "tier.place"  # ctx: tier, level, ckpt_id, rank
    TIER_COMMIT = "tier.commit"  # ctx: tier, level, ckpt_id, rank
    OBJSTORE_PUT = "objstore.put"  # ctx: key
    OBJSTORE_GET = "objstore.get"  # ctx: key
    OBJSTORE_DELETE = "objstore.delete"  # ctx: key (GC sweep deletes)
    CHUNK_EMIT = "chunkstream.emit"  # ctx: name, seq
    HEARTBEAT = "heartbeat.beat"  # ctx: step
    DEPLOY_POLL = "deploy.poll"  # ctx: replica
    TRAIN_STEP = "train.step"  # ctx: step


SITES = SiteNames()

"""Protection registry: state tree ⇄ named tensors + clause-carrying selectors.

The PyTorch counterpart of ``repro.core.protect``.  Flattening extracts
(path, dtype, shape, device) from the state the user names; the user writes
``ctx.store(state, ...)`` and nothing is hand-serialized.

State trees are nested ``dict`` / ``list`` / ``tuple`` / ``NamedTuple``
containers whose leaves are ``torch.Tensor``s (or numpy arrays / Python
scalars).  Paths and leaf order equal the JAX package's for the same tree:
dict keys are walked in *sorted* order (as jax's pytree registry does), not
insertion order (as ``torch.utils._pytree`` does), and each key is rendered
exactly as jax's ``keystr`` would render it; a NamedTuple's children are
named by field, in field order, as jax names them (``TrainState.step`` is
``step``), while plain tuples and lists keep index names.  So both packages
name and order the leaves of one checkpoint identically.

Selectors are the analogue of *self-iterative data expressions* (§5.2):
``"params/layers/*/wq"`` expands over the tree exactly like
``{data[i], i=0;4}`` expands over an array.  A :class:`Protect` spec is a
selector **plus the paper's per-data clauses** (``kind(DIFF)``,
compression codec, target format/precision, axis metadata).
"""
from __future__ import annotations

import re
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.formats import (
    PRECISIONS,
    numpy_to_tensor,
    str_to_dtype,
    tensor_to_numpy,
    torch_dtype_to_str,
    dtype_to_str,
)
from repro_torch.telemetry import metrics as tmetrics

CHK_FULL = "FULL"
CHK_DIFF = "DIFF"

#: codecs the Pack-side compression tier implements (core/tiers.py)
KNOWN_CODECS = ("int8",)
#: container formats the Pack-side format tier can emit
KNOWN_FORMATS = ("chk5",)
#: the gated-dependency message for ``Protect(format="hdf5")`` — raised at
#: *spec validation* time (constructing the spec), never deep in Pack, so
#: a misconfigured protect fails before any checkpoint machinery runs;
#: pinned verbatim by tests/test_protect_specs.py
HDF5_GATE_MSG = (
    "format='hdf5' needs h5py, which this environment does not ship; "
    "CHK5 keeps the same self-describing semantics (format='chk5')")


@dataclass
class Protect:
    """One protected subtree: a selector plus per-subtree clauses.

    Clause fields (all optional — a clause-less spec is exactly the old
    flat selector):

    ``kind``       checkpoint kind for this subtree (``CHK_FULL`` /
                   ``CHK_DIFF``); ``None`` inherits the store's kind.
                   Mixed-kind stores (DIFF params + FULL optimizer in one
                   checkpoint) are expressed by giving subtrees different
                   kinds.
    ``compress``   Pack-side payload codec (``"int8"`` — per-block max-abs
                   quantization, dist/compression.py), roundtrip-verified
                   on load.
    ``format``     target container format tier (``"chk5"``).
    ``precision``  store-side dtype cast (``"bf16"`` …); restore casts back
                   to the template dtype.
    ``axis``       explicit axis metadata, e.g. ``{"batch": 1}`` — carried
                   to dist/sharding.py (cache layouts) and recorded as
                   dataset attrs.
    ``max_error``  relative-L2 bound for lossy codecs; a leaf whose
                   roundtrip error exceeds it is stored uncompressed
                   (``codec_fallback`` attr records why).
    """

    selector: str
    kind: Optional[str] = None
    compress: Optional[str] = None
    format: Optional[str] = None
    precision: Optional[str] = None
    axis: Optional[Dict[str, int]] = None
    max_error: Optional[float] = None
    _regex: Any = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if not isinstance(self.selector, str) or not self.selector:
            raise ValueError(f"Protect selector must be a non-empty string, "
                             f"got {self.selector!r}")
        if self.kind is not None and self.kind not in (CHK_FULL, CHK_DIFF):
            raise ValueError(f"Protect kind must be {CHK_FULL!r} or "
                             f"{CHK_DIFF!r}, got {self.kind!r}")
        if self.compress is not None and self.compress not in KNOWN_CODECS:
            raise ValueError(f"unknown compress codec {self.compress!r}; "
                             f"have {list(KNOWN_CODECS)}")
        if self.format is not None and self.format not in KNOWN_FORMATS:
            if self.format == "hdf5":
                raise ValueError(HDF5_GATE_MSG)
            raise ValueError(f"unknown format {self.format!r}; "
                             f"have {list(KNOWN_FORMATS)}")
        if self.precision is not None and self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}; "
                             f"have {sorted(PRECISIONS)}")
        if self.axis is not None and not all(
                isinstance(k, str) and isinstance(v, int)
                for k, v in self.axis.items()):
            raise ValueError(f"Protect axis must map str → int dim, "
                             f"got {self.axis!r}")
        self._regex = _selector_regex(self.selector)

    # ------------------------------------------------------------------ #

    def matches(self, path: str) -> bool:
        return self._regex.match(path) is not None

    def clauses(self) -> Dict[str, Any]:
        """The non-empty clause fields — what the format tier records as
        dataset attributes (and ``chkls`` prints)."""
        out: Dict[str, Any] = {}
        for f in ("kind", "compress", "format", "precision", "axis",
                  "max_error"):
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        return out


def _selector_regex(pat: str):
    """``**`` crosses slashes; ``*`` does not."""
    esc = re.escape(pat)
    esc = esc.replace(r"\*\*", ".*").replace(r"\*", "[^/]*")
    return re.compile("^" + esc + "$")


def normalize_protects(
    specs: Optional[Sequence[Union[str, Protect]]],
) -> Optional[List[Protect]]:
    """Directive-level shim: accept ``Protect`` specs and (deprecated)
    plain selector strings; strings become clause-less specs."""
    if not specs:
        return None
    out: List[Protect] = []
    legacy = []
    for s in specs:
        if isinstance(s, Protect):
            out.append(s)
        elif isinstance(s, str):
            legacy.append(s)
            out.append(Protect(s))
        else:
            raise TypeError(f"protect() takes Protect specs or selector "
                            f"strings, got {type(s).__name__}")
    if legacy:
        warnings.warn(
            f"flat selector strings {legacy} are deprecated; use "
            f"Protect(selector, ...) specs (clauses: kind/compress/"
            f"format/precision/axis)", DeprecationWarning, stacklevel=3)
    return out


def _key_str(k) -> str:
    """One dict key → its path component, as jax renders a ``DictKey``
    (``[repr(key)]``) with only the delimiters stripped: ``'name'`` →
    ``name``, ``0`` → ``0``.  A key like ``".hidden"`` or ``"w.q"`` keeps
    its dots, and quotes inside the content stay intact."""
    s = repr(k)
    if len(s) >= 2 and s[0] == s[-1] and s[0] in ("'", '"'):
        s = s[1:-1]
    return s


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> List:
    """(path component, child) pairs of a container in jax's leaf order:
    sorted dict keys, a NamedTuple's fields in field order, list and tuple
    indices."""
    if isinstance(tree, dict):
        return [(_key_str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    return [(str(i), v) for i, v in enumerate(tree)]


def _path_str(path: List[str]) -> str:
    """Path components → the canonical slash path: ``["params", "groups",
    "0", "attn", "wq"]`` → ``"params/groups/0/attn/wq"`` (the one form
    selector matching and the sharding rules' lookup agree on)."""
    return "/".join(path)


def _walk(tree: Any, prefix: List[str], out: List):
    """Depth-first (path components, leaf) pairs in jax's leaf order."""
    if tree is None:
        return                           # jax: None is an empty subtree
    if isinstance(tree, (dict, list, tuple)):
        for key, child in _children(tree):
            _walk(child, prefix + [key], out)
    else:
        out.append((_path_str(prefix), tree))


def flatten_named(tree: Any) -> Dict[str, Any]:
    """→ ``{path: leaf}`` in jax's canonical order (sorted dict keys).

    Unlike the JAX package no treedef is returned: :func:`unflatten_named`
    rebuilds the structure from the restart template itself."""
    pairs: List = []
    _walk(tree, [], pairs)
    named: Dict[str, Any] = {}
    for p, leaf in pairs:
        if p in named:
            raise ValueError(f"duplicate tree path {p!r}")
        named[p] = leaf
    return named


def unflatten_named(named: Dict[str, Any], template: Any,
                    prefix: str = "") -> Any:
    """Rebuild a tree shaped like ``template`` from named leaves (match by
    path; order-free — unlike the paper's order-critical load/store lists)."""
    def sub(key: str) -> str:
        return f"{prefix}/{key}" if prefix else key

    if template is None:
        return None
    if isinstance(template, dict):
        return type(template)(
            (k, unflatten_named(named, v, sub(_key_str(k))))
            for k, v in template.items())
    if _is_namedtuple(template):
        return type(template)(*(unflatten_named(named, v, sub(f))
                                for f, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_named(named, v, sub(str(i)))
                              for i, v in enumerate(template))
    if prefix not in named:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    return named[prefix]


def resolve_specs(
    named: Dict[str, Any],
    protects: Optional[Sequence[Union[str, Protect]]],
) -> Dict[str, Optional[Protect]]:
    """Resolve clause specs over the flattened tree → ``{path: spec}``.

    ``None``/empty → every leaf, clause-less (``{path: None}``).  A leaf
    matched by several specs is selected **once**, governed by the *first*
    matching spec.  A spec that matches no leaf is an error naming the
    offending selector."""
    if not protects:
        return {path: None for path in named}
    specs = normalize_protects(protects)
    out: Dict[str, Optional[Protect]] = {}
    unmatched = []
    for spec in specs:
        hit = False
        for path in named:
            if spec.matches(path):
                hit = True
                out.setdefault(path, spec)     # first matching spec governs
        if not hit:
            unmatched.append(spec.selector)
    if unmatched:
        raise ValueError(
            f"Protect selectors {unmatched} matched no leaves "
            f"(all selectors: {[s.selector for s in specs]}; "
            f"protected paths: {sorted(named)[:8]}"
            f"{' …' if len(named) > 8 else ''})")
    # keep the tree's canonical leaf order, not match order
    return {path: out[path] for path in named if path in out}


def select(named: Dict[str, Any], patterns: Optional[List[str]]) -> Dict[str, Any]:
    """Glob-select protected leaves. ``None`` → everything. ``**`` crosses
    slashes; ``*`` does not.  (Compatibility wrapper over
    :func:`resolve_specs` — kept for callers that only need the leaves.)"""
    if not patterns:
        return dict(named)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        chosen = resolve_specs(named, list(patterns))
    return {path: named[path] for path in chosen}


def to_host(named: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Device→host snapshot of every protected leaf.

    Each tensor is copied synchronously (``Tensor.to("cpu")`` waits for
    the copy), so the snapshot is complete when this returns: an in-place
    update the caller makes afterwards cannot reach it.  CPU tensors and
    numpy leaves are copied as well, for the same reason.  The tensors'
    bytes count in ``openchk_d2h_bytes_total`` (:func:`tensor_bytes`)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in named.items():
        if isinstance(v, torch.Tensor):
            out[k] = tensor_to_numpy(v)
        else:
            out[k] = np.array(v, copy=True)
    n = tensor_bytes(named)
    if n:
        tmetrics.counter("openchk_d2h_bytes_total",
                         memory="pageable").inc(n)
    return out


def tensor_bytes(named: Dict[str, Any]) -> int:
    """Bytes of the tensors among ``named``'s leaves."""
    return sum(v.nbytes for v in named.values()
               if isinstance(v, torch.Tensor))


def from_numpy_named(named_np: Dict[str, np.ndarray],
                     device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """``{path: np.ndarray}`` (e.g. the JAX package's state after
    ``jax.device_get``) → ``{path: Tensor}`` on ``device`` with identical
    bytes, dtype and shape — how state is carried across the packages."""
    return {k: numpy_to_tensor(v, device) for k, v in named_np.items()}


def leaf_meta(named: Dict[str, Any]) -> Dict[str, Dict]:
    """``{path: {"dtype": numpy's dtype string, "shape": [...]}}`` — the
    string numpy gives the leaf's host copy (``"<f4"``; bf16 through
    ml_dtypes, ``"<V2"``), as the JAX package's ``leaf_meta`` gives it."""
    return {k: {"dtype": str_to_dtype(leaf_dtype_str(v)).str,
                "shape": list(v.shape)}
            for k, v in named.items()}


def leaf_dtype_str(leaf: Any) -> str:
    """CHK5 dtype string of a tensor / numpy / scalar leaf."""
    if isinstance(leaf, torch.Tensor):
        return torch_dtype_to_str(leaf.dtype)
    return dtype_to_str(np.asarray(leaf).dtype)

"""Mesh axis conventions and the sharding-hint layer, on a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

Axis conventions (every mesh in this repo uses these names):

- ``MODEL`` (``"model"``) — tensor parallelism. The only axis parameter
  feature dims ever shard over.
- ``DATA`` (``"data"``) — data parallelism (batch dim, ZeRO/FSDP shards).
- ``POD`` (``"pod"``) — an outer data-parallel axis on multi-pod meshes.
  Anything that shards on ``DATA`` folds ``pod`` in: requesting ``DATA``
  resolves to *every non-model axis* of the active mesh, so model code
  never cares whether it runs on ``(data, model)`` or ``(pod, data,
  model)``.

A layout is written per tensor dimension, as the JAX package writes it: a
:class:`PartitionSpec` holds, for each dim, ``None``, one axis name or a
tuple of axis names (major first).  :class:`NamedSharding` binds a spec
to a mesh.  ``DTensor`` speaks per *mesh* dimension instead;
:func:`spec_to_placements` and :func:`placements_to_spec` translate, and
:func:`shard_box` gives the index box a mesh coordinate holds — the
counterpart of ``NamedSharding.devices_indices_map``.

The rules take any mesh with axis names and sizes: a ``DeviceMesh``, or an
:class:`AbstractMesh` that holds no process (how the rules are checked on
a 16-device layout from one process).

The hint layer is deliberately no-op-safe: model code calls
``shard_hint`` unconditionally; without an active mesh (CPU tests,
single-device serving) or with hints disabled (``constraint_hints(False)``
— the dp-only ablation) the input is returned unchanged.

Sharded execution: the models run on ``DTensor`` parameters, batches and
caches as on plain tensors.  :func:`sharded_scope` (entered by the
forwards, decode steps and the train step when a leaf is a ``DTensor``)
lets the plain constants a layer makes (rope tables, masks, ``arange``)
meet ``DTensor`` operands as replicated values, and
:func:`bounded_placements` gives the layout a per-(batch, head) local
computation (``local_map``) runs in.

Every resolution is divisibility-aware: an axis is kept only when the dim
it shards divides evenly by the axis size; dims that do not divide degrade
to replicated, and a spec whose every requested axis dissolved resolves to
``None`` (caller falls back).
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

DATA = "data"
MODEL = "model"
POD = "pod"

Box = Tuple[Tuple[int, int], ...]

_state = threading.local()


def _st():
    if not hasattr(_state, "mesh"):
        _state.mesh = None
        _state.hints = True
    return _state


# --------------------------------------------------------------------------- #
# specs and meshes
# --------------------------------------------------------------------------- #


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), an axis name, or a tuple of
    axis names (the dim split over their product, first name major).  As
    in JAX, a one-name tuple is that name and an empty one is ``None``."""

    def __new__(cls, *dims: Any):
        def canon(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(canon(e) for e in dims))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names with no process behind them, as
    ``jax.sharding.AbstractMesh((4, 4), ("data", "model"))``."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh: Any) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        raise ValueError(f"mesh {mesh!r} has no axis names")
    return tuple(names)


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name → size, in mesh order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), (int(n) for n in mesh.mesh.shape)))


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh (the counterpart of
    ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_to_placements(self.mesh, self.spec)


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_to_placements(mesh: Any, spec: Sequence[Any]) -> tuple:
    """Per-dim spec → one DTensor placement per mesh dim.  A dim split
    over several axes must name them in mesh order: DTensor splits a dim
    by its mesh dims from the outermost in, which is JAX's major-first
    order exactly then."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: dim {dim} names {axes} out of "
                             f"mesh order {names}")
        for j in pos:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[j]!r} "
                                 "shards two dims")
            out[j] = Shard(dim)
    return tuple(out)


def placements_to_spec(mesh: Any, placements: Sequence[Any],
                       ndim: int) -> PartitionSpec:
    """DTensor placements → the per-dim spec (``Partial`` is no layout of
    stored state and is refused)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    dims: List[List[str]] = [[] for _ in range(ndim)]
    for j, pl in enumerate(placements):
        if isinstance(pl, Shard) and type(pl) is Shard:
            dims[pl.dim % ndim].append(names[j])
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl!r} on mesh axis {names[j]!r} "
                             "has no per-dim spec")
    return P(*(None if not d else d[0] if len(d) == 1 else tuple(d)
               for d in dims))


def shard_box(shape: Sequence[int], mesh: Any, spec: Sequence[Any],
              coord: Sequence[int]) -> Box:
    """The global index box ``((lo, hi), ...)`` the mesh coordinate
    ``coord`` holds of a ``shape`` leaf laid out by ``spec``.  A dim split
    over several axes is split by each in turn, major first, with
    ``torch.chunk``'s sizes — DTensor's layout, and JAX's wherever the
    dim divides."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = []
    for dim, n in enumerate(shape):
        lo, hi = 0, int(n)
        entry = spec[dim] if dim < len(spec) else None
        for a in _entry_axes(entry):
            k = sizes[a]
            step = -(-(hi - lo) // k)
            c = coord[names.index(a)]
            lo, hi = min(lo + c * step, hi), min(lo + (c + 1) * step, hi)
        out.append((lo, hi))
    return tuple(out)


def mesh_coords(mesh: Any) -> Dict[int, Tuple[int, ...]]:
    """Rank → mesh coordinate, for every rank of a ``DeviceMesh``."""
    shape = tuple(int(n) for n in mesh.mesh.shape)
    return {int(r): _unravel(flat, shape)
            for flat, r in enumerate(mesh.mesh.reshape(-1).tolist())}


def _unravel(flat: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(flat % n)
        flat //= n
    return tuple(reversed(out))


# --------------------------------------------------------------------------- #
# the ambient mesh
# --------------------------------------------------------------------------- #


def active_mesh() -> Optional[Any]:
    """The mesh entered via ``use_mesh``, or None (hints no-op)."""
    return _st().mesh


@contextlib.contextmanager
def use_mesh(mesh: Any):
    """Make ``mesh`` ambient for the hint layer."""
    st = _st()
    prev = st.mesh
    st.mesh = mesh
    try:
        yield mesh
    finally:
        st.mesh = prev


@contextlib.contextmanager
def constraint_hints(enabled: bool):
    """Toggle the hint layer (``False`` → every hint is identity). The
    dp-only dry-run disables hints so TP constraints never fight a
    replicated-parameter layout."""
    st = _st()
    prev = st.hints
    st.hints = bool(enabled)
    try:
        yield
    finally:
        st.hints = prev


def hints_enabled() -> bool:
    return _st().hints


# --------------------------------------------------------------------------- #
# axis resolution
# --------------------------------------------------------------------------- #


def data_axes(mesh: Any) -> Tuple[str, ...]:
    """Every non-model axis, mesh order — ``("data",)`` or
    ``("pod", "data")``. This is the pod→data folding rule."""
    return tuple(a for a in axis_names(mesh) if a != MODEL)


def _axis_size(mesh: Any, axis: Any) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _expand(mesh: Any, axis: Any) -> Any:
    """Expand an axis request against the active mesh: ``DATA`` folds all
    data axes; names absent from the mesh dissolve to None."""
    if axis is None:
        return None
    names = axis_names(mesh)
    if axis == DATA:
        dax = data_axes(mesh)
        if not dax:
            return None
        return dax[0] if len(dax) == 1 else dax
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in names)
        return kept if kept else None
    return axis if axis in names else None


def resolve_spec(mesh: Any, axes: Sequence[Any],
                 shape: Sequence[int]) -> Optional[PartitionSpec]:
    """Divisibility-aware spec resolution.

    Per dim: keep the requested axis iff the dim divides by the (folded)
    axis size, else degrade that dim to replicated. Returns ``None`` when
    every requested axis dissolved — the caller's signal to fall back to
    its next rule rather than emit an all-replicated constraint.
    """
    dims = []
    kept = 0
    for i, dim in enumerate(shape):
        axis = _expand(mesh, axes[i] if i < len(axes) else None)
        if axis is not None and dim % _axis_size(mesh, axis) == 0:
            dims.append(axis)
            kept += 1
        else:
            dims.append(None)
    if kept == 0:
        return None
    return P(*dims)


# --------------------------------------------------------------------------- #
# DTensor execution helpers
# --------------------------------------------------------------------------- #


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def any_dtensor(tree: Any) -> bool:
    """True if a leaf of the nested dicts, lists and tuples is a
    ``DTensor``."""
    if isinstance(tree, dict):
        return any(any_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(any_dtensor(v) for v in tree)
    return is_dtensor(tree)


@contextlib.contextmanager
def sharded_scope(*trees: Any):
    """Where a leaf of ``trees`` is a ``DTensor``: plain tensors that meet
    ``DTensor`` operands count as replicated on their mesh (the constants
    a layer builds: rope angles, masks, ``arange``).  Otherwise a no-op."""
    from torch.distributed.tensor import DTensor
    # implicit_replication() switches the flag off when it exits, nested
    # or not: enter it only where no scope is open yet
    if (any(any_dtensor(t) for t in trees)
            and not DTensor._op_dispatcher._allow_implicit_replication):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            yield
    else:
        yield


def bounded_placements(x: Any, free_dims: Sequence[int]) -> tuple:
    """``x``'s placements with every ``Partial`` and every shard of a dim
    outside ``free_dims`` made ``Replicate``: the layout a computation
    that is independent along ``free_dims`` runs in, locally."""
    from torch.distributed.tensor import Replicate, Shard
    nd = x.ndim
    return tuple(pl if isinstance(pl, Shard) and type(pl) is Shard
                 and pl.dim % nd in free_dims else Replicate()
                 for pl in x.placements)


def to_placements(x: Any, placements: Sequence[Any]) -> Any:
    """``x`` redistributed to ``placements`` (the same object when it
    already lies so)."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def mesh_dims_sharding(x: Any, dim: int) -> List[int]:
    """The mesh dims along which ``x``'s tensor dim ``dim`` is sharded,
    outermost first."""
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(x.placements)
            if isinstance(pl, Shard) and pl.dim % x.ndim == dim % x.ndim]


def local_range(x: Any, dim: int) -> Tuple[int, int]:
    """``[lo, hi)``: the global indices of tensor dim ``dim`` this rank's
    shard of ``x`` holds (``torch.chunk``'s split, major mesh dim
    first)."""
    coord = x.device_mesh.get_coordinate()
    lo, hi = 0, int(x.shape[dim])
    for i in mesh_dims_sharding(x, dim):
        k = x.device_mesh.size(i)
        step = -(-(hi - lo) // k)
        lo, hi = min(lo + coord[i] * step, hi), min(lo + (coord[i] + 1) * step,
                                                   hi)
    return lo, hi


def gather_data_shards(tree: Any) -> Any:
    """FSDP's weight gather: each ``DTensor`` leaf's shards along the data
    axes (along every axis when hints are off: the dp-only layout) are
    all-gathered, its tensor-parallel shards kept; the backward of the
    gather is the gradient's reduce-scatter.  A tree with no data-sharded
    leaf comes back unchanged."""
    from torch.distributed.tensor import Replicate

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x) if not hasattr(x, "_fields") \
                else type(x)(*(one(v) for v in x))
        if not is_dtensor(x):
            return x
        names = x.device_mesh.mesh_dim_names or ()
        keep = {i for i, n in enumerate(names) if n == MODEL} \
            if _st().hints else set()
        return to_placements(x, [q if i in keep else Replicate()
                                 for i, q in enumerate(x.placements)])
    return one(tree)


def resolve_partial(y: Any) -> Any:
    """A block's output before it joins the residual stream: a ``DTensor``
    keeps its batch shards and has its partial sums (a row-parallel
    product's) all-reduced, so the stream stays replicated over MODEL, as
    GSPMD lays it out.  Left to DTensor, ``h + y`` reduce-scatters ``y``
    over MODEL instead, and the next column-parallel product then gathers
    its weight.  A plain tensor is returned as it is."""
    if not is_dtensor(y):
        return y
    return to_placements(y, bounded_placements(y, (0,)))


def split_last(x: Any, *shape: int) -> Any:
    """``x.reshape(*shape)`` where ``shape`` splits ``x``'s last dim into
    (heads, head_dim): a ``DTensor`` whose last dim is sharded across a
    head (the heads do not divide by the shard count) is first replicated
    along it, which GSPMD would do by itself."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        dims = mesh_dims_sharding(x, x.ndim - 1)
        if dims and shape[-2] % math.prod(x.device_mesh.size(i)
                                          for i in dims):
            x = to_placements(x, [Replicate() if i in dims else q
                                  for i, q in enumerate(x.placements)])
    return x.reshape(*shape)


# --------------------------------------------------------------------------- #
# hints (no-op-safe: identity without an active mesh)
# --------------------------------------------------------------------------- #


def _constrain(x: Any, mesh: Any, spec: PartitionSpec) -> Any:
    """A ``DTensor`` is redistributed to ``spec``'s placements on its mesh;
    a plain tensor is returned unchanged (it carries no layout to
    constrain: with no compiler to propagate one, a hint cannot place a
    rank-local tensor)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, spec_to_placements(mesh, spec))


def shard_hint(x: Any, *axes: Any) -> Any:
    """Redistribute a ``DTensor`` to the layout ``axes`` resolve to on the
    active mesh, or return ``x`` unchanged when there is no mesh, hints
    are disabled, no requested axis survives divisibility, or ``x`` is a
    plain tensor."""
    mesh = active_mesh()
    if mesh is None or not _st().hints:
        return x
    spec = resolve_spec(mesh, axes, x.shape)
    if spec is None:
        return x
    return _constrain(x, mesh, spec)


def shard_decode_kv(x: Any, model_dim: Optional[int] = 2) -> Any:
    """Decode-path KV/latent cache layout, chosen by shape:

    - batch divides the data axes → batch-sharded decode (dim 0 on DATA);
    - else sequence-sharded long-context decode (dim 1 — the cache-seq
      dim — on DATA);
    - ``model_dim`` (the repeated-heads dim; None for MLA latents) shards
      on MODEL when divisible.

    A ``DTensor`` is redistributed to it; a plain tensor, or any input
    without an active mesh or with hints disabled, is returned unchanged.
    """
    mesh = active_mesh()
    if mesh is None or not _st().hints:
        return x
    dax = _expand(mesh, DATA)
    dims: list = [None] * x.ndim
    if dax is not None:
        dsize = _axis_size(mesh, dax)
        if x.shape[0] % dsize == 0:
            dims[0] = dax
        elif x.ndim >= 2 and x.shape[1] % dsize == 0:
            dims[1] = dax
    sizes = axis_sizes(mesh)
    if (model_dim is not None and model_dim < x.ndim
            and MODEL in sizes
            and x.shape[model_dim] % sizes[MODEL] == 0):
        dims[model_dim] = MODEL
    if all(d is None for d in dims):
        return x
    return _constrain(x, mesh, P(*dims))

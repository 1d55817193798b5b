"""Path-based parameter sharding rules over ``param_struct()`` trees.

Rule resolution order (per leaf):

1. The leaf's *name* (last path component) selects an ordered list of
   candidate axis templates. Templates describe the **trailing** dims of
   the leaf; any extra leading dims (the stacked-layer ``(n_groups, ...)``
   dim, encdec's ``(L, ...)``) are replicated — so one rule covers a layer
   whether it is stacked or not.
2. Candidates are tried in order through the divisibility-aware
   ``resolve_spec``; the first template that keeps at least one axis wins.
   This is how the vocab-parallel embedding falls back to hidden-dim
   sharding when the vocabulary does not divide the model axis (granite's
   49155), and how expert-parallel MoE weights fall back to feature-dim
   sharding when the expert count does not.
3. No rule, or every candidate dissolved → fully replicated.

Conventions follow Megatron/MaxText tensor parallelism: projections *into*
the sharded dimension are column-parallel (output features on MODEL),
projections back to the residual stream are row-parallel (input features
on MODEL), embeddings are vocab-parallel when divisible.

The rules read only shapes: the leaves may be tensors on any device,
``torch.device("meta")`` tensors (``Model.param_struct``) or numpy arrays.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.core.protect import (
    Protect,
    _children,
    _key_str,
    _path_str,
    flatten_named,
    unflatten_named,
)
from repro_torch.dist.context import (
    MODEL,
    NamedSharding,
    P,
    PartitionSpec,
    axis_names,
    axis_sizes,
    data_axes,
    resolve_spec,
)


# column-parallel (output features on MODEL) / row-parallel (input features)
_COL: List[Tuple] = [(None, MODEL)]
_ROW: List[Tuple] = [(MODEL, None)]
# expert-parallel over E first, feature-parallel fallback
_MOE_IN = [(MODEL, None, None), (None, None, MODEL)]
_MOE_OUT = [(MODEL, None, None), (None, MODEL, None)]

_RULES = {
    # embeddings: vocab-parallel, hidden-dim fallback
    "embed": [(MODEL, None), (None, MODEL)],
    "lm_head": [(None, MODEL), (MODEL, None)],
    # attention (GQA + rwkv share wk/wv/wo names; shapes differ, rules don't)
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "bq": [(MODEL,)], "bk": [(MODEL,)], "bv": [(MODEL,)],
    # MLA projections
    "w_dq": _COL, "w_uq": _COL, "w_dkv": _COL, "w_uk": _COL, "w_uv": _COL,
    # dense MLP
    "w_gate": _COL, "w_up": _COL, "w_down": _ROW,
    # MoE experts (leading E dim)
    "moe_w_gate": _MOE_IN, "moe_w_up": _MOE_IN, "moe_w_down": _MOE_OUT,
    # rwkv time-mix / mamba in-projections
    "wr": _COL, "wg": _COL, "w_z": _COL, "w_x": _COL,
}


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  prefix: Optional[List[str]] = None) -> Any:
    """``fn(path, leaf)`` over every leaf, the tree's structure kept
    (``tree_map_with_path`` with the canonical slash paths)."""
    prefix = prefix or []
    if tree is None:
        return None
    if isinstance(tree, (dict, list, tuple)):
        done = {key: map_with_path(fn, child, prefix + [key])
                for key, child in _children(tree)}
        if isinstance(tree, dict):
            return type(tree)((k, done[_key_str(k)]) for k in tree)
        if hasattr(tree, "_fields"):
            return type(tree)(*(done[f] for f in tree._fields))
        return type(tree)(done[str(i)] for i in range(len(tree)))
    return fn(_path_str(prefix), tree)


def _resolve_rules(mesh: Any, name: str,
                   shape: Sequence[int]) -> Optional[PartitionSpec]:
    for template in _RULES.get(name, ()):
        if len(template) > len(shape):
            continue
        full = (None,) * (len(shape) - len(template)) + tuple(template)
        spec = resolve_spec(mesh, full, shape)
        if spec is not None:
            return spec
    return None


def param_shardings(mesh: Any, params: Any) -> Any:
    """Tree of :class:`NamedSharding` matching ``params``, resolved through
    the rule table; unmatched leaves (norm scales, routers, decay params,
    scalars) are replicated."""

    def one(path: str, leaf: Any) -> NamedSharding:
        name = path.rsplit("/", 1)[-1]
        spec = _resolve_rules(mesh, name, tuple(leaf.shape))
        return NamedSharding(mesh, spec if spec is not None else P())

    return map_with_path(one, params)


def _folded_data(mesh: Any):
    dax = data_axes(mesh)
    if not dax:
        return None
    return dax[0] if len(dax) == 1 else dax


def batch_sharding(mesh: Any, ndim: int, *,
                   batch_divisible: bool = True) -> NamedSharding:
    """Batch-dim sharding over the folded data axes (``pod`` folds into
    ``data`` on multi-pod meshes). ``batch_divisible=False`` (e.g. a
    global batch of 1) replicates."""
    daxis = _folded_data(mesh)
    if daxis is None or not batch_divisible:
        return NamedSharding(mesh, P())
    return NamedSharding(mesh, P(daxis, *([None] * (ndim - 1))))


def cache_shardings(mesh: Any, caches: Any, global_batch: int, *,
                    seq_axis_sharded: bool = False,
                    protects: Optional[Sequence[Protect]] = None) -> Any:
    """Decode-cache shardings (stacked ``(L, B, C, ...)`` leaves).

    The batch dim is located by **explicit axis metadata first**: a
    ``Protect(selector, axis={"batch": d})`` spec from the cache
    constructor (``models/zoo.Model.cache_protects``) pins the batch dim
    for every matching leaf; only leaves with no governing spec fall back
    to the size-match heuristic (first dim equal to ``global_batch`` —
    ambiguous when e.g. a head count or window equals the batch size).
    An explicit dim outside the leaf's rank (shape-(0,) cache-union
    placeholders) falls back too.

    Default: shard the batch dim over the folded data axes. With
    ``seq_axis_sharded`` (long-context, batch too small to split) the
    cache-sequence dim — the dim after batch — is sharded instead, which
    is what makes ``shard_decode_kv``'s sequence-sharded decode line up
    with the cache layout. A head dim two past batch shards on MODEL when
    divisible; everything that does not divide stays replicated.
    """
    daxis = _folded_data(mesh)
    sizes = axis_sizes(mesh)
    dsize = 1
    if daxis is not None:
        for a in (daxis if isinstance(daxis, tuple) else (daxis,)):
            dsize *= sizes[a]
    tp = sizes.get(MODEL, 1)
    specs = [s for s in (protects or []) if s.axis and "batch" in s.axis]

    def one(p: str, leaf: Any) -> NamedSharding:
        shape = tuple(leaf.shape)
        dims: list = [None] * len(shape)
        bdim = None
        for spec in specs:
            if spec.matches(p):
                d = spec.axis["batch"]
                if 0 <= d < len(shape):
                    bdim = d
                break
        if bdim is None:
            bdim = next((i for i, d in enumerate(shape)
                         if d == global_batch), None)
        if bdim is not None and daxis is not None:
            if seq_axis_sharded:
                sdim = bdim + 1
                if sdim < len(shape) and shape[sdim] % dsize == 0:
                    dims[sdim] = daxis
            elif shape[bdim] % dsize == 0:
                dims[bdim] = daxis
        if bdim is not None and MODEL in axis_names(mesh):
            hdim = bdim + 2
            if (hdim < len(shape) and dims[hdim] is None
                    and shape[hdim] % tp == 0):
                dims[hdim] = MODEL
        return NamedSharding(mesh, P(*dims))

    return map_with_path(one, caches)


def train_state_shardings(mesh: Any, state_struct: Any, zero1: bool,
                          fsdp: bool, dp_only: bool = False) -> Any:
    """``TrainState`` shardings: params per rules (+FSDP), moments
    (+ZeRO-1).  ``state_struct`` is a ``TrainState`` of shapes
    (``train.state.train_state_struct``).

    ``dp_only``: treat the model axis as extra data parallelism — params
    replicated (or FSDP-sharded) over ALL axes, no tensor parallelism.
    """
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.state import TrainState

    if dp_only:
        pshard = map_with_path(lambda _p, _x: NamedSharding(mesh, P()),
                               state_struct.params)
    else:
        pshard = param_shardings(mesh, state_struct.params)
    dax = data_axes(mesh) + ((MODEL,) if dp_only else ())
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in dax)
    daxis = dax if len(dax) > 1 else dax[0]
    leaves = flatten_named(state_struct.params)

    def augment(tree):
        """Add the data axes to the first unsharded divisible dim."""
        def one(path, sharding):
            shape = tuple(leaves[path].shape)
            spec = list(sharding.spec) + [None] * (len(shape)
                                                   - len(sharding.spec))
            for i, (s, dim) in enumerate(zip(spec, shape)):
                if s is None and dim % dp == 0 and dim >= dp:
                    spec[i] = daxis
                    return NamedSharding(mesh, P(*spec))
            return sharding
        named = flatten_named(tree)
        return unflatten_named({p: one(p, s) for p, s in named.items()},
                               tree)

    mshard = pshard
    if zero1:
        mshard = augment(pshard)
    if fsdp:
        pshard = augment(pshard)

    scalar = NamedSharding(mesh, P())
    return TrainState(
        step=scalar,
        params=pshard,
        opt=AdamWState(count=scalar, mu=mshard, nu=mshard),
        rng=scalar,
        data_state=map_with_path(lambda _p, _x: scalar,
                                 state_struct.data_state),
    )

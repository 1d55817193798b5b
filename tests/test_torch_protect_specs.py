"""The torch mirror of tests/test_protect_specs.py, on the port.

The clause-carrying protection API: Protect spec validation, selector
resolution semantics (`*` vs `**`, overlap, first-match-wins), path
canonicalization regressions, and the deprecation shim for flat selectors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.protect import flatten_named as jflatten_named
from repro_torch.core.context import CheckpointConfig, CheckpointContext
from repro_torch.core.protect import (
    CHK_DIFF,
    HDF5_GATE_MSG,
    Protect,
    flatten_named,
    normalize_protects,
    resolve_specs,
)


def _ctx(tmp_path, name="p"):
    return CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / name), backend="fti", dedicated_thread=False))


# ------------------------------------------------------------------ #
# path canonicalization
# ------------------------------------------------------------------ #


def test_path_str_keeps_dots_and_quotes_in_keys():
    """Regression: strip("[]'\\".") ate leading/trailing dots and quotes
    from string keys — ".hidden" collided with "hidden", "w.q" lost its
    dot."""
    named = flatten_named({
        "a": {".hidden": torch.ones(2), "hidden": torch.zeros(2),
              "w.q": torch.ones(3), "wq": torch.zeros(3)},
    })
    assert set(named) == {"a/.hidden", "a/hidden", "a/w.q", "a/wq"}


def test_path_str_mixed_key_types():
    named = flatten_named({"params": {"groups": [
        {"attn": {"wq": torch.ones(2)}},
        {"attn": {"wq": torch.zeros(2)}},
    ]}})
    assert set(named) == {"params/groups/0/attn/wq",
                          "params/groups/1/attn/wq"}


def test_flatten_named_rejects_engineered_collision():
    """Two distinct keys that canonicalize identically must raise, not
    silently drop a leaf."""
    with pytest.raises(ValueError, match="duplicate tree path"):
        flatten_named({"a": {"b": torch.ones(2)}, "a/b": torch.zeros(2)})


def test_path_str_quoted_content_preserved():
    """A key with quotes in it keeps them, as the reference names it."""
    jnamed, _ = jflatten_named({"'q'": jnp.ones(1)})
    assert list(flatten_named({"'q'": torch.ones(1)})) == list(jnamed) \
        == ["'q'"]


# ------------------------------------------------------------------ #
# selector semantics
# ------------------------------------------------------------------ #


NAMED = {
    "params/wq": 1, "params/attn/wq": 2, "params/attn/wo": 3,
    "opt/m": 4, "step": 5,
}


def test_star_does_not_cross_slashes():
    assert set(resolve_specs(NAMED, [Protect("params/*")])) == {"params/wq"}
    assert set(resolve_specs(NAMED, [Protect("params/**")])) == {
        "params/wq", "params/attn/wq", "params/attn/wo"}


def test_overlapping_patterns_select_once_first_spec_governs():
    specs = [Protect("params/attn/wq", compress="int8"),
             Protect("params/**")]
    out = resolve_specs(NAMED, specs)
    assert sorted(out) == ["params/attn/wo", "params/attn/wq", "params/wq"]
    # the leaf matched by both is selected once, governed by the first spec
    assert out["params/attn/wq"].compress == "int8"
    assert out["params/attn/wo"].compress is None


def test_resolve_specs_no_protects_selects_everything_clauseless():
    out = resolve_specs(NAMED, None)
    assert set(out) == set(NAMED)
    assert all(v is None for v in out.values())


def test_unmatched_selector_names_the_offender():
    with pytest.raises(ValueError, match=r"\['nope/\*\*'\] matched no leaves"):
        resolve_specs(NAMED, [Protect("params/**"), Protect("nope/**")])


def test_unmatched_selector_surfaces_through_store_and_load(tmp_path):
    state = {"params": {"w": torch.arange(4.0)},
             "step": torch.tensor(0, dtype=torch.int32)}
    ctx = _ctx(tmp_path)
    ctx.protect(Protect("params/**"), Protect("optt/**"))
    with pytest.raises(ValueError, match="optt"):
        ctx.store(state, id=1, level=1)
    with pytest.raises(ValueError, match="optt"):
        ctx.load(state)
    # a corrected protect keeps the context usable
    ctx.protect(Protect("params/**"), Protect("step"))
    assert ctx.store(state, id=1, level=1) is not None
    ctx.shutdown()


# ------------------------------------------------------------------ #
# Protect validation + the deprecation shim
# ------------------------------------------------------------------ #


def test_protect_clause_validation():
    with pytest.raises(ValueError, match="kind"):
        Protect("a/**", kind="SOMETIMES")
    with pytest.raises(ValueError, match="codec"):
        Protect("a/**", compress="zstd")
    with pytest.raises(ValueError, match="precision"):
        Protect("a/**", precision="int3")
    with pytest.raises(ValueError, match="h5py"):
        Protect("a/**", format="hdf5")      # missing dep is gated, not faked
    with pytest.raises(ValueError, match="axis"):
        Protect("a/**", axis={"batch": "one"})
    with pytest.raises(TypeError):
        normalize_protects([42])
    spec = Protect("a/**", kind=CHK_DIFF, compress="int8", precision="bf16")
    assert spec.clauses() == {"kind": CHK_DIFF, "compress": "int8",
                              "precision": "bf16"}


def test_hdf5_gate_raises_at_spec_validation_time():
    """The missing-h5py gate fires when the spec is *constructed* — the
    user's ``ctx.protect(Protect(..., format="hdf5"))`` line — never deep
    inside Pack where the traceback would point at checkpoint internals.
    The message is pinned verbatim (it names the dependency and the
    CHK5 equivalence, the paper's §4.2.4 portability argument)."""
    with pytest.raises(ValueError) as ei:
        Protect("params/**", format="hdf5")
    assert str(ei.value) == HDF5_GATE_MSG
    assert "h5py" in HDF5_GATE_MSG and "chk5" in HDF5_GATE_MSG
    # no store machinery involved: a context is never even constructed,
    # and a valid format clause still passes validation
    assert Protect("params/**", format="chk5").clauses() == {
        "format": "chk5"}


def test_flat_selector_strings_shim_to_clauseless_specs():
    with pytest.warns(DeprecationWarning, match="deprecated"):
        specs = normalize_protects(["params/**", "step"])
    assert [s.selector for s in specs] == ["params/**", "step"]
    assert all(s.clauses() == {} for s in specs)


def test_legacy_string_protect_still_roundtrips(tmp_path):
    state = {"params": {"w": torch.arange(4.0)}, "opt": {"m": torch.ones(4)},
             "step": torch.tensor(7, dtype=torch.int32)}
    ctx = _ctx(tmp_path, "legacy")
    with pytest.warns(DeprecationWarning):
        ctx.protect("params/**", "step")
    ctx.store(state, id=1, level=1)
    ctx.shutdown()
    ctx2 = _ctx(tmp_path, "legacy")
    with pytest.warns(DeprecationWarning):
        ctx2.protect("params/**", "step")
    got = ctx2.load({"params": {"w": torch.zeros(4)},
                     "opt": {"m": torch.zeros(4)},
                     "step": torch.tensor(0, dtype=torch.int32)})
    assert ctx2.restarted
    assert torch.equal(got["params"]["w"], torch.arange(4.0))
    assert int(got["step"]) == 7
    assert float(got["opt"]["m"][0]) == 0.0       # unprotected → template
    ctx2.shutdown()


def test_legacy_positional_tcl_protocol_still_works(tmp_path):
    """Backend.tcl_store(named, id, level, kind) — the pre-request call
    protocol — must keep working for native-API callers."""
    from repro_torch.backends.registry import make_backend
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.storage import CHK_FULL, StorageConfig
    b = make_backend(StorageConfig(root=str(tmp_path / "lp")),
                     LocalComm(str(tmp_path / "lp" / "nl")), "fti",
                     dedicated_thread=False)
    b.tcl_store({"x": np.arange(6.0)}, 1, 1, CHK_FULL)
    got = b.tcl_load()
    np.testing.assert_array_equal(got["x"], np.arange(6.0))
    b.tcl_finalize()


# ------------------------------------------------------------------ #
# select / leaf_meta (the reference's compatibility helpers)
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("patterns", [
    None, [], ["params/**"], ["params/*"], ["opt/m", "step"],
    ["params/layers/*/wq", "params/**"], ["nope/**"]])
def test_select_and_leaf_meta_equal_reference(patterns):
    """On one named tree (seeded numpy leaves of every dtype width, bf16
    included), ``select`` picks the reference's leaves in its order — or
    raises as it does for a selector that matches nothing — and
    ``leaf_meta`` gives its numpy dtype strings and shapes."""
    import ml_dtypes
    from repro.core.protect import leaf_meta as ref_leaf_meta
    from repro.core.protect import select as ref_select
    from repro_torch.core.formats import numpy_to_tensor
    from repro_torch.core.protect import leaf_meta, select

    rng = np.random.default_rng(7)
    tree_np = {
        "params": {"embed": rng.normal(size=(8, 4)).astype(np.float32),
                   "layers": [{"wq": rng.normal(size=(4, 4)).astype(
                       ml_dtypes.bfloat16)} for _ in range(2)],
                   "scale": rng.normal(size=(4,)).astype(np.float16)},
        "opt": {"m": rng.normal(size=(3, 5)).astype(np.float32),
                "count": rng.integers(0, 9, size=(2,)).astype(np.int16)},
        "step": np.asarray(7, np.int32),
        "mask": rng.integers(0, 2, size=(6,)).astype(np.uint8),
    }
    ref_named, _ = jflatten_named(_map(jnp.asarray, tree_np))
    named = flatten_named(_map(numpy_to_tensor, tree_np))
    assert list(named) == list(ref_named)
    if patterns == ["nope/**"]:
        with pytest.raises(ValueError, match="nope"):
            ref_select(ref_named, patterns)
        with pytest.raises(ValueError, match="nope"):
            select(named, patterns)
        return
    want = ref_select(ref_named, patterns)
    got = select(named, patterns)
    assert list(got) == list(want)
    assert all(got[k] is named[k] for k in got)
    assert leaf_meta(got) == ref_leaf_meta(want)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)

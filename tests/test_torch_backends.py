"""The port's backends (tests/test_backends.py, mirrored): the TCL surface
on FTI, SCR and VeloC, the paper's DIFF-support matrix, the native APIs
(SCR's route-file protocol included), backend selection from the
environment — and an SCR container read by both packages, whichever wrote
it.  Inputs are numpy arrays from a seed, handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends.scr import SCRBackend as JSCRBackend
from repro.core.comm import LocalComm as JLocalComm
from repro.core.storage import StorageConfig as JStorageConfig
from repro_torch.backends.fti import FTIBackend
from repro_torch.backends.registry import ENV_VAR, make_backend
from repro_torch.backends.scr import SCRBackend
from repro_torch.backends.veloc import VELOC_FAILURE, VELOC_SUCCESS, VeloCBackend
from repro_torch.core.comm import LocalComm
from repro_torch.core.context import (
    CHK_DIFF,
    CHK_FULL,
    CheckpointConfig,
    CheckpointContext,
    Protect,
)
from repro_torch.core.formats import CHK5Reader, CHK5Writer, tensor_to_numpy
from repro_torch.core.storage import StorageConfig


def _cfg(tmp_path, name):
    return StorageConfig(root=str(tmp_path / name))


def _comm(tmp_path, name):
    return LocalComm(str(tmp_path / name / "node-local"))


def _named():
    return {"a": torch.arange(10, dtype=torch.float32),
            "b": torch.ones((3, 3), dtype=torch.int32)}


@pytest.mark.parametrize("backend", ["fti", "scr", "veloc"])
def test_tcl_surface_roundtrip(tmp_path, backend):
    b = make_backend(_cfg(tmp_path, backend), _comm(tmp_path, backend),
                     backend)
    assert b.tcl_load() is None
    b.tcl_store(_named(), 1, 4, CHK_FULL)        # L4: global + object store
    b.tcl_wait()
    assert b.engine.objstore_tier().catalog.ids() == [1]
    got = b.tcl_load()
    assert set(got) == {"a", "b"}
    assert np.array_equal(got["a"], np.arange(10, dtype=np.float32))
    b.tcl_finalize()


@pytest.mark.parametrize("backend,fallbacks", [("fti", 0), ("scr", 1),
                                               ("veloc", 1)])
def test_diff_support_matrix(tmp_path, backend, fallbacks):
    """Paper §3: only FTI has checkpoint kinds; others fall back to FULL."""
    b = make_backend(_cfg(tmp_path, backend), _comm(tmp_path, backend),
                     backend)
    b.tcl_store(_named(), 1, 1, CHK_FULL)
    b.tcl_wait()
    b.tcl_store(_named(), 2, 1, CHK_DIFF)
    b.tcl_wait()
    assert b.stats["diff_fallbacks"] == fallbacks
    assert np.array_equal(b.tcl_load()["a"], np.arange(10, dtype=np.float32))
    b.tcl_finalize()


def test_fti_native_api(tmp_path):
    b = FTIBackend(_cfg(tmp_path, "f"), _comm(tmp_path, "f"),
                   dedicated_thread=False)
    assert b.status() is False
    b.protect(0, "step", torch.tensor(7, dtype=torch.int32))
    b.protect(1, "data", torch.arange(5.0))
    rep = b.checkpoint(1, level=1)
    assert rep is not None and rep.kind == CHK_FULL and b.status() is True
    got = b.recover()
    assert got[0] == 7 and np.array_equal(got[1], np.arange(5.0))
    b.finalize()


def test_fti_differential_payload_shrinks(tmp_path):
    b = FTIBackend(_cfg(tmp_path, "fd"), _comm(tmp_path, "fd"),
                   dedicated_thread=False)
    big = torch.zeros(100_000)
    b.protect(0, "big", big)
    full = b.checkpoint(1, level=1)
    big2 = big.clone()
    big2[5] = 1.0
    b.protect(0, "big", big2)
    diff = b.checkpoint(2, level=1, differential=True)
    assert diff.kind == CHK_DIFF
    assert diff.bytes_payload < full.bytes_payload / 3
    assert np.array_equal(b.recover()[0], big2.numpy())


def test_scr_native_file_mode(tmp_path):
    b = SCRBackend(_cfg(tmp_path, "s"), _comm(tmp_path, "s"))
    b.start_checkpoint(1, level=1)
    path = b.route_file("my.ckpt")
    with CHK5Writer(path) as w:
        w.write_dataset("data/x", np.arange(4.0))
    assert b.complete_checkpoint(valid=True) is not None
    assert b.have_restart() == 1
    assert b.start_restart() == 1
    rd = CHK5Reader(b.route_file("my.ckpt"))
    assert np.array_equal(rd.read_dataset("data/x"), np.arange(4.0))
    rd.close()
    b.complete_restart(True)
    assert b.stats["loads"] == 1


def test_scr_invalid_checkpoint_aborts(tmp_path):
    b = SCRBackend(_cfg(tmp_path, "sa"), _comm(tmp_path, "sa"))
    b.start_checkpoint(1, level=1)
    b.route_file("x")
    assert b.complete_checkpoint(valid=False) is None
    assert b.have_restart() is None


def test_veloc_native_api(tmp_path):
    b = VeloCBackend(_cfg(tmp_path, "v"), _comm(tmp_path, "v"))
    assert b.restart_test("job") == VELOC_FAILURE
    b.mem_protect(0, torch.tensor(3, dtype=torch.int32), "t")
    b.mem_protect(1, torch.arange(6.0), "arr")
    assert b.checkpoint("job", 1) == VELOC_SUCCESS
    assert b.checkpoint_wait() == VELOC_SUCCESS
    assert b.restart_test("job") == 1
    assert b.restart("job", 1) == VELOC_SUCCESS
    assert np.array_equal(b.recovered(1), np.arange(6.0))
    b.tcl_finalize()


def test_env_backend_selection(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV_VAR, "scr")
    assert make_backend(_cfg(tmp_path, "e"), _comm(tmp_path, "e")).name == "scr"
    monkeypatch.setenv(ENV_VAR, "nope")
    with pytest.raises(KeyError):
        make_backend(_cfg(tmp_path, "e2"), _comm(tmp_path, "e2"))


def test_portability_same_code_all_backends(tmp_path, monkeypatch):
    """The paper's portability claim: identical app code, backend from env."""
    state = {"w": torch.arange(8.0), "step": torch.tensor(0)}
    for backend in ("fti", "scr", "veloc"):
        monkeypatch.setenv(ENV_VAR, backend)
        d = str(tmp_path / f"port-{backend}")
        ctx = CheckpointContext(CheckpointConfig(dir=d))
        s = ctx.load(state)
        ctx.store({"w": s["w"] + 1, "step": s["step"] + 1}, id=1, level=1)
        ctx.shutdown()
        ctx2 = CheckpointContext(CheckpointConfig(dir=d))
        s2 = ctx2.load(state)
        ctx2.shutdown()
        assert ctx2.restarted, backend
        assert torch.equal(s2["w"], torch.arange(8.0) + 1), backend


# --------------------------------------------------------------------------- #
# an SCR container crosses the packages
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("level", [1, 4])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_scr_container_cross_reads_both_ways(tmp_path, writer, level):
    """SCR's file mode writes the container itself (clause codecs apply):
    each package restores the other's bit for bit, at L1 and at L4."""
    rng = np.random.RandomState(5)
    named = {"w": rng.randn(64, 9).astype(np.float32),
             "h": rng.randint(-5, 5, 31).astype(np.int8)}
    root = str(tmp_path / "s")
    if writer == "jax":
        b = JSCRBackend(JStorageConfig(root=root),
                        JLocalComm(f"{root}/node-local"))
        b.tcl_store({k: jnp.asarray(v) for k, v in named.items()}, 1, level,
                    CHK_FULL)
    else:
        b = SCRBackend(StorageConfig(root=root),
                       LocalComm(f"{root}/node-local"))
        b.tcl_store({k: torch.from_numpy(v.copy()) for k, v in named.items()},
                    1, level, CHK_FULL)
    jb = JSCRBackend(JStorageConfig(root=root),
                     JLocalComm(f"{root}/node-local"))
    tb = SCRBackend(StorageConfig(root=root), LocalComm(f"{root}/node-local"))
    jgot, tgot = jb.tcl_load(), tb.tcl_load()
    for k, v in named.items():
        assert np.asarray(jgot[k]).tobytes() == v.tobytes()
        assert tgot[k].dtype == v.dtype and tgot[k].tobytes() == v.tobytes()


def test_scr_through_directives_restores_onto_tensors(tmp_path):
    ctx = CheckpointContext(CheckpointConfig(dir=str(tmp_path / "d"),
                                             backend="scr"))
    ctx.protect(Protect("w", compress="int8"), Protect("s"))
    w = torch.from_numpy(np.random.RandomState(1).randn(1000)
                         .astype(np.float32))
    ctx.store({"w": w, "s": torch.tensor(3)}, id=5, level=2)
    ctx.shutdown()
    ctx2 = CheckpointContext(CheckpointConfig(dir=str(tmp_path / "d"),
                                              backend="scr"))
    ctx2.protect(Protect("w", compress="int8"), Protect("s"))
    got = ctx2.load({"w": torch.zeros(1000), "s": torch.tensor(0)})
    ctx2.shutdown()
    assert ctx2.restarted and int(got["s"]) == 3
    # int8 is lossy within max|block|/127 (dist/compression.py)
    err = float((got["w"] - w).abs().max())
    assert 0 < err <= float(w.abs().max()) / 127 + 1e-6
    assert tensor_to_numpy(got["w"]).dtype == np.float32

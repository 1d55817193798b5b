"""The port's chaos scenario matrix: every scenario × every backend, zero
loss, on the CPU (the JAX package's tests/test_chaos_scenarios.py), and
each cell's recovery path and fault count held against the JAX package's
own run of the same cell.

Each cell runs the real store→inject→restart→verify cycle
(``repro_torch.chaos.scenarios``) with its payloads as tensors on the
device it is given; this file asserts the harness contract — bit-exact
restores, machine-readable reports, and zero data loss everywhere.
"""
import json
from concurrent.futures import wait

import numpy as np
import pytest

from repro_torch.chaos import inject as chaos
from repro_torch.chaos.scenarios import (BACKENDS, SCENARIOS, _payload,
                                         run_matrix, run_scenario)


@pytest.fixture(autouse=True)
def _clean_registry():
    chaos.reset()
    yield
    chaos.reset()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_bit_exact_zero_loss(tmp_path, name, backend):
    r = run_scenario(name, backend, str(tmp_path), device="cpu")
    assert r.ok, f"{name}×{backend}: {r.detail}"
    assert r.data_loss_bytes == 0
    assert r.faults_fired >= 1
    assert r.recovery_path in ("local", "partner", "erasure", "global",
                               "objstore", "elastic")


def test_matrix_report_is_machine_readable(tmp_path):
    report = run_matrix(str(tmp_path), backends=("fti",),
                        names=["corrupt-chunk"], device="cpu")
    blob = json.loads(json.dumps(report))       # JSON round-trip
    assert blob["ok"] and blob["passed"] == blob["total"] == 1
    assert blob["data_loss_bytes"] == 0
    (cell,) = blob["scenarios"]
    for key in ("name", "backend", "ok", "faults_fired", "recovery_path",
                "recovery_s", "data_loss_bytes", "detail"):
        assert key in cell


def test_crashed_scenario_reports_failure_not_raise(tmp_path):
    SCENARIOS["_boom"] = lambda w, b, d: 1 / 0
    try:
        r = run_scenario("_boom", "fti", str(tmp_path), device="cpu")
        assert not r.ok and "ZeroDivisionError" in r.detail["error"]
    finally:
        del SCENARIOS["_boom"]


def test_runner_cli_writes_report(tmp_path, capsys):
    from repro_torch.chaos.runner import main
    out = tmp_path / "report.json"
    rc = main(["--device", "cpu", "--workdir", str(tmp_path / "w"),
               "--backend", "fti", "--scenario", "node-loss-mid-store",
               "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["ok"] and report["total"] == 1
    assert "PASS" in capsys.readouterr().out


def test_a_card_that_is_not_there_is_an_error(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.chaos.runner import main
    with pytest.raises(RuntimeError, match="is_available"):
        run_scenario("mesh-shrink", "fti", str(tmp_path))
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--workdir", str(tmp_path / "w"), "--scenario", "mesh-shrink"])


def test_payloads_equal_the_reference_payloads():
    """The same values, dtypes and shapes as the JAX package's payload."""
    from repro.chaos.scenarios import _payload as ref_payload
    from repro_torch.core.formats import tensor_to_numpy
    for rank, ckpt_id in ((0, 1), (2, 2), (3, 7)):
        want = ref_payload(rank, ckpt_id)
        got = _payload(rank, ckpt_id, "cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            g = tensor_to_numpy(got[k])
            assert g.dtype == want[k].dtype and g.shape == want[k].shape
            assert g.tobytes() == np.asarray(want[k]).tobytes()


def _joined(result):
    """``PendingFile.result`` that joins every transfer before it raises
    the first failure."""
    def joined(self):
        wait(self.futures)
        return result(self)
    return joined


def test_recovery_paths_equal_the_reference_matrix(tmp_path, monkeypatch):
    """Every cell takes the recovery path, and fires the faults, that the
    JAX package's matrix does for the same cell.

    During an object-store outage every chunk put of the degraded store
    fails.  The store reports its first failed put at once, and a put
    still queued then may run after the scenario lifts the outage and
    succeed: the count would depend on thread timing.  The port's
    scenarios join those puts before they go on (``_join_uploads``); the
    reference's uploads are joined here before they report, so every put
    fires in both packages and the equality is exact."""
    from repro.chaos import inject as ref_chaos
    from repro.chaos.scenarios import run_matrix as ref_matrix
    from repro.objstore import chunks as ref_chunks
    monkeypatch.setattr(ref_chunks.PendingFile, "result",
                        _joined(ref_chunks.PendingFile.result))
    mine = run_matrix(str(tmp_path / "torch"), device="cpu")
    ref_chaos.reset()
    try:
        ref = ref_matrix(str(tmp_path / "ref"))
    finally:
        ref_chaos.reset()
    assert mine["ok"] and ref["ok"]
    assert mine["total"] == ref["total"] == 24
    key = lambda c: (c["name"], c["backend"])
    cells = {key(c): c for c in ref["scenarios"]}
    for c in mine["scenarios"]:
        r = cells[key(c)]
        assert (c["recovery_path"], c["faults_fired"]) == \
            (r["recovery_path"], r["faults_fired"]), key(c)
        assert c["data_loss_bytes"] == r["data_loss_bytes"] == 0

"""A run's last line on the CPU at a tiny size (the harness's look for a
card skipped), and the command's refusal where there is no card."""
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, spec, tiny

BENCH = spec.load()


@pytest.fixture(scope="module")
def restart_run(tmp_path_factory):
    torch.set_num_threads(2)
    cell = spec.cell(BENCH, "smollm2-1.7b.train-restart")
    return harness.run_cell(BENCH, cell, 2**31 + 99, 2.0, True,
                            torch.device("cpu"), time.time(),
                            workdir=tmp_path_factory.mktemp("wd"),
                            shrink=tiny.shrink)


def test_line_keys_and_order(restart_run):
    out = dict(restart_run)
    out.pop("_log")
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "checks"
    assert {"metrics", "device", "breakdown"} <= set(out)
    line = json.loads(json.dumps(out))
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 3
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(dev)
    bd = line["breakdown"]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_traced_restart_reports_its_layers(restart_run):
    got = set(restart_run["metrics"])
    assert {"train_mfu", "store_queue_s", "plan_gbps", "pack_gbps",
            "device_idle"} <= got
    # no card: the kernels' rooflines have nothing to read
    assert not {"flash_roofline", "blockhash2_roofline"} & got


def test_untraced_run_reports_end_to_end_metrics(tmp_path):
    torch.set_num_threads(2)
    cell = spec.cell(BENCH, "smollm2-1.7b.train-restart")
    out = harness.run_cell(BENCH, cell, 5, 2.0, False, torch.device("cpu"),
                           time.time(), workdir=tmp_path,
                           shrink=tiny.shrink)
    assert set(out["metrics"]) == {m["name"] for m in
                                   spec.metrics_of(BENCH, cell["name"],
                                                   False)}
    assert "breakdown" not in out and "busy_s" not in out["device"]
    assert out["correct"] is True
    assert out["checks"]["restore_mismatch"]["value"] == 0
    assert out["checks"]["replay_mismatch"]["value"] == 0


def test_command_refuses_without_a_card():
    got = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload",
         "smollm2-1.7b.train-restart", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "CUDA device" in got.stderr

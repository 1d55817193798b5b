"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration, traffic mix, limit file and metric found by name from its
own files; a cell and a metric added from new files alone."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            cells = e2e[m["moves"]].get("workloads")
            assert cells is None or w in cells


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(BENCH, w["name"], True)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    for k in cfg["reduced"]:
        assert cfg[k] != cfg["published"][k]
    tr = spec.traffic(w["traffic"])
    assert tr["name"] == w["traffic"]
    fam = spec.reference(cfg["reference"])
    for fn in ("dims", "batch_shapes", "loss_tokens", "attention_launches",
               "model_flops", "forward_blocks"):
        assert callable(getattr(fam, fn))
    lim = spec.limits(w["config"])
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(lim)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.reader(metric))


def test_port_configs_match_the_files():
    from perfbench.harness import port_arch
    for c in BENCH["configs"]:
        arch = port_arch(spec.config(BENCH, c["name"]))
        assert arch.compute_dtype == "bfloat16"


def test_a_cell_and_a_metric_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a cell (a new traffic file) and a
    per-layer metric (a new reader) by new files and new entries, and a
    run of the new cell on the CPU reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    tr = spec.traffic("train-steady")
    tr.update(name="train-steady-pool4", batch_pool=4)
    (root / "perfbench" / "traffic" / "train-steady-pool4.json").write_text(
        json.dumps(tr))
    (root / "perfbench" / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return float(len(run.step_times))\n")
    bench["workloads"].append({
        "name": "smollm2-1.7b.train-steady-pool4", "config": "smollm2-1.7b",
        "traffic": "train-steady-pool4", "chips": 1, "why": "a test cell"})
    steady = next(m for m in bench["end_to_end"]
                  if m["name"] == "train_tokens_per_s.steady")
    steady["workloads"].append("smollm2-1.7b.train-steady-pool4")
    bench["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "train step, model",
        "moves": "train_tokens_per_s.steady",
        "workloads": ["smollm2-1.7b.train-steady-pool4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time, torch\n"
        "from pathlib import Path\n"
        "torch.set_num_threads(2)\n"
        "from perfbench import harness, spec, tiny\n"
        "assert spec.ROOT == Path(sys.argv[1]), spec.ROOT\n"
        "b = spec.load()\n"
        "c = spec.cell(b, 'smollm2-1.7b.train-steady-pool4')\n"
        "out = harness.run_cell(b, c, 7, 1.0, True, torch.device('cpu'),\n"
        "                       time.time(), workdir=Path(sys.argv[1]) / 'wd',\n"
        "                       shrink=tiny.shrink)\n"
        "print(json.dumps(out['metrics']))\n")
    src = str(Path(spec.ROOT) / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), src]))
    got = subprocess.run([sys.executable, "-c", code, str(root)],
                         capture_output=True, text=True, env=env,
                         cwd=str(root), timeout=240)
    assert got.returncode == 0, got.stderr[-3000:]
    metrics = json.loads(got.stdout.strip().splitlines()[-1])
    assert metrics["steps_in_window"]["value"] >= 1
    assert metrics["steps_in_window"]["unit"] == "steps"

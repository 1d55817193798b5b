"""The port's CLI tools and training launcher, as the JAX package's tests
of ``chkls`` and ``launch.train`` hold them: ``repro_torch.tools.chkls`` on plain and
clause-carrying containers, and ``repro_torch.launch.train`` direct mode
through fault → rerun → resume, on the CPU."""
import json
import os
import subprocess
import sys

import numpy as np


def test_chkls_cli(tmp_path, capsys):
    from repro_torch.core.formats import CHK5Writer
    from repro_torch.tools.chkls import main as chkls_main
    p = str(tmp_path / "x.chk5")
    with CHK5Writer(p) as w:
        w.write_dataset("data/a", np.arange(6.0).reshape(2, 3))
        w.set_attrs("", {"id": 1})
    assert chkls_main([p, "--verify", "--stats"]) == 0
    out = capsys.readouterr().out
    assert "data/a" in out and "crc OK" in out and "μ=" in out


def test_chkls_json_and_clause_attrs(tmp_path, capsys):
    """--json emits a machine-readable inventory (attrs included) and the
    human listing shows clause attrs — what CI asserts container contents
    with."""
    from repro_torch.core.formats import CHK5Writer
    from repro_torch.core.protect import Protect
    from repro_torch.core.tiers import pack_named
    from repro_torch.tools.chkls import main as chkls_main
    p = str(tmp_path / "c.chk5")
    with CHK5Writer(p) as w:
        w.set_attrs("", {"kind": "FULL", "id": 4})
        pack_named(w, {"params/w": np.linspace(-1, 1, 2048, dtype=np.float32),
                       "step": np.int32(7)},
                   {"params/w": Protect("params/**", compress="int8"),
                    "step": None})
    assert chkls_main([p, "--json", "--verify"]) == 0
    inv = json.loads(capsys.readouterr().out)
    assert inv["attrs"] == {"kind": "FULL", "id": 4}
    by = {d["name"]: d for d in inv["datasets"]}
    assert by["data/params/w"]["attrs"]["codec"] == "int8"
    assert by["data/params/w"]["dtype"] == "|i1"
    assert "codec" not in by["data/step"]["attrs"]
    assert inv["verified"] is True
    assert inv["total_bytes"] == sum(d["nbytes"] for d in inv["datasets"])
    # human listing shows the clause column
    assert chkls_main([p]) == 0
    out = capsys.readouterr().out
    assert "codec=int8" in out and "kind=FULL" in out


def test_chkls_lists_the_shard_inventory(tmp_path, capsys):
    """A sharded rank container: ``--json`` carries each ``shardidx/``
    dataset's chunk index and the human listing summarizes it."""
    from repro_torch.core.formats import CHK5Writer
    from repro_torch.core.resharding import (ShardChunk, ShardSnapshot,
                                             write_shard_files)
    from repro_torch.tools.chkls import main as chkls_main
    d = str(tmp_path)
    full = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    chunks = [ShardChunk((4 * k, 0), (4, 8), full[4 * k:4 * k + 4])
              for k in range(4)]
    p = os.path.join(d, "rank0.chk5")
    with CHK5Writer(p) as w:
        w.set_attrs("", {"kind": "FULL", "sharded": True})
        write_shard_files(d, "rank0", w,
                          {"w": ShardSnapshot("<f4", (16, 8), chunks)},
                          max_writers=2)
    assert chkls_main([p, "--json"]) == 0
    inv = json.loads(capsys.readouterr().out)
    idx = {x["name"]: x for x in inv["datasets"]}["shardidx/w"]
    assert idx["attrs"]["n_chunks"] == 4
    assert idx["attrs"]["global_shape"] == [16, 8]
    assert sorted(set(idx["attrs"]["files"])) == [
        "rank0.shard0.chk5", "rank0.shard1.chk5"]
    assert inv["attrs"]["sharded"] is True
    assert chkls_main([p]) == 0
    assert "sharded n_chunks=4 global=(16, 8) over 2 file(s)" in \
        capsys.readouterr().out


def test_launch_train_worker_restart(tmp_path):
    """launch.train direct mode: fault → rerun → resume (subprocess)."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    d = str(tmp_path / "t")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--arch", "tinyllama-1.1b", "--steps", "20", "--batch",
            "2", "--seq", "32", "--ckpt-every", "5", "--ckpt-dir", d,
            "--no-dedicated-thread"]
    r1 = subprocess.run(base + ["--inject-at", "0.8"], env=env,
                        capture_output=True, text=True, timeout=420)
    assert r1.returncode != 0
    assert "injected fault" in (r1.stderr + r1.stdout)
    r2 = subprocess.run(base, env=env, capture_output=True, text=True,
                        timeout=420)
    assert r2.returncode == 0, r2.stderr[-1000:]
    assert "restart detected" in r2.stdout
    assert "'final_step': 20" in r2.stdout


def test_launch_train_keep_last_full_and_launch_counts(tmp_path):
    """``--keep-last-full 1`` leaves only the newest committed FULL on the
    node-local tier; ``--launch-counts`` writes the worker's kernel
    launches (none on the CPU) into the checkpoint dir."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    d = tmp_path / "t"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "tinyllama-1.1b", "--steps", "9", "--batch", "2", "--seq",
         "32", "--ckpt-every", "3", "--ckpt-dir", str(d),
         "--no-dedicated-thread", "--keep-last-full", "1", "--launch-counts"],
        env=env, capture_output=True, text=True, timeout=420)
    assert r.returncode == 0, r.stderr[-1000:]
    ckpts = d / "node-local" / "ckpts"
    assert sorted(p.name for p in ckpts.glob("ckpt-*")) == ["ckpt-9"]
    counts = [json.loads(p.read_text()) for p in d.glob("launches-*.json")]
    assert counts == [{"blockhash2": 0, "diffpack": 0, "diffunpack": 0,
                       "flashattn": 0}]

"""Simulated multi-rank cluster on the port: partner copies, erasure
recovery, quorum — the JAX package's tests/test_cluster.py."""
import os

import numpy as np

from repro_torch.core.comm import SimulatedCluster
from repro_torch.core.storage import StorageConfig, StorageEngine
from repro_torch.ft.straggler import commit_if_quorum, validate_quorum
from repro_torch.redundancy.groups import Topology


def _named(rank):
    return {"w": np.full(100, float(rank), np.float32),
            "step": np.asarray(np.int32(rank))}


def _engines(tmp_path, world, **kw):
    cluster = SimulatedCluster(str(tmp_path / "cluster"), world)
    cfg = StorageConfig(root=str(tmp_path / "shared"), group_size=4, **kw)
    engines = [StorageEngine(cfg, c) for c in cluster.comms]
    return cluster, engines


def test_l1_per_rank_storage(tmp_path):
    cluster, engines = _engines(tmp_path, 4)
    for r, e in enumerate(engines):
        e.store(_named(r), 1, level=1)
    for r, e in enumerate(engines):
        named, meta = e.load_latest()
        assert named["w"][0] == float(r)


def test_l2_partner_recovers_lost_node(tmp_path):
    """FTI recovery ladder: node dies → restarted rank restores from the
    partner replica held on a surviving node's local storage."""
    cluster, engines = _engines(tmp_path, 4)
    for r, e in enumerate(engines):
        e.store(_named(r), 1, level=2)
    cluster.kill_node(2)                   # wipe node 2's local storage
    named, meta = engines[2].load_latest()
    assert named["w"][0] == 2.0 and named["step"] == 2


def test_l3_erasure_reconstruct_after_node_loss(tmp_path):
    """RS parity across the group reconstructs a dead node's payload."""
    cluster, engines = _engines(tmp_path, 4, erasure_scheme="rs", rs_parity=2)
    for r, e in enumerate(engines):
        e.store(_named(r), 1, level=3)
    cluster.kill_node(1)
    got = engines[1].load_latest()
    assert got is not None, "erasure reconstruction failed"
    named, meta = got
    assert named["w"][0] == 1.0 and named["step"] == 1


def test_l3_xor_reconstruct(tmp_path):
    """XOR parity lives on the *next* group (world > group_size), so any
    single node loss is recoverable."""
    cluster, engines = _engines(tmp_path, 8, erasure_scheme="xor")
    for r, e in enumerate(engines):
        e.store(_named(r), 3, level=3)
    cluster.kill_node(0)
    got = engines[0].load_latest()
    assert got is not None
    assert got[0]["w"][0] == 0.0


def test_l4_global_shared(tmp_path):
    cluster, engines = _engines(tmp_path, 2)
    for r, e in enumerate(engines):
        e.store(_named(r), 7, level=4)
    # both ranks' files live in the shared global dir
    import repro_torch.core.manifest as mf
    d = mf.ckpt_dir(engines[0].cfg.global_root, 7)
    files = sorted(f for f in os.listdir(d) if f.endswith(".chk5"))
    assert files == ["rank0.chk5", "rank1.chk5"]
    # each rank restores its own payload
    for r, e in enumerate(engines):
        named, _ = e.load_latest()
        assert named["step"] == r


def test_quorum_commit_with_straggler(tmp_path):
    """L2 checkpoint restorable when partner copies cover missing writers."""
    import repro_torch.core.manifest as mf
    topo = Topology(world=4)
    root = str(tmp_path / "q")
    d = mf.begin(root, 5)
    # ranks 0,1,3 wrote; rank 2 is a straggler but rank 1 holds its replica
    for r in (0, 1, 3):
        open(os.path.join(d, f"rank{r}.chk5"), "wb").write(b"x" * 10)
    open(os.path.join(d, f"rank{topo.partner_of(2)}.partner2.chk5"),
         "wb").write(b"y")
    rep = validate_quorum(d, topo)
    assert rep.restorable and rep.covered_by_partner == [2]
    assert commit_if_quorum(root, 5, topo)
    assert mf.latest_id(root) == 5


def test_quorum_rejects_uncovered_loss(tmp_path):
    import repro_torch.core.manifest as mf
    topo = Topology(world=4)
    root = str(tmp_path / "q2")
    d = mf.begin(root, 5)
    for r in (0, 1):
        open(os.path.join(d, f"rank{r}.chk5"), "wb").write(b"x")
    rep = validate_quorum(d, topo)
    assert not rep.restorable and set(rep.lost) == {2, 3}
    assert not commit_if_quorum(root, 5, topo)

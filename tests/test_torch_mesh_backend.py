"""How a worker joins its world: the backend and the card that
``launch/mesh.py`` picks from the hardware, on the CPU.

- ``world_layout`` for every combination of device type, local world
  size and card count: NCCL (``cpu:gloo,cuda:nccl``) with one rank per
  card where the machine has a card per local rank, gloo on shared cards
  and on the CPU.
- ``join`` and ``join_from_env`` with ``torch.cuda.device_count`` (and
  the process group's start) patched: the backend, the card bound first,
  NCCL's eager communicator on that card, and gloo's all-gather override
  on gloo worlds on the card only.
- ``join_from_env`` on the CPU makes a real gloo world and installs no
  override.

The JAX package has no counterpart: its meshes join no process group.
"""
import os
import socket
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.launch import mesh  # noqa: E402

LOCAL_WORLDS = (1, 2, 4, 8)
CARDS = (0, 1, 2, 4, 8)


@pytest.mark.parametrize("n_cards", CARDS)
@pytest.mark.parametrize("local_world", LOCAL_WORLDS)
@pytest.mark.parametrize("device_type", ("cpu", "cuda"))
def test_world_layout_gives_each_rank_a_backend_and_a_device(
        device_type, local_world, n_cards):
    if device_type == "cuda" and n_cards == 0:
        with pytest.raises(ValueError, match="no card"):
            mesh.world_layout(device_type, 0, local_world, n_cards)
        return
    got = [mesh.world_layout(device_type, r, local_world, n_cards)
           for r in range(local_world)]
    backends = {b for b, _ in got}
    devices = [d for _, d in got]
    assert len(backends) == 1            # every rank of a world agrees
    backend = backends.pop()
    if device_type == "cpu":
        assert backend == "gloo"
        assert devices == [torch.device("cpu")] * local_world
    elif local_world <= n_cards:         # a card per rank: NCCL, one each
        assert backend == mesh.NCCL == "cpu:gloo,cuda:nccl"
        assert devices == [torch.device("cuda", r)
                           for r in range(local_world)]
    else:                                # ranks share cards: gloo
        assert backend == "gloo"
        assert devices == [torch.device("cuda", r % n_cards)
                           for r in range(local_world)]
        assert {d.index for d in devices} == set(range(n_cards))


def test_world_layout_refuses_another_device_type():
    with pytest.raises(ValueError, match="cuda or cpu"):
        mesh.world_layout("mps", 0, 1, 1)


@pytest.fixture
def no_process_group(monkeypatch):
    """``join`` with the process group's start, the card binding and the
    gloo override recorded instead of made."""
    calls = {"init": [], "set_device": [], "override": 0}

    def init(backend, **kw):
        calls["init"].append(dict(kw, backend=backend))

    def override():
        calls["override"] += 1

    monkeypatch.setattr(mesh.dist, "init_process_group", init)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls["set_device"].append(d))
    monkeypatch.setattr(mesh, "gloo_cuda_all_gather", override)
    return calls


@pytest.mark.parametrize("device_type,local_rank,local_world,n_cards", [
    ("cpu", 1, 4, 0), ("cuda", 0, 1, 1), ("cuda", 3, 4, 4),
    ("cuda", 1, 2, 4), ("cuda", 3, 4, 1), ("cuda", 3, 4, 2),
    ("cuda", 5, 8, 4)])
def test_join_binds_the_card_then_starts_the_chosen_backend(
        no_process_group, monkeypatch, device_type, local_rank,
        local_world, n_cards):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    device, backend = mesh.join(
        local_rank, local_world, "tcp://localhost:1", device_type=device_type,
        local_rank=local_rank, local_world=local_world, timeout_s=5)
    calls = no_process_group
    assert (backend, device) == mesh.world_layout(device_type, local_rank,
                                                  local_world, n_cards)
    [init] = calls["init"]
    assert init["backend"] == backend
    assert (init["rank"], init["world_size"]) == (local_rank, local_world)
    assert init["init_method"] == "tcp://localhost:1"
    assert init["timeout"].total_seconds() == 5
    if backend == mesh.NCCL:
        # NCCL's communicator is made at the join, on the bound card
        assert init["device_id"] == device == torch.device("cuda", local_rank)
        assert calls["set_device"] == [device]
        assert calls["override"] == 0
    elif device_type == "cuda":
        assert init["device_id"] is None
        assert calls["set_device"] == [device]
        assert device.index == local_rank % n_cards
        assert calls["override"] == 1
    else:
        assert init["device_id"] is None
        assert calls["set_device"] == [] and calls["override"] == 0


def test_join_defaults_the_local_world_to_the_world(no_process_group,
                                                    monkeypatch):
    """Without a local world size every rank of the world counts as local:
    four ranks on two cards share them over gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    device, backend = mesh.join(3, 4, "tcp://localhost:1",
                                device_type="cuda", local_rank=3)
    assert (backend, device) == ("gloo", torch.device("cuda", 1))


def test_join_from_env_reads_the_launchers_local_world(no_process_group,
                                                       monkeypatch):
    """Rank 6 of two machines of four ranks each, on a machine of four
    cards: NCCL on ``cuda:2``."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k, v in {"RANK": "6", "WORLD_SIZE": "8", "LOCAL_RANK": "2",
                 "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "host0",
                 "MASTER_PORT": "29500"}.items():
        monkeypatch.setenv(k, v)
    rank, world, device, backend = mesh.join_from_env("cuda")
    assert (rank, world) == (6, 8)
    assert (backend, device) == (mesh.NCCL, torch.device("cuda", 2))
    [init] = no_process_group["init"]
    assert init["init_method"] == "tcp://host0:29500"
    assert (init["rank"], init["world_size"]) == (6, 8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_join_on_the_cpu_makes_a_gloo_world_without_the_override():
    script = (
        "import torch, torch.distributed as dist\n"
        "from repro_torch.launch import mesh\n"
        "rank, world, device, backend = mesh.join_from_env('cpu')\n"
        "t = torch.ones(3)\n"
        "dist.all_reduce(t)\n"
        "m = mesh.make_mesh((1, 1), ('data', 'model'), 'cpu')\n"
        "print(rank, world, device, backend, dist.get_backend(),\n"
        "      mesh._GLOO_CUDA_LIB is None, t.tolist(),\n"
        "      tuple(m.mesh.shape))\n"
        "mesh.leave()\n")
    env = dict(os.environ, PYTHONPATH=SRC, RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == [
        "0", "1", "cpu", "gloo", "gloo", "True", "[1.0,", "1.0,", "1.0]",
        "(1,", "1)"]

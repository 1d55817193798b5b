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
- The world and mesh entry points default to the card: with no card
  visible they raise, naming it, and work with ``"cpu"`` named; no line
  of the module picks the device from ``torch.cuda.is_available()``.

The JAX package has no counterpart: its meshes join no process group.
"""
import inspect
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


@pytest.fixture
def no_card(monkeypatch):
    """The card hidden: ``torch.cuda`` sees none (and would fail if asked
    to bind one)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def one_process_world():
    """A one-rank gloo world in this process, left at the end."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _launcher_env(monkeypatch):
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)


ENTRY_POINTS = {
    "make_mesh": lambda: mesh.make_mesh((1, 1)),
    "make_production_mesh": lambda: mesh.make_production_mesh(),
    "join": lambda: mesh.join(0, 1, "tcp://localhost:1"),
    "join_from_env": lambda: mesh.join_from_env(),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card_and_raise_without_one(
        no_card, no_process_group, monkeypatch, entry):
    """No device type named and no card visible: a ``ValueError`` that
    names the card, before any process group or mesh is made."""
    _launcher_env(monkeypatch)
    with pytest.raises(ValueError, match="no card is visible") as err:
        ENTRY_POINTS[entry]()
    assert "cuda" in str(err.value) and "'cpu'" in str(err.value)
    assert no_process_group["init"] == []
    assert no_process_group["set_device"] == []


def test_make_mesh_names_the_device_types_it_lays_out(no_card):
    with pytest.raises(ValueError, match="cuda or cpu"):
        mesh.make_mesh((1, 1), ("data", "model"), "mps")


def test_join_and_join_from_env_on_the_cpu_named_need_no_card(
        no_card, no_process_group, monkeypatch):
    device, backend = mesh.join(0, 1, "tcp://localhost:1", device_type="cpu")
    assert (device, backend) == (torch.device("cpu"), "gloo")
    _launcher_env(monkeypatch)
    rank, world, device, backend = mesh.join_from_env("cpu")
    assert (rank, world, device, backend) == (0, 1, torch.device("cpu"),
                                              "gloo")
    assert [c["backend"] for c in no_process_group["init"]] == ["gloo"] * 2
    assert no_process_group["set_device"] == []
    assert no_process_group["override"] == 0


def test_meshes_on_the_cpu_named_need_no_card(no_card, one_process_world):
    """``make_mesh`` with ``"cpu"`` named, and ``make_host_mesh`` (the CPU
    smoke mesh, whose default stays the CPU), on a world of one."""
    for m in (mesh.make_mesh((1, 1), ("data", "model"), "cpu"),
              mesh.make_host_mesh()):
        assert m.device_type == "cpu"
        assert tuple(m.mesh.shape) == (1, 1)
        assert m.mesh_dim_names == ("data", "model")


def test_no_device_choice_from_is_available():
    """The module reads the card count where it must (``join``, the
    mesh's check) and never takes the CPU because no card answered."""
    src = inspect.getsource(mesh)
    assert "is_available" not in src
    for fn in (mesh.make_mesh, mesh.make_production_mesh, mesh.join,
               mesh.join_from_env):
        assert inspect.signature(fn).parameters[
            "device_type"].default == "cuda"
    assert inspect.signature(mesh.make_host_mesh).parameters[
        "device_type"].default == "cpu"

"""The supervised-kill scenario on the port, on the CPU at the reduced
config (the JAX package's tests/test_supervisor.py end-to-end test):
``repro_torch.launch.train --supervise`` workers, an exit-mode chaos spec
kills the first child at step 8, the supervisor detects, backs off,
restarts, and the durable counters keep child 2 alive."""
from repro_torch.chaos.scenarios import run_scenario


def test_supervised_kill_scenario_end_to_end(tmp_path):
    r = run_scenario("supervised-kill", "fti", str(tmp_path), device="cpu")
    assert r.ok, r.detail
    assert r.detail["resumed_from_step_6"]     # never from step 0
    assert r.detail["exactly_one_restart"] and r.detail["backoff_paced"]
    assert r.detail["feed"]["deaths"] == 1
    assert r.data_loss_bytes == 0 and r.mttr_s > 0
    # the finishing worker wrote its kernel launches: none on the CPU
    assert r.detail["worker_launches"] == [
        {"blockhash2": 0, "diffpack": 0, "diffunpack": 0, "flashattn": 0,
         "flashattn_bwd": 0}]

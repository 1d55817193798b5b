"""repro_torch.chaos: injection plane, Daly cadence, backoff, quorum/elastic
ties — the JAX package's tests/test_chaos.py, run against the port."""
import json
import os

import numpy as np
import pytest

from repro_torch.chaos import inject as chaos
from repro_torch.chaos.cadence import (
    REFERENCE,
    CadenceConfig,
    CadenceController,
    MTBFEstimator,
    checkpoint_efficiency,
    daly_interval,
    progress_rate,
)
from repro_torch.chaos.inject import ChaosRegistry, FaultSpec, InjectedFault
from repro_torch.ft.backoff import ExponentialBackoff, backoff_delay


@pytest.fixture(autouse=True)
def _clean_registry():
    chaos.reset()
    yield
    chaos.reset()


# -- FaultSpec triggers ------------------------------------------------------
def test_spec_at_fires_on_nth_hit():
    reg = ChaosRegistry(env={})
    reg.arm(FaultSpec(site="s", at=3))
    reg.fire("s")
    reg.fire("s")
    with pytest.raises(InjectedFault):
        reg.fire("s")
    reg.fire("s")                              # times=1: exhausted
    assert reg.fired_count("s") == 1


def test_spec_every_repeats_up_to_times():
    reg = ChaosRegistry(env={})
    reg.arm(FaultSpec(site="s", every=2, times=2, mode="skip"))
    hits = [reg.fire("s").skipped for _ in range(8)]
    assert hits == [False, True, False, True, False, False, False, False]


def test_spec_prob_is_seeded_deterministic():
    def pattern(seed):
        reg = ChaosRegistry(env={})
        reg.arm(FaultSpec(site="s", prob=0.5, times=None, seed=seed,
                          mode="skip"))
        return [reg.fire("s").skipped for _ in range(64)]

    assert pattern(7) == pattern(7)
    assert pattern(7) != pattern(8)
    assert 10 < sum(pattern(7)) < 54          # actually probabilistic


def test_spec_match_filters_site_glob_and_ctx():
    reg = ChaosRegistry(env={})
    reg.arm(FaultSpec(site="objstore.*", match={"rank": 3}, times=None))
    reg.fire("objstore.put", rank=1)           # ctx mismatch
    reg.fire("tier.place", rank=3)             # site mismatch
    with pytest.raises(InjectedFault):
        reg.fire("objstore.get", rank=3)


def test_error_mode_raises_the_sites_natural_exception():
    class SiteError(Exception):
        pass

    reg = ChaosRegistry(env={})
    reg.arm(FaultSpec(site="s", message="boom"))
    with pytest.raises(SiteError, match="boom"):
        reg.fire("s", exc=SiteError)


def test_corrupt_mode_flips_payload_bytes():
    reg = ChaosRegistry(env={})
    reg.arm(FaultSpec(site="s", mode="corrupt"))
    blob = bytes(range(32))
    out = reg.fire("s", data=blob)
    assert out.data != blob and len(out.data) == len(blob)
    assert reg.fire("s", data=blob).data == blob   # exhausted → pass-through


def test_delay_mode_sleeps():
    import time
    reg = ChaosRegistry(env={})
    reg.arm(FaultSpec(site="s", mode="delay", delay_s=0.05))
    t0 = time.monotonic()
    reg.fire("s")
    assert time.monotonic() - t0 >= 0.05


def test_unknown_mode_and_unknown_keys_rejected():
    with pytest.raises(ValueError):
        FaultSpec(site="s", mode="explode")
    with pytest.raises(ValueError):
        FaultSpec.from_dict({"site": "s", "wat": 1})


# -- env activation protocol -------------------------------------------------
def test_env_round_trip_arms_specs_in_child_registry():
    specs = [FaultSpec(site="tier.place", at=2, match={"rank": 1}),
             FaultSpec(site="objstore.*", mode="corrupt", times=None)]
    env = chaos.env_for_specs(specs)
    reg = ChaosRegistry(env=env)
    assert reg.load_env() == 2
    armed = reg.specs()
    assert [s.to_dict() for s in armed] == [s.to_dict() for s in specs]


def test_env_file_indirection(tmp_path):
    p = tmp_path / "spec.json"
    p.write_text(json.dumps([{"site": "s", "mode": "skip"}]))
    reg = ChaosRegistry(env={chaos.CHAOS_ENV: f"@{p}"})
    assert reg.load_env() == 1
    assert reg.fire("s").skipped


def test_malformed_chaos_env_warns_and_arms_nothing():
    for bad in ("not json", '{"site": "s", "mode": "wat"}', '[{"nope": 1}]',
                "@/does/not/exist.json"):
        reg = ChaosRegistry(env={chaos.CHAOS_ENV: bad})
        with pytest.warns(RuntimeWarning):
            assert reg.load_env() == 0
        assert reg.fire("s").fired == 0        # inert, no raise


def test_fire_lazily_loads_env_once():
    reg = ChaosRegistry(env=chaos.env_for_specs([FaultSpec(site="s")]))
    with pytest.raises(InjectedFault):
        reg.fire("s")                          # no explicit load_env


def test_legacy_inject_at_warns_not_raises():
    from repro_torch.ft.failures import should_inject_from_env
    assert chaos.legacy_inject_at({}) is None
    assert chaos.legacy_inject_at({chaos.LEGACY_INJECT_ENV: "0.9"}) == 0.9
    with pytest.warns(RuntimeWarning):
        assert chaos.legacy_inject_at({chaos.LEGACY_INJECT_ENV: "90%"}) is None
    os.environ[chaos.LEGACY_INJECT_ENV] = "oops"
    try:
        with pytest.warns(RuntimeWarning):
            assert should_inject_from_env() is None
    finally:
        del os.environ[chaos.LEGACY_INJECT_ENV]


# -- instrumented seams ------------------------------------------------------
def test_heartbeat_fsyncs_before_replace(tmp_path, monkeypatch):
    from repro_torch.ft import detector
    synced = []
    real = os.fsync
    monkeypatch.setattr(detector.os, "fsync",
                        lambda fd: (synced.append(fd), real(fd))[1])
    hb = detector.Heartbeat(str(tmp_path / "hb"))
    hb.beat(1)
    assert synced and hb.last_step() == 1


def test_heartbeat_skip_site_suppresses_write(tmp_path):
    from repro_torch.ft.detector import Heartbeat
    chaos.arm(chaos.SITES.HEARTBEAT, mode="skip", times=None)
    hb = Heartbeat(str(tmp_path / "hb"))
    hb.beat(1)
    assert hb.last() is None                   # write never landed


# -- closed-form Daly equations (goldens from comd-ft's reference model) -----
GOLDEN = {  # num_nodes -> (delta_s, mtbf_s, tau_opt_s, efficiency)
    10: (0.4864, 3155760.0, 1751.795, 0.999445),
    100: (4.864, 315576.0, 1748.879, 0.994443),
    1000: (48.64, 31557.6, 1719.843, 0.944045),
    10000: (486.4, 3155.76, 1442.856, 0.464944),
}


@pytest.mark.parametrize("n", sorted(GOLDEN))
def test_daly_optimum_matches_reference_platform(n):
    delta, mtbf, tau, eff = GOLDEN[n]
    p = REFERENCE.platform(n)
    assert p.delta_s == pytest.approx(delta, rel=1e-9)
    assert p.mtbf_s == pytest.approx(mtbf, rel=1e-9)
    assert p.recovery_s == p.delta_s           # recovery reads what we wrote
    assert daly_interval(p.delta_s, p.mtbf_s) == pytest.approx(tau, rel=1e-4)
    assert checkpoint_efficiency(
        p.delta_s, p.recovery_s, p.mtbf_s) == pytest.approx(eff, rel=1e-4)


def test_daly_interval_edges():
    assert daly_interval(10.0, 4.0) == 4.0     # delta >= 2M → tau = M
    with pytest.raises(ValueError):
        daly_interval(0.0, 100.0)
    with pytest.raises(ValueError):
        daly_interval(1.0, 0.0)
    # optimum actually optimal: nudging tau either way loses progress
    p = REFERENCE.platform(1000)
    tau = daly_interval(p.delta_s, p.mtbf_s)
    best = progress_rate(tau, p.delta_s, p.recovery_s, p.mtbf_s)
    assert best > progress_rate(tau * 1.5, p.delta_s, p.recovery_s, p.mtbf_s)
    assert best > progress_rate(tau * 0.5, p.delta_s, p.recovery_s, p.mtbf_s)


def test_progress_rate_overflow_guard():
    assert progress_rate(1e9, 1.0, 1.0, 1.0) == 0.0


# -- online MTBF estimation --------------------------------------------------
def test_mtbf_estimator_converges_to_failure_spacing():
    est = MTBFEstimator(prior_mtbf_s=3600.0)
    est.note_progress(0.0)
    for i in range(1, 101):
        est.note_failure(i * 500.0)
    assert est.estimate() == pytest.approx(500.0, rel=0.15)
    assert est.failures == 100


def test_mtbf_estimator_counts_heartbeat_gaps_as_failures():
    est = MTBFEstimator(prior_mtbf_s=100.0, gap_failure_s=10.0)
    est.note_progress(0.0)
    est.note_progress(5.0)
    est.note_progress(50.0)                    # 45 s silence → failure
    assert est.failures == 1


def test_ingest_chaos_history_is_cursor_based():
    ctl = CadenceController()
    chaos.arm("s", mode="skip", every=1, times=None)
    chaos.fire("s")
    chaos.fire("s")
    assert ctl.ingest_chaos_history() == 2
    assert ctl.ingest_chaos_history() == 0     # nothing new
    chaos.fire("s")
    assert ctl.ingest_chaos_history() == 1
    assert ctl.mtbf.failures == 3


# -- cadence controller vs the closed form -----------------------------------
@pytest.mark.parametrize("n", [10, 100, 1000, 10000])
def test_controller_tracks_daly_optimum_within_10pct(n):
    """Synthetic MTBF sweep: store costs + failures at exact MTBF spacing →
    the controller's L4 interval lands within 10% of the closed form."""
    p = REFERENCE.platform(n)
    ctl = CadenceController(CadenceConfig(max_interval_s=1e9))
    for _ in range(8):
        ctl.note_store(4, p.delta_s)           # measured store cost
    ctl.note_step(0.0)
    for i in range(1, 201):                    # failures at exact spacing
        ctl.note_failure(i * p.mtbf_s)
    tau = ctl.interval_for(4)
    ref = daly_interval(p.delta_s, p.mtbf_s)
    assert abs(tau - ref) / ref < 0.10
    dp = ctl.datapoints(4)
    assert dp["checkpoint_efficiency"] == pytest.approx(
        checkpoint_efficiency(p.delta_s, p.recovery_s, p.mtbf_s), rel=0.05)
    assert 0.0 < dp["progress_rate"] <= 1.0


def test_due_levels_keeps_l1_frequent_l4_rare():
    ctl = CadenceController(CadenceConfig(prior_mtbf_s=10_000.0))
    ctl.note_store(1, 0.001)                   # cheap local tier
    ctl.note_store(4, 25.0)                    # expensive PFS tier
    assert ctl.interval_for(1) < ctl.interval_for(4) / 10
    assert ctl.due_levels(now=0.0) == [4, 3, 2, 1]   # nothing stored yet
    ctl.mark_stored(4, now=0.0)                # L4 refreshes nested tiers
    assert ctl.due_levels(now=0.0) == []
    t1 = ctl.interval_for(1) * 1.01
    assert ctl.due_levels(now=t1) == [1]       # only L1 due again
    assert ctl.due_levels(now=ctl.interval_for(4) * 1.01) == [4, 3, 2, 1]


def test_recovery_cost_falls_back_to_store_cost():
    ctl = CadenceController()
    ctl.note_store(4, 7.0)
    assert ctl.recovery_cost(4) == 7.0
    ctl.note_recovery(4, 3.0)
    assert ctl.recovery_cost(4) == 3.0


# -- shared restart backoff --------------------------------------------------
def test_backoff_delay_doubles_and_caps():
    assert backoff_delay(0) == 0.0
    assert [backoff_delay(k, 1.0, 30.0) for k in (1, 2, 3, 4, 5, 6)] == \
        [1.0, 2.0, 4.0, 8.0, 16.0, 30.0]


def test_exponential_backoff_state_machine():
    b = ExponentialBackoff(base_s=0.5, max_s=4.0)
    assert b.delay() == 0.0
    assert [b.failed() for _ in range(5)] == [0.5, 1.0, 2.0, 4.0, 4.0]
    b.reset()
    assert b.failed() == 0.5
    slept = []
    b.sleep_after_failure(sleep_fn=slept.append)
    assert slept == [1.0]


# -- quorum over multi-file shard sets ---------------------------------------
def _touch(d, name, payload=b"x"):
    with open(os.path.join(d, name), "wb") as f:
        f.write(payload)


def test_quorum_partner_covers_lost_shard_file(tmp_path):
    from repro_torch.core import manifest as mf
    from repro_torch.ft.straggler import commit_if_quorum, validate_quorum
    from repro_torch.redundancy.groups import Topology
    topo = Topology(world=4)
    d = mf.begin(str(tmp_path), 1)
    for r in range(4):
        _touch(d, f"rank{r}.chk5")
        for j in (0, 1):
            if (r, j) != (2, 1):               # rank 2 lost shard 1
                _touch(d, f"rank{r}.shard{j}.chk5")
    h = topo.partner_of(2)
    _touch(d, f"rank{h}.partner2.chk5")
    _touch(d, f"rank{h}.partner2.shard1.chk5")  # ...but its partner holds it
    rep = validate_quorum(d, topo)
    assert rep.restorable
    assert rep.covered_by_partner == [2] and (2, 1) in rep.shards_covered
    assert sorted(rep.present) == [0, 1, 3]
    assert commit_if_quorum(str(tmp_path), 1, topo)


def test_quorum_shard_hole_nobody_holds_is_lost(tmp_path):
    from repro_torch.core import manifest as mf
    from repro_torch.ft.straggler import validate_quorum
    from repro_torch.redundancy.groups import Topology
    topo = Topology(world=2)
    d = mf.begin(str(tmp_path), 1)
    for r in range(2):
        _touch(d, f"rank{r}.chk5")
        _touch(d, f"rank{r}.shard0.chk5")
    _touch(d, "rank0.shard2.chk5")             # shard 1 is a hole for rank 0
    rep = validate_quorum(d, topo)
    assert not rep.restorable and rep.lost == [0]


# -- elastic discovery through objstore catalog roots ------------------------
def _one_rank_backend(tmp_path, name="fti"):
    from repro_torch.backends.registry import make_backend
    from repro_torch.core.comm import LocalComm
    from repro_torch.core.storage import StorageConfig
    cfg = StorageConfig(root=str(tmp_path / "shared"), group_size=1)
    comm = LocalComm(str(tmp_path / "node-local"))
    kw = {"dedicated_thread": False} if name == "fti" else {}
    return cfg, comm, make_backend(cfg, comm, name, **kw)


def test_find_latest_sharded_discovers_catalog_ids(tmp_path):
    import shutil
    from repro_torch.core.storage import CHK_FULL
    from repro_torch.ft.elastic import find_latest_sharded
    cfg, comm, b = _one_rank_backend(tmp_path)
    b.tcl_store({"w": np.arange(64, dtype=np.float32)}, 5, 4, CHK_FULL)
    b.tcl_wait()
    tier = b.engine.objstore_tier()
    shutil.rmtree(comm.node_local_dir)
    shutil.rmtree(cfg.global_root)
    got = find_latest_sharded([cfg.global_root], tiers=[tier])
    assert got is not None
    d, ckpt_id = got
    assert ckpt_id == 5 and d.startswith(tier.root)
    assert os.path.exists(os.path.join(d, "rank0.chk5"))  # materialized


def test_find_latest_sharded_falls_back_past_dead_catalog(tmp_path):
    import shutil
    from repro_torch.core import manifest as mf
    from repro_torch.core.storage import CHK_FULL
    from repro_torch.ft.elastic import find_latest_sharded
    cfg, comm, b = _one_rank_backend(tmp_path)
    b.tcl_store({"w": np.zeros(8, np.float32)}, 9, 4, CHK_FULL)
    b.tcl_wait()
    tier = b.engine.objstore_tier()
    shutil.rmtree(cfg.global_root)             # id 9 lives only in the bucket
    # a directory-backed id 3 plus the catalog id 9 behind an outage
    d3 = mf.begin(cfg.global_root, 3)
    _touch(d3, "rank0.chk5")
    mf.write_manifest(cfg.global_root, 3, {"kind": "FULL", "level": 4})
    mf.commit(cfg.global_root, 3, keep_last=10)
    chaos.arm("objstore.*", mode="error", every=1, times=None)
    got = find_latest_sharded([cfg.global_root], tiers=[tier])
    assert got is not None and got[1] == 3     # catalog dark → dir id wins


# -- restart-durable chaos state ---------------------------------------------
def _state_env(specs, state_path):
    return chaos.env_for_specs(specs, state_path=str(state_path))


def test_state_file_persists_counters_across_registries(tmp_path):
    spec = FaultSpec(site="s", mode="error", at=3, times=1)
    env = _state_env([spec], tmp_path / "state.json")
    reg1 = ChaosRegistry(env=env)
    assert reg1.fire("s").fired == 0           # hit 1
    assert reg1.fire("s").fired == 0           # hit 2 — persisted
    reg2 = ChaosRegistry(env=env)              # the restarted process
    with pytest.raises(InjectedFault):
        reg2.fire("s")                         # hit 3, not hit 1
    reg3 = ChaosRegistry(env=env)              # spec now exhausted
    assert reg3.fire("s").fired == 0
    blob = json.loads((tmp_path / "state.json").read_text())
    (st,) = blob.values()
    assert st["hits"] == 3 and st["fired"] == 1


def test_prob_spec_rng_state_round_trips(tmp_path):
    mk = lambda: FaultSpec(site="s", mode="skip", prob=0.5, seed=7,
                           times=None)
    ref = mk()                                 # uninterrupted reference
    want = [ref.should_fire() for _ in range(20)]
    env = _state_env([mk()], tmp_path / "state.json")
    reg1 = ChaosRegistry(env=env)
    got = [reg1.fire("s").skipped for _ in range(10)]
    reg2 = ChaosRegistry(env=env)              # resumes the RNG stream
    got += [reg2.fire("s").skipped for _ in range(10)]
    assert got == want


def test_malformed_state_file_warns_never_raises(tmp_path):
    p = tmp_path / "state.json"
    spec = FaultSpec(site="s", at=1)
    bad_counters = json.dumps({spec.state_key(): {"hits": "wat"}})
    for bad in ("not json", "[1, 2]", bad_counters):
        p.write_text(bad)
        env = _state_env([FaultSpec(site="s", at=1)], p)
        reg = ChaosRegistry(env=env)
        with pytest.warns(RuntimeWarning):
            assert reg.load_env() == 1         # spec armed, counters zeroed
        with pytest.raises(InjectedFault):
            reg.fire("s")                      # still fires on hit 1
    # a state key that matches no armed spec is simply ignored (it may
    # belong to a sibling process's spec set)
    p.write_text('{"deadbeef": {"hits": 5}}')
    reg = ChaosRegistry(env=_state_env([FaultSpec(site="s", at=1)], p))
    assert reg.load_env() == 1
    with pytest.raises(InjectedFault):
        reg.fire("s")


def test_rearm_flag_serialization_round_trips():
    assert "rearm" not in FaultSpec(site="s").to_dict()   # default stays
    d = FaultSpec(site="s", rearm=False).to_dict()
    assert d["rearm"] is False
    assert FaultSpec.from_dict(d).rearm is False
    assert FaultSpec.from_dict({"site": "s"}).rearm is True


def test_restart_env_applies_rearm_semantics(tmp_path):
    keep = FaultSpec(site="train.step", mode="exit", every=8)
    drop = FaultSpec(site="objstore.*", mode="error", rearm=False)
    env = _state_env([keep, drop], tmp_path / "st.json")
    env[chaos.LEGACY_INJECT_ENV] = "0.9"
    out = chaos.restart_env(env)
    assert chaos.LEGACY_INJECT_ENV not in out  # one-shot legacy fault
    assert json.loads(out[chaos.CHAOS_ENV]) == [keep.to_dict()]
    assert out[chaos.CHAOS_STATE_ENV] == str(tmp_path / "st.json")
    # all rearm=False → both chaos vars drop
    out2 = chaos.restart_env(_state_env([drop], tmp_path / "st.json"))
    assert chaos.CHAOS_ENV not in out2 and chaos.CHAOS_STATE_ENV not in out2
    # malformed spec JSON → warn, drop, never raise
    with pytest.warns(RuntimeWarning):
        out3 = chaos.restart_env({chaos.CHAOS_ENV: "not json"})
    assert chaos.CHAOS_ENV not in out3
    assert chaos.restart_env({}) == {}


def test_exit_spec_kills_child_n_but_not_child_n_plus_1(tmp_path):
    """The tentpole contract end to end: a repeating exit spec kills the
    child whose hit count reaches the trigger, and the durable state file
    keeps it from re-killing the next child at the same count."""
    import subprocess
    import sys

    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(_state_env(
        [FaultSpec(site="train.step", mode="exit", every=2, times=1)],
        tmp_path / "state.json"))
    script = ("from repro_torch.chaos import inject as chaos\n"
              "for i in range(2):\n"
              "    chaos.fire('train.step', step=i)\n"
              "print('CLEAN')\n")
    p1 = subprocess.run([sys.executable, "-c", script], env=env,
                        capture_output=True, text=True, timeout=60)
    assert p1.returncode == chaos.EXIT_CODE and "CLEAN" not in p1.stdout
    p2 = subprocess.run([sys.executable, "-c", script], env=env,
                        capture_output=True, text=True, timeout=60)
    assert p2.returncode == 0 and "CLEAN" in p2.stdout
    blob = json.loads((tmp_path / "state.json").read_text())
    assert sum(v["fired"] for v in blob.values()) == 1


# -- cadence-aware DIFF scheduling -------------------------------------------
def test_kind_strings_mirror_core_protect():
    from repro_torch.chaos.cadence import CHK_DIFF_KIND, CHK_FULL_KIND
    from repro_torch.core.protect import CHK_DIFF, CHK_FULL
    assert CHK_FULL_KIND == CHK_FULL and CHK_DIFF_KIND == CHK_DIFF


def test_diff_interval_golden_vs_closed_form():
    from repro_torch.chaos.cadence import CHK_DIFF_KIND
    ctl = CadenceController(CadenceConfig(max_interval_s=1e9))
    for _ in range(8):
        ctl.note_store(4, 20.0)
        ctl.note_diff_store(4, 2.0, 0.10)
    m = ctl.mtbf.estimate()
    assert ctl.interval_for(4) == pytest.approx(daly_interval(20.0, m))
    assert ctl.interval_for(4, kind=CHK_DIFF_KIND) == pytest.approx(
        daly_interval(2.0, m))
    assert ctl.interval_for(4, kind=CHK_DIFF_KIND) < ctl.interval_for(4)
    sched = ctl.schedule(kind=CHK_DIFF_KIND)
    assert sched[4] == ctl.interval_for(4, kind=CHK_DIFF_KIND)


def test_diff_interval_collapses_to_full_past_promote_threshold():
    from repro_torch.chaos.cadence import CHK_DIFF_KIND
    ctl = CadenceController(CadenceConfig(max_interval_s=1e9))
    ctl.note_store(4, 20.0)
    ctl.note_diff_store(4, 2.0, 0.99)          # dirty past break-even
    assert ctl.diff_store_cost(4) == ctl.store_cost(4)
    assert ctl.interval_for(4, kind=CHK_DIFF_KIND) == ctl.interval_for(4)


def test_diff_dirty_ratio_scales_full_cost_when_unmeasured():
    from repro_torch.chaos.cadence import CHK_DIFF_KIND
    ctl = CadenceController(CadenceConfig(max_interval_s=1e9))
    ctl.note_store(4, 20.0)
    ctl.note_diff_store(4, None, 0.25)         # ratio known, cost not
    assert ctl.diff_store_cost(4) == pytest.approx(0.25 * 20.0)
    assert ctl.interval_for(4, kind=CHK_DIFF_KIND) == pytest.approx(
        daly_interval(5.0, ctl.mtbf.estimate()))
    # nothing observed at all → never schedule cheaper than evidence
    assert ctl.diff_store_cost(3) == ctl.store_cost(3)


def test_note_report_routes_diff_vs_promoted_full():
    from types import SimpleNamespace as NS
    ctl = CadenceController()
    ctl.note_report(NS(level=4, seconds=2.0, kind="DIFF",
                       promoted_full=False, dirty_ratio=0.2))
    assert ctl._costs[4].diff_store_s == 2.0 and ctl._costs[4].store_s is None
    ctl.note_report(NS(level=4, seconds=21.0, kind="DIFF",
                       promoted_full=True, dirty_ratio=0.98))
    assert ctl._costs[4].store_s == 21.0       # promoted = FULL pricing
    assert ctl._costs[4].diff_store_s == 2.0   # DIFF EWMA untouched
    assert ctl._costs[4].dirty_ratio > 0.2     # but the evidence lands
    ctl.note_report(NS(level=4, seconds=20.0, kind="FULL",
                       promoted_full=False, dirty_ratio=None))
    assert ctl._costs[4].store_s < 21.0


# -- MTBF merge + durable feed -----------------------------------------------
def test_mtbf_merge_and_feed_round_trip(tmp_path):
    from repro_torch.chaos.cadence import MTBFFeed
    est = MTBFEstimator(prior_mtbf_s=3600.0)
    est.note_progress(0.0)
    est.note_failure(10.0)
    feed = MTBFFeed(str(tmp_path / "feed.json"))
    assert feed.read() is None                 # missing file: no warning
    feed.write(est, deaths=1, mttr_s=[2.5])
    fresh = MTBFEstimator(prior_mtbf_s=3600.0)
    assert feed.seed(fresh) is True
    assert fresh.failures == 1 and fresh.span_s == pytest.approx(10.0)
    assert fresh.estimate() == pytest.approx(est.estimate())
    assert fresh.estimate() < 3600.0           # the estimate actually moved
    blob = feed.read()
    assert blob["deaths"] == 1 and blob["mttr_s"] == [2.5]


def test_mtbf_feed_malformed_warns_and_seeds_nothing(tmp_path):
    from repro_torch.chaos.cadence import MTBFFeed
    p = tmp_path / "feed.json"
    for bad in ("not json", "[1]", '{"failures": "wat", "span_s": "x"}'):
        p.write_text(bad)
        est = MTBFEstimator()
        with pytest.warns(RuntimeWarning):
            assert MTBFFeed(str(p)).seed(est) is False
        assert est.failures == 0


# -- backoff reset after sustained health ------------------------------------
def test_backoff_resets_after_sustained_healthy_span():
    b = ExponentialBackoff(base_s=1.0, max_s=30.0)
    b.failed()
    b.failed()
    assert b.note_healthy_span(5.0, 10.0) is False
    assert b.failures == 2                     # not healthy long enough
    assert b.note_healthy_span(10.0, 10.0) is True
    assert b.failures == 0
    assert b.note_healthy_span(20.0, 10.0) is False   # nothing to forget
    assert b.failed() == 1.0                   # back to base, not 4.0

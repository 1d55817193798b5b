"""``tests/test_supervisor.py``'s fake-world tests on the port's
``ft/supervisor`` (a copy of the reference's): kill/restart policy under a
simulated clock.

The fake world drives Supervisor's injectable clock/wall/sleep/popen so
the startup-grace, stale-heartbeat, backoff-reset, MTTR and MTBF-feed
behaviors are asserted deterministically — no real sleeps, no real
processes.  The end-to-end supervised kill is
``tests/test_torch_supervised_kill.py``.
"""
import json

import pytest

from repro_torch.chaos.cadence import MTBFFeed
from repro_torch.ft.supervisor import Supervisor, SupervisorConfig

WALL0 = 1000.0  # arbitrary wall-clock origin for the fake world


class FakeProc:
    def __init__(self):
        self.rc = None
        self.killed = False

    def poll(self):
        return self.rc

    def kill(self):
        self.killed = True
        self.rc = -9

    def wait(self):
        return self.rc


class World:
    """Simulated time: sleep() advances the clock and fires scheduled
    events (worker beats, worker exits) as their times pass."""

    def __init__(self, hb_path):
        self.t = 0.0
        self.hb_path = str(hb_path)
        self.events = []  # sorted (t, fn)

    def clock(self):
        return self.t

    def wall(self):
        return WALL0 + self.t

    def sleep(self, d):
        target = self.t + d
        while self.events and self.events[0][0] <= target:
            et, fn = self.events.pop(0)
            self.t = max(self.t, et)
            fn()
        self.t = target

    def at(self, t, fn):
        self.events.append((t, fn))
        self.events.sort(key=lambda e: e[0])

    def beat_at(self, t, step):
        def write():
            with open(self.hb_path, "w") as f:
                f.write(f"{self.wall()} {step}")
        self.at(t, write)

    def exit_at(self, t, proc, rc):
        def die():
            proc.rc = rc
        self.at(t, die)


def make_sup(tmp_path, procs, world, logs, **cfg_kw):
    cfg = SupervisorConfig(heartbeat_path=str(tmp_path / "hb"), **cfg_kw)
    it = iter(procs)
    return Supervisor(
        ["worker"], {}, cfg,
        clock=world.clock, wall=world.wall, sleep=world.sleep,
        popen=lambda cmd, env: next(it), log=logs.append)


def test_startup_grace_kills_beatless_worker(tmp_path):
    """The old inline loop's blind spot: a worker that wedges before its
    first heartbeat now dies at 2x the heartbeat timeout."""
    world = World(tmp_path / "hb")
    procs = [FakeProc(), FakeProc()]
    logs = []
    sup = make_sup(tmp_path, procs, world, logs,
                   heartbeat_timeout_s=10.0, max_restarts=1, poll_s=1.0,
                   backoff_base_s=1.0)
    assert sup.run() == 1                      # both attempts wedge
    assert all(p.killed for p in procs)
    assert sup.gap_kills == 2 and sup.deaths == 2
    assert any("startup grace" in m for m in logs)
    # each kill landed at the grace deadline (2x timeout), not the
    # heartbeat timeout and not never
    assert world.t == pytest.approx(20.0 + 1.0 + 20.0, abs=2.0)
    # hang kills are real failure observations: the estimate moved down
    assert sup.estimator.failures == 2
    assert sup.estimator.estimate() < sup.cfg.prior_mtbf_s


def test_stale_previous_heartbeat_does_not_mask_wedge(tmp_path):
    """A heartbeat file left by the dead predecessor (wall time older than
    this attempt's spawn) must not count as liveness."""
    (tmp_path / "hb").write_text(f"{WALL0 - 50.0} 7")   # stale beat
    world = World(tmp_path / "hb")
    p = FakeProc()
    logs = []
    sup = make_sup(tmp_path, [p], world, logs,
                   heartbeat_timeout_s=10.0, max_restarts=0, poll_s=1.0)
    assert sup.run() == 1
    assert p.killed and sup.gap_kills == 1
    assert world.t == pytest.approx(20.0, abs=2.0)      # grace, not timeout


def test_heartbeat_gap_kills_beating_then_silent_worker(tmp_path):
    world = World(tmp_path / "hb")
    p = FakeProc()
    logs = []
    world.beat_at(1.0, 1)                      # one beat, then silence
    sup = make_sup(tmp_path, [p], world, logs,
                   heartbeat_timeout_s=5.0, max_restarts=0, poll_s=1.0)
    assert sup.run() == 1
    assert p.killed
    assert any("heartbeat timeout" in m for m in logs)
    # killed ~5s after the beat — well before the 10s startup grace
    assert world.t == pytest.approx(6.0, abs=2.0)


def test_backoff_resets_after_sustained_healthy_run(tmp_path):
    """The old inline loop's other blind spot: one early crash must not
    tax every later restart at the doubled price."""
    world = World(tmp_path / "hb")
    p1, p2, p3 = FakeProc(), FakeProc(), FakeProc()
    logs = []
    world.exit_at(2.0, p1, 1)                  # crash 1: fast death
    # worker 2 spawns at ~6 (death + 4s backoff): beats 7..29, dies at 30
    for t in range(7, 30):
        world.beat_at(float(t), t)
    world.exit_at(30.0, p2, 1)
    # worker 3 spawns at ~34: beats, then clean exit
    world.beat_at(35.0, 35)
    world.exit_at(36.0, p3, 0)
    sup = make_sup(tmp_path, [p1, p2, p3], world, logs,
                   heartbeat_timeout_s=10.0, healthy_reset_s=10.0,
                   max_restarts=2, poll_s=1.0, backoff_base_s=4.0)
    assert sup.run() == 0
    delays = [float(m.split("backing off ")[1].split("s")[0])
              for m in logs if "backing off" in m]
    # without the reset the second delay would be 8.0
    assert delays == [4.0, 4.0]
    assert len(sup.mttr_s) == 2                # both deaths recovered from
    assert all(m > 0 for m in sup.mttr_s)


def test_mttr_recorded_and_feed_written(tmp_path):
    world = World(tmp_path / "hb")
    p1, p2 = FakeProc(), FakeProc()
    logs = []
    world.exit_at(1.0, p1, 1)                  # death at t=1
    world.beat_at(4.0, 4)                      # recovery beat at t=4
    world.exit_at(5.0, p2, 0)
    feed_path = str(tmp_path / "feed.json")
    sup = make_sup(tmp_path, [p1, p2], world, logs,
                   heartbeat_timeout_s=10.0, max_restarts=1, poll_s=1.0,
                   backoff_base_s=1.0, mtbf_feed_path=feed_path,
                   prior_mtbf_s=3600.0)
    assert sup.run() == 0
    (mttr,) = sup.mttr_s
    assert mttr == pytest.approx(3.0, abs=1.5)  # death t=1 → beat t=4
    blob = json.loads(open(feed_path).read())
    assert blob["deaths"] == 1 and blob["failures"] == 1
    assert blob["estimate_s"] < 3600.0
    assert blob["mttr_s"] == [round(mttr, 6)]
    # the feed seeds a fresh estimator (what a restarted worker does)
    from repro_torch.chaos.cadence import MTBFEstimator
    est = MTBFEstimator(prior_mtbf_s=3600.0)
    assert MTBFFeed(feed_path).seed(est)
    assert est.estimate() == pytest.approx(blob["estimate_s"], rel=1e-6)


def test_success_without_death_writes_feed_once(tmp_path):
    world = World(tmp_path / "hb")
    p = FakeProc()
    world.beat_at(1.0, 1)
    world.exit_at(2.0, p, 0)
    feed_path = str(tmp_path / "feed.json")
    sup = make_sup(tmp_path, [p], world, [],
                   heartbeat_timeout_s=10.0, mtbf_feed_path=feed_path)
    assert sup.run() == 0
    blob = json.loads(open(feed_path).read())
    assert blob["deaths"] == 0 and blob["failures"] == 0
    assert sup.mttr_s == []                    # nothing to recover from

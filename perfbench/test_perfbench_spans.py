"""The readers of the program's spans: the five restore and Plan metrics
on the CPU at a tiny size, nothing where the program has no such spans,
and the card's idle gaps named after the spans on one clock."""
import time

import pytest
import torch

from perfbench import gapnames, harness, spec, tiny

BENCH = spec.load()
SPAN_METRICS = ("plan_d2h_gbps", "recover_read_gbps", "recover_decode_gbps",
                "recover_h2d_gbps", "load_s")


@pytest.fixture(scope="module")
def restart_run(tmp_path_factory):
    torch.set_num_threads(2)
    cell = spec.cell(BENCH, "smollm2-1.7b.train-restart")
    return harness.run_cell(BENCH, cell, 2**31 + 7, 2.0, True,
                            torch.device("cpu"), time.time(),
                            workdir=tmp_path_factory.mktemp("wd"),
                            shrink=tiny.shrink)


def test_traced_restart_reports_the_span_metrics(restart_run):
    got = restart_run["metrics"]
    for name in SPAN_METRICS:
        assert got[name]["value"] > 0, name
    assert got["load_s"]["unit"] == "s"
    assert restart_run["correct"] is True


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_is_silent_without_the_span(name):
    """A program whose store and restore record no such spans (the one
    before they were added) gives the reader nothing to read."""
    run = harness.Run(spans=[
        {"ph": "B", "name": "pipeline.pack", "tid": 1, "ts": 0,
         "args": {}},
        {"ph": "E", "tid": 1, "ts": 10}])
    assert spec.reader(name)(run) is None


MS = 1_000_000                         # a millisecond, in nanoseconds
SHIFT = 5 * MS                         # the profiler's clock runs ahead
MAIN, CP = 11, 22                      # the window's thread, the CP thread


def _span_events(name, tid, a_ms, b_ms):
    return [{"ph": "B", "name": name, "tid": tid, "ts": a_ms * 1000,
             "args": {}},
            {"ph": "E", "tid": tid, "ts": b_ms * 1000}]


def test_idle_gaps_are_named_after_the_program_spans():
    busy_ms = [(0, 12), (20, 25), (28, 45), (50, 70), (75, 90)]
    device = [("spin", 1 * MS + SHIFT, 2 * MS + SHIFT)] + [
        ("gemm", a * MS + SHIFT, b * MS + SHIFT) for a, b in busy_ms]
    ranges = [("window", 0, 100 * MS), ("store", 10 * MS, 30 * MS),
              ("step", 40 * MS, 60 * MS), ("step", 60 * MS, 80 * MS)]
    events = (_span_events("chk.store", MAIN, 10, 30)
              + _span_events("plan.d2h", MAIN, 12, 20)
              + _span_events("pipeline.pack", CP, 30, 70)
              + _span_events("chk.load", MAIN, 90, 99)
              + _span_events("restore.read", MAIN, 90, 93)
              + _span_events("restore.decode", MAIN, 93, 99))
    events.sort(key=lambda e: e["ts"])
    got = gapnames.reduce_named(device, 1 * MS, ranges, events, MAIN)
    idle = got["idle_by_phase"]
    # the last gap (90-100 ms) runs from the read through the decode and
    # past the load: each piece goes to what holds it
    want = {"store/plan.d2h": 0.008, "store/chk.store": 0.003,
            "step+pipeline.pack": 0.005, "step": 0.005,
            "other/restore.read": 0.003, "other/restore.decode": 0.006,
            "other": 0.001}
    assert set(idle) == set(want)
    for k, v in want.items():
        assert idle[k] == pytest.approx(v), k
    assert got["window_s"] == pytest.approx(0.1)
    assert got["busy_s"] == pytest.approx(0.069)
    # without the marker the spans would sit 5 ms off the gaps
    unshifted = gapnames.reduce_named(device, None, ranges, events, MAIN)
    assert set(unshifted["idle_by_phase"]) != set(idle)

"""``flash_bwd_roofline``'s reader on a reduced trace made by hand: its
bound at the cell's shape, the backward passes it counts, and that it
never reads over 100 % where the kernels take just its bound."""
import math
from types import SimpleNamespace

import pytest

from perfbench import spec
from perfbench.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S

BENCH = spec.load()
CELL_SHAPE = (14, 4096, 4096, 32, 32, 64, True)   # B, S, Sk, H, KV, dh
DQ = "void (anonymous namespace)::tc::flash_bwd_dq_kernel<64>(CUtensorMap_st)"
DKDV = "void (anonymous namespace)::tc::flash_bwd_dkdv_kernel<64>(CUtensorMap_st)"
FWD = "void (anonymous namespace)::tc::flash_tc_kernel<64>(CUtensorMap_st)"

read = spec.reader("flash_bwd_roofline")
work = read.__globals__


def _run(kernels, layers=3):
    """A run of the cell's shape whose traced window holds ``kernels``."""
    family = SimpleNamespace(
        attention_launches=lambda cfg, job: [CELL_SHAPE] * layers)
    return SimpleNamespace(
        device_trace={"window_s": 51.0, "busy_s": 50.0, "kernels": kernels,
                      "idle_by_phase": {}},
        family=family, cfg={}, job={})


def test_bound_at_the_cells_shape():
    """10·dh FLOPs over the causal triangle with its diagonal: 2.41e12
    FLOPs, 2.433 ms at 989 TFLOP/s, against 1.66 GB, 0.495 ms at 3.35
    TB/s, so the operations bound it."""
    flops, nbytes = work["flash_bwd_work"](*CELL_SHAPE)
    pairs = 14 * 32 * 4096 * 4097 // 2
    assert flops == 10 * 64 * pairs
    assert nbytes == 2 * 7 * 14 * 4096 * 32 * 64 + 8 * 14 * 32 * 4096
    assert round(flops / BF16_FLOPS_PER_S * 1e3, 3) == 2.433
    assert round(nbytes / HBM_BYTES_PER_S * 1e3, 3) == 0.495
    assert work["flash_bwd_bound_s"](CELL_SHAPE) == flops / BF16_FLOPS_PER_S


def test_counts_passes_from_the_dq_kernel_and_times_every_bwd_kernel():
    one = work["flash_bwd_bound_s"](CELL_SHAPE)
    # two steps of 3 layers: 6 backwards, each kernel launched once a pass;
    # the forward's kernel is not the backward's time
    got = read(_run({DQ: [6, 0.02], DKDV: [6, 0.04], FWD: [12, 0.05]}))
    assert math.isclose(got, 100.0 * 2 * 3 * one / 0.06)


@pytest.mark.parametrize("share", [1.0, 0.5, 0.25])
def test_never_over_100_when_the_kernels_take_the_bound(share):
    one = work["flash_bwd_bound_s"](CELL_SHAPE)
    total = 6 * one
    kernels = {DQ: [6, total * share], DKDV: [6, total * (1 - share)]}
    if share == 1.0:
        del kernels[DKDV]
    got = read(_run(kernels))
    assert math.isclose(got, 100.0)
    slower = read(_run({DQ: [6, total * share],
                        DKDV: [6, total * (1 - share) + 1e-3]}))
    assert slower < 100.0


def test_no_reading_without_the_kernel_or_a_whole_pass():
    # the plain backward: f32 GEMMs and elementwise kernels, no flash_bwd
    assert read(_run({FWD: [12, 0.05], "sm80_xmma_gemm_f32f32": [90, 5.8]})) \
        is None
    assert read(_run({DQ: [5, 0.02], DKDV: [5, 0.04]})) is None
    assert read(SimpleNamespace(device_trace=None)) is None


@pytest.mark.parametrize("name,cell", [
    ("flash_bwd_roofline", "smollm2-1.7b.train-restart"),
    ("flash_bwd_roofline.steady", "smollm2-1.7b.train-steady")])
def test_each_cell_lists_its_reading(name, cell):
    m = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert m["workloads"] == [cell] and m["layer"] == "kernels"
    assert m["moves"] in {e["name"] for e in spec.metrics_of(BENCH, cell,
                                                             False)}
    assert spec.reader(name)(_run({DQ: [3, 0.01]})) == read(
        _run({DQ: [3, 0.01]}))

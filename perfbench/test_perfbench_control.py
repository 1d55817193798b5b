"""The control of ``correct``: the plain reference in the program's place,
rounded to float8 where the configuration computes in bfloat16.

On the card, at the cell's own size, it comes out not correct against the
configuration's limits and the program beside it correct, on the seeds
the limits were read on (``perfbench/control.py`` gave those readings).

On the CPU, at a size a test run holds, the same readings keep their
order: the control's gaps lie several times above the program's on
every seed, and the reference rounded to bfloat16 where the program
rounds (what the stated precision alone costs) reads like the program.
The limits themselves belong to the cell's size (a narrow model's norms
average fewer roundings), so they are judged only on the card."""
import pytest
import torch

from perfbench import check, control, spec, tiny

CELLS = {"smollm2-1.7b": "smollm2-1.7b.train-restart"}
#: wide enough that a leaf's norm averages thousands of roundings
CPU_SIZE = {"hidden_size": 256, "num_attention_heads": 4,
            "num_key_value_heads": 4, "intermediate_size": 1024,
            "vocab_size": 2048}
CPU_JOB = {"batch": 4, "tokens": 128}


def _cpu_size(cfg, job):
    cfg, job = tiny.shrink(cfg, job)
    return (dict(cfg, **CPU_SIZE, compute_dtype="bfloat16"),
            dict(job, **CPU_JOB))


@pytest.fixture(scope="module", params=sorted(CELLS))
def cpu_rows(request):
    torch.set_num_threads(2)
    return control.run(CELLS[request.param], [5, 6, 7], 3,
                       torch.device("cpu"), shrink=_cpu_size)["rows"]


def test_control_reads_far_above_the_program(cpu_rows):
    for r in cpu_rows:
        prog, ctl = r["program"], r["control"]
        assert ctl["grad_gap"] > 5 * prog["grad_gap"], r
        assert ctl["loss_gap"] > 3 * prog["loss_gap"], r
        assert ctl["change_gap"] > 3 * prog["change_gap"], r


def test_witness_reads_like_the_program(cpu_rows):
    for r in cpu_rows:
        prog, wit = r["program"], r["bf16_witness"]
        for name in ("loss_gap", "grad_gap", "change_gap"):
            assert wit[name] < 3 * max(prog[name], 1e-6), (name, r)


def test_half_batch_reads_far_above_the_program(cpu_rows):
    for r in cpu_rows:
        assert r["half_batch"]["grad_gap"] > 10 * r["program"]["grad_gap"]


@pytest.mark.gpu
@pytest.mark.parametrize("config", sorted(CELLS))
def test_control_fails_the_limits_at_the_cells_size_on_card(config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the limits hold at the cell's size")
    rows = control.run(CELLS[config], [21, 22, 23], 3,
                       torch.device("cuda", 0))["rows"]
    limits = spec.limits(config)
    for r in rows:
        assert check.judge(r["program"], limits)[0], r["program"]
        assert check.judge(r["bf16_witness"], limits)[0], r["bf16_witness"]
        assert not check.judge(r["control"], limits)[0], r["control"]
        assert not check.judge(r["half_batch"], limits)[0], r["half_batch"]


def test_every_configuration_has_a_control_case():
    bench = spec.load()
    assert set(CELLS) == {c["name"] for c in bench["configs"]}
    for config, cell in CELLS.items():
        assert spec.cell(bench, cell)["config"] == config

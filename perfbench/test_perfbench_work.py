"""The yardstick's arithmetic against ``chip_smoke.py``'s bounds, at the
shapes of the port's kernel table (``PERF.md``, measured in the bring-up
on an H100), and the model FLOPs of both configurations against a count
of their parameters."""
import math

import pytest

import chip_smoke
from perfbench import spec, work
from perfbench.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S

# (B, S, Sk, H, KV, dh, causal) → the bound chip_smoke printed, in ms
FLASH_TABLE = [
    ((4, 2048, 2048, 32, 4, 64, True), 0.0695, "operations"),
    ((4, 2048, 2048, 32, 4, 64, False), 0.1390, "operations"),
    ((4, 2048, 2048, 24, 8, 64, True), 0.0521, "operations"),
    ((16, 512, 512, 12, 12, 64, True), 0.0150, "bytes"),
]


@pytest.mark.parametrize("shape,ms,by", FLASH_TABLE)
def test_flash_bound_matches_chip_smoke(shape, ms, by):
    secs, got_by = work.bound_s(*work.flash_work(*shape))
    assert got_by == by
    assert round(secs * 1e3, 4) == ms


def test_flash_counts_the_lower_triangle_with_its_diagonal():
    flops, _ = work.flash_work(1, 4, 4, 1, 1, 8, True)
    assert flops == 4 * 8 * 10
    flops, nbytes = work.flash_work(2, 3, 5, 4, 2, 8, False)
    assert flops == 4 * 8 * 2 * 4 * 3 * 5
    assert nbytes == 2 * (2 * 2 * 3 * 4 * 8 + 2 * 2 * 5 * 2 * 8)


@pytest.mark.parametrize("nbytes", [262_144_000, 1, 65_536, 65_537,
                                    3_538_206_720])
def test_blockhash_bytes_match_chip_smoke(nbytes):
    moved = work.blockhash_bytes(nbytes)
    blocks = max(1, -(-nbytes // 65_536))
    assert moved == nbytes + 8 * blocks
    assert chip_smoke.bound(moved) == (moved / HBM_BYTES_PER_S * 1e3,
                                       "bytes")


def test_embed_hash_bound_is_the_table_s():
    """tinyllama's embed, 32000 × 2048 f32: 0.0783 ms in the table."""
    ms = work.bound_s(0, work.blockhash_bytes(32000 * 2048 * 4))[0] * 1e3
    assert round(ms, 4) == 0.0783


def test_peaks_are_chip_smoke_s():
    assert HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert BF16_FLOPS_PER_S == chip_smoke.BF16_FLOPS_PER_S


@pytest.mark.parametrize("config", ["smollm2-1.7b"])
def test_model_flops_cover_every_product(config):
    """Model FLOPs of a step, less attention's, are 6 per matrix parameter
    a token touches (2 forward, 4 backward), the tied logits' included."""
    bench = spec.load()
    cfg = spec.config(bench, config)
    fam = spec.reference(cfg["reference"])
    job = cfg["job"]
    m = fam.dims(cfg)
    d, h, kv, dh = m["d"], m["H"], m["KV"], m["dh"]
    flops = fam.model_flops(cfg, job)
    attn = sum(work.flash_work(*s)[0] for s in
               fam.attention_launches(cfg, job))
    t = job["batch"] * job["tokens"]
    per_token = 2 * d * h * dh + 2 * d * kv * dh + 3 * d * m["F"]
    matrices = t * (m["L"] * per_token + d * m["V"])
    assert math.isclose(flops, 6 * matrices + 3 * attn, rel_tol=1e-12)


@pytest.mark.parametrize("config", ["smollm2-1.7b"])
def test_matrix_parameters_are_the_programs(config):
    """The per-token matrix count above is the program's own parameter
    count of the configuration, less the norms' gains."""
    from perfbench.harness import port_arch
    from repro_torch.core.protect import flatten_named
    from repro_torch.models.zoo import build_model
    cfg = spec.config(spec.load(), config)
    fam = spec.reference(cfg["reference"])
    m = fam.dims(cfg)
    d, h, kv, dh = m["d"], m["H"], m["KV"], m["dh"]
    shapes = flatten_named(build_model(port_arch(cfg)).param_struct())
    matrices = sum(math.prod(v.shape) for k, v in shapes.items()
                   if not k.endswith("scale"))
    per_layer = 2 * d * h * dh + 2 * d * kv * dh + 3 * d * m["F"]
    assert matrices == m["L"] * per_layer + d * m["V"]

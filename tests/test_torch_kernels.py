"""The port's checkpoint kernels against the JAX package.

On the CPU the port runs the plain PyTorch versions: they must give the
same u32 words as ``repro.kernels.ref`` and as the Pallas kernels run in
interpret mode, bit for bit, for the shapes ``tests/test_kernels.py``
uses, and the same per-block digests as ``repro.kernels.ops.blockhash``
for every dtype width at ragged sizes.  The hand-written Hopper kernels
are checked against those plain versions on a card in
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.blockhash import BE, BR, blockhash2_pallas, blockhash_pallas
from repro.kernels.diffpack import diffpack_pallas, diffunpack_pallas
from repro_torch.core.formats import numpy_to_tensor
from repro_torch.kernels import blockhash as bh
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import diffpack as dp
from repro_torch.kernels import flashattn as fa


def words(a: np.ndarray) -> torch.Tensor:
    """Host u32 words → the port's int32-carried word tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def rand_u32(rng, *shape) -> np.ndarray:
    return rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("rows_mult,elems_mult", [(1, 1), (2, 1), (1, 3), (4, 2)])
def test_blockhash_ref_matches_reference_and_pallas(rows_mult, elems_mult):
    rng = np.random.RandomState(rows_mult * 10 + elems_mult)
    x = rand_u32(rng, BR * rows_mult, BE * elems_mult)
    got = ops.u32_numpy(ref.blockhash_ref(words(x)))
    assert np.array_equal(got, np.asarray(jref.blockhash_ref(jnp.asarray(x))))
    assert np.array_equal(got, np.asarray(
        blockhash_pallas(jnp.asarray(x), interpret=True)))


def test_blockhash2_ref_two_lanes_match_pallas():
    rng = np.random.RandomState(0)
    x = rand_u32(rng, BR, BE)
    got = ops.u32_numpy(ref.blockhash2_ref(words(x)))
    assert got.shape == (BR, 2) and not np.array_equal(got[:, 0], got[:, 1])
    assert np.array_equal(got, np.asarray(
        blockhash2_pallas(jnp.asarray(x), interpret=True)))
    assert np.array_equal(got, np.asarray(jref.blockhash2_ref(jnp.asarray(x))))


@pytest.mark.parametrize("n_blocks,elems,n_dirty",
                         [(8, 128, 3), (16, 256, 16), (4, 512, 1)])
def test_diffpack_ref_matches_reference_and_pallas(n_blocks, elems, n_dirty):
    rng = np.random.RandomState(n_blocks)
    blocks = rng.randn(n_blocks, elems).astype(np.float32)
    idx = rng.choice(n_blocks, size=n_dirty, replace=False).astype(np.int32)
    got = ops.u32_numpy(ref.diffpack_ref(words(blocks.view(np.uint32)),
                                         torch.from_numpy(idx)))
    want = np.asarray(diffpack_pallas(jnp.asarray(blocks), jnp.asarray(idx),
                                      interpret=True))
    assert np.array_equal(got, want.view(np.uint32))
    assert np.array_equal(got, np.asarray(jref.diffpack_ref(
        jnp.asarray(blocks), jnp.asarray(idx))).view(np.uint32))


def test_diffunpack_ref_matches_reference_and_pallas():
    rng = np.random.RandomState(3)
    base = rng.randn(16, 128).astype(np.float32)
    idx = np.array([1, 7, 13], np.int32)
    packed = rng.randn(3, 128).astype(np.float32)
    got = ops.u32_numpy(ref.diffunpack_ref(
        words(base.view(np.uint32)), words(packed.view(np.uint32)),
        torch.from_numpy(idx)))
    want = np.asarray(diffunpack_pallas(jnp.asarray(base), jnp.asarray(packed),
                                        jnp.asarray(idx), interpret=True))
    assert np.array_equal(got, want.view(np.uint32))


DTYPES = [np.float32, ml_dtypes.bfloat16, np.int32, np.float64, np.uint8,
          np.int8]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_ops_blockhash_matches_reference(dtype):
    """Same bytes → the same (n_blocks, 2) digests as the JAX package, at
    ragged sizes (a sub-word tail and a partial last block).  x64 is on
    for the reference so f64 leaves keep their width there too."""
    rng = np.random.RandomState(7)
    for n in (1, 3, 65, 1001):
        a = (rng.randn(n) * 100).astype(dtype)
        got = ops.u32_numpy(ops.blockhash(numpy_to_tensor(a), 256))
        with jax.enable_x64(True):
            want = np.asarray(jops.blockhash(jnp.asarray(a), 256))
        assert got.dtype == np.uint32 and np.array_equal(got, want), n


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.uint8,
                                   np.float64], ids=lambda d: np.dtype(d).name)
def test_as_u32_blocks_and_pack_dirty_match_reference(dtype):
    """The padded u32 block view and the gathered dirty rows equal the JAX
    package's (little-endian pairs/quads, zero-padded ragged tail)."""
    rng = np.random.RandomState(1)
    a = (rng.randn(777) * 10).astype(dtype)
    t = numpy_to_tensor(a)
    blocks, n = ops.as_u32_blocks(t, 256)
    with jax.enable_x64(True):
        jblocks, jn = jops.as_u32_blocks(jnp.asarray(a), 256)
        idx = np.array([0, n - 1, 2], np.int32)
        jpacked = jops.pack_dirty(jnp.asarray(a), jnp.asarray(idx), 3, 256)
    assert n == jn
    assert np.array_equal(ops.u32_numpy(blocks), np.asarray(jblocks))
    assert np.array_equal(ops.u32_numpy(ops.pack_dirty_many([t], [idx], 256)),
                          np.asarray(jpacked))


def test_dirty_indices_and_fingerprint_match_reference():
    h1 = np.zeros((10, 2), np.uint32)
    h2 = h1.copy()
    h2[3, 0] = 1
    h2[7, 1] = 9
    assert ops.dirty_indices(h2, h1).tolist() == [3, 7]
    assert ops.dirty_indices(h2, None).tolist() == list(range(10))
    assert np.array_equal(ops.dirty_indices(h2, h1),
                          jops.dirty_indices(h2, h1))
    assert ops.digest_fingerprint(h2) == jops.digest_fingerprint(h2)


def test_cpu_tensors_take_the_plain_version_without_launching():
    ops.reset_launch_counts()
    x = torch.arange(5000, dtype=torch.float32)
    ops.blockhash(x, 256)
    idx = np.array([1, 2], np.int32)
    rows = ops.pack_dirty_many([x], [idx], 256)
    ops.unpack_dirty_many([x.clone()], [idx], [rows], 256)
    qkv = x[:4096].reshape(2, 32, 64)
    ops.flash_attention(qkv, qkv, qkv)
    assert ops.launch_counts() == {"blockhash2": 0, "diffpack": 0,
                                   "diffunpack": 0, "flashattn": 0}
    # the kernel wrappers themselves refuse CPU tensors: no silent path
    with pytest.raises(ValueError, match="CUDA tensor"):
        bh.blockhash2(x, 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp.diffpack_many([x], [np.zeros(1, np.int32)], 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp.diffunpack_many([x], [idx], rows, 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(qkv, qkv, qkv)
    with pytest.raises(IndexError, match="outside"):
        ops.pack_dirty_many([x], [np.array([0, 79], np.int32)], 256)
    with pytest.raises(ValueError, match="no checkpoint kernel"):
        ops.blockhash(x.to("meta"), 256)


def test_kernel_build_names_track_source_and_flags(monkeypatch):
    """A changed source or flag set never reuses a stale library."""
    a = build.library_path("blockhash2")
    assert a.parent == build.BUILD_DIR and a.name.startswith("libblockhash2-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.library_path("blockhash2") != a
    assert "arch=compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)


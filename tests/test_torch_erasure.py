"""The torch mirror of tests/test_erasure.py, on the port.

Erasure coding properties: XOR (1 loss) and Reed–Solomon (≤m losses)."""
import itertools

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # container without hypothesis: tiny shim
    from _hypothesis_fallback import given, settings, st

from repro_torch.redundancy import erasure
from repro_torch.redundancy.groups import Topology


def _payloads(rng, k):
    return [rng.bytes(rng.randint(1, 200)) for _ in range(k)]


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), k=st.integers(2, 6),
       lost=st.integers(0, 5))
def test_xor_single_loss(seed, k, lost):
    rng = np.random.RandomState(seed)
    payloads = _payloads(rng, k)
    lens = [len(p) for p in payloads]
    parity = erasure.encode_xor(payloads)
    lost = lost % k
    surv = {i: payloads[i] for i in range(k) if i != lost}
    rec = erasure.decode_xor(surv, parity, k, lens)
    assert all(rec[i] == payloads[i] for i in range(k))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), k=st.integers(2, 6), m=st.integers(1, 3))
def test_rs_all_loss_patterns(seed, k, m):
    rng = np.random.RandomState(seed)
    payloads = _payloads(rng, k)
    lens = [len(p) for p in payloads]
    pars = erasure.encode_rs(payloads, m)
    for lost in itertools.combinations(range(k), min(m, k)):
        surv = {i: payloads[i] for i in range(k) if i not in lost}
        rec = erasure.decode_rs(surv, dict(enumerate(pars)), k, lens)
        assert all(rec[i] == payloads[i] for i in range(k)), lost


def test_rs_insufficient_survivors():
    rng = np.random.RandomState(0)
    payloads = _payloads(rng, 4)
    pars = erasure.encode_rs(payloads, 1)
    with pytest.raises(ValueError):
        erasure.decode_rs({0: payloads[0]}, {0: pars[0]}, 4,
                          [len(p) for p in payloads])


def test_topology_partners_distinct_nodes():
    topo = Topology(world=8, ranks_per_node=2, group_size=4)
    for r in range(8):
        p = topo.partner_of(r)
        assert p != r
        assert topo.node_of(p) != topo.node_of(r)


def test_topology_groups():
    topo = Topology(world=10, group_size=4)
    assert topo.erasure_group(0) == [0, 1, 2, 3]
    assert topo.erasure_group(9) == [8, 9]
    custom = Topology(world=4, group_size=2,
                      custom_groups={"erasure": [[0, 3], [1, 2]]})
    assert custom.erasure_group(3) == [0, 3]

"""Erasure coding for L3 checkpoints: XOR parity and GF(2^8) Reed–Solomon.

FTI's L3 applies Reed–Solomon across a node group so any m node losses are
recoverable from the surviving payloads + parity. We implement:

- ``xor``: single parity block (RAID-5-like) — tolerates 1 loss per group;
- ``rs``: systematic Reed–Solomon over GF(256) with a Vandermonde-derived
  encoding matrix — tolerates up to ``m`` losses per group.

Payloads are byte strings of (possibly) different lengths; they are
zero-padded to the group max internally and lengths recorded by the caller.
numpy table-driven GF math: fast enough for checkpoint-sized payloads.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# ---------------------------------------------------------------------- #
# GF(256) tables (AES polynomial 0x11d, generator 2)
# ---------------------------------------------------------------------- #

_EXP = np.zeros(512, np.uint8)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def gf_mul(a: np.ndarray, b: int) -> np.ndarray:
    """Multiply byte array by scalar in GF(256)."""
    if b == 0:
        return np.zeros_like(a)
    if b == 1:
        return a.copy()
    lb = int(_LOG[b])
    out = np.zeros_like(a)
    nz = a != 0
    out[nz] = _EXP[_LOG[a[nz]] + lb]
    return out


def _gf_mul_scalar(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[int(_LOG[a]) + int(_LOG[b])])


def _gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError
    return int(_EXP[255 - int(_LOG[a])])


def _gf_matinv(m: np.ndarray) -> np.ndarray:
    """Invert a small GF(256) matrix (Gauss-Jordan)."""
    n = m.shape[0]
    a = m.astype(np.int32).copy()
    inv = np.eye(n, dtype=np.int32)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if a[r, col] != 0:
                piv = r
                break
        if piv is None:
            raise np.linalg.LinAlgError("singular GF matrix")
        a[[col, piv]] = a[[piv, col]]
        inv[[col, piv]] = inv[[piv, col]]
        s = _gf_inv(int(a[col, col]))
        for c in range(n):
            a[col, c] = _gf_mul_scalar(int(a[col, c]), s)
            inv[col, c] = _gf_mul_scalar(int(inv[col, c]), s)
        for r in range(n):
            if r != col and a[r, col] != 0:
                f = int(a[r, col])
                for c in range(n):
                    a[r, c] ^= _gf_mul_scalar(f, int(a[col, c]))
                    inv[r, c] ^= _gf_mul_scalar(f, int(inv[col, c]))
    return inv.astype(np.uint8)


def _vandermonde(m: int, k: int) -> np.ndarray:
    """m×k encoding rows: row i = [alpha^(i·j)] — any k rows of [I; V] are
    independent (classic systematic RS construction)."""
    v = np.zeros((m, k), np.uint8)
    for i in range(m):
        for j in range(k):
            v[i, j] = _EXP[(i + 1) * j % 255]
    return v


def _pad_stack(payloads: Sequence[bytes]) -> np.ndarray:
    n = max(len(p) for p in payloads)
    out = np.zeros((len(payloads), n), np.uint8)
    for i, p in enumerate(payloads):
        out[i, : len(p)] = np.frombuffer(p, np.uint8)
    return out


# ---------------------------------------------------------------------- #
# public API
# ---------------------------------------------------------------------- #


def encode_xor(payloads: Sequence[bytes]) -> bytes:
    """Single XOR parity over the group."""
    stack = _pad_stack(payloads)
    return np.bitwise_xor.reduce(stack, axis=0).tobytes()


def decode_xor(payloads: Dict[int, bytes], parity: bytes, k: int,
               lengths: Sequence[int]) -> List[bytes]:
    """Recover the (single) missing payload from k-1 survivors + parity."""
    missing = [i for i in range(k) if i not in payloads]
    if len(missing) > 1:
        raise ValueError(f"xor parity recovers 1 loss, got {len(missing)}")
    if not missing:
        return [payloads[i][: lengths[i]] for i in range(k)]
    n = len(parity)
    acc = np.frombuffer(parity, np.uint8).copy()
    for i, p in payloads.items():
        buf = np.zeros(n, np.uint8)
        buf[: len(p)] = np.frombuffer(p, np.uint8)
        acc ^= buf
    out = []
    for i in range(k):
        if i in payloads:
            out.append(payloads[i][: lengths[i]])
        else:
            out.append(acc.tobytes()[: lengths[i]])
    return out


def encode_rs(payloads: Sequence[bytes], m: int) -> List[bytes]:
    """m parity blocks over k payloads; tolerates any ≤m losses."""
    k = len(payloads)
    data = _pad_stack(payloads)                       # (k, n)
    v = _vandermonde(m, k)
    out = []
    for i in range(m):
        acc = np.zeros(data.shape[1], np.uint8)
        for j in range(k):
            acc ^= gf_mul(data[j], int(v[i, j]))
        out.append(acc.tobytes())
    return out


def decode_rs(payloads: Dict[int, bytes], parities: Dict[int, bytes], k: int,
              lengths: Sequence[int]) -> List[bytes]:
    """Recover all k payloads from any k of (payloads ∪ parities)."""
    missing = [i for i in range(k) if i not in payloads]
    if not missing:
        return [payloads[i][: lengths[i]] for i in range(k)]
    if len(payloads) + len(parities) < k:
        raise ValueError("not enough survivors for RS decode")
    n = max(
        [len(p) for p in payloads.values()] + [len(p) for p in parities.values()])
    m_all = max(parities) + 1 if parities else 0
    v = _vandermonde(m_all, k) if m_all else np.zeros((0, k), np.uint8)

    rows, rhs = [], []
    for i in sorted(payloads):
        r = np.zeros(k, np.uint8)
        r[i] = 1
        rows.append(r)
        buf = np.zeros(n, np.uint8)
        b = payloads[i]
        buf[: len(b)] = np.frombuffer(b, np.uint8)
        rhs.append(buf)
    for i in sorted(parities):
        rows.append(v[i])
        buf = np.zeros(n, np.uint8)
        b = parities[i]
        buf[: len(b)] = np.frombuffer(b, np.uint8)
        rhs.append(buf)
    # pick k independent equations (identity rows first; try parity subsets
    # if a Vandermonde subset happens to be dependent with the survivors)
    import itertools

    base = list(range(len(payloads)))
    extra = list(range(len(payloads), len(rows)))
    need = k - len(base)
    ainv = None
    chosen = None
    for combo in itertools.combinations(extra, need):
        idx = base + list(combo)
        try:
            ainv = _gf_matinv(np.stack([rows[i] for i in idx]))
            chosen = idx
            break
        except np.linalg.LinAlgError:
            continue
    if ainv is None:
        raise np.linalg.LinAlgError("no independent equation subset")
    b = np.stack([rhs[i] for i in chosen])
    data = np.zeros((k, n), np.uint8)
    for i in range(k):
        acc = np.zeros(n, np.uint8)
        for j in range(k):
            acc ^= gf_mul(b[j], int(ainv[i, j]))
        data[i] = acc
    return [data[i, : lengths[i]].tobytes() for i in range(k)]

"""Content-defined chunking (CDC) — gear-style rolling-hash boundaries.

Fixed-size chunking keys every chunk to its absolute file offset: insert
one byte and every boundary after it shifts, so the whole container tail
re-uploads.  CDC cuts where the *content* says to cut — a short window
hash over the trailing bytes, boundary wherever its low bits are zero —
so boundaries re-synchronize within one chunk of an insertion and
unchanged data keeps producing the same chunks at new offsets.

The chunker is incremental (:class:`Chunker` — ``push`` bytes as a
writer produces them, completed chunks come back immediately) because
the store path fuses chunking into Pack: CHK5 writers tee every write
into a :class:`~repro_torch.objstore.chunks.ChunkStream`, which uploads chunks
the moment a boundary lands.  Determinism contract: the cut sequence
depends only on the byte sequence (plus any explicit :meth:`flush`
positions), never on push granularity — tested against single-shot
splits in tests/test_cdc.py.

Boundary rule, for cut position ``c`` (1-based byte count):

    hash(bytes[c-4:c]) & mask == 0,   min_bytes <= c <= max_bytes

with ``mask`` carrying ``log2(avg_bytes)`` low bits, so boundaries land
every ``avg_bytes`` on average.  No candidate by ``max_bytes`` forces a
cut there; degenerate data (e.g. all zeros hashes to 0 everywhere) cuts
at ``min_bytes`` each time — uniform chunks that dedup to one stored
object.  The scan is vectorized numpy with an argmax-stepping search
(never materializing the full candidate index set — all-zero regions
have a candidate at every byte).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

#: defaults match the old fixed chunk size on average (1 MiB) while
#: bounding the variance a pathological byte stream could produce
DEFAULT_MIN_BYTES = 256 << 10
DEFAULT_AVG_BYTES = 1 << 20
DEFAULT_MAX_BYTES = 4 << 20

_WINDOW = 4                      # boundary hash window (bytes)


@dataclass(frozen=True)
class CDCParams:
    """min/avg/max chunk-size bounds; ``avg`` sets the boundary mask."""
    min_bytes: int = DEFAULT_MIN_BYTES
    avg_bytes: int = DEFAULT_AVG_BYTES
    max_bytes: int = DEFAULT_MAX_BYTES

    def __post_init__(self):
        if self.min_bytes < _WINDOW:
            raise ValueError(f"min_bytes {self.min_bytes} < window {_WINDOW}")
        if not (self.min_bytes <= self.avg_bytes <= self.max_bytes):
            raise ValueError(
                f"need min <= avg <= max, got {self.min_bytes}/"
                f"{self.avg_bytes}/{self.max_bytes}")

    @property
    def mask(self) -> int:
        """Low-bit mask sized so candidates land every ~avg_bytes."""
        bits = max(1, int(self.avg_bytes).bit_length() - 1)
        return (1 << bits) - 1


def _window_hashes(buf: np.ndarray) -> np.ndarray:
    """uint8 buffer → uint32 hash per 4-byte window (entry ``i`` hashes
    ``buf[i:i+4]``).  A little-endian word load plus an avalanche mix —
    position-independent, which is what makes boundaries re-synchronize
    after an insertion."""
    b = buf.astype(np.uint32)
    w = b[:-3] | (b[1:-2] << np.uint32(8)) | (b[2:-1] << np.uint32(16)) \
        | (b[3:] << np.uint32(24))
    with np.errstate(over="ignore"):
        h = w * np.uint32(0x9E3779B1)
        h ^= h >> np.uint32(15)
        h = h * np.uint32(0x85EBCA77)
        h ^= h >> np.uint32(13)
    return h


class Chunker:
    """Incremental CDC splitter: ``push`` returns completed chunks,
    ``flush`` force-cuts the pending bytes (region boundaries — dataset
    edges the caller wants layout-aligned), ``finish`` emits the final
    partial chunk.  ``_scanned`` tracks the no-boundary prefix of the
    pending buffer so repeated small pushes never re-hash bytes."""

    def __init__(self, params: CDCParams):
        self.params = params
        self._buf = bytearray()
        self._scanned = 0        # cut positions < this were checked: no hit

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def push(self, data) -> List[bytes]:
        if not len(data):
            return []
        self._buf += data
        return self._drain(final=False)

    def flush(self) -> List[bytes]:
        """Force a cut at the current position (CDC cuts still apply
        inside the flushed span).  The resulting layout for the span is
        self-contained — it depends only on the span's own bytes."""
        return self._drain(final=True)

    def finish(self) -> List[bytes]:
        return self._drain(final=True)

    # ------------------------------------------------------------------ #

    def _drain(self, final: bool) -> List[bytes]:
        out: List[bytes] = []
        while True:
            cut = self._find_cut(final)
            if cut is None:
                break
            out.append(bytes(self._buf[:cut]))
            del self._buf[:cut]
            self._scanned = 0
        return out

    def _find_cut(self, final: bool) -> Optional[int]:
        p = self.params
        n = len(self._buf)
        if n == 0 or (n < p.min_bytes and not final):
            return None
        hi = min(n, p.max_bytes)          # candidate cuts in [min, hi]
        lo = max(p.min_bytes, self._scanned, _WINDOW)
        if hi >= lo:
            view = np.frombuffer(self._buf, np.uint8,
                                 count=hi - (lo - _WINDOW),
                                 offset=lo - _WINDOW)
            h = _window_hashes(view)      # h[j] → cut at lo + j
            hit = (h & np.uint32(p.mask)) == 0
            j = int(np.argmax(hit))       # no index-set materialization
            if hit[j]:
                return lo + j
            self._scanned = hi + 1
        if n >= p.max_bytes:
            return p.max_bytes            # no boundary: force the max cut
        return n if final else None       # final partial chunk


def split(data, params: CDCParams) -> List[bytes]:
    """One-shot split (tests, file-based uploads): the same cuts an
    incremental :class:`Chunker` produces for the same bytes."""
    c = Chunker(params)
    out = c.push(data)
    out += c.finish()
    return out

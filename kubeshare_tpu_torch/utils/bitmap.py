"""Bitmaps for port allocation.

The port's copy of ``kubeshare_tpu/utils/bitmap.py``.

Re-design of ``pkg/lib/bitmap`` (``bitmap.go:1-51`` — fixed 64-bit words;
``rrbitmap.go:1-56`` — round-robin find-next-and-set). Used by the scheduler
to hand out pod-manager ports (512 ports from 50050 per node,
``pkg/scheduler/node.go:11-15``). Python ints are arbitrary-precision so a
single int is the natural word.
"""

from __future__ import annotations

import threading


class Bitmap:
    """Fixed-size bitmap with mask/unmask/test."""

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError(f"bitmap size must be positive, got {size}")
        self._size = size
        self._bits = 0
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return self._size

    def _check(self, pos: int) -> None:
        if not 0 <= pos < self._size:
            raise IndexError(f"bit {pos} out of range [0, {self._size})")

    def mask(self, pos: int) -> None:
        self._check(pos)
        with self._lock:
            self._bits |= 1 << pos

    def unmask(self, pos: int) -> None:
        self._check(pos)
        with self._lock:
            self._bits &= ~(1 << pos)

    def is_masked(self, pos: int) -> bool:
        self._check(pos)
        with self._lock:
            return bool(self._bits >> pos & 1)

    def count(self) -> int:
        with self._lock:
            return self._bits.bit_count()


class RRBitmap(Bitmap):
    """Round-robin bitmap: allocation resumes after the last grant.

    ``FindNextFromCurrentAndSet`` parity (``rrbitmap.go:24-49``): scan from
    the cursor, wrap once, return -1 when full.
    """

    def __init__(self, size: int):
        super().__init__(size)
        self._cursor = 0

    def find_next_and_set(self) -> int:
        with self._lock:
            for off in range(self._size):
                pos = (self._cursor + off) % self._size
                if not self._bits >> pos & 1:
                    self._bits |= 1 << pos
                    self._cursor = (pos + 1) % self._size
                    return pos
            return -1

"""Streaming order statistics shared across the engine.

One dual-heap tracker serves three consumers: the scheduler's straggler
cutoffs (median × factor, or a direct ``straggler_quantile`` such as
p90), the lane pool's adaptive batch controller (median + p90 of
per-frame durations), and the results layer's per-group medians.  All of
them need an O(log n)-insert running quantile over an unbounded sample
stream without retaining a sorted list.

This lives in its own module because ``scheduler`` imports ``executors``
— a tracker defined in either would leave the other unable to import it.
"""
from __future__ import annotations

import heapq

__all__ = ["StreamingQuantile", "StreamingMedian"]


class StreamingQuantile:
    """Running q-quantile over a stream via two heaps.

    ``quantile()`` returns ``sorted(samples)[int(q * n)]`` (clamped to
    the last element) — the same upper-median convention the scheduler
    has always used for q=0.5.  The lower heap (a max-heap of negated
    values) holds the ``int(q*n)`` smallest samples; the upper heap's
    root is the answer.
    """

    __slots__ = ("q", "_lo", "_hi")

    def __init__(self, q: float = 0.5) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q!r}")
        self.q = q
        self._lo: list[float] = []      # max-heap (negated): smallest q·n
        self._hi: list[float] = []      # min-heap: the rest; root = answer

    def add(self, x: float) -> None:
        if self._lo and x <= -self._lo[0]:
            heapq.heappush(self._lo, -x)
        else:
            heapq.heappush(self._hi, x)
        n = len(self._lo) + len(self._hi)
        target = min(int(self.q * n), n - 1)
        while len(self._lo) > target:
            heapq.heappush(self._hi, -heapq.heappop(self._lo))
        while len(self._lo) < target:
            heapq.heappush(self._lo, -heapq.heappop(self._hi))

    def quantile(self) -> float:
        if not self._hi:
            raise ValueError("no samples")
        return self._hi[0]

    def __len__(self) -> int:
        return len(self._lo) + len(self._hi)


class StreamingMedian(StreamingQuantile):
    """Backward-compatible running (upper) median."""

    __slots__ = ()

    def __init__(self) -> None:
        super().__init__(0.5)

    def median(self) -> float:
        return self.quantile()

"""Streaming sketches for drift and quality monitoring (the start of a port
of the JAX package's ``obs/drift.py``): :class:`P2Quantile`, which the
uncertainty scorer's per-tenant quantiles use. The drift monitor itself,
its histograms and its reference profiles are not ported yet
(``ROADMAP.md``, queue 1, item 5).
"""

import math
from typing import List, Optional


class P2Quantile:
    """P² single-quantile estimator (Jain & Chlamtac 1985): five markers,
    no buffering past the first five samples, exact below five
    observations. Not mergeable."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.n = 0
        self._heights: List[float] = []
        self._pos: List[float] = []
        self._want: List[float] = []
        self._inc = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def add(self, x: float):
        x = float(x)
        self.n += 1
        if self.n <= 5:
            self._heights.append(x)
            self._heights.sort()
            if self.n == 5:
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
            return
        h, pos = self._heights, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._inc[i]
        for i in (1, 2, 3):  # move the interior markers toward their places
            d = self._want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                    d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                s = 1.0 if d >= 1.0 else -1.0
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # the parabola overshot: linear
                    j = i + int(s)
                    h[i] = h[i] + s * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        )

    def value(self) -> Optional[float]:
        if self.n == 0:
            return None
        if self.n <= 5:  # exact: nearest rank over the sorted buffer
            idx = min(int(math.ceil(self.q * self.n)) - 1, self.n - 1)
            return self._heights[max(idx, 0)]
        return self._heights[2]

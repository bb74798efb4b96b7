"""Flush-friendly block progress bar (counterpart of
``nuzero_tpu/utils/printbar.py``; ref ``Utils/Progress_Bars/PrintBar.py``).

A fixed-width block bar suited to batch-job logs: no carriage returns, one
line each time a new block fills.  ``PrintBar(title, total, width)``, then
``.next()`` per unit and ``.finish()``.  The training pipeline's early fill
reports through it.
"""

from __future__ import annotations

import sys


class PrintBar:
    def __init__(self, title: str, total: int, width: int = 20, stream=None):
        self.title = title
        self.total = max(int(total), 1)
        self.width = width
        self.count = 0
        self._drawn = -1
        self.stream = stream if stream is not None else sys.stdout
        self._draw()

    def _draw(self) -> None:
        filled = self.width * self.count // self.total
        if filled == self._drawn and self.count not in (0, self.total):
            return  # only print when a new block fills (log-friendly)
        self._drawn = filled
        bar = "█" * filled + "·" * (self.width - filled)
        pct = 100 * self.count // self.total
        self.stream.write(f"{self.title} |{bar}| {pct:3d}%\n")
        self.stream.flush()

    def next(self, n: int = 1) -> None:
        self.count = min(self.count + n, self.total)
        self._draw()

    def finish(self) -> None:
        self.count = self.total
        self._draw()

"""Progress reporting with ETA
(port of acceleratedvolrenderer_tpu/utils/progress.py: ProgressReporter).

pbrt's ProgressReporter (src/pbrt/util/progressreporter.h:46): a console
bar with the elapsed time and the estimate of what remains, redrawn at
most every 0.25 s.  It writes the reference's characters.
"""
from __future__ import annotations

import sys
import time


class ProgressReporter:
    def __init__(self, total: int, title: str = "Rendering", quiet: bool = False,
                 stream=None):
        self.total = max(int(total), 1)
        self.title = title
        self.quiet = quiet
        self.stream = stream or sys.stderr
        self.done = 0
        self.t0 = time.time()
        self._last_print = 0.0

    def update(self, n: int = 1):
        """Count n more units of work; redraw the bar unless the last draw
        was under 0.25 s ago and the work is not complete."""
        self.done += n
        now = time.time()
        if self.quiet or (now - self._last_print < 0.25
                          and self.done < self.total):
            return
        self._last_print = now
        frac = self.done / self.total
        elapsed = now - self.t0
        eta = elapsed / frac * (1 - frac) if frac > 0 else 0.0
        width = 28
        filled = int(width * frac)
        bar = "+" * filled + "-" * (width - filled)
        self.stream.write(
            f"\r{self.title}: [{bar}] {100 * frac:5.1f}%  "
            f"({elapsed:.1f}s|{eta:.1f}s)")
        self.stream.flush()

    def finish(self):
        self.done = self.total
        if not self.quiet:
            elapsed = time.time() - self.t0
            self.stream.write(
                f"\r{self.title}: done in {elapsed:.1f}s" + " " * 30 + "\n")
            self.stream.flush()

    @property
    def elapsed(self):
        return time.time() - self.t0

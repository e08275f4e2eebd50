"""Render statistics: counters, distributions, reporting, and the
utilization logger (port of acceleratedvolrenderer_tpu/utils/stats.py,
numpy only).

Counters and distributions are accumulated on the host from numpy arrays;
per-pixel counters are (H, W) planes written as EXR (`--pixelstats`).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np


class StatsAccumulator:
    """Host-side registry; device code returns per-wave dicts of scalars or
    (H, W) planes which are accumulated here."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.distributions: Dict[str, list] = defaultdict(list)
        self.pixel_planes: Dict[str, np.ndarray] = {}
        self.ratios: Dict[str, list] = defaultdict(lambda: [0, 0])

    def count(self, name: str, n):
        self.counters[name] += int(n)

    def percent(self, name: str, num, denom):
        r = self.ratios[name]
        r[0] += int(num)
        r[1] += int(denom)

    def distribution(self, name: str, values):
        self.distributions[name].append(np.asarray(values))

    def pixel_counter(self, name: str, plane):
        plane = np.asarray(plane)
        if name in self.pixel_planes:
            self.pixel_planes[name] = self.pixel_planes[name] + plane
        else:
            self.pixel_planes[name] = plane.copy()

    def report(self) -> str:
        """Formatted like pbrt's --stats output (category/name columns)."""
        lines = ["Statistics:"]
        by_cat = defaultdict(list)
        for name, v in sorted(self.counters.items()):
            cat, _, label = name.partition("/")
            by_cat[cat].append(f"    {label:<42} {v:>16,d}")
        for name, (num, den) in sorted(self.ratios.items()):
            cat, _, label = name.partition("/")
            pct = 100.0 * num / den if den else 0.0
            by_cat[cat].append(
                f"    {label:<42} {num:>12,d} / {den:,d} ({pct:.2f}%)")
        for name, chunks in sorted(self.distributions.items()):
            cat, _, label = name.partition("/")
            v = np.concatenate([c.reshape(-1) for c in chunks])
            by_cat[cat].append(
                f"    {label:<42} avg {v.mean():.3f} "
                f"(min {v.min():.3g}, max {v.max():.3g})")
        for cat in sorted(by_cat):
            lines.append(f"  {cat}")
            lines.extend(by_cat[cat])
        return "\n".join(lines)

    def write_pixel_stats(self, prefix: str):
        from . import image

        for name, plane in self.pixel_planes.items():
            safe = name.replace("/", "_").replace(" ", "_")
            image.write_exr(f"{prefix}_{safe}.exr",
                            plane.astype(np.float32), channel_names=("Y",))


GLOBAL_STATS = StatsAccumulator()


class UtilizationLogger:
    """Periodic CPU / memory sampling (--log-utilization, options.h:52).

    The reference samples process CPU time and peak RSS on a logging thread
    (util/log.cpp's utilization reporter); here a daemon thread reads
    /proc/self/stat + /proc/stat once a second and emits
    `utilization: cpu XX% mem YYYY MB` lines to the given stream (or
    collects them for report())."""

    def __init__(self, interval: float = 1.0, stream=None):
        import threading

        self.interval = interval
        self.stream = stream
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _read():
        with open("/proc/self/stat") as f:
            parts = f.read().split()
        utime, stime = int(parts[13]), int(parts[14])
        rss_pages = int(parts[23])
        with open("/proc/stat") as f:
            cpu = f.readline().split()[1:]
        total = sum(int(x) for x in cpu)
        import os as _os

        page = _os.sysconf("SC_PAGE_SIZE")
        return utime + stime, total, rss_pages * page

    def _run(self):
        import os as _os

        ncpu = _os.cpu_count() or 1
        prev_proc, prev_total, _ = self._read()
        while not self._stop.wait(self.interval):
            proc, total, rss = self._read()
            dt_total = max(total - prev_total, 1)
            cpu_pct = 100.0 * (proc - prev_proc) / dt_total * ncpu
            prev_proc, prev_total = proc, total
            sample = (cpu_pct, rss / 1e6)
            self.samples.append(sample)
            if self.stream is not None:
                print(f"utilization: cpu {cpu_pct:5.1f}%  "
                      f"mem {rss / 1e6:8.1f} MB", file=self.stream, flush=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def report(self) -> str:
        if not self.samples:
            return "utilization: no samples"
        cpu = [s[0] for s in self.samples]
        mem = [s[1] for s in self.samples]
        return (f"utilization: cpu avg {sum(cpu) / len(cpu):.1f}% "
                f"peak {max(cpu):.1f}%; mem peak {max(mem):.1f} MB "
                f"({len(self.samples)} samples)")

"""Goodput accounting: productive step time ÷ accountable wall clock (the
port's copy of ``runbooks_tpu.obs.goodput``).

"Goodput" per the TPU-scale training literature (arXiv:2011.03641,
arXiv:1909.09756): the fraction of wall-clock the job spends computing
steps that advance training, as opposed to waiting on input, writing
checkpoints, or paying restart overhead. The trainer feeds one tracker per
run; the ratio and its component breakdown land in ``metrics.json``, the
per-log-step JSON line, and the process registry.

Restart-awareness (the PR-4 resume path): restore and recompile time after
a preemption are *excluded* from the accountable window — they are
restart overhead, reported separately (``restore_s``/``compile_s``), so a
fault-injected resume reports the same steady-state goodput as an
uninterrupted run instead of a ratio silently dragged down by however long
the restore happened to take. Fleet-level "goodput including restarts" is
recoverable from the same snapshot: ``productive_s / wall_s``.
"""

from __future__ import annotations

import time
from typing import Dict


class GoodputTracker:
    """Accumulates per-step phase timings; all methods are cheap (float
    adds), safe to call once per training step."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.productive_s = 0.0     # step compute (dispatch + device sync)
        self.data_wait_s = 0.0      # blocked on the input pipeline
        self.ckpt_s = 0.0           # blocking checkpoint time
        self.excluded_s = 0.0       # restart overhead (restore + compile)
        self.excluded: Dict[str, float] = {}
        self.steps = 0

    def exclude(self, seconds: float, kind: str) -> None:
        """Remove restart overhead (``restore``, ``compile``) from the
        accountable window; tracked per kind for the breakdown."""
        if seconds and seconds > 0:
            self.excluded_s += seconds
            self.excluded[kind] = self.excluded.get(kind, 0.0) + seconds

    def step(self, step_s: float, data_wait_s: float = 0.0,
             ckpt_s: float = 0.0) -> None:
        self.productive_s += max(step_s, 0.0)
        self.data_wait_s += max(data_wait_s, 0.0)
        self.ckpt_s += max(ckpt_s, 0.0)
        self.steps += 1

    def wall_s(self) -> float:
        return time.perf_counter() - self._t0

    def ratio(self) -> float:
        """Productive fraction of the accountable window (wall minus
        restart overhead). Clamped to [0, 1]: phase timings measured
        around adjacent host calls can overlap the window edges by
        microseconds."""
        accountable = self.wall_s() - self.excluded_s
        if accountable <= 0:
            return 0.0
        return min(self.productive_s / accountable, 1.0)

    def snapshot(self) -> Dict[str, float]:
        """The breakdown written to metrics.json: every accounted bucket
        plus the raw wall clock, so both goodput definitions (steady-state
        and including restarts) are recomputable downstream."""
        wall = self.wall_s()
        return {
            "goodput": round(self.ratio(), 4),
            "productive_s": round(self.productive_s, 3),
            "data_wait_s": round(self.data_wait_s, 3),
            "ckpt_s": round(self.ckpt_s, 3),
            "restore_s": round(self.excluded.get("restore", 0.0), 3),
            "compile_s": round(self.excluded.get("compile", 0.0), 3),
            "wall_s": round(wall, 3),
            "steps": self.steps,
        }

"""Tracing and throughput (counterpart of carle_tpu/utils/profiling.py).

* :func:`trace`: a context manager over ``torch.profiler.profile`` that
  records the host's activity, and the card's kernels where it is present,
  and writes a Chrome trace (``trace.json``) that TensorBoard or Perfetto
  opens into ``log_dir``;
* :class:`Throughput`: the reference trainer's steps/s counter as an
  object, with cell updates/s derived.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "./logs/trace") -> Iterator[torch.profiler.profile]:
    """Profile a block: ``with trace("logs/t"): run(...)``, then open
    ``logs/t/trace.json``.  CUDA activity is recorded where
    ``torch.cuda.is_available()``; the card is synchronised before the
    trace closes, so the block's kernels are in it.  Yields the profiler
    (``key_averages()`` for a table)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class Throughput:
    """Wall-clock steps/s and cell-updates/s counter."""

    def __init__(self, instances: int, cells_per_instance: int = 0) -> None:
        self.instances = instances
        self.cells_per_instance = cells_per_instance
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def add(self, steps: int) -> None:
        self._steps += steps

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_second(self) -> float:
        return self._steps * self.instances / max(self.seconds, 1e-9)

    @property
    def cell_updates_per_second(self) -> float:
        return self.steps_per_second * self.cells_per_instance

    def report(self) -> str:
        msg = f"steps / second = {self.steps_per_second:.3f}"
        if self.cells_per_instance:
            msg += f" ({self.cell_updates_per_second:.3e} cell updates/s)"
        return msg


__all__ = ["TRACE_FILE", "Throughput", "trace"]

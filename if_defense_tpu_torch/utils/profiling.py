"""Profiling and tracing helpers (port of `if_defense_tpu/utils/profiling.py`).

(a) `PhaseTimer`, wall time per named phase on the host's
`time.perf_counter`, each phase optionally ended by a wait for the device
that holds a given tensor, and (b) `trace(logdir)`, a `torch.profiler`
trace of the host and the card that TensorBoard's profiler plugin and
Chrome's trace viewer read.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class PhaseTimer:
    """Accumulates wall time per named phase (AverageMeter-style)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_array=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_array is not None:
                self.sync(sync_array)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    @staticmethod
    def sync(array: torch.Tensor) -> None:
        """Wait for the work queued on the tensor's device (nothing to wait
        for on the CPU, where the ops have already run)."""
        if array.is_cuda:
            torch.cuda.synchronize(array.device)

    def summary(self) -> dict:
        return {
            name: {"total_s": self.totals[name],
                   "count": self.counts[name],
                   "mean_s": self.totals[name] / self.counts[name]}
            for name in self.totals
        }


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the host and, where a card is present, the card, and write
    one trace under `logdir` (TensorBoard's profiler plugin reads it, and so
    does Chrome's trace viewer). Yields a dict whose `path` names the file
    once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    out: dict = {}
    with torch.profiler.profile(activities=activities) as prof:
        yield out
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}"
                        ".pt.trace.json")
    prof.export_chrome_trace(path)
    out["path"] = path

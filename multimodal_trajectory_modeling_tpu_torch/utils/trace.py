"""Training observability: per-iteration EM metrics and the profiler hook.

Counterpart of ``multimodal_trajectory_modeling_tpu/utils/trace.py``:
``EMTrace`` (:27) records the host-stepped loop's iterations; ``profile``
(:51), which wraps ``jax.profiler.trace`` there, wraps
``torch.profiler.profile`` here and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from multimodal_trajectory_modeling_tpu_torch.device import resolve_device

__all__ = ["EMTrace", "profile"]


@dataclass
class EMTrace:
    """Per-iteration EM training metrics: the objective Q, the switch
    count and the wall seconds of each iteration."""

    iterations: list = field(default_factory=list)

    def record(self, i: int, objective: float, n_switches: int, dt: float):
        self.iterations.append(
            {
                "iteration": i,
                "objective": objective,
                "n_switches": n_switches,
                "seconds": dt,
            }
        )

    def to_dataframe(self):
        """The records as a ``pandas.DataFrame`` (pandas is imported
        here only, so the package needs it for this method alone)."""
        import pandas as pd

        return pd.DataFrame(self.iterations)

    def __len__(self):
        return len(self.iterations)


@contextlib.contextmanager
def profile(logdir: str | os.PathLike, *, device=None):
    """Profile the enclosed block with ``torch.profiler`` (host activity,
    and CUDA activity when ``device``, default the card, is a card) and
    write its Chrome trace into ``logdir``; yields the profiler, whose
    ``key_averages()`` sum the recorded events.

    Usage::

        with trace.profile("tmp/em-profile"):
            mdl.train(n_steps=10)
    """
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.perf_counter()
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        )
        print(f"profile captured to {logdir} ({time.perf_counter()-t0:.1f}s)")

"""Per-iteration EM metrics of the host-stepped training loop.

Counterpart of ``multimodal_trajectory_modeling_tpu/utils/trace.py``
(``EMTrace`` :27).  Its ``profile`` wraps ``jax.profiler`` and has no
counterpart here: ``torch.profiler.profile`` is the card's tool.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["EMTrace"]


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

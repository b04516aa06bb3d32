"""Checkpoint and resume.

Counterpart of ``multimodal_trajectory_modeling_tpu/utils/checkpoint.py``.
The whole-model gzip-pickle cache lives on the model classes
(``to_pickle``/``from_pickle``); :class:`EMCheckpointer` adds mid-training
step checkpoints of ``(MixtureParams, assignments)`` every ``every`` EM
iterations, so a killed run resumes from the latest step.  The JAX package
stores them with orbax; here each step is one ``.npz`` file with the same
payload (the seven parameter fields and the assignment, as numpy).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.models import em

__all__ = ["EMCheckpointer", "train_em_checkpointed"]

_STEP_FILE = re.compile(r"^step_(\d+)\.npz$")


class EMCheckpointer:
    """Step checkpoints of ``(MixtureParams, assignments)`` in
    ``directory``, one ``step_<step>.npz`` each; the newest
    ``max_to_keep`` are kept."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.npz")

    def all_steps(self) -> list[int]:
        """The stored steps, oldest first."""
        steps = (_STEP_FILE.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in steps if m)

    def save(self, step: int, params: em.MixtureParams, assign) -> None:
        """Write step ``step`` (atomically: a partial file is never read
        as a checkpoint), then drop the oldest beyond ``max_to_keep``."""
        fields = dict(zip(em.MixtureParams._fields, em.mixture_params_to_numpy(params)))
        assign = assign.cpu().numpy() if hasattr(assign, "cpu") else np.asarray(assign)
        tmp = os.path.join(self.directory, f".step_{int(step)}.{os.getpid()}.tmp.npz")
        np.savez(tmp, assign=assign, **fields)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int = None):
        """``(step, MixtureParams of numpy arrays, assign)`` of ``step``
        (default the latest), or None if there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        with np.load(self._path(step)) as f:
            params = em.MixtureParams(*(f[k] for k in em.MixtureParams._fields))
            return step, params, f["assign"]


def train_em_checkpointed(
    params0,
    assign0,
    z,
    x,
    v,
    patterns,
    pattern_id,
    *,
    checkpointer: EMCheckpointer,
    n_steps: int = 1000,
    every: int = 10,
    resume: bool = True,
    **train_kwargs,
):
    """:func:`..models.em.train_em` in chunks of ``every`` iterations, a
    checkpoint after each chunk; resumes from the latest checkpoint when
    there is one.  Returns ``(params, assign, iterations done, status)``.

    Chunking is exact: the M step is a deterministic function of the
    assignment, so restarting a chunk from ``(params, assign)`` reproduces
    the uninterrupted trajectory."""
    start_iter = 0
    params, assign = params0, assign0
    if resume and (state := checkpointer.restore()) is not None:
        start_iter, params_np, assign_np = state
        params = em.mixture_params_from_numpy(params_np, device=z.device, dtype=z.dtype)
        assign = torch.as_tensor(assign_np, device=z.device)

    done = start_iter
    status = em.STATUS_RUNNING
    while done < n_steps:
        chunk = min(every, n_steps - done)
        params, assign, iters, status = em.train_em(
            params, assign, z, x, v, patterns, pattern_id, n_steps=chunk, **train_kwargs
        )
        done += int(iters)
        checkpointer.save(done, params, assign)
        if int(status) != em.STATUS_RUNNING:
            break
    return params, assign, done, int(status)

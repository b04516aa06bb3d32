"""Synthetic scale sweep on the card: dense hard EM over the cluster count
on 1e6 trajectories.

Counterpart of ``drivers/synthetic-scale-sweep.py``: for each C in
(2, 4, 8, 16), :func:`..models.em.train_em` (at most 50 steps) on one
synthetic batch of
``MTM_SWEEP_N`` trajectories (default 1e6; T=10, d=5, l=3, NaN-padded to
the lengths 5, 8 and 10 with shares 0.3/0.3/0.4), then the complete-data
objective under a fresh E step; one JSON line a C and a last line with all.
The JAX driver's ``method="inverse"`` (the log-likelihoods from
precomputed per-pattern inverses) is, on the card, the hand kernel of
that form, K12 (``method="pallas"``: once an E step and once for the
objective), and on the CPU the grouped ``"inverse"`` form itself.

The batch is the JAX driver's in shape and in law, not bit for bit: the
JAX driver draws it with ``bench._make_data`` (one LG-SSM from
``default_rng(0)``: A ~ N(0, 0.4²), H ~ N(0, 1), m ~ N(0, 1); S = I/5,
G = I/2, L = I/3; the trajectories from JAX's PRNG), which imports JAX;
here the same parameters and lengths come from ``default_rng(0)`` in the
same order, and the trajectories from :func:`..ops.samplers.
sample_trajectories` with a seeded ``torch.Generator``.  The starting
parameters and assignments come from ``default_rng(0)`` as in the JAX
driver.  Device as in :mod:`.inference_adni_xval` (the card by default,
float32).

Usage::

    python -m multimodal_trajectory_modeling_tpu_torch.drivers.synthetic_scale_sweep
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.device import resolve_device, resolve_dtype
from multimodal_trajectory_modeling_tpu_torch.drivers import configure_from_env
from multimodal_trajectory_modeling_tpu_torch.models import em
from multimodal_trajectory_modeling_tpu_torch.ops.samplers import sample_trajectories

N = int(os.environ.get("MTM_SWEEP_N", "1000000"))
CLUSTER_GRID = (2, 4, 8, 16)
MAX_STEPS = 50
T, D_H, D_O = 10, 5, 3
LENGTHS = (T // 2, T - 2, T)


def make_data(n, *, device=None, dtype=None, seed=0):
    """``(z, x, v, patterns, pattern_id)`` on ``device``: the sweep's
    batch, NaN-padded to its lengths, with the patterns (one a length)
    built from the lengths."""
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    rng = np.random.default_rng(seed)
    A = rng.normal(scale=0.4, size=(D_H, D_H))
    H = rng.normal(size=(D_H, D_O))
    m = rng.normal(size=D_H)
    lens = rng.choice(LENGTHS, size=n, p=[0.3, 0.3, 0.4])
    pid = np.searchsorted(np.asarray(LENGTHS), lens).astype(np.int32)
    patterns = np.stack(
        [
            np.concatenate([np.repeat(np.arange(T) < ln, D_H), np.repeat(np.arange(T) < ln, D_O)])
            for ln in LENGTHS
        ]
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    z, x = sample_trajectories(
        gen, n, T, m, np.eye(D_H) / 5, A, np.eye(D_H) / 2, H, np.eye(D_O) / 3, device=dev, dtype=dt
    )
    tmask = (torch.arange(T, device=dev)[:, None] < torch.as_tensor(lens, device=dev)[None, :])[:, :, None]
    z = torch.where(tmask, z, torch.nan)
    x = torch.where(tmask, x, torch.nan)
    v = em.pack_joint(z, x)
    return z, x, v, torch.as_tensor(patterns, device=dev), torch.as_tensor(pid, device=dev)


def start(rng, C, n, *, device, dtype):
    """The JAX driver's starting parameters and assignment for C clusters."""
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    params0 = em.MixtureParams(
        pi=as_t(np.ones(C) / C),
        m=as_t(rng.normal(size=(C, D_H))),
        S=as_t(np.stack([np.eye(D_H)] * C)),
        A=as_t(rng.normal(scale=0.3, size=(C, D_H, D_H))),
        G=as_t(np.stack([np.eye(D_H)] * C)),
        H=as_t(rng.normal(size=(C, D_H, D_O))),
        L=as_t(np.stack([np.eye(D_O)] * C)),
    )
    assign0 = torch.as_tensor(rng.integers(0, C, size=n), dtype=torch.int32, device=device)
    return params0, assign0


def run(n=N, *, device=None, report=print):
    """The sweep: one record a cluster count (``n_clusters``, ``iterations``,
    ``status``, ``wall_s``, ``iters_per_sec``, ``complete_data_loglik``)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dev)
    method = "pallas" if dev.type == "cuda" else "inverse"
    z, x, v, patterns, pid = make_data(n, device=dev, dtype=dt)
    rng = np.random.default_rng(0)
    results = []
    for C in CLUSTER_GRID:
        params0, assign0 = start(rng, C, v.shape[0], device=dev, dtype=dt)
        t0 = time.perf_counter()
        params, assign, iters, status = em.train_em(
            params0, assign0, z, x, v, patterns, pid, n_steps=MAX_STEPS, method=method
        )
        q = float(em.complete_data_loglik(params, v, patterns, pid, T=T, method=method))  # host pull = sync
        wall = time.perf_counter() - t0
        results.append(
            {
                "n_clusters": C,
                "iterations": int(iters),
                "status": int(status),
                "wall_s": round(wall, 2),
                "iters_per_sec": round(int(iters) / wall, 3) if wall > 0 else None,
                "complete_data_loglik": q,
            }
        )
        if report is not None:
            report(json.dumps(results[-1]))
    if report is not None:
        report(json.dumps({"sweep": results}))
    return results


def main():
    configure_from_env()
    run(report=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()

"""Trajectory samplers, the synthetic-data fixtures of the framework.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/samplers.py``
(``sample_trajectories`` :26, ``sample_nonlinear_trajectories`` :64):
forward simulation of a linear-Gaussian SSM (and of an arbitrary
nonlinear, non-Gaussian SSM) in whole batches, shapes ``T × n × dim``.

The port draws from a ``torch.Generator`` where the JAX package splits a
``jax.random`` key, so the two packages' draws cannot be equal: the data
follow the reference in shape and law, not bit for bit.  The draws are
taken in a fixed order (documented per function), so a seeded generator
replays them exactly.
"""

from __future__ import annotations

from typing import Callable

import torch

from multimodal_trajectory_modeling_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
)

__all__ = ["sample_trajectories", "sample_nonlinear_trajectories"]


def _chol(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cholesky(torch.atleast_2d(M))


def sample_trajectories(
    generator: torch.Generator,
    n: int,
    T: int,
    m,
    S,
    A,
    G,
    H,
    L,
    *,
    device=None,
    dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n`` trajectories of length ``T`` from the LG-SSM ``z' = z A +
    N(0, G)``, ``x = z H + N(0, L)``, ``z_0 ~ N(m, S)``: returns ``(z, x)``
    of shapes ``(T, n, d)`` and ``(T, n, l)`` on ``device`` (the card
    unless the caller asks for the CPU).

    The standard normals come from ``generator`` (on its own device), in
    this order: the initial states ``(n, d)``, the transition noise
    ``(T-1, n, d)``, the measurement noise ``(T, n, l)``; each is scaled
    by the lower Cholesky factor of its covariance (``eps @ chol.T``)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    m, S, A, G, H, L = (
        torch.as_tensor(a, dtype=dt, device=dev) for a in (m, S, A, G, H, L)
    )
    m = torch.atleast_1d(m)
    S, A, G, H, L = map(torch.atleast_2d, (S, A, G, H, L))
    d, l = A.shape[0], H.shape[1]
    cS, cG, cL = _chol(S), _chol(G), _chol(L)

    def normal(*shape):
        return torch.randn(
            shape, generator=generator, dtype=dt, device=generator.device
        ).to(dev)

    z0 = m + normal(n, d) @ cS.T
    eps_g = normal(T - 1, n, d) @ cG.T
    eps_l = normal(T, n, l) @ cL.T
    z = torch.empty((T, n, d), dtype=dt, device=dev)
    z[0] = z0
    for t in range(1, T):
        z[t] = z[t - 1] @ A + eps_g[t - 1]
    x = z @ H + eps_l
    return z, x


def sample_nonlinear_trajectories(
    generator: torch.Generator,
    n: int,
    dz: int,
    dx: int,
    T: int,
    m: Callable[[torch.Generator, int], torch.Tensor],
    f: Callable[[torch.Tensor], torch.Tensor],
    G: Callable[[torch.Generator, int], torch.Tensor],
    h: Callable[[torch.Tensor], torch.Tensor],
    L: Callable[[torch.Generator, int], torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-simulate an arbitrary (nonlinear, non-Gaussian) SSM:
    ``(z (T, n, dz), x (T, n, dx))``.

    ``m(generator, n)`` samples the initial latent batch; ``f`` and ``h``
    map latent batches; ``G(generator, n)`` and ``L(generator, n)`` sample
    transition and measurement noise batches.  They draw from the one
    ``generator`` in the order ``m, L`` (step 0), then ``G, L`` for each
    later step, as the JAX package spends its ``2T`` keys."""
    z0 = m(generator, n)
    x0 = h(z0) + L(generator, n)
    zs, xs = [z0], [x0]
    for _ in range(T - 1):
        zt = f(zs[-1]) + G(generator, n)
        xt = h(zt) + L(generator, n)
        zs.append(zt)
        xs.append(xt)
    return torch.stack(zs), torch.stack(xs)

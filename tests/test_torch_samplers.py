"""The port's samplers (``ops/samplers.py``) and its ``ops`` exports,
float64 on the CPU.  The port draws from a ``torch.Generator``, so its
draws cannot be the JAX package's: they are held to the reference in law
(the empirical joint moments against JAX ``ops.joint_moments``, within
sampling error) and to an exact numpy replay of the documented draw
order."""

import inspect

import jax.numpy as jnp
import numpy as np
import torch

from multimodal_trajectory_modeling_tpu import ops as jops
from multimodal_trajectory_modeling_tpu_torch import ops as tops
from multimodal_trajectory_modeling_tpu_torch.models import em as tem


def _lgssm(seed, d=2, l=3):
    rng = np.random.default_rng(seed)

    def spd(k):
        M = rng.normal(size=(k, k))
        return M @ M.T / k + 0.5 * np.eye(k)

    return (rng.normal(size=d), spd(d), rng.normal(scale=0.4, size=(d, d)), spd(d),
            rng.normal(size=(d, l)), spd(l))


def test_sample_trajectories_follows_the_reference_law():
    """n = 2·10⁴ draws at T = 4: the empirical mean and covariance of the
    joint vector ``[z_1..z_T, x_1..x_T]`` within five standard errors of
    JAX's ``joint_moments`` for the same parameters."""
    T, n = 4, 20_000
    m, S, A, G, H, L = _lgssm(0)
    z, x = tops.sample_trajectories(torch.Generator().manual_seed(1), n, T, m, S, A, G, H, L, device="cpu")
    assert z.shape == (T, n, 2) and x.shape == (T, n, 3) and z.dtype == torch.float64
    v = tem.pack_joint(z, x).numpy()
    mean, cov = (np.asarray(a) for a in jops.joint_moments(T, *map(jnp.asarray, (m, S, A, G, H, L))))
    var = np.diag(cov)
    assert np.all(np.abs(v.mean(0) - mean) <= 5 * np.sqrt(var / n))
    se = np.sqrt((np.outer(var, var) + cov**2) / n)
    assert np.all(np.abs(np.cov(v.T) - cov) <= 5 * se)


def test_sample_trajectories_replays_its_draws_exactly():
    """A seeded generator's draws (initial states, transition noise,
    measurement noise, in that order) through a numpy recursion give the
    sampler's output to 1e-12."""
    T, n = 5, 300
    m, S, A, G, H, L = _lgssm(2)
    z, x = tops.sample_trajectories(torch.Generator().manual_seed(7), n, T, m, S, A, G, H, L, device="cpu")
    g = torch.Generator().manual_seed(7)
    e0, eg, el = (torch.randn(s, generator=g, dtype=torch.float64).numpy()
                  for s in ((n, 2), (T - 1, n, 2), (T, n, 3)))
    cS, cG, cL = (np.linalg.cholesky(M) for M in (S, G, L))
    zz = np.empty((T, n, 2))
    zz[0] = m + e0 @ cS.T
    for t in range(1, T):
        zz[t] = zz[t - 1] @ A + eg[t - 1] @ cG.T
    np.testing.assert_allclose(z.numpy(), zz, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), zz @ H + el @ cL.T, rtol=1e-12, atol=1e-12)


def test_sample_nonlinear_trajectories_replays_its_draws_exactly():
    """The nonlinear sampler spends one generator in the order m, L, then
    G, L a step; a numpy replay gives its output to 1e-12."""
    T, n, dz, dx = 4, 50, 2, 3
    W = np.random.default_rng(3).normal(size=(dz, dx))

    def noise(scale, k):
        return lambda g, n: scale * torch.randn((n, k), generator=g, dtype=torch.float64)

    z, x = tops.sample_nonlinear_trajectories(
        torch.Generator().manual_seed(4), n, dz, dx, T, noise(2.0, dz), torch.tanh,
        noise(0.3, dz), lambda zt: torch.sin(zt) @ torch.from_numpy(W), noise(0.1, dx),
    )
    g = torch.Generator().manual_seed(4)

    def draw(scale, k):
        return scale * torch.randn((n, k), generator=g, dtype=torch.float64).numpy()

    zs = [draw(2.0, dz)]
    xs = [np.sin(zs[0]) @ W + draw(0.1, dx)]
    for _ in range(T - 1):
        zs.append(np.tanh(zs[-1]) + draw(0.3, dz))
        xs.append(np.sin(zs[-1]) @ W + draw(0.1, dx))
    assert z.shape == (T, n, dz) and x.shape == (T, n, dx)
    np.testing.assert_allclose(z.numpy(), np.stack(zs), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.stack(xs), rtol=1e-12, atol=1e-12)


def test_ops_exports_cover_the_jax_names():
    """Every name the JAX package's ``ops`` exports, the port's ``ops``
    exports too (``__all__``), and each resolves."""
    jax_names = {k for k, v in vars(jops).items() if not k.startswith("_") and not inspect.ismodule(v)}
    assert jax_names and jax_names <= set(tops.__all__)
    assert all(hasattr(tops, k) for k in tops.__all__)

"""The port's Kalman filters against the JAX package, float64 on the CPU:
the masked filter (``kalman_masked_logliks``) and K7's plain version
(``kalman_masked_logliks_packed`` on CPU tensors) against JAX's XLA
filter and its Pallas kernel in interpret mode, on per-coordinate and
interior NaNs, pure suffixes, all-NaN rows (exactly 0.0) and an
expansive transition that overflows the state; the split step against
the combined step; ``kalman_observed_logliks`` and
``kalman_filter_covs``.  Tolerance 1e-10 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu.ops import kalman as jk
from multimodal_trajectory_modeling_tpu.ops.pallas_kalman import (
    kalman_masked_logliks_pallas as jax_pallas,
)
from multimodal_trajectory_modeling_tpu_torch.ops import kalman as tk
from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk

SHAPES = [(1, 3), (2, 3), (5, 3), (3, 2), (1, 1)]


def _params(rng, C, d, l, a_scale=0.3):
    return (
        rng.normal(size=(C, d)),
        np.stack([np.eye(d) * 0.8 + 0.05] * C),
        rng.normal(scale=a_scale, size=(C, d, d)),
        np.stack([np.eye(d) * 0.5] * C),
        rng.normal(size=(C, d, l)),
        np.stack([np.eye(l) * 0.4 + 0.1] * C),
    )


def _data(seed, T, n, d, l, kind):
    """``per-coordinate``: 30% of the entries NaN; ``interior``: whole
    steps missing inside the trajectories; ``suffix``: NaN past a length.
    Rows 0 and 1 have no finite entry."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    if kind == "per-coordinate":
        z[rng.random(z.shape) < 0.3] = np.nan
        x[rng.random(x.shape) < 0.3] = np.nan
    elif kind == "interior":
        gap = rng.random((T, n)) < 0.25
        gap[0] = False
        z[gap] = np.nan
        x[gap] = np.nan
    else:
        past = np.arange(T)[:, None] >= rng.integers(1, T + 1, size=n)[None, :]
        z[past] = np.nan
        x[past] = np.nan
    z[:, :2] = np.nan
    x[:, :2] = np.nan
    return z, x, rng


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("kind", ["per-coordinate", "interior", "suffix"])
@pytest.mark.parametrize("d,l", SHAPES)
def test_masked_logliks_match_jax(d, l, kind):
    z, x, rng = _data(d * 10 + l, 7, 60, d, l, kind)
    args = (z, x, *_params(rng, 3, d, l))
    want = jk.kalman_masked_logliks(*map(jnp.asarray, args))
    got = tk.kalman_masked_logliks(*map(torch.from_numpy, args)).numpy()
    _close(got, want)
    assert (got[:, :2] == 0.0).all()  # no finite entry: exactly 0.0


@pytest.mark.parametrize("d,l", SHAPES)
def test_k7_plain_matches_jax_kernel(d, l):
    """K7's plain version (the wrapper on CPU tensors) against the JAX
    Pallas kernel in interpret mode, n not a multiple of any block."""
    z, x, rng = _data(d + 7 * l, 5, 37, d, l, "per-coordinate")
    args = (z, x, *_params(rng, 2, d, l))
    want = jax_pallas(*map(jnp.asarray, args), interpret=True)
    before = kk.kalman_masked_logliks_packed.launches
    got = kk.kalman_masked_logliks_pallas(*map(torch.from_numpy, args)).numpy()
    assert kk.kalman_masked_logliks_packed.launches == before  # CPU: no kernel
    _close(got, want)
    assert (got[:, :2] == 0.0).all()
    zp, xp = kk.pack_masked_kalman(torch.from_numpy(z), torch.from_numpy(x))
    assert zp.shape == (5, d, 37) and zp.is_contiguous()
    np.testing.assert_array_equal(zp.numpy(), z.transpose(0, 2, 1))


@pytest.mark.parametrize("dtype,A,T,rtol", [("float64", 1e3, 60, 1e-10), ("float32", 30.0, 40, 1e-4)])
def test_expansive_transition_stays_finite(dtype, A, T, rtol):
    """An expansive A over a long unobserved tail overflows P (and mu) to
    inf; the selects keep the observed prefix's log-density finite, and
    equal to JAX's."""
    rng = np.random.default_rng(3)
    n, d, l = 40, 5, 3
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    z[2:], x[2:] = np.nan, np.nan
    z[0, ::3, 1] = np.nan
    eye = lambda k: np.eye(k)[None]  # noqa: E731
    args = [a.astype(dtype) for a in (z, x, np.zeros((1, d)), eye(d), A * eye(d), eye(d),
                                      rng.normal(size=(1, d, l)), eye(l))]
    want = np.asarray(jk.kalman_masked_logliks(*map(jnp.asarray, args)))
    tt = [torch.from_numpy(a) for a in args]
    got = tk.kalman_masked_logliks(*tt).numpy()
    plain = kk.kalman_masked_logliks_pallas(*tt).numpy()
    assert np.isfinite(got).all() and np.isfinite(plain).all() and np.isfinite(want).all()
    _close(got, want, rtol)
    _close(plain, want, rtol)


def _lanes(rng, k, n, mask=False):
    if mask:
        return [torch.from_numpy((rng.random(n) < 0.6).astype(np.float64)) for _ in range(k)]
    return [torch.from_numpy(rng.normal(size=n)) for _ in range(k)]


@pytest.mark.parametrize("d,l", SHAPES)
def test_split_step_matches_combined_and_jax(d, l):
    """One step on 64 lanes with random masks: the split step equals the
    combined step (the same density by the chain rule) and JAX's split
    step."""
    rng = np.random.default_rng(d * 3 + l)
    n = 64
    mu, z_t, x_t = _lanes(rng, d, n), _lanes(rng, d, n), _lanes(rng, l, n)
    oz, ox = _lanes(rng, d, n, mask=True), _lanes(rng, l, n, mask=True)
    B = rng.normal(size=(d, d, n))
    P = [[torch.from_numpy((B[i] * B[j]).sum(0) / d + (i == j)) for j in range(d)] for i in range(d)]
    m, S, A, G, H, L = _params(rng, 1, d, l)
    pl = lambda M: [[float(v) for v in row] for row in M[0]]  # noqa: E731
    Hs, As, Gs, Ls = pl(H), pl(A), pl(G), pl(L)
    split = tk.masked_filter_step_split(mu, P, z_t, x_t, oz, ox, Hs, As, Gs, Ls, d, l)
    comb = tk.masked_filter_step(mu, P, [torch.where(o > 0, v, 0.0) for o, v in zip(oz, z_t)],
                                 [torch.where(o > 0, v, 0.0) for o, v in zip(ox, x_t)],
                                 oz, ox, Hs, As, Gs, Ls, d, l)
    j = lambda ls: [jnp.asarray(v.numpy()) for v in ls]  # noqa: E731
    jsplit = jk.masked_filter_step_split(
        j(mu), [j(row) for row in P], j(z_t), j(x_t), j(oz), j(ox), Hs, As, Gs, Ls, d, l
    )
    for got, ref in ((split, comb), (split, jsplit)):
        _close(got[2].numpy(), np.asarray(ref[2]))
        for i in range(d):
            _close(got[0][i].numpy(), np.asarray(ref[0][i]))
            for k in range(d):
                _close(got[1][i][k].numpy(), np.asarray(ref[1][i][k]))


def test_observed_filter_and_covs_match_jax():
    rng = np.random.default_rng(5)
    T, n, d, l, C = 8, 90, 2, 3, 3
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    x[np.arange(T)[:, None] >= lens[None, :]] = np.nan
    params = _params(rng, C, d, l)
    want = jk.kalman_observed_logliks(jnp.asarray(x), jnp.asarray(lens), *map(jnp.asarray, params))
    got = tk.kalman_observed_logliks(torch.from_numpy(x), torch.from_numpy(lens),
                                     *map(torch.from_numpy, params))
    _close(got.numpy(), want)
    covs_j = jk.kalman_filter_covs(*(jnp.asarray(p[1]) for p in params[1:]), T)
    covs_t = tk.kalman_filter_covs(*(torch.from_numpy(p[1]) for p in params[1:]), T)
    for a, b in zip(covs_t, covs_j):
        _close(a.numpy(), b)


def _issued_operations(d, l):
    """Operations the plain split step issues on one-lane tensors: every
    torch call but the lanes' construction and the integer 0 that Python's
    ``sum`` starts from."""
    issued = [0]

    class _Count(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            starts_sum = getattr(func, "__name__", "") in ("add", "__radd__") and any(
                type(a) is int and a == 0 for a in args
            )
            issued[0] += not starts_sum
            return func(*args, **(kwargs or {}))

    def lane(v):
        return torch.full((1,), float(v), dtype=torch.float64)

    def mat(r, c, diag):
        return [[diag if i == j else 0.1 for j in range(c)] for i in range(r)]

    mu = [lane(0.0) for _ in range(d)]
    P = tk._tri_unpack([lane(1.0 if i == j else 0.1) for i in range(d) for j in range(i + 1)], d)
    args = ([lane(0.5)] * d, [lane(0.5)] * l, [lane(1.0)] * d, [lane(1.0)] * l)
    with _Count():
        tk.masked_filter_step_split(
            mu, P, *args, mat(d, l, 1.0), mat(d, d, 0.9), mat(d, d, 1.0), mat(l, l, 1.0), d, l
        )
    return issued[0]


def test_masked_step_operations():
    """K7's operation count (its bound) is what the step's code issues,
    shape by shape; 1229 at the bench shape."""
    for d, l in SHAPES:
        assert kk.masked_step_operations(d, l) == _issued_operations(d, l), (d, l)
    assert kk.masked_step_operations(5, 3) == 1229

"""The arithmetic of the dense E-step kernels' float32 tensor-core body
(``csrc/estep_mma.cuh``: K8, K12, K13, K14), emulated on the CPU and held
against the float64 plain versions.

The kernel forms each row's residual r in float32, splits r and the
inverse M into TF32 parts (``hi = tf32_rna(x)``, ``lo = tf32_rna(x −
hi)``), accumulates ``Y' = R M'`` per k step of 8 as three products into
one float32 accumulator (lo·hi, hi·lo, then hi·hi), where M' is M over
8×8 blocks doubled above the diagonal blocks and zero below (M is
symmetric, so ``rᵀMr = Σ_j r_j y'_j``), and takes ``q = Σ_j r_j y'_j`` by
float32 FMAs in n-tile order within each of a quad's four lanes (columns
2t and 2t + 1 of every 8), then ``(q0 + q1) + (q2 + q3)``.  The
emulation below follows that order; each mma's eight products are summed
in float64 and rounded once into the float32 accumulator (the card's
internal order within an mma is its own).  ``cvt.rna.tf32.f32`` rounds
the 13 low mantissa bits to nearest, ties away from zero.

Tolerance: ``chip_smoke.py`` phase 20's, 2e-5 of the log-likelihood's
magnitude ``½ aᵀ|M|a + |const|`` with ``a = |v| + |m|`` at the finite
coordinates (plus ``|log π|`` for K8's scores).  Data: unstandardized
(|x| ~ 50) gapped trajectories at D = 80 and D = 512, from a numpy seed.
The same data shows why the split exists: one TF32 product (hi·hi only)
misses that tolerance."""

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.ops import estep_kernels as ek
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops

REL = 2e-5


def tf32_rna(x):
    """float32 → the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, as a float32; Inf and NaN unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _fma32(a, b, c):
    """float32 fused multiply-add: the exact product, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def quad_form_tf32(r, M, *, split=True):
    """q = rᵀMr of each row of r (s, D), float32, in the kernel's order."""
    s, D = r.shape
    Dp = (D + 7) // 8 * 8
    r = torch.nn.functional.pad(r, (0, Dp - D))
    M = torch.nn.functional.pad(M, (0, Dp - D, 0, Dp - D))
    blk = torch.arange(Dp) // 8
    M = M * ((blk[None, :] > blk[:, None]) * 2.0 + (blk[None, :] == blk[:, None])).float()
    rh, mh = tf32_rna(r), tf32_rna(M)
    rl, ml = tf32_rna(r - rh), tf32_rna(M - mh)
    terms = ((rl, mh), (rh, ml), (rh, mh)) if split else ((rh, mh),)
    acc = torch.zeros((s, Dp), dtype=torch.float32)
    for k0 in range(0, Dp, 8):
        for a, b in terms:
            acc = (acc.double() + a[:, k0 : k0 + 8].double() @ b[k0 : k0 + 8].double()).float()
    lanes = torch.zeros((s, 4), dtype=torch.float32)
    for nt in range(Dp // 8):
        for t in range(4):
            for j in (8 * nt + 2 * t, 8 * nt + 2 * t + 1):
                lanes[:, t] = _fma32(r[:, j], acc[:, j], lanes[:, t])
    return (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])


def _wide_batch(T, n, seed, C=16, d=5, l=3, scale=25.0):
    """A sorted gapped batch with |x| ~ 50 and cluster parameters of the
    same scale, float64 on the CPU: ``(v, sizes, patterns, means, minv,
    const, logpi)``."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d)) * 2.0
    x = z @ rng.normal(size=(d, l)) + rng.normal(size=(T, n, l))
    z = scale * z + rng.normal(scale=scale, size=d)
    x = scale * x + rng.normal(scale=scale, size=l)
    lens = rng.choice([T // 2, T - 2, T], size=n)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    gap = np.where(rng.uniform(size=n) < 0.25)[0]
    tg = rng.integers(1, 4, size=gap.size)
    z[tg, gap] = np.nan
    x[tg, gap] = np.nan
    x[0, rng.uniform(size=n) < 0.1] = np.nan
    v = tem.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    patterns, pid = gops.pattern_groups(v)
    sizes = tuple(int(c) for c in np.bincount(pid, minlength=patterns.shape[0]))
    eye = lambda k: np.stack([np.eye(k)] * C) * scale**2  # noqa: E731
    params = tem.mixture_params_from_numpy(
        (rng.dirichlet(np.ones(C)), rng.normal(scale=scale, size=(C, d)), eye(d),
         rng.normal(scale=0.3, size=(C, d, d)), eye(d), rng.normal(size=(C, d, l)), eye(l)),
        device="cpu", dtype=torch.float64,
    )
    means, covs = tem.cluster_joint_moments(params, T)
    pat = torch.from_numpy(patterns)
    minv, const = ek.precompute_cluster_pattern_inverses(means, covs, pat)
    v = torch.from_numpy(v[np.argsort(pid, kind="stable")])
    return v, sizes, pat, means, minv, const, torch.log(params.pi)


@pytest.fixture(scope="module", params=[(10, 2000), (64, 300)], ids=["D80", "D512"])
def wide(request):
    T, n = request.param
    return _wide_batch(T, n, seed=T)


def _emulated(wide, form, split):
    """The emulated kernel's float32 output of ``form`` ("logliks": K12/K13,
    "scores": K8/K14) beside the float64 plain version and the magnitude:
    ``(got (C, n) float32, want, mag)`` in float64."""
    v, sizes, pat, means, minv, const, logpi = wide
    C, n = const.shape[0], v.shape[0]
    v32, means32, minv32 = v.float(), means.float(), minv.float()
    fin = torch.isfinite(v)
    if form == "logliks":
        want = ek.estep_logliks_pattern_sorted_plain(v, means, minv, const, sizes=sizes)
        lead32, lead = const.float(), const.abs()
    else:
        want = ek.sorted_scores(v.T, means, minv, const, logpi, pat, sizes=sizes)
        lead32, lead = logpi.float()[:, None] + const.float(), const.abs() + logpi.abs()[:, None]
    got = torch.empty((C, n), dtype=torch.float32)
    mag = torch.empty((C, n), dtype=torch.float64)
    off = 0
    for p, s in enumerate(sizes):
        rows, f = slice(off, off + s), fin[off : off + s]
        vm32 = torch.where(f, v32[rows], 0.0)
        for c in range(C):
            if form == "logliks":
                r = torch.where(f, v32[rows] - means32[c], 0.0)
            else:
                r = vm32 - means32[c] * pat[p].float()
            got[c, rows] = lead32[c, p] - 0.5 * quad_form_tf32(r, minv32[c, p], split=split)
            a = torch.where(f, v[rows].abs() + means[c].abs(), 0.0)
            mag[c, rows] = 0.5 * ((a @ minv[c, p].abs()) * a).sum(1) + lead[c, p]
        off += s
    return got.double(), want, mag


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # a TF32 ulp at 1
    fmax = float(torch.finfo(torch.float32).max)
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0**-23, one + 3 * ulp / 2,
                      fmax, float("inf"), float("-inf"), float("nan"), 0.0, -0.0], dtype=torch.float32)
    got = tf32_rna(x)
    assert got[:4].tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp]
    assert got[4] == float("inf")  # past the largest TF32 value
    assert got[5] == float("inf") and got[6] == float("-inf") and torch.isnan(got[7])
    assert got[8] == 0.0 and torch.signbit(got[9])
    assert bool((tf32_rna(got[:4]) == got[:4]).all())  # TF32 values are fixed points


@pytest.mark.parametrize("form", ["logliks", "scores"])
def test_three_term_split_is_within_tolerance(wide, form):
    got, want, mag = _emulated(wide, form, split=True)
    assert bool(torch.isfinite(got).all())
    ratio = ((got - want).abs() / mag).max()
    assert ratio <= REL, f"split: {float(ratio):.3e} of the magnitude"


@pytest.mark.parametrize("form", ["logliks", "scores"])
def test_single_tf32_product_misses_tolerance(wide, form):
    """Why the split exists: hi·hi alone errs beyond the tolerance."""
    got, want, mag = _emulated(wide, form, split=False)
    ratio = ((got - want).abs() / mag).max()
    assert ratio > REL, f"single TF32: {float(ratio):.3e} of the magnitude"

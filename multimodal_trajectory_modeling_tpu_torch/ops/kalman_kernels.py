"""The exact masked Kalman filter as one kernel: K7.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/pallas_kalman.py``:
``pack_masked_kalman`` (:189), ``kalman_masked_logliks_packed`` (:230,
the TPU kernel) → ``csrc/masked_kalman.cu``, and
``kalman_masked_logliks_pallas`` (:287), which keeps its public signature
``(z, x, m, S, A, G, H, L) → (C, n)``.

The batch is laid out as ``zp (T, d, n)`` and ``xp (T, l, n)`` with the
NaNs kept, so that consecutive rows sit at consecutive addresses; the
observation masks are ``v == v`` in the kernel, as in the TPU kernel.
The TPU layout (the (8, Bn) sublane tiles, the time chunks and the VMEM
budget that capped the parameter rows at about 200) is not carried over:
any number of parameter rows works, R·C = 512 of the masked pool
included.

A step past a row's last observed step adds exactly −0.0 to its
log-density (every term is selected to 0, the dummy pivots are 1, w = 0),
so the kernel runs each row only up to its extent, 1 + its last step with
a finite z or x entry (0 for a row with no finite entry, which gives
exactly 0.0).  A plan (:func:`.row_plan.masked_plan`, plain torch on the
batch's device, no host synchronisation; K6 takes the same) holds each
row's extent and a stable order of the rows by extent, longest first, so
that the kernel's tiles of 128 consecutive rows run nearly uniform loop
counts and a warp's reads of z and x stay contiguous.  Trainers build it once per fit with the packed
batch (:func:`plan_masked_batch`: the batch permuted once into the plan's
order, one copy as before); the kernel writes each result to the
caller's row.  A caller that passes ``(zp, xp)`` in its own order without
a plan gets one built for that call.  Besides the skip, the kernel
stages the parameters in shared memory in the order the step reads them,
read with 128-bit loads (float32 holds A, G and Λ in registers), and
takes one log a step: of the product of the step's pivot variances, kept
as a mantissa product and an exponent sum (:func:`pivot_log_sum` is that
arithmetic in torch).

The bound counts the least work: ``masked_step_operations(d, l) · C ·
Σ extent`` element operations (``chip_smoke.py`` prints the count over
all T beside it).

The device chooses between kernel and plain version (there is no
``MTM_KALMAN_PALLAS``): CPU tensors take the plain version
(:func:`kalman_masked_logliks_packed_plain`, the step algebra of
:func:`.kalman.masked_filter_step_split` on ``(C, n)`` lanes over all T);
CUDA tensors launch the kernel or raise.  The wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import kalman as kops
from multimodal_trajectory_modeling_tpu_torch.ops.markov_kernels import _device_index
from multimodal_trajectory_modeling_tpu_torch.ops.row_plan import MaskedPlan, masked_plan

__all__ = [
    "MaskedBatch",
    "MaskedPlan",
    "kalman_masked_logliks_packed",
    "kalman_masked_logliks_packed_plain",
    "kalman_masked_logliks_pallas",
    "masked_plan",
    "masked_step_operations",
    "pack_masked_kalman",
    "pivot_log_sum",
    "plan_masked_batch",
]

_KINDS = {torch.float32: 0, torch.float64: 1}


class MaskedBatch(NamedTuple):
    """The batch in K7's layout, its rows in ``plan``'s order:
    ``zp (T, d, n)``, ``xp (T, l, n)``, NaNs kept."""

    zp: torch.Tensor
    xp: torch.Tensor
    plan: MaskedPlan


def pack_masked_kalman(z: torch.Tensor, x: torch.Tensor):
    """``(zp (T, d, n), xp (T, l, n))``: the batch ``z (T, n, d)``, ``x
    (T, n, l)`` in the kernel's layout, in the caller's row order, NaNs
    kept."""
    return z.permute(0, 2, 1).contiguous(), x.permute(0, 2, 1).contiguous()


def plan_masked_batch(z: torch.Tensor, x: torch.Tensor) -> MaskedBatch:
    """The batch ``z (T, n, d)``, ``x (T, n, l)`` packed for K7 in its
    plan's order, in one copy.  Trainers call it once per fit, outside
    the EM loop."""
    zt, xt = z.permute(0, 2, 1), x.permute(0, 2, 1)
    plan = masked_plan(zt, xt)
    return MaskedBatch(zt.index_select(2, plan.rows), xt.index_select(2, plan.rows), plan)


def _check_args(zp, xp, params, plan=None):
    if zp.ndim != 3 or xp.ndim != 3 or zp.shape[0] != xp.shape[0] or zp.shape[2] != xp.shape[2]:
        raise ValueError(
            f"zp (T, d, n) and xp (T, l, n) disagree: {tuple(zp.shape)}, {tuple(xp.shape)}"
        )
    _T, d, n = zp.shape
    l = xp.shape[1]
    m, S, A, G, H, L = params
    C = m.shape[0]
    want = ((C, d), (C, d, d), (C, d, d), (C, d, d), (C, d, l), (C, l, l))
    if tuple(tuple(a.shape) for a in params) != want:
        raise ValueError(
            f"parameters must be shaped {want}, got {[tuple(a.shape) for a in params]}"
        )
    if any(a.device != zp.device for a in (xp, *params)):
        raise ValueError("the batch and the parameters must be on one device")
    if plan is not None and any(
        a.shape != (n,) or a.dtype != torch.int32 or a.device != zp.device or not a.is_contiguous()
        for a in plan
    ):
        raise ValueError(f"the plan must be two contiguous int32 ({n},) tensors on the batch's device")


def kalman_masked_logliks_packed_plain(zp, xp, m, S, A, G, H, L, plan=None) -> torch.Tensor:
    """Plain torch version of :func:`kalman_masked_logliks_packed`: every
    row through all T steps."""
    _check_args(zp, xp, (m, S, A, G, H, L), plan)
    dtype = zp.dtype
    oz, ox = zp == zp, xp == xp
    ll = kops.masked_filter_scan(
        torch.where(oz, zp, 0.0), torch.where(ox, xp, 0.0), oz.to(dtype), ox.to(dtype),
        *(a.to(dtype) for a in (m, S, A, G, H, L)),
    )
    if plan is None:
        return ll
    out = torch.empty_like(ll)
    out[:, plan.rows.long()] = ll
    return out


def kalman_masked_logliks_packed(
    zp: torch.Tensor,  # (T, d, n) from pack_masked_kalman or plan_masked_batch
    xp: torch.Tensor,  # (T, l, n)
    m: torch.Tensor,  # (C, d)
    S: torch.Tensor,  # (C, d, d)
    A: torch.Tensor,  # (C, d, d)
    G: torch.Tensor,  # (C, d, d)
    H: torch.Tensor,  # (C, d, l)
    L: torch.Tensor,  # (C, l, l)
    plan: MaskedPlan | None = None,  # zp and xp's row order; None: the caller's
) -> torch.Tensor:
    """K7: ``(C, n)`` exact observed-data log-densities on the packed
    batch, in the batch's dtype and the caller's row order
    (``pallas_kalman.py:230``).  A row with no finite entry gives exactly
    0.0.  CUDA tensors launch ``csrc/masked_kalman.cu`` (float32 or
    float64; d and l up to the kernel's maximum of 8), each row stopping
    at its extent; without a plan, one is built and the batch reordered
    for this call.  CPU tensors take the plain version."""
    params = (m, S, A, G, H, L)
    _check_args(zp, xp, params, plan)
    if zp.device.type == "cpu":
        return kalman_masked_logliks_packed_plain(zp, xp, *params, plan=plan)
    if zp.device.type != "cuda":
        raise ValueError(f"unsupported device {zp.device}")
    if zp.dtype not in _KINDS or xp.dtype != zp.dtype:
        raise ValueError(f"zp and xp must share float32 or float64, got {zp.dtype}, {xp.dtype}")
    if not (zp.is_contiguous() and xp.is_contiguous()):
        raise ValueError("zp and xp must be contiguous")
    T, d, n = zp.shape
    l = xp.shape[1]
    C = m.shape[0]
    if n == 0 or T == 0 or C == 0:
        raise ValueError("empty batch or no parameter rows")
    lib = _build.library()
    if d > lib.mtm_masked_kalman_max_dim() or l > lib.mtm_masked_kalman_max_dim():
        raise ValueError(
            f"d={d}, l={l}: the masked-filter kernel takes at most "
            f"{lib.mtm_masked_kalman_max_dim()} of each"
        )
    if plan is None:
        plan = masked_plan(zp, xp)
        zp, xp = zp.index_select(2, plan.rows), xp.index_select(2, plan.rows)
    rows = torch.cat([a.to(zp.dtype).reshape(C, -1) for a in params], dim=1).contiguous()
    out = torch.empty((C, n), dtype=zp.dtype, device=zp.device)
    rc = lib.mtm_masked_kalman(
        _device_index(zp),
        _KINDS[zp.dtype],
        zp.data_ptr(),
        xp.data_ptr(),
        rows.data_ptr(),
        plan.rows.data_ptr(),
        plan.extent.data_ptr(),
        out.data_ptr(),
        n,
        T,
        d,
        l,
        C,
        torch.cuda.current_stream(zp.device).cuda_stream,
    )
    _build.check(rc, "kalman_masked_logliks_packed")
    kalman_masked_logliks_packed.launches += 1
    return out


kalman_masked_logliks_packed.launches = 0


def kalman_masked_logliks_pallas(z, x, m, S, A, G, H, L) -> torch.Tensor:
    """``(C, n)`` exact observed-data log-densities under arbitrary
    per-coordinate missingness from the unpacked batch ``z (T, n, d)``,
    ``x (T, n, l)``: :func:`plan_masked_batch`, then K7
    (``pallas_kalman.py:287``)."""
    zp, xp, plan = plan_masked_batch(z, x)
    return kalman_masked_logliks_packed(zp, xp, m, S, A, G, H, L, plan=plan)


def pivot_log_sum(s_z: torch.Tensor, obs_z: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """K7's one log a step, in torch: ``Σ_{observed a} log s_z[..., a] +
    Σ_b log s_x[..., b]`` from the product of the pivots' mantissas and
    the sum of their exponents (``csrc/masked_kalman.cu:PivotLog``, its
    exact path).  A z pivot that is zero, infinite, negative or NaN adds
    the class of ``log s`` (−Inf, +Inf, NaN), an x pivot outside (0, Inf)
    NaN (the class of ``2 log(s rsqrt s)``); subnormals are rescaled."""
    s = torch.cat([torch.where(obs_z, s_z, 1.0), s_x], dim=-1)
    f32 = s.dtype == torch.float32
    shift, mant_bits, bias = (24, 23, 127) if f32 else (54, 52, 1023)
    good = (s > 0) & (s < torch.inf)
    tiny = good & (s < torch.finfo(s.dtype).tiny)  # subnormal: rescaled by 2^shift
    bits = torch.where(good, torch.where(tiny, s * 2.0**shift, s), 1.0).view(torch.int32 if f32 else torch.int64)
    k = (bits >> mant_bits) - bias - torch.where(tiny, shift, 0)
    mant = ((bits & ((1 << mant_bits) - 1)) | (bias << mant_bits)).view(s.dtype)
    z_class = torch.where(s == 0, -torch.inf, torch.where(s > 0, torch.inf, torch.nan))[..., : s_z.shape[-1]]
    odd = torch.where(good, 0.0, torch.cat([z_class, torch.full_like(s_x, torch.nan)], dim=-1))
    return torch.log(mant.prod(-1)) + k.sum(-1).to(s.dtype) * math.log(2.0) + odd.sum(-1)


def masked_step_operations(d: int, l: int) -> int:
    """Element operations of one masked filter step (one row, one
    parameter row): every add, subtraction, multiply, compare, select,
    ``log`` and ``rsqrt`` of :func:`.kalman.masked_filter_step_split`,
    counted part by part (``tests/test_torch_kalman.py`` holds the count
    against the operations the plain step issues).  Used for K7's
    bound."""
    tri = d * (d + 1) // 2
    # d scalar conditionings on z: compare, row select, rsqrt, reciprocal,
    # innovation, log term, gain, μ and P downdates; the terms summed, ×−½
    z_cond = d * (d * d + 5 * d + 12) + d
    # PH = P_c H, the lower triangle of HᵀPH + Λ, Hᵀμ, the innovation
    moments = d * l * (2 * d - 1) + l * (l + 1) * d + l * (2 * d - 1) + l
    chol = sum(2 * j + 2 + (l - 1 - j) * (2 * j + 1) for j in range(l))
    x_update = (
        2 * l * l + 2 * l  # the masked innovation covariance
        + chol
        + 2 * l + l * l  # the masked innovation, L⁻¹e
        + (2 * l - 1) + 2 * l + (l - 1) + 4  # quadratic form, log-det, count, ll
        + d * (2 * l + l * l)  # U = L⁻¹ PM, PM masked
        + 2 * d * l + 2 * l * tri  # μ + Uᵀw, P − UᵀU
    )
    predict = d * (2 * d - 1) + d * d * (2 * d - 1) + 2 * d * tri  # μA, AᵀP, AᵀPA + G
    return z_cond + moments + x_update + predict + 1  # + 1: ll_z + ll_x

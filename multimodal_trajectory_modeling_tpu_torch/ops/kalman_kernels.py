"""The exact masked Kalman filter as one kernel: K7.

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/pallas_kalman.py``:
``pack_masked_kalman`` (:189), ``kalman_masked_logliks_packed`` (:230,
the TPU kernel) → ``csrc/masked_kalman.cu``, and
``kalman_masked_logliks_pallas`` (:287), which keeps its public signature
``(z, x, m, S, A, G, H, L) → (C, n)``.

The batch is laid out once per fit as ``zp (T, d, n)`` and ``xp (T, l,
n)`` with the NaNs kept, so that consecutive rows sit at consecutive
addresses; the observation masks are ``v == v`` in the kernel, as in the
TPU kernel.  The TPU layout (the (8, Bn) sublane tiles, the time chunks
and the VMEM budget that capped the parameter rows at about 200) is not
carried over: any number of parameter rows works, R·C = 512 of the
masked pool included.

The device chooses between kernel and plain version (there is no
``MTM_KALMAN_PALLAS``): CPU tensors take the plain version
(:func:`kalman_masked_logliks_packed_plain`, the step algebra of
:func:`.kalman.masked_filter_step_split` on ``(C, n)`` lanes); CUDA
tensors launch the kernel or raise.  The wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import kalman as kops
from multimodal_trajectory_modeling_tpu_torch.ops.markov_kernels import _device_index

__all__ = [
    "kalman_masked_logliks_packed",
    "kalman_masked_logliks_packed_plain",
    "kalman_masked_logliks_pallas",
    "masked_step_operations",
    "pack_masked_kalman",
]

_KINDS = {torch.float32: 0, torch.float64: 1}


def pack_masked_kalman(z: torch.Tensor, x: torch.Tensor):
    """``(zp (T, d, n), xp (T, l, n))``: the batch ``z (T, n, d)``, ``x
    (T, n, l)`` in the kernel's layout, NaNs kept.  Trainers call it once
    per fit, outside the EM loop."""
    return z.permute(0, 2, 1).contiguous(), x.permute(0, 2, 1).contiguous()


def _check_args(zp, xp, params):
    if zp.ndim != 3 or xp.ndim != 3 or zp.shape[0] != xp.shape[0] or zp.shape[2] != xp.shape[2]:
        raise ValueError(
            f"zp (T, d, n) and xp (T, l, n) disagree: {tuple(zp.shape)}, {tuple(xp.shape)}"
        )
    _T, d, _n = zp.shape
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


def kalman_masked_logliks_packed_plain(zp, xp, m, S, A, G, H, L) -> torch.Tensor:
    """Plain torch version of :func:`kalman_masked_logliks_packed`."""
    _check_args(zp, xp, (m, S, A, G, H, L))
    dtype = zp.dtype
    oz, ox = zp == zp, xp == xp
    return kops.masked_filter_scan(
        torch.where(oz, zp, 0.0), torch.where(ox, xp, 0.0), oz.to(dtype), ox.to(dtype),
        *(a.to(dtype) for a in (m, S, A, G, H, L)),
    )


def kalman_masked_logliks_packed(
    zp: torch.Tensor,  # (T, d, n) from pack_masked_kalman
    xp: torch.Tensor,  # (T, l, n)
    m: torch.Tensor,  # (C, d)
    S: torch.Tensor,  # (C, d, d)
    A: torch.Tensor,  # (C, d, d)
    G: torch.Tensor,  # (C, d, d)
    H: torch.Tensor,  # (C, d, l)
    L: torch.Tensor,  # (C, l, l)
) -> torch.Tensor:
    """K7: ``(C, n)`` exact observed-data log-densities on the packed
    batch, in the batch's dtype (``pallas_kalman.py:230``).  A row with no
    finite entry gives exactly 0.0.  CUDA tensors launch
    ``csrc/masked_kalman.cu`` (float32 or float64; d and l up to the
    kernel's maximum of 8); CPU tensors take the plain version."""
    params = (m, S, A, G, H, L)
    _check_args(zp, xp, params)
    if zp.device.type == "cpu":
        return kalman_masked_logliks_packed_plain(zp, xp, *params)
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
    rows = torch.cat([a.to(zp.dtype).reshape(C, -1) for a in params], dim=1).contiguous()
    out = torch.empty((C, n), dtype=zp.dtype, device=zp.device)
    rc = lib.mtm_masked_kalman(
        _device_index(zp),
        _KINDS[zp.dtype],
        zp.data_ptr(),
        xp.data_ptr(),
        rows.data_ptr(),
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
    ``x (T, n, l)``: :func:`pack_masked_kalman`, then K7
    (``pallas_kalman.py:287``)."""
    return kalman_masked_logliks_packed(*pack_masked_kalman(z, x), m, S, A, G, H, L)


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

"""Markov EM kernels: Φ materialization (K2; K5 at any T), the Φ-reading
EM iteration for one restart (K1) and for R restarts (K3), the EM
iteration that rebuilds Φ from the packed batch on every call, for one
restart (K4a) and for R restarts (K4b), and the EM passes over the raw
NaN-padded batch at any T (K6, K10, K11).

Counterpart of ``multimodal_trajectory_modeling_tpu/ops/pallas_markov.py``,
whose Pallas TPU kernels become hand-written CUDA kernels:

- K2 ``markov_materialize_features`` (:1314) → ``csrc/markov_features.cu``;
- K5 ``markov_materialize_features_longT`` (:1842) →
  ``csrc/markov_features_longT.cu``;
- K1 ``markov_em_from_features`` (:1464) → ``csrc/markov_em.cu``;
- K3 ``markov_em_from_features_multi`` (:1658), K4a
  ``markov_em_fused_packed`` (:727) and K4b
  ``markov_em_fused_packed_multi`` (:898) → ``csrc/markov_em_multi.cu``
  and ``csrc/markov_em_packed.cu``, one kernel body that reads Φ from
  device memory (K3 on wide Φ) or builds each instance's Φ column in
  shared memory with K2's row build (``csrc/markov_common.cuh``, float64
  K4a and K4b); int16 Φ takes K3's tensor-core body
  (``csrc/markov_em_multi_mma.cu``), float32 K4b and float32 K4a their own,
  which stage the packed batch in shared memory and build Φ tiles there
  (``csrc/markov_em_packed_mma.cu``, planned by :func:`packed_mma_plan`;
  ``csrc/markov_em_packed_one.cu``, planned by :func:`packed_one_plan`);
- K6 ``markov_em_fused_longT`` (:1148), K10 ``markov_assign_suffix``
  (:245) and K11 ``markov_em_fused`` (:438) → ``csrc/markov_em_batch.cu``,
  one kernel body that builds each instance's canonical Φ column in
  shared memory with K5's row arithmetic (``csrc/markov_longT_rows.cuh``)
  from the batch staged in shared memory, and runs K1's step on it; the
  grouped weights of K6 and K10 are folded into the canonical layout first
  (:func:`..markov.canonical_weights`).  A plan (:func:`plan_raw_batch`:
  K7's row plan, :mod:`.row_plan`) orders the rows by extent so that each
  stops at its last observed step; the long-T trainer keeps its batch and
  assignments in that order (:class:`RawBatch`).

- Layout (``markov_packed_spec``, ``pack_markov_u``,
  ``markov_compact_spec``): the batch is packed per time step as
  ``[z_t; x_t; 0-pad]`` on ``s = 8·ceil((d+l)/8)`` rows; every feature of
  the g-layout (:mod:`.markov`) is then one row of a T-reduced
  accumulator ``ACC`` of shift products, and Φ keeps only the referenced
  rows.  The index arrays are identical to the JAX package's.  Unlike
  there, the instance axis is not padded: the kernels mask the ragged
  edge.
- Layouts of Φ (``_feature_layout``, decided by the shape alone): the
  compact layout, the referenced ACC rows of the packed batch (K2, T·s ≤
  512), and past it the canonical layout, the g-layout rows themselves
  (K5, built for any T); K1 and K3 read either, their weights folded and
  their statistics unfolded through the layout's feature → row map.
- Storage (``PhiQuant``, ``quantize_phi``): Φ may be stored int16 with one
  scale per row; the scales fold into the score weights and unfold from
  the statistics, so K1 and K3 read half the bytes.
- Argmax rules follow the replaced kernels: K1, K4a, K6, K10 and K11
  take the first maximum with NaN counted as the maximum
  (``jnp.argmax``); K3 and K4b a strict ``>`` scan over the clusters, so
  a NaN never wins (and a NaN at cluster 0 stays).  A degenerate cluster has NaN weights, so the two
  rules give different assignments there.
- Kernels: each wrapper takes its plain torch version for CPU tensors
  only.  For CUDA tensors it launches the kernel or raises.  Each wrapper
  counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops.markov import canonical_weights
from multimodal_trajectory_modeling_tpu_torch.ops.row_plan import MaskedPlan, masked_plan

__all__ = [
    "PackedOnePlan",
    "PackedPlan",
    "PhiQuant",
    "RawBatch",
    "dequantize_phi",
    "fold_weights",
    "markov_assign_suffix",
    "markov_assign_suffix_plain",
    "markov_em_fused",
    "markov_em_fused_longT",
    "markov_em_fused_longT_plain",
    "markov_em_fused_plain",
    "markov_compact_spec",
    "markov_em_compact",
    "markov_em_compact_plain",
    "fold_weights_multi",
    "markov_em_compact_multi",
    "markov_em_compact_multi_plain",
    "markov_em_from_features",
    "markov_em_from_features_multi",
    "markov_em_fused_packed",
    "markov_em_fused_packed_multi",
    "markov_em_fused_packed_multi_plain",
    "markov_em_fused_packed_plain",
    "markov_materialize_features",
    "markov_materialize_features_longT",
    "markov_materialize_features_longT_plain",
    "markov_materialize_features_plain",
    "markov_packed_ok",
    "markov_packed_spec",
    "pack_markov_u",
    "packed_mma_plan",
    "packed_one_plan",
    "packed_one_smem",
    "plan_raw_batch",
    "raw_batch_plan",
    "packed_mma_smem",
    "phi_scale_from_absmax",
    "quantize_phi",
]

# Instances per block of K1; int16 statistics are summed in int32 inside
# a block, which holds for up to 65536 instances.  K3/K4 take their
# objective partials per _EM_CHUNK instances too (so that K3's objective
# is K1's bit for bit), and their statistics per _multi_chunk(R).
_EM_CHUNK = 1024


def _multi_chunk(R: int) -> int:
    """K3/K4's instances per block: 1024 per four restarts, at most 8192,
    so the grid keeps about n/1024 blocks of restart groups while the
    per-block partials (R statistics each) stay small."""
    return _EM_CHUNK * min(8, -(-R // 4))

# ----------------------------------------------------------------------
# layout
# ----------------------------------------------------------------------


def _acc_bases(d: int, l: int):
    """``(s, ks, base_B, base_F0, base_AID, base_AVM, base_U0, base_EX,
    Facc)`` of the ACC layout."""
    s = 8 * ((d + l + 7) // 8)
    ks = sorted(set(range(d + l)) | set(range(s - d + 1, s + d)))
    base_B = len(ks) * s
    base_F0 = base_B + d * s
    base_AID = base_F0 + d * s
    base_AVM = base_AID + s
    base_U0 = base_AVM + s
    base_EX = base_U0 + s
    Facc = base_EX + s
    return s, ks, base_B, base_F0, base_AID, base_AVM, base_U0, base_EX, Facc


def markov_packed_spec(T: int, d: int, l: int):
    """Accumulator layout (``pallas_markov.py:511``).

    Returns ``(s, ks, Facc, rows)``: the step height ``s``, the shifts
    ``ks`` of the A groups, the ACC row count, and ``rows[f]``, the ACC row
    that holds g-layout feature ``f``.  The ACC groups are

    - ``A_k`` (k in ks): Σ_t u[st+r]·u[st+r+k]
    - ``B_k`` (k < d): the same under the vm_{t+1} mask (g2)
    - ``F0_k`` (k < d): the t=0 products (g6)
    - ``AID`` Σ_t u_t (g8/g9), ``AVM`` Σ_t vm_{t+1}·u_t (g7), ``U0`` = u_0
      (g10), ``EXTRA`` = [len, 1, 0…]
    """
    s, ks, base_B, base_F0, base_AID, base_AVM, base_U0, base_EX, Facc = (
        _acc_bases(d, l)
    )
    kpos = {k: i for i, k in enumerate(ks)}

    def A(k, r):
        return kpos[k] * s + r

    rows = []
    pairs_d = [(i, j) for i in range(d) for j in range(d)]
    rows += [A(abs(i - j), min(i, j)) for i, j in pairs_d]  # g1
    rows += [base_B + abs(i - j) * s + min(i, j) for i, j in pairs_d]  # g2
    rows += [A(s + j - i, i) for i, j in pairs_d]  # g3
    rows += [
        A(abs(a - b), d + min(a, b)) for a in range(l) for b in range(l)
    ]  # g4
    rows += [A(d + a - i, i) for i in range(d) for a in range(l)]  # g5
    rows += [base_F0 + abs(i - j) * s + min(i, j) for i, j in pairs_d]  # g6
    rows += [base_AVM + i for i in range(d)]  # g7
    rows += [base_AID + i for i in range(d)]  # g8
    rows += [base_AID + d + a for a in range(l)]  # g9
    rows += [base_U0 + i for i in range(d)]  # g10
    rows += [base_EX + 0, base_EX + 1]  # len, const
    return s, tuple(ks), Facc, np.asarray(rows, np.int64)


def markov_compact_spec(T: int, d: int, l: int):
    """Compact Φ layout (``pallas_markov.py:1249``): ``(Fc_pad, uniq,
    pos)`` with ``uniq`` the referenced ACC rows in ascending order,
    ``pos[f]`` the Φ row of g-layout feature ``f``, and ``Fc_pad`` the
    referenced row count rounded up to 8."""
    _s, _ks, _Facc, rows = markov_packed_spec(T, d, l)
    uniq = np.unique(rows)
    Fc = int(uniq.shape[0])
    Fc_pad = 8 * ((Fc + 7) // 8)
    pos = np.searchsorted(uniq, rows).astype(np.int64)
    return Fc_pad, uniq, pos


def _canonical_offsets(d: int, l: int) -> dict:
    """First row of each g-layout group in the canonical Φ, and ``F``
    (``pallas_markov.py:1775-1785``)."""
    dd = d * d
    o = {"g1": 0, "g2": dd, "g3": 2 * dd, "g4": 3 * dd}
    o["g5"] = o["g4"] + l * l
    o["g6"] = o["g5"] + d * l
    o["g7"] = o["g6"] + dd
    o["g8"] = o["g7"] + d
    o["g9"] = o["g8"] + d
    o["g10"] = o["g9"] + l
    o["len"] = o["g10"] + d
    o["one"] = o["len"] + 1
    o["F"] = o["one"] + 1
    return o


def markov_packed_ok(T: int, d: int, l: int) -> bool:
    """Whether the packed layout takes this shape (T·s ≤ 512); past it Φ
    is materialized in the canonical layout (kernel K5)."""
    return T * 8 * ((d + l + 7) // 8) <= 512


def _canonical_rows(d: int, l: int) -> int:
    """Row count of the canonical Φ: ``F = 4d²+l²+dl+2d+l+d+2`` padded to
    8 (144 at d=5, l=3; ``pallas_markov.py:1281``)."""
    return 8 * ((_canonical_offsets(d, l)["F"] + 7) // 8)


def _feature_layout(T: int, d: int, l: int):
    """(padded row count, g-layout feature → Φ row) of the Φ that the
    trainers build at this shape (``pallas_markov.py:1281``): the compact
    rows of K2 where the packed layout takes the shape
    (:func:`markov_packed_ok`), else the canonical rows of K5."""
    if markov_packed_ok(T, d, l):
        Fc_pad, _uniq, pos = markov_compact_spec(T, d, l)
        return Fc_pad, pos
    return _canonical_rows(d, l), np.arange(_canonical_offsets(d, l)["F"], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _positions(T: int, d: int, l: int, device: torch.device) -> torch.Tensor:
    """``pos`` of :func:`_feature_layout` as a tensor on ``device`` (read
    by every EM iteration; copied to the device once)."""
    return torch.as_tensor(_feature_layout(T, d, l)[1], device=device)


@functools.lru_cache(maxsize=None)
def _acc_rows(T: int, d: int, l: int, device: torch.device) -> torch.Tensor:
    """``rows`` of :func:`markov_packed_spec` as a tensor on ``device``."""
    return torch.as_tensor(markov_packed_spec(T, d, l)[3], device=device)


def pack_markov_u(
    z_t: torch.Tensor,  # (T·d, n) transposed latent batch (NaN-padded)
    x_t: torch.Tensor,  # (T·l, n)
    *,
    T: int,
    d: int,
    l: int,
) -> torch.Tensor:
    """Interleave the batch per time step as ``[z_t; x_t; 0-pad]`` on ``s``
    rows, non-finite → 0: the packed batch ``u (T·s, n)``
    (``pallas_markov.py:573``, without its lane padding)."""
    s = 8 * ((d + l + 7) // 8)
    n = z_t.shape[1]
    z3 = z_t.reshape(T, d, n)
    x3 = x_t.reshape(T, l, n)
    u = torch.zeros((T, s, n), dtype=z_t.dtype, device=z_t.device)
    u[:, :d] = torch.where(torch.isfinite(z3), z3, 0.0)
    u[:, d : d + l] = torch.where(torch.isfinite(x3), x3, 0.0)
    return u.reshape(T * s, n)


# ----------------------------------------------------------------------
# int16 storage of Φ
# ----------------------------------------------------------------------


class PhiQuant(NamedTuple):
    """Φ stored int16 with one scale per row: ``Φ ≈ scale[:, None] · q``,
    the row's largest magnitude on ±32766 (``pallas_markov.py:111``).
    The EM kernel never dequantizes: the scales fold into the score
    weights and unfold from the statistics."""

    q: torch.Tensor  # (Fc_pad, n) int16
    scale: torch.Tensor  # (Fc_pad,) compute dtype


def phi_scale_from_absmax(amax: torch.Tensor, dtype) -> torch.Tensor:
    """Per-row quantization scale from the per-row max |Φ|."""
    scale = torch.where(amax > 0.0, amax, torch.ones_like(amax)) * (
        1.0 / 32766.0
    )
    return scale.to(dtype)


def quantize_phi(
    phi: torch.Tensor, scale: torch.Tensor | None = None
) -> PhiQuant:
    """Quantize Φ (rows = features, columns = instances) to
    :class:`PhiQuant`, rounding half to even as ``jnp.round`` does.
    All-zero rows get scale 1."""
    if scale is None:
        scale = phi_scale_from_absmax(phi.abs().amax(dim=1), phi.dtype)
    q = torch.round(phi * (1.0 / scale)[:, None]).to(torch.int16)
    return PhiQuant(q, scale.to(phi.dtype))


def dequantize_phi(pq: PhiQuant) -> torch.Tensor:
    """The rounded wide Φ (for tests and diagnostics)."""
    return pq.scale[:, None] * pq.q.to(pq.scale.dtype)


# ----------------------------------------------------------------------
# K2: Φ materialization
# ----------------------------------------------------------------------

# row kinds of csrc/markov_features.cu
_ROW_A, _ROW_B, _ROW_F0, _ROW_AID, _ROW_AVM, _ROW_U0 = range(6)
_ROW_LEN, _ROW_ONE, _ROW_ZERO = 6, 7, 8


def _acc_row_table(d: int, l: int) -> np.ndarray:
    """``(Facc, 3)`` int32: each ACC row as ``(kind, shift k, row r)``,
    the form in which the CUDA kernel computes it."""
    s, ks, base_B, base_F0, base_AID, base_AVM, base_U0, base_EX, Facc = (
        _acc_bases(d, l)
    )
    table = np.zeros((Facc, 3), np.int32)
    for row in range(Facc):
        if row < base_B:
            entry = (_ROW_A, ks[row // s], row % s)
        elif row < base_F0:
            k, r = divmod(row - base_B, s)
            # the kernel sums B rows under the mask directly, which equals
            # the JAX algebra (A_k minus the last step) only while r+k < s
            entry = (_ROW_B, k, r) if r + k < s else (_ROW_A, k, r)
        elif row < base_AID:
            k, r = divmod(row - base_F0, s)
            entry = (_ROW_F0, k, r)
        elif row < base_AVM:
            entry = (_ROW_AID, 0, row - base_AID)
        elif row < base_U0:
            entry = (_ROW_AVM, 0, row - base_AVM)
        elif row < base_EX:
            entry = (_ROW_U0, 0, row - base_U0)
        else:
            r = row - base_EX
            entry = ({0: _ROW_LEN, 1: _ROW_ONE}.get(r, _ROW_ZERO), 0, r)
        table[row] = entry
    return table


@functools.lru_cache(maxsize=None)
def _row_desc(T: int, d: int, l: int, device: torch.device) -> torch.Tensor:
    """The (Fc, 3) int32 ACC-row table of Φ's referenced rows on
    ``device``, read by K2, K4a and K4b (copied to the device once)."""
    uniq = markov_compact_spec(T, d, l)[1]
    return torch.as_tensor(_acc_row_table(d, l)[uniq], device=device)


def _packed_acc_build(u, lens, *, T: int, d: int, s: int, ks: tuple):
    """The (Facc, n) accumulator of :func:`markov_packed_spec` from the
    packed batch, with the JAX kernel's algebra (``pallas_markov.py:606``):
    the vm_{t+1}-masked groups are the unmasked sums minus the last valid
    step's products."""
    Ts, n = u.shape
    zeros = functools.partial(torch.zeros, dtype=u.dtype, device=u.device)

    def shifted(a, k):  # rows shifted up by k, 0-fill
        return a if k == 0 else torch.cat([a[k:], zeros((k, a.shape[1]))])

    def treduce(p):  # Σ over t of the per-step (s, n) blocks
        return p.reshape(T, s, n).sum(dim=0)

    rowt = torch.arange(Ts, device=u.device) // s
    last_mask = (rowt[:, None] + 1 == lens[None, :]).to(u.dtype)
    ulast = treduce(u * last_mask)

    a_groups = {k: treduce(u * shifted(u, k)) for k in ks}
    groups = [a_groups[k] for k in ks]  # A_k
    groups += [a_groups[k] - ulast * shifted(ulast, k) for k in range(d)]
    u0 = u[:s]
    groups += [u0 * u[k : k + s] for k in range(d)]  # F0_k
    aid = u.reshape(T, s, n).sum(dim=0)
    groups += [aid, aid - ulast, u0]  # AID, AVM, U0
    extra = zeros((s, n))
    extra[0] = lens.to(u.dtype)
    extra[1] = 1.0
    groups.append(extra)
    return torch.cat(groups)


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _check_features_args(u, lens, T, d, l):
    s = 8 * ((d + l + 7) // 8)
    if u.ndim != 2 or u.shape[0] != T * s:
        raise ValueError(f"u must be (T·s, n) = ({T * s}, n), got {tuple(u.shape)}")
    if lens.shape != (u.shape[1],):
        raise ValueError(f"lens must be ({u.shape[1]},), got {tuple(lens.shape)}")
    if lens.device != u.device:
        raise ValueError("u and lens must be on one device")
    return s


def markov_materialize_features_plain(
    u: torch.Tensor, lens: torch.Tensor, *, T: int, d: int, l: int
) -> torch.Tensor:
    """Plain torch version of :func:`markov_materialize_features`."""
    s = _check_features_args(u, lens, T, d, l)
    _s, ks, _Facc, _rows = markov_packed_spec(T, d, l)
    Fc_pad, uniq, _pos = markov_compact_spec(T, d, l)
    acc = _packed_acc_build(u, lens, T=T, d=d, s=s, ks=ks)
    phi = torch.zeros((Fc_pad, u.shape[1]), dtype=u.dtype, device=u.device)
    phi[: uniq.shape[0]] = acc[torch.as_tensor(uniq, device=u.device)]
    return phi


def markov_materialize_features(
    u: torch.Tensor,  # (T·s, n) from pack_markov_u
    lens: torch.Tensor,  # (n,) int32
    *,
    T: int,
    d: int,
    l: int,
) -> torch.Tensor:
    """K2: the per-instance Markov EM features Φ (Fc_pad, n) in the
    compact layout, in u's dtype; once per fit (``pallas_markov.py:1314``).
    CUDA tensors launch ``csrc/markov_features.cu`` (float32 or float64,
    contiguous u, int32 lens); CPU tensors take the plain version."""
    s = _check_features_args(u, lens, T, d, l)
    if u.device.type == "cpu":
        return markov_materialize_features_plain(u, lens, T=T, d=d, l=l)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    kinds = {torch.float32: 0, torch.float64: 1}
    if u.dtype not in kinds:
        raise ValueError(f"u must be float32 or float64, got {u.dtype}")
    if lens.dtype != torch.int32:
        raise ValueError(f"lens must be int32, got {lens.dtype}")
    if not (u.is_contiguous() and lens.is_contiguous()):
        raise ValueError("u and lens must be contiguous")
    n = u.shape[1]
    if n == 0:
        raise ValueError("empty batch")
    Fc_pad, uniq, _pos = markov_compact_spec(T, d, l)
    desc = _row_desc(T, d, l, u.device)
    phi = torch.empty((Fc_pad, n), dtype=u.dtype, device=u.device)
    rc = _build.library().mtm_markov_features(
        _device_index(u),
        kinds[u.dtype],
        u.data_ptr(),
        lens.data_ptr(),
        desc.data_ptr(),
        phi.data_ptr(),
        n,
        T,
        s,
        int(uniq.shape[0]),
        Fc_pad,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(rc, "markov_materialize_features")
    markov_materialize_features.launches += 1
    return phi


markov_materialize_features.launches = 0

# ----------------------------------------------------------------------
# K5: canonical Φ at any T
# ----------------------------------------------------------------------


def _check_longT_args(z_t, x_t, lens, T, d, l):
    if z_t.ndim != 2 or z_t.shape[0] != T * d:
        raise ValueError(f"z_t must be (T·d, n) = ({T * d}, n), got {tuple(z_t.shape)}")
    n = z_t.shape[1]
    if x_t.shape != (T * l, n) or lens.shape != (n,):
        raise ValueError(
            f"x_t must be ({T * l}, {n}) and lens ({n},), got {tuple(x_t.shape)}, "
            f"{tuple(lens.shape)}"
        )
    if not (z_t.device == x_t.device == lens.device):
        raise ValueError("z_t, x_t and lens must be on one device")


def markov_materialize_features_longT_plain(
    z_t: torch.Tensor, x_t: torch.Tensor, lens: torch.Tensor, *, T: int, d: int, l: int,
    extent: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of :func:`markov_materialize_features_longT`:
    the TPU kernel's per-step accumulation (``pallas_markov.py:1763``),
    the steps added in order.  With ``extent`` (n,), each row's sums stop
    at its extent, as the raw-batch kernels' build does (the ``len`` and
    ``1`` rows are written whatever the extent): bit-equal to the sums
    over all T, since every step past a row's extent adds ±0."""
    _check_longT_args(z_t, x_t, lens, T, d, l)
    n, dtype = z_t.shape[1], z_t.dtype
    F_pad = _canonical_rows(d, l)
    o = _canonical_offsets(d, l)
    z3, x3 = z_t.reshape(T, d, n), x_t.reshape(T, l, n)
    acc = torch.zeros((F_pad, n), dtype=dtype, device=z_t.device)

    def fin(a):
        return torch.where(torch.isfinite(a), a, 0.0)

    def kron(a, b):  # row i·len(b) + j = a_i · b_j
        return (a[:, None, :] * b[None, :, :]).reshape(-1, n)

    def rows(g, k):
        return slice(o[g], o[g] + k)

    for t in range(T):
        zc, zn, xc = fin(z3[t]), fin(z3[min(t + 1, T - 1)]), fin(x3[t])
        vm = ((lens > t + 1) & (t < T - 1)).to(dtype)[None, :]
        takes = None if extent is None else (extent > t)[None, :]

        def add(g, k, v):
            r = rows(g, k)
            acc[r] = acc[r] + v if takes is None else torch.where(takes, acc[r] + v, acc[r])

        zz = kron(zc, zc)
        add("g1", d * d, zz)
        add("g2", d * d, vm * zz)
        add("g3", d * d, kron(zc, zn * vm))
        add("g4", l * l, kron(xc, xc))
        add("g5", d * l, kron(zc, xc))
        add("g7", d, vm * zc)
        add("g8", d, zc)
        add("g9", l, xc)
        if t == 0:
            add("g6", d * d, zz)
            add("g10", d, zc)
            acc[rows("len", 1)] += lens.to(dtype)[None, :]
            acc[rows("one", 1)] += 1.0
    return acc


def markov_materialize_features_longT(
    z_t: torch.Tensor,  # (T·d, n) transposed latent batch (NaN-padded)
    x_t: torch.Tensor,  # (T·l, n)
    lens: torch.Tensor,  # (n,) int32
    *,
    T: int,
    d: int,
    l: int,
) -> torch.Tensor:
    """K5: the per-instance Markov EM features Φ (F_pad, n) in the
    canonical layout, for any T, in z_t's dtype; once per fit
    (``pallas_markov.py:1842``).  K1 and K3 then run every iteration from
    it at a cost independent of T.  CUDA tensors launch
    ``csrc/markov_features_longT.cu`` (float32 or float64, contiguous,
    int32 lens, d and l up to 8; bit-identical to the plain version); CPU
    tensors take the plain version."""
    _check_longT_args(z_t, x_t, lens, T, d, l)
    if z_t.device.type == "cpu":
        return markov_materialize_features_longT_plain(z_t, x_t, lens, T=T, d=d, l=l)
    if z_t.device.type != "cuda":
        raise ValueError(f"unsupported device {z_t.device}")
    kinds = {torch.float32: 0, torch.float64: 1}
    if z_t.dtype not in kinds or x_t.dtype != z_t.dtype:
        raise ValueError(f"z_t and x_t must share float32 or float64, got {z_t.dtype}, {x_t.dtype}")
    if lens.dtype != torch.int32:
        raise ValueError(f"lens must be int32, got {lens.dtype}")
    if not (z_t.is_contiguous() and x_t.is_contiguous() and lens.is_contiguous()):
        raise ValueError("z_t, x_t and lens must be contiguous")
    n = z_t.shape[1]
    if n == 0:
        raise ValueError("empty batch")
    lib = _build.library()
    if max(d, l) > lib.mtm_markov_features_longT_max_dim():
        raise ValueError(
            f"d={d}, l={l}: the long-T feature kernel takes at most "
            f"{lib.mtm_markov_features_longT_max_dim()} of each"
        )
    F_pad = _canonical_rows(d, l)
    phi = torch.empty((F_pad, n), dtype=z_t.dtype, device=z_t.device)
    rc = lib.mtm_markov_features_longT(
        _device_index(z_t),
        kinds[z_t.dtype],
        z_t.data_ptr(),
        x_t.data_ptr(),
        lens.data_ptr(),
        phi.data_ptr(),
        n,
        T,
        d,
        l,
        F_pad,
        torch.cuda.current_stream(z_t.device).cuda_stream,
    )
    _build.check(rc, "markov_materialize_features_longT")
    markov_materialize_features_longT.launches += 1
    return phi


markov_materialize_features_longT.launches = 0

# ----------------------------------------------------------------------
# K1: one EM iteration over Φ
# ----------------------------------------------------------------------


def _argmax_first(scores: torch.Tensor):
    """``(max, argmax)`` over axis 0 with ``jnp.argmax``/``jnp.max``
    semantics: the first maximum, and where a column holds a NaN, its
    first NaN and the value NaN (K1, K4a)."""
    best, na = scores.max(dim=0)
    nan = scores.isnan()
    anynan = nan.any(dim=0)
    na = torch.where(anynan, nan.to(torch.uint8).argmax(dim=0), na)
    best = torch.where(anynan, torch.nan, best)
    return best, na.to(torch.int32)


def _argmax_strict(scores: torch.Tensor):
    """``(max, argmax)`` over axis 0 by a strict ``>`` scan from row 0, as
    the multi-restart kernels take it (K3, K4b): a NaN never replaces the
    running best, and a NaN in row 0 stays."""
    best = scores[0]
    na = torch.zeros(scores.shape[1], dtype=torch.int32, device=scores.device)
    for c in range(1, scores.shape[0]):
        upd = scores[c] > best
        na = torch.where(upd, c, na)
        best = torch.where(upd, scores[c], best)
    return best, na


def _em_plain(phi, phi_w, prev, wc, *, assign_mode, strict, forced=False):
    """One restart's EM outputs from a dense score matrix and one-hot
    statistics.  ``phi_w`` is Φ in the weights' dtype; ``phi`` gives the
    statistics' type: exact integer sums (float64, then int64) for int16
    Φ.  A ``forced`` slot takes ``prev`` with switches and objective 0."""
    mode = "prev" if forced else assign_mode
    scores = wc @ phi_w if mode == "argmax" else None  # (C, n)
    na, switches, obj = _estep_outputs(scores, prev, mode, wc.dtype, strict=strict)
    assign, counts, onehot = _assign_counts(na, prev, wc.shape[0])
    if phi.dtype == torch.int16:
        macc = (phi_w.to(torch.float64) @ onehot.to(torch.float64)).to(torch.int64)
    else:
        macc = phi_w @ onehot.to(wc.dtype)
    return assign, counts, switches, macc, obj


def _estep_outputs(scores, prev, assign_mode, dtype, *, strict=False):
    """``(na, switches, obj)`` of the argmax over the (C, n) scores, the
    first maximum with NaN winning or (``strict``) a strict ``>`` scan;
    ``prev`` itself, 0 and 0 under ``assign_mode="prev"``, where ``scores``
    is not read."""
    valid = prev >= 0
    if assign_mode == "prev":
        return (prev, torch.zeros((), dtype=torch.int32, device=prev.device),
                torch.zeros((), dtype=dtype, device=prev.device))
    best, na = (_argmax_strict if strict else _argmax_first)(scores)
    switches = ((na != prev) & valid).sum().to(torch.int32)
    return na, switches, torch.where(valid, best, 0.0).sum()


def _assign_counts(na, prev, C):
    """``(assign, counts, onehot (n, C))``: ``C`` where ``prev < 0``,
    which counts nowhere."""
    valid = prev >= 0
    assign = torch.where(valid, na, C).to(torch.int32)
    clusters = torch.arange(C, dtype=torch.int32, device=prev.device)
    onehot = (assign[:, None] == clusters[None, :]) & valid[:, None]
    return assign, onehot.sum(dim=0).to(torch.int32), onehot


def _check_mode(assign_mode):
    if assign_mode not in ("argmax", "prev"):
        raise ValueError(f"unknown assign_mode {assign_mode!r}")


# dtype codes of the EM kernels' C interface (Φ, weights)
_PHI_KINDS = {torch.int16: 0, torch.float32: 1, torch.float64: 2}
_W_KINDS = {torch.float32: 1, torch.float64: 2}


def _check_clusters(lib, C: int):
    if C > lib.mtm_markov_em_max_clusters():
        raise ValueError(
            f"{C} clusters: the kernel takes at most "
            f"{lib.mtm_markov_em_max_clusters()}"
        )


def markov_em_compact_plain(
    phi: torch.Tensor,
    prev: torch.Tensor,
    wc: torch.Tensor,
    *,
    assign_mode: str = "argmax",
):
    """Plain torch version of :func:`markov_em_compact`: the same outputs
    from a dense score matrix and one-hot statistics.  Under int16 Φ the
    statistics are summed exactly (integer sums in float64, then int64)."""
    _check_mode(assign_mode)
    return _em_plain(
        phi, phi.to(wc.dtype), prev, wc, assign_mode=assign_mode, strict=False
    )


def markov_em_compact(
    phi: torch.Tensor,  # (Fc_pad, n) int16 payload, or wide float
    prev: torch.Tensor,  # (n,) int32; < 0 marks rows to leave out
    wc: torch.Tensor,  # (C, Fc_pad) compact (and scale-) folded weights
    *,
    assign_mode: str = "argmax",
):
    """K1: one EM iteration over Φ with folded weights.

    Returns ``(assign (n,) int32, counts (C,) int32, switches () int32,
    macc (Fc_pad, C), obj ())``: first-max assignments (``prev`` itself
    under ``assign_mode="prev"``), ``C`` where ``prev < 0``; per-cluster
    member counts, switches against ``prev`` and Σ max score over the
    valid rows; and the per-cluster sums of Φ's rows — int64 and exact
    for int16 Φ, else in ``wc``'s dtype.  CUDA tensors launch
    ``csrc/markov_em.cu``; CPU tensors take the plain version."""
    if phi.ndim != 2 or prev.shape != (phi.shape[1],):
        raise ValueError(
            f"phi (Fc_pad, n) and prev (n,) disagree: {tuple(phi.shape)}, "
            f"{tuple(prev.shape)}"
        )
    if wc.ndim != 2 or wc.shape[1] != phi.shape[0]:
        raise ValueError(f"wc must be (C, {phi.shape[0]}), got {tuple(wc.shape)}")
    if not (phi.device == prev.device == wc.device):
        raise ValueError("phi, prev and wc must be on one device")
    _check_mode(assign_mode)
    if phi.device.type == "cpu":
        return markov_em_compact_plain(phi, prev, wc, assign_mode=assign_mode)
    if phi.device.type != "cuda":
        raise ValueError(f"unsupported device {phi.device}")
    if phi.dtype not in _PHI_KINDS or wc.dtype not in _W_KINDS:
        raise ValueError(f"unsupported dtypes phi {phi.dtype}, wc {wc.dtype}")
    if phi.dtype != torch.int16 and phi.dtype != wc.dtype:
        raise ValueError("a wide Φ must have the weights' dtype")
    if prev.dtype != torch.int32:
        raise ValueError(f"prev must be int32, got {prev.dtype}")
    if not (phi.is_contiguous() and prev.is_contiguous() and wc.is_contiguous()):
        raise ValueError("phi, prev and wc must be contiguous")
    Fcp, n = phi.shape
    C = wc.shape[0]
    if n == 0:
        raise ValueError("empty batch")
    lib = _build.library()
    _check_clusters(lib, C)
    argmax = assign_mode == "argmax"
    pk, wk = _PHI_KINDS[phi.dtype], _W_KINDS[wc.dtype]
    quant = phi.dtype == torch.int16
    part_dtype = torch.int32 if quant else wc.dtype
    macc_dtype = torch.int64 if quant else wc.dtype
    nblocks = -(-n // _EM_CHUNK)
    empty = functools.partial(torch.empty, device=phi.device)
    part_stats = empty((nblocks, Fcp, C), dtype=part_dtype)
    part_counts = empty((nblocks, C), dtype=torch.int32)
    part_sw = empty((nblocks,), dtype=torch.int32)
    part_obj = empty((nblocks,), dtype=wc.dtype)
    assign = empty((n,), dtype=torch.int32)
    counts = empty((C,), dtype=torch.int32)
    switches = empty((), dtype=torch.int32)
    macc = empty((Fcp, C), dtype=macc_dtype)
    obj = empty((), dtype=wc.dtype)
    rc = lib.mtm_markov_em(
        _device_index(phi),
        pk,
        wk,
        phi.data_ptr(),
        prev.data_ptr(),
        wc.data_ptr(),
        assign.data_ptr(),
        part_stats.data_ptr(),
        part_counts.data_ptr(),
        part_sw.data_ptr(),
        part_obj.data_ptr(),
        macc.data_ptr(),
        counts.data_ptr(),
        switches.data_ptr(),
        obj.data_ptr(),
        n,
        Fcp,
        C,
        _EM_CHUNK,
        int(argmax),
        torch.cuda.current_stream(phi.device).cuda_stream,
    )
    _build.check(rc, "markov_em_compact")
    markov_em_compact.launches += 1
    return assign, counts, switches, macc, obj


markov_em_compact.launches = 0


def fold_weights(
    Wg: torch.Tensor, *, T: int, d: int, l: int, scale=None
) -> torch.Tensor:
    """K1's weights ``wc (C, Fc_pad)`` from the g-layout ``Wg (C, F)``:
    features that share a Φ row add up, and int16 ``scale`` folds in."""
    pos = _positions(T, d, l, Wg.device)
    Fc_pad = _feature_layout(T, d, l)[0]
    wc = torch.zeros((Wg.shape[0], Fc_pad), dtype=Wg.dtype, device=Wg.device)
    wc.index_add_(1, pos, Wg)
    if scale is not None:
        wc = wc * scale[None, :].to(wc.dtype)
    return wc


def markov_em_from_features(
    phi,  # (Fc_pad, n) tensor or PhiQuant, from markov_materialize_features
    prev_assign: torch.Tensor,  # (n,) int32
    Wg: torch.Tensor,  # (C, F) g-layout weights (+ log π folded)
    *,
    T: int,
    d: int,
    l: int,
    assign_mode: str = "argmax",
):
    """One EM iteration over Φ with the contract of
    ``pallas_markov.py:1464``: ``(assign, counts, switches, g (F, C),
    obj)``.  Folds ``Wg`` into the layout of Φ at this shape
    (:func:`_feature_layout`; and the int16 scales), runs
    K1 (:func:`markov_em_compact`) and unfolds its statistics into the
    g-layout."""
    scale = None
    if isinstance(phi, PhiQuant):
        phi, scale = phi.q, phi.scale
    pos = _positions(T, d, l, Wg.device)
    wc = fold_weights(Wg, T=T, d=d, l=l, scale=scale)
    assign, counts, switches, macc, obj = markov_em_compact(
        phi, prev_assign, wc, assign_mode=assign_mode
    )
    g = macc[pos].to(Wg.dtype)
    if scale is not None:
        g = g * scale[pos][:, None].to(g.dtype)
    return assign, counts, switches, g, obj


# ----------------------------------------------------------------------
# K3: one EM iteration over Φ for R restarts
# ----------------------------------------------------------------------

def _force_vector(force, R: int, device) -> torch.Tensor:
    """``force_prev`` as a contiguous (R,) int32 tensor (zeros for None)."""
    if force is None:
        return torch.zeros((R,), dtype=torch.int32, device=device)
    force = torch.as_tensor(force, device=device)
    if force.shape != (R,):
        raise ValueError(f"force_prev must be ({R},), got {tuple(force.shape)}")
    return force.to(torch.int32).contiguous()


def _check_multi_args(n: int, prev, wc, device):
    if prev.ndim != 2 or prev.shape[1] != n:
        raise ValueError(f"prev must be (R, {n}), got {tuple(prev.shape)}")
    if wc.ndim != 3 or wc.shape[0] != prev.shape[0]:
        raise ValueError(
            f"wc must be (R={prev.shape[0]}, C, Fc_pad), got {tuple(wc.shape)}"
        )
    if not (prev.device == wc.device == device):
        raise ValueError("Φ (or u), prev and wc must be on one device")


def _multi_buffers(R, n, Fcp, C, *, quant, wdtype, device):
    """Outputs ``(assign, counts, switches, macc, obj)`` and partials of
    the R-restart kernels: per block of :func:`_multi_chunk` instances,
    the objective's per ``_EM_CHUNK``."""
    nblocks = -(-n // _multi_chunk(R))
    empty = functools.partial(torch.empty, device=device)
    parts = (
        empty((nblocks, R, Fcp, C), dtype=torch.int32 if quant else wdtype),
        empty((nblocks, R, C), dtype=torch.int32),
        empty((nblocks, R), dtype=torch.int32),
        empty((-(-n // _EM_CHUNK), R), dtype=wdtype),
    )
    outs = (
        empty((R, n), dtype=torch.int32),
        empty((R, C), dtype=torch.int32),
        empty((R,), dtype=torch.int32),
        empty((R, Fcp, C), dtype=torch.int64 if quant else wdtype),
        empty((R,), dtype=wdtype),
    )
    return parts, outs


def markov_em_compact_multi_plain(
    phi: torch.Tensor,
    prev: torch.Tensor,
    wc: torch.Tensor,
    force=None,
    *,
    assign_mode: str = "argmax",
):
    """Plain torch version of :func:`markov_em_compact_multi`: restart by
    restart, the plain math of K1 with the strict argmax and the
    ``force`` slots taking ``prev``."""
    _check_mode(assign_mode)
    R = wc.shape[0]
    force = _force_vector(force, R, phi.device).cpu().tolist()
    phi_w = phi.to(wc.dtype)
    outs = [
        _em_plain(
            phi, phi_w, prev[r], wc[r], assign_mode=assign_mode, strict=True,
            forced=assign_mode == "argmax" and force[r] != 0,
        )
        for r in range(R)
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def markov_em_compact_multi(
    phi: torch.Tensor,  # (Fc_pad, n) int16 payload, or wide float
    prev: torch.Tensor,  # (R, n) int32; < 0 marks rows to leave out
    wc: torch.Tensor,  # (R, C, Fc_pad) folded weights (fold_weights_multi)
    force=None,  # (R,) int/bool; 1 ⇒ the slot takes prev (argmax mode)
    *,
    assign_mode: str = "argmax",
):
    """K3: K1 for R restarts from one Φ.

    Returns ``(assign (R, n) int32, counts (R, C) int32, switches (R,)
    int32, macc (R, Fc_pad, C), obj (R,))``, each restart as K1 gives it
    (bit for bit, objective included, where its scores are finite) but
    with the strict argmax (a NaN score never wins); a ``force`` slot
    takes ``prev`` with switches and objective exactly 0.  CUDA tensors
    launch ``csrc/markov_em_multi.cu``: int16 Φ its tensor-core body
    (``csrc/markov_em_multi_mma.cu``), wide Φ its float one; CPU tensors
    take the plain version."""
    if phi.ndim != 2:
        raise ValueError(f"phi must be (Fc_pad, n), got {tuple(phi.shape)}")
    _check_multi_args(phi.shape[1], prev, wc, phi.device)
    if wc.shape[2] != phi.shape[0]:
        raise ValueError(f"wc must be (R, C, {phi.shape[0]}), got {tuple(wc.shape)}")
    _check_mode(assign_mode)
    if phi.device.type == "cpu":
        return markov_em_compact_multi_plain(
            phi, prev, wc, force, assign_mode=assign_mode
        )
    if phi.device.type != "cuda":
        raise ValueError(f"unsupported device {phi.device}")
    if phi.dtype not in _PHI_KINDS or wc.dtype not in _W_KINDS:
        raise ValueError(f"unsupported dtypes phi {phi.dtype}, wc {wc.dtype}")
    if phi.dtype != torch.int16 and phi.dtype != wc.dtype:
        raise ValueError("a wide Φ must have the weights' dtype")
    if prev.dtype != torch.int32:
        raise ValueError(f"prev must be int32, got {prev.dtype}")
    if not (phi.is_contiguous() and prev.is_contiguous() and wc.is_contiguous()):
        raise ValueError("phi, prev and wc must be contiguous")
    (Fcp, n), (R, C, _F) = phi.shape, wc.shape
    if n == 0:
        raise ValueError("empty batch")
    lib = _build.library()
    _check_clusters(lib, C)
    force = _force_vector(force, R, phi.device)
    quant = phi.dtype == torch.int16
    parts, outs = _multi_buffers(
        R, n, Fcp, C, quant=quant, wdtype=wc.dtype, device=phi.device
    )
    rc = lib.mtm_markov_em_multi(
        _device_index(phi),
        _PHI_KINDS[phi.dtype],
        _W_KINDS[wc.dtype],
        phi.data_ptr(),
        prev.data_ptr(),
        force.data_ptr(),
        wc.data_ptr(),
        outs[0].data_ptr(),
        *(p.data_ptr() for p in parts),
        *(o.data_ptr() for o in outs[3:4] + outs[1:3] + outs[4:]),
        n,
        Fcp,
        C,
        R,
        _multi_chunk(R),
        _EM_CHUNK,
        int(assign_mode == "argmax"),
        torch.cuda.current_stream(phi.device).cuda_stream,
    )
    _build.check(rc, "markov_em_compact_multi")
    markov_em_compact_multi.launches += 1
    return outs


markov_em_compact_multi.launches = 0


def fold_weights_multi(
    Wg: torch.Tensor, *, T: int, d: int, l: int, scale=None
) -> torch.Tensor:
    """K3's weights ``wc (R, C, Fc_pad)`` from ``Wg (R, C, F)``: restart r
    folds exactly as :func:`fold_weights` folds ``Wg[r]`` (at most two
    features share a Φ row, so the sum is the same in any order)."""
    R, C, F = Wg.shape
    return fold_weights(
        Wg.reshape(R * C, F), T=T, d=d, l=l, scale=scale
    ).reshape(R, C, -1)


def markov_em_from_features_multi(
    phi,  # (Fc_pad, n) tensor or PhiQuant, from markov_materialize_features
    lens: torch.Tensor,  # (n,) int32 — the batch size carrier
    prev_assign: torch.Tensor,  # (R, n) int32
    Wg: torch.Tensor,  # (R, C, F) g-layout weights (+ log π folded)
    *,
    T: int,
    d: int,
    l: int,
    assign_mode: str = "argmax",
    force_prev=None,  # (R,) int/bool; 1 ⇒ the slot takes prev
):
    """R-restart EM iteration over Φ with the contract of
    ``pallas_markov.py:1658``: ``(assign (R, n), counts (R, C), switches
    (R,), g (R, F, C), obj (R,))``.  Folds ``Wg`` (and the int16 scales)
    into the layout of Φ at this shape, runs K3
    (:func:`markov_em_compact_multi`) and unfolds its statistics as
    :func:`markov_em_from_features` does, restart by restart."""
    scale = None
    if isinstance(phi, PhiQuant):
        phi, scale = phi.q, phi.scale
    if lens.shape != (phi.shape[1],):
        raise ValueError(f"lens must be ({phi.shape[1]},), got {tuple(lens.shape)}")
    pos = _positions(T, d, l, Wg.device)
    wc = fold_weights_multi(Wg, T=T, d=d, l=l, scale=scale)
    assign, counts, switches, macc, obj = markov_em_compact_multi(
        phi, prev_assign, wc, force_prev, assign_mode=assign_mode
    )
    g = macc[:, pos].to(Wg.dtype)
    if scale is not None:
        g = g * scale[pos][None, :, None].to(g.dtype)
    return assign, counts, switches, g, obj


# ----------------------------------------------------------------------
# K4a/K4b: EM iterations that rebuild Φ from the packed batch
# ----------------------------------------------------------------------


def _packed_acc(u, lens, dtype, *, T: int, d: int, l: int):
    """The (Facc, n) ACC of the packed batch in ``dtype`` (the weights'),
    and its g-layout rows."""
    s, ks, _Facc, _rows = markov_packed_spec(T, d, l)
    acc = _packed_acc_build(u.to(dtype), lens, T=T, d=d, s=s, ks=ks)
    return acc, _acc_rows(T, d, l, u.device)


def _fold_acc(Wg: torch.Tensor, rows: torch.Tensor, Facc: int) -> torch.Tensor:
    """``Wg (…, F)`` folded onto the ACC rows: ``(…, Facc)``."""
    flat = Wg.reshape(-1, Wg.shape[-1])
    wacc = torch.zeros((flat.shape[0], Facc), dtype=Wg.dtype, device=Wg.device)
    wacc.index_add_(1, rows, flat)
    return wacc.reshape(*Wg.shape[:-1], Facc)


def markov_em_fused_packed_plain(
    u, lens, prev_assign, Wg, *, T: int, d: int, l: int,
    assign_mode: str = "argmax",
):
    """Plain torch version of :func:`markov_em_fused_packed`: the ACC
    rows of ``_packed_acc_build`` (the JAX kernel's algebra), then K1's
    plain math over them."""
    _check_features_args(u, lens, T, d, l)
    _check_mode(assign_mode)
    acc, rows = _packed_acc(u, lens, Wg.dtype, T=T, d=d, l=l)
    wacc = _fold_acc(Wg, rows, acc.shape[0])
    assign, counts, switches, macc, obj = _em_plain(
        acc, acc, prev_assign, wacc, assign_mode=assign_mode, strict=False
    )
    return assign, counts, switches, macc[rows], obj


def markov_em_fused_packed_multi_plain(
    u, lens, prev_assign, Wg, *, T: int, d: int, l: int,
    assign_mode: str = "argmax", force_prev=None,
):
    """Plain torch version of :func:`markov_em_fused_packed_multi`: the
    ACC rows, then K3's plain math over them."""
    _check_features_args(u, lens, T, d, l)
    acc, rows = _packed_acc(u, lens, Wg.dtype, T=T, d=d, l=l)
    wacc = _fold_acc(Wg, rows, acc.shape[0])
    assign, counts, switches, macc, obj = markov_em_compact_multi_plain(
        acc, prev_assign, wacc, force_prev,
        assign_mode=assign_mode,
    )
    return assign, counts, switches, macc[:, rows], obj


# K4b's float32 body (csrc/markov_em_packed_mma.cu): a block has at most
# this much shared memory
_MAX_SMEM = 232448


class PackedPlan(NamedTuple):
    """A block of K4b's float32 body: ``nt`` instances a tile (128, 64 or
    32), ``rg`` restarts, ``cs`` blocks a cluster (restart groups of one
    chunk that build each Φ tile once between them) and ``smem`` bytes of
    shared memory."""

    nt: int
    rg: int
    cs: int
    smem: int


def packed_mma_smem(Fcp: int, Ts: int, C: int, rg: int, nt: int, *, argmax: bool) -> int:
    """Shared memory of a block of K4b's float32 body (``packed_smem`` in
    the CUDA source): weights ``(rg, Fcp, CB)`` (under argmax) and
    statistics ``(rg, Fcp, CB + 1)``, the Φ tile ``(Fcp, nt + 1)``, the u
    tile ``(Ts, nt)``, the objective's ``(rg, 128)`` sums, and the ints:
    the row table ``(Fcp,)``, lengths ``(nt,)``, assignments and the
    sorted tile ``(rg, nt)`` each (the latter also the objective's warp
    sums), cluster counts and offsets ``(rg, 2, 33)``, switches
    ``(rg,)``."""
    cb = 8 if C <= 8 else 16 if C <= 16 else 32
    return 4 * (rg * Fcp * ((cb if argmax else 0) + cb + 1) + Fcp * (nt + 1) + Ts * nt + rg * 128
                + Fcp + nt + 2 * rg * nt + 2 * rg * 33 + rg)


def packed_mma_plan(Fcp: int, Ts: int, C: int, R: int, *, argmax: bool = True):
    """The block of K4b's float32 body for Fcp rows of Φ, Ts = T·s rows of
    u, C clusters and R restarts, as a :class:`PackedPlan`: the most
    restarts a block (up to 8), then the widest tile that fits, and as
    many of a chunk's ⌈R / rg⌉ restart groups a cluster as divide them (up
    to 8), so that a chunk's Φ tiles are built ⌈R / (rg · cs)⌉ times; None
    if no block fits."""
    for rg in sorted({min(g, R) for g in (8, 4, 2, 1)}, reverse=True):
        for nt in (128, 64, 32):
            smem = packed_mma_smem(Fcp, Ts, C, rg, nt, argmax=argmax)
            if smem <= _MAX_SMEM:
                groups = -(-R // rg)
                cs = max(q for q in range(1, 9) if groups % q == 0)
                return PackedPlan(nt, rg, cs, smem)
    return None


# Float32 K4a's body (csrc/markov_em_packed_one.cu): threads an instance
# (the kernel's kQ53 for the bench shape's compile-time rows)
_ONE_Q = 4
_SM_SMEM = 233472  # an SM's shared memory for blocks (228 KB)


class PackedOnePlan(NamedTuple):
    """A block of float32 K4a's body: ``nt`` instances a tile (128, 64 or
    32), ``q`` threads an instance building its Φ rows, a ring of ``ring``
    staged u tiles (2, or 1 where two do not fit), ``smem`` bytes of shared memory, ``threads``
    (nt · q) and ``blocks_per_sm`` that the shared memory allows."""

    nt: int
    q: int
    ring: int
    smem: int
    threads: int
    blocks_per_sm: int


class PackedOneLaunch(NamedTuple):
    """Float32 K4a's launch on a device: its plan, then what the runtime
    gives it: blocks an SM (registers and shared memory), SMs, registers
    and local (spill) bytes a thread."""

    nt: int
    q: int
    ring: int
    smem: int
    threads: int
    blocks_per_sm: int
    sms: int
    registers: int
    local_bytes: int


def packed_one_smem(Fcp: int, Ts: int, C: int, nt: int, ring: int, *, argmax: bool) -> int:
    """Shared memory of a block of float32 K4a's body (``one_smem`` in
    the CUDA source): the u ring ``(ring, Ts, nt)``, the weights ``(Fcp,
    CB)`` under argmax, the statistics ``(Fcp, CB + 1)``, the Φ tile
    ``(Fcp, nt + 1)``, then the ints: lengths ``(ring, nt)``, assignments
    and the sorted tile ``(nt,)`` each, the sort's counts and first
    positions ``(2, 33)``, the row table ``(Fcp,)`` and 32 of a block sum's
    scratch.  CB is C rounded up to 8, 16 or 32 (32 under
    ``assign_mode="prev"``)."""
    cb = 32 if not argmax or C > 16 else 16 if C > 8 else 8
    return 4 * (ring * Ts * nt + (Fcp * cb if argmax else 0) + Fcp * (cb + 1) + Fcp * (nt + 1) + ring * nt
                + 2 * nt + 66 + Fcp + 32)


def packed_one_plan(T: int, d: int, l: int, C: int, *, argmax: bool = True):
    """The block of float32 K4a's body for the packed batch of (T, d, l)
    and C clusters, as a :class:`PackedOnePlan`: four threads an instance,
    then the tile that puts the most warps on an SM (at most 16: a thread
    holds up to 128 registers) with a ring of two tiles if one fits, ties
    to the wider tile.  None where no block fits 232 448 bytes."""
    Fcp = markov_compact_spec(T, d, l)[0]
    Ts = T * 8 * ((d + l + 7) // 8)
    q = _ONE_Q
    best = key = None
    for t in (128, 64, 32):
        for r in (2, 1):
            smem = packed_one_smem(Fcp, Ts, C, t, r, argmax=argmax)
            if smem > _MAX_SMEM:
                continue
            blocks = min(_SM_SMEM // (smem + 1024), 2048 // (t * q), 32)
            k = (r > 1, min(blocks * t * q // 32, 16), t)
            if key is None or k > key:
                best, key = PackedOnePlan(t, q, r, smem, t * q, blocks), k
    return best


@functools.lru_cache(maxsize=None)
def _packed_one_config(device: int, T: int, d: int, l: int, C: int, argmax: bool):
    """The :class:`PackedOneLaunch` of float32 K4a at this shape on
    ``device`` (the plan, then the runtime's occupancy), or None where no
    plan exists."""
    plan = packed_one_plan(T, d, l, C, argmax=argmax)
    if plan is None:
        return None
    Fcp, uniq, _pos = markov_compact_spec(T, d, l)
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        rc = _build.library().mtm_markov_em_packed_one_config(
            d, l, int(uniq.shape[0]), Fcp, T * 8 * ((d + l + 7) // 8), C, int(argmax), plan.nt, plan.q, plan.ring,
            out)
    _build.check(rc, "markov_em_fused_packed (its launch)")
    return PackedOneLaunch(plan.nt, plan.q, plan.ring, *out)


def _launch_packed(u, lens, prev, wc, force, *, T, d, l, argmax, strict):
    """Launch ``mtm_markov_em_packed`` (K4a with ``strict=False`` and
    R = 1, K4b with ``strict=True``; float32 K4b on the plan of
    :func:`packed_mma_plan`, float32 K4a on that of :func:`packed_one_plan`
    with a persistent grid and its own partial buffers); returns the
    R-restart outputs."""
    if u.dtype not in _W_KINDS or wc.dtype != u.dtype:
        raise ValueError(
            f"u and the weights must share float32 or float64, got {u.dtype}, "
            f"{wc.dtype}"
        )
    if lens.dtype != torch.int32 or prev.dtype != torch.int32:
        raise ValueError("lens and prev must be int32")
    if not (u.is_contiguous() and lens.is_contiguous() and prev.is_contiguous()):
        raise ValueError("u, lens and prev must be contiguous")
    n = u.shape[1]
    if n == 0:
        raise ValueError("empty batch")
    R, C, Fcp = wc.shape
    lib = _build.library()
    _check_clusters(lib, C)
    Fc = int(markov_compact_spec(T, d, l)[1].shape[0])
    desc = _row_desc(T, d, l, u.device)
    one = None
    if not strict and u.dtype == torch.float32:
        one = _packed_one_config(_device_index(u), T, d, l, C, argmax)
    if one is not None:
        grid = min(-(-n // one.nt), one.blocks_per_sm * one.sms)
        empty = functools.partial(torch.empty, device=u.device)
        parts = (
            empty((grid, Fcp, C), dtype=wc.dtype),
            empty((grid, C), dtype=torch.int32),
            empty((grid,), dtype=torch.int32),
            empty((n + -(-n // _EM_CHUNK),), dtype=wc.dtype),  # each instance's objective entry, each sub's
        )
        outs = (
            empty((R, n), dtype=torch.int32),
            empty((R, C), dtype=torch.int32),
            empty((R,), dtype=torch.int32),
            empty((R, Fcp, C), dtype=wc.dtype),
            empty((R,), dtype=wc.dtype),
        )
        plan_args = (one.nt, one.q, one.ring, d, l, grid)
    else:
        parts, outs = _multi_buffers(
            R, n, Fcp, C, quant=False, wdtype=wc.dtype, device=u.device
        )
        plan = None
        if strict and u.dtype == torch.float32:
            plan = packed_mma_plan(Fcp, u.shape[0], C, R, argmax=argmax)
        plan_args = (*(plan[:3] if plan is not None else (0, 0, 0)), d, l, 0)
    rc = lib.mtm_markov_em_packed(
        _device_index(u),
        _W_KINDS[u.dtype],
        u.data_ptr(),
        lens.data_ptr(),
        desc.data_ptr(),
        prev.data_ptr(),
        force.data_ptr(),
        wc.data_ptr(),
        outs[0].data_ptr(),
        *(p.data_ptr() for p in parts),
        *(o.data_ptr() for o in outs[3:4] + outs[1:3] + outs[4:]),
        n,
        T,
        u.shape[0] // T,
        Fc,
        Fcp,
        C,
        R,
        _multi_chunk(R),
        _EM_CHUNK,
        int(argmax),
        int(strict),
        *plan_args,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(rc, "markov_em_fused_packed" + ("_multi" if strict else ""))
    return outs


def markov_em_fused_packed(
    u: torch.Tensor,  # (T·s, n) from pack_markov_u
    lens: torch.Tensor,  # (n,) int32
    prev_assign: torch.Tensor,  # (n,) int32
    Wg: torch.Tensor,  # (C, F) g-layout weights (+ log π folded)
    *,
    T: int,
    d: int,
    l: int,
    assign_mode: str = "argmax",
):
    """K4a: one EM iteration that rebuilds Φ from the packed batch, with
    the contract of ``pallas_markov.py:727``: ``(assign (n,), counts (C,),
    switches (), g (F, C), obj ())``; the first-maximum argmax of K1.
    CUDA tensors launch ``csrc/markov_em_packed.cu`` at R = 1: float32 its
    staged body (``csrc/markov_em_packed_one.cu``; its assignments, counts
    and switches K1's on K2's float32 Φ bit for bit, its objective float32
    K4b's slot objective bit for bit), float64 the header's body; CPU
    tensors take the plain version."""
    _check_features_args(u, lens, T, d, l)
    _check_mode(assign_mode)
    if prev_assign.shape != lens.shape:
        raise ValueError(f"prev_assign must be {tuple(lens.shape)}")
    if u.device.type == "cpu":
        return markov_em_fused_packed_plain(
            u, lens, prev_assign, Wg, T=T, d=d, l=l, assign_mode=assign_mode
        )
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    wc = fold_weights(Wg, T=T, d=d, l=l)[None]
    force = torch.zeros((1,), dtype=torch.int32, device=u.device)
    assign, counts, switches, macc, obj = _launch_packed(
        u, lens, prev_assign[None], wc, force, T=T, d=d, l=l,
        argmax=assign_mode == "argmax", strict=False,
    )
    markov_em_fused_packed.launches += 1
    g = macc[0][_positions(T, d, l, u.device)]
    return assign[0], counts[0], switches[0], g, obj[0]


markov_em_fused_packed.launches = 0


def markov_em_fused_packed_multi(
    u: torch.Tensor,  # (T·s, n) from pack_markov_u — shared by the restarts
    lens: torch.Tensor,  # (n,) int32
    prev_assign: torch.Tensor,  # (R, n) int32
    Wg: torch.Tensor,  # (R, C, F) g-layout weights (+ log π folded)
    *,
    T: int,
    d: int,
    l: int,
    assign_mode: str = "argmax",
    force_prev=None,  # (R,) int/bool; 1 ⇒ the slot takes prev
):
    """K4b: R-restart EM iteration that rebuilds Φ from the packed batch,
    with the contract of ``pallas_markov.py:898``: ``(assign (R, n),
    counts (R, C), switches (R,), g (R, F, C), obj (R,))``; the strict
    argmax and ``force_prev`` of K3.  CUDA tensors launch
    ``csrc/markov_em_packed.cu``: float32 its own body
    (``csrc/markov_em_packed_mma.cu``), float64 the body K4a runs; CPU
    tensors take the plain version."""
    _check_features_args(u, lens, T, d, l)
    _check_multi_args(u.shape[1], prev_assign, Wg, u.device)
    _check_mode(assign_mode)
    if u.device.type == "cpu":
        return markov_em_fused_packed_multi_plain(
            u, lens, prev_assign, Wg, T=T, d=d, l=l, assign_mode=assign_mode,
            force_prev=force_prev,
        )
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    wc = fold_weights_multi(Wg, T=T, d=d, l=l)
    force = _force_vector(force_prev, Wg.shape[0], u.device)
    assign, counts, switches, macc, obj = _launch_packed(
        u, lens, prev_assign, wc, force, T=T, d=d, l=l,
        argmax=assign_mode == "argmax", strict=True,
    )
    markov_em_fused_packed_multi.launches += 1
    g = macc[:, _positions(T, d, l, u.device)]
    return assign, counts, switches, g, obj


markov_em_fused_packed_multi.launches = 0

# ----------------------------------------------------------------------
# K6, K10, K11: EM passes over the raw NaN-padded batch
# ----------------------------------------------------------------------


class RawBatch(NamedTuple):
    """The transposed batch in its plan's row order, as the long-T trainer
    keeps it for K6: ``z_t (T·d, n)``, ``x_t (T·l, n)``, ``lens (n,)``
    int32, and ``plan`` (``plan.rows``: the caller's row at each
    position; ``plan.extent``: each position's extent)."""

    z_t: torch.Tensor
    x_t: torch.Tensor
    lens: torch.Tensor
    plan: MaskedPlan


def raw_batch_plan(z_t: torch.Tensor, x_t: torch.Tensor, *, T: int, d: int, l: int) -> MaskedPlan:
    """The plan of a transposed batch ``z_t (T·d, n)``, ``x_t (T·l, n)``:
    K7's rule (:func:`.row_plan.masked_plan`) on its ``(T, d, n)`` and
    ``(T, l, n)`` views."""
    n = z_t.shape[1]
    return masked_plan(z_t.view(T, d, n), x_t.view(T, l, n))


def plan_raw_batch(z: torch.Tensor, x: torch.Tensor, lens: torch.Tensor) -> RawBatch:
    """The batch ``z (T, n, d)``, ``x (T, n, l)`` (any strides) transposed
    for K6 in its plan's row order, one copy each (the permutation is
    folded into the transposing copy), with ``lens`` in that order.
    Trainers call it once per fit."""
    T, n, d = z.shape
    l = x.shape[-1]
    zp, xp = z.permute(0, 2, 1), x.permute(0, 2, 1)
    plan = masked_plan(zp, xp)
    return RawBatch(zp.index_select(2, plan.rows).reshape(T * d, n), xp.index_select(2, plan.rows).reshape(T * l, n),
                    lens.to(torch.int32).index_select(0, plan.rows), plan)


def _check_batch_args(z_t, x_t, lens, prev, T, d, l, assign_mode="argmax", plan=None):
    _check_longT_args(z_t, x_t, lens, T, d, l)
    if prev.shape != lens.shape or prev.device != lens.device:
        raise ValueError(f"prev must be ({lens.shape[0]},) on the batch's device, got {tuple(prev.shape)}")
    _check_mode(assign_mode)
    n = lens.shape[0]
    if plan is not None and any(
        a.shape != (n,) or a.dtype != torch.int32 or a.device != lens.device or not a.is_contiguous() for a in plan
    ):
        raise ValueError(f"the plan must be two contiguous int32 ({n},) tensors on the batch's device")


def _in_caller_order(plan, z_t, x_t, lens, prev):
    """The planned batch's columns put back in the caller's order (the
    plain versions' way with a plan: their sums then run over the rows in
    the caller's order, as without one)."""
    rows = plan.rows.long()

    def back(a):
        out = torch.empty_like(a)
        out[..., rows] = a
        return out

    return back(z_t), back(x_t), back(lens), back(prev)


def _planned(plain, z_t, x_t, lens, prev, plan, **kw):
    """``plain`` on a planned batch: the batch in the caller's order, the
    assignments back in the plan's."""
    out = plain(*_in_caller_order(plan, z_t, x_t, lens, prev), **kw)
    return (out[0][plan.rows.long()], *out[1:])


def _kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(p, n), (q, n) → (p·q, n)``, row ``i·q + j`` = ``a_i ⊙ b_j``."""
    return (a[:, None, :] * b[None, :, :]).reshape(-1, a.shape[1])


def _fin(a: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(a), a, 0.0)


class _Batch:
    """The transposed batch per step, as the replaced kernels read it:
    ``z(t)``, ``x(t)`` with non-finite values 0, the transition mask
    ``vm(t) = (len > t+1) & (t < T-1)``, and the end features
    ``[z_0⊗z_0, z_0, len, 1]``."""

    def __init__(self, z_t, x_t, lens, T, d, l):
        self.T, self.n, self.dtype = T, z_t.shape[1], z_t.dtype
        self.z3, self.x3, self.lens = z_t.reshape(T, d, self.n), x_t.reshape(T, l, self.n), lens

    def z(self, t):
        return _fin(self.z3[t])

    def x(self, t):
        return _fin(self.x3[t])

    def vm(self, t):
        return ((self.lens > t + 1) & (t < self.T - 1)).to(self.dtype)[None, :]

    def end(self):
        z0 = self.z(0)
        ones = torch.ones((1, self.n), dtype=self.dtype, device=z0.device)
        return torch.cat([_kron(z0, z0), z0, self.lens.to(self.dtype)[None, :], ones])


def markov_em_fused_longT_plain(
    z_t, x_t, lens, prev_assign, W1, W2, W3, *, T: int, d: int, l: int,
    assign_mode: str = "argmax", plan: MaskedPlan | None = None,
):
    """Plain torch version of :func:`markov_em_fused_longT`, the JAX
    kernels' algebra step by step (``pallas_markov.py:992``, ``:1057``):
    per t the grouped score GEMMs ``W1·[z⊗z, x⊗x, z⊗x] + vm·W2·[z⊗z,
    z⊗zn]`` (plus ``W3`` on the end features at t = 0), the first-max
    argmax, then the statistics as per-t GEMMs against the one-hot, the
    vm_{t+1} groups masked (g2, g3 = z⊗(zn·vm), g7).  With a plan, the
    batch and ``prev_assign`` are in its order and so are the
    assignments; the sums run over the caller's order, so the result is
    the one without a plan bit for bit."""
    _check_batch_args(z_t, x_t, lens, prev_assign, T, d, l, assign_mode, plan)
    if plan is not None:
        return _planned(markov_em_fused_longT_plain, z_t, x_t, lens, prev_assign, plan, W1=W1, W2=W2, W3=W3,
                        T=T, d=d, l=l, assign_mode=assign_mode)
    b = _Batch(z_t, x_t, lens, T, d, l)
    C, dtype = W1.shape[0], z_t.dtype
    scores = None
    if assign_mode == "argmax":
        scores = torch.zeros((C, b.n), dtype=dtype, device=z_t.device)
        for t in range(T):
            zc, zn, xc = b.z(t), b.z(min(t + 1, T - 1)), b.x(t)
            zz = _kron(zc, zc)
            acc = W1 @ torch.cat([zz, _kron(xc, xc), _kron(zc, xc)])
            acc = acc + b.vm(t) * (W2 @ torch.cat([zz, _kron(zc, zn)]))
            scores = scores + acc
            if t == 0:
                scores = scores + W3 @ b.end()
    na, switches, obj = _estep_outputs(scores, prev_assign, assign_mode, dtype)
    assign, counts, onehot = _assign_counts(na, prev_assign, C)
    o = _canonical_offsets(d, l)
    oh = onehot.to(dtype)
    g = torch.zeros((o["F"], C), dtype=dtype, device=z_t.device)

    def add(key, rows):
        g[o[key] : o[key] + rows.shape[0]] += rows

    for t in range(T):
        zc, zn, xc, vm = b.z(t), b.z(min(t + 1, T - 1)), b.x(t), b.vm(t)
        zz = _kron(zc, zc)
        ga = torch.cat([zz, _kron(xc, xc), _kron(zc, xc), zc, xc]) @ oh
        gb = torch.cat([vm * zz, _kron(zc, zn * vm), vm * zc]) @ oh
        for key, rows in zip(("g1", "g4", "g5", "g8", "g9"), ga.split([d * d, l * l, d * l, d, l])):
            add(key, rows)
        for key, rows in zip(("g2", "g3", "g7"), gb.split([d * d, d * d, d])):
            add(key, rows)
        if t == 0:
            gc = b.end() @ oh
            for key, rows in zip(("g6", "g10", "len", "one"), gc.split([d * d, d, 1, 1])):
                add(key, rows)
    return assign, counts, switches, g, obj


def markov_assign_suffix_plain(
    z_t, x_t, lens, prev_assign, W1, W2, W3, *, T: int, d: int, l: int, plan: MaskedPlan | None = None
):
    """Plain torch version of :func:`markov_assign_suffix`, the JAX
    kernel's features in its order (``pallas_markov.py:165``): per t
    ``W1·[z⊗z, x⊗x, z⊗x]``, per t < T-1 ``W2·[vm·z⊗z, z⊗z_{t+1}]`` (the
    missing z_{t+1} read as 0), then ``W3`` on the end features; the
    first-max argmax.  A plan as in :func:`markov_em_fused_longT_plain`."""
    _check_batch_args(z_t, x_t, lens, prev_assign, T, d, l, plan=plan)
    if plan is not None:
        return _planned(markov_assign_suffix_plain, z_t, x_t, lens, prev_assign, plan, W1=W1, W2=W2, W3=W3,
                        T=T, d=d, l=l)
    b = _Batch(z_t, x_t, lens, T, d, l)
    scores = torch.zeros((W1.shape[0], b.n), dtype=z_t.dtype, device=z_t.device)
    for t in range(T):
        zc, xc = b.z(t), b.x(t)
        scores = scores + W1 @ torch.cat([_kron(zc, zc), _kron(xc, xc), _kron(zc, xc)])
    for t in range(T - 1):
        zc = b.z(t)
        scores = scores + W2 @ torch.cat([b.vm(t) * _kron(zc, zc), _kron(zc, b.z(t + 1))])
    scores = scores + W3 @ b.end()
    na, switches, _obj = _estep_outputs(scores, prev_assign, "argmax", z_t.dtype)
    assign, counts, _onehot = _assign_counts(na, prev_assign, W1.shape[0])
    return assign, counts, switches


def markov_em_fused_plain(
    z_t, x_t, lens, prev_assign, Wg, *, T: int, d: int, l: int,
    assign_mode: str = "argmax", plan: MaskedPlan | None = None,
):
    """Plain torch version of :func:`markov_em_fused`, the JAX kernel's
    algebra (``pallas_markov.py:320``): the g-layout features summed over
    t (g2 and g7 under vm_{t+1}, g3 = Σ_{t<T-1} z_t⊗z_{t+1} with a
    missing z_{t+1} read as 0), the scores ``Wg·g``, the first-max argmax
    and the statistics ``g·onehotᵀ``.  A plan as in
    :func:`markov_em_fused_longT_plain`."""
    _check_batch_args(z_t, x_t, lens, prev_assign, T, d, l, assign_mode, plan)
    if plan is not None:
        return _planned(markov_em_fused_plain, z_t, x_t, lens, prev_assign, plan, Wg=Wg, T=T, d=d, l=l,
                        assign_mode=assign_mode)
    b = _Batch(z_t, x_t, lens, T, d, l)
    o = _canonical_offsets(d, l)
    dd = d * d
    g = torch.zeros((o["F"], b.n), dtype=z_t.dtype, device=z_t.device)
    for t in range(T):
        zc, xc = b.z(t), b.x(t)
        zz = _kron(zc, zc)
        g[o["g1"] : o["g1"] + dd] += zz
        g[o["g4"] : o["g4"] + l * l] += _kron(xc, xc)
        g[o["g5"] : o["g5"] + d * l] += _kron(zc, xc)
        g[o["g8"] : o["g8"] + d] += zc
        g[o["g9"] : o["g9"] + l] += xc
        if t < T - 1:
            vm = b.vm(t)
            g[o["g2"] : o["g2"] + dd] += vm * zz
            g[o["g3"] : o["g3"] + dd] += _kron(zc, b.z(t + 1))
            g[o["g7"] : o["g7"] + d] += vm * zc
    end = b.end()
    g[o["g6"] : o["g6"] + dd] = end[:dd]
    g[o["g10"] :] = end[dd:]
    return _em_plain(g, g, prev_assign, Wg, assign_mode=assign_mode, strict=False)


@functools.lru_cache(maxsize=None)
def _batch_config(device: int, kind: int, d: int, l: int, F_pad: int, C: int, argmax: bool, stats: bool):
    """The batch kernel's launch for a shape on a device: ``(tile, blocks
    an SM, stages, SMs)`` (``mtm_markov_em_batch_config``)."""
    cfg = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        rc = _build.library().mtm_markov_em_batch_config(kind, d, l, F_pad, C, int(argmax), int(stats), cfg)
    _build.check(rc, "markov_em_batch_config")
    return cfg[0], cfg[3], cfg[4], cfg[5]


def _launch_batch(z_t, x_t, lens, prev, Wc, *, T, d, l, argmax, stats, plan, what):
    """Launch ``mtm_markov_em_batch`` with the canonical weights ``Wc (C,
    F)`` (each row stopping at its extent under a plan); returns
    ``(assign, counts, switches, g (F, C), obj)``."""
    kinds = {torch.float32: 0, torch.float64: 1}
    if z_t.dtype not in kinds or x_t.dtype != z_t.dtype or Wc.dtype != z_t.dtype:
        raise ValueError(
            f"z_t, x_t and the weights must share float32 or float64, got {z_t.dtype}, "
            f"{x_t.dtype}, {Wc.dtype}"
        )
    if lens.dtype != torch.int32 or prev.dtype != torch.int32:
        raise ValueError("lens and prev must be int32")
    if not all(t.is_contiguous() for t in (z_t, x_t, lens, prev)):
        raise ValueError("z_t, x_t, lens and prev must be contiguous")
    if Wc.device != z_t.device:
        raise ValueError("the weights must be on the batch's device")
    n, C = z_t.shape[1], Wc.shape[0]
    if n == 0:
        raise ValueError("empty batch")
    lib = _build.library()
    _check_clusters(lib, C)
    if max(d, l) > lib.mtm_markov_features_longT_max_dim():
        raise ValueError(f"d={d}, l={l}: the batch kernel takes at most {lib.mtm_markov_features_longT_max_dim()} of each")
    F = Wc.shape[1]
    F_pad = _canonical_rows(d, l)
    wc = torch.zeros((C, F_pad), dtype=Wc.dtype, device=Wc.device)
    wc[:, :F] = Wc
    dev = _device_index(z_t)
    tile, blocks, stages, sms = _batch_config(dev, kinds[z_t.dtype], d, l, F_pad, C, argmax, stats)
    grid = min(-(-n // tile), blocks * sms)
    empty = functools.partial(torch.empty, device=z_t.device)
    part_stats = empty((grid if stats else 1, F_pad, C), dtype=z_t.dtype)
    part_counts = empty((grid, C), dtype=torch.int32)
    part_sw = empty((grid,), dtype=torch.int32)
    part_obj = empty((grid,), dtype=z_t.dtype)
    assign = empty((n,), dtype=torch.int32)
    counts = empty((C,), dtype=torch.int32)
    switches = empty((), dtype=torch.int32)
    macc = empty((F_pad, C), dtype=z_t.dtype)
    obj = empty((), dtype=z_t.dtype)
    rc = lib.mtm_markov_em_batch(
        dev,
        kinds[z_t.dtype],
        z_t.data_ptr(),
        x_t.data_ptr(),
        lens.data_ptr(),
        None if plan is None else plan.extent.data_ptr(),
        prev.data_ptr(),
        wc.data_ptr(),
        assign.data_ptr(),
        part_stats.data_ptr(),
        part_counts.data_ptr(),
        part_sw.data_ptr(),
        part_obj.data_ptr(),
        macc.data_ptr(),
        counts.data_ptr(),
        switches.data_ptr(),
        obj.data_ptr(),
        n,
        T,
        d,
        l,
        F_pad,
        C,
        tile,
        stages,
        grid,
        int(argmax),
        int(stats),
        torch.cuda.current_stream(z_t.device).cuda_stream,
    )
    _build.check(rc, what)
    return assign, counts, switches, macc[:F], obj


def markov_em_fused_longT(
    z_t: torch.Tensor,  # (T·d, n) transposed latent batch (NaN-padded)
    x_t: torch.Tensor,  # (T·l, n)
    lens: torch.Tensor,  # (n,) int32
    prev_assign: torch.Tensor,  # (n,) int32; < 0 marks rows to leave out
    W1: torch.Tensor,  # (C, d²+l²+dl) per-step weights
    W2: torch.Tensor,  # (C, 2d²) vm_{t+1} weights
    W3: torch.Tensor,  # (C, d²+d+2) end weights (+ log π folded)
    *,
    T: int,
    d: int,
    l: int,
    assign_mode: str = "argmax",
    plan: MaskedPlan | None = None,  # the rows' order (plan_raw_batch); None: the caller's, all T
):
    """K6: one EM pass over the raw batch at any T, with the contract of
    ``pallas_markov.py:1148``: ``(assign (n,) int32, counts (C,) int32,
    switches () int32, g (F, C), obj ())``: first-max assignments (``prev``
    itself under ``assign_mode="prev"``, with switches and objective 0),
    ``C`` where ``prev < 0`` (such rows count nowhere), the g-layout
    statistics and Σ max score over the valid rows.  The contract is
    suffix data: each instance's NaNs start at its length, where the
    kernel's transition products equal the JAX kernels'.  With a plan
    (:class:`RawBatch`), ``z_t``, ``x_t``, ``lens``, ``prev_assign`` and
    the assignments are in its order and each row stops at its extent;
    without one, every row runs to T in the order given.  CUDA tensors
    launch ``csrc/markov_em_batch.cu`` on the folded canonical weights
    (float32 or float64, contiguous, int32 lens and prev, d and l up to
    8); CPU tensors take the plain version."""
    _check_batch_args(z_t, x_t, lens, prev_assign, T, d, l, assign_mode, plan)
    if z_t.device.type == "cpu":
        return markov_em_fused_longT_plain(
            z_t, x_t, lens, prev_assign, W1, W2, W3, T=T, d=d, l=l, assign_mode=assign_mode, plan=plan
        )
    if z_t.device.type != "cuda":
        raise ValueError(f"unsupported device {z_t.device}")
    out = _launch_batch(
        z_t, x_t, lens, prev_assign, canonical_weights(W1, W2, W3, d=d, l=l), T=T, d=d, l=l,
        argmax=assign_mode == "argmax", stats=True, plan=plan, what="markov_em_fused_longT",
    )
    markov_em_fused_longT.launches += 1
    return out


markov_em_fused_longT.launches = 0


def markov_assign_suffix(
    z_t: torch.Tensor,  # (T·d, n) transposed latent batch (NaN-padded)
    x_t: torch.Tensor,  # (T·l, n)
    lens: torch.Tensor,  # (n,) int32
    prev_assign: torch.Tensor,  # (n,) int32; < 0 marks rows to leave out
    W1: torch.Tensor,
    W2: torch.Tensor,
    W3: torch.Tensor,  # log π folded into W3[:, -1]
    *,
    T: int,
    d: int,
    l: int,
    plan: MaskedPlan | None = None,
):
    """K10: the E step over the raw batch, with the contract of
    ``pallas_markov.py:245``: ``(assign (n,) int32, counts (C,) int32,
    switches () int32)``, the first-max argmax of ``markov_suffix_logliks
    + log π`` on suffix data.  A plan as in :func:`markov_em_fused_longT`.
    CUDA tensors launch ``csrc/markov_em_batch.cu`` without its
    statistics; CPU tensors take the plain version."""
    _check_batch_args(z_t, x_t, lens, prev_assign, T, d, l, plan=plan)
    if z_t.device.type == "cpu":
        return markov_assign_suffix_plain(z_t, x_t, lens, prev_assign, W1, W2, W3, T=T, d=d, l=l, plan=plan)
    if z_t.device.type != "cuda":
        raise ValueError(f"unsupported device {z_t.device}")
    assign, counts, switches, _g, _obj = _launch_batch(
        z_t, x_t, lens, prev_assign, canonical_weights(W1, W2, W3, d=d, l=l), T=T, d=d, l=l,
        argmax=True, stats=False, plan=plan, what="markov_assign_suffix",
    )
    markov_assign_suffix.launches += 1
    return assign, counts, switches


markov_assign_suffix.launches = 0


def markov_em_fused(
    z_t: torch.Tensor,  # (T·d, n) transposed latent batch (NaN-padded)
    x_t: torch.Tensor,  # (T·l, n)
    lens: torch.Tensor,  # (n,) int32
    prev_assign: torch.Tensor,  # (n,) int32; < 0 marks rows to leave out
    Wg: torch.Tensor,  # (C, F) g-layout weights (+ log π folded)
    *,
    T: int,
    d: int,
    l: int,
    assign_mode: str = "argmax",
    plan: MaskedPlan | None = None,
):
    """K11: K6's contract from the canonical weights ``Wg (C, F)``
    (``pallas_markov.py:438``): ``(assign, counts, switches, g (F, C),
    obj)``; under ``assign_mode="prev"`` the statistics are taken under
    ``prev`` itself.  A plan as in :func:`markov_em_fused_longT`.  CUDA
    tensors launch ``csrc/markov_em_batch.cu``; CPU tensors take the
    plain version."""
    _check_batch_args(z_t, x_t, lens, prev_assign, T, d, l, assign_mode, plan)
    if z_t.device.type == "cpu":
        return markov_em_fused_plain(z_t, x_t, lens, prev_assign, Wg, T=T, d=d, l=l, assign_mode=assign_mode,
                                     plan=plan)
    if z_t.device.type != "cuda":
        raise ValueError(f"unsupported device {z_t.device}")
    out = _launch_batch(
        z_t, x_t, lens, prev_assign, Wg, T=T, d=d, l=l,
        argmax=assign_mode == "argmax", stats=True, plan=plan, what="markov_em_fused",
    )
    markov_em_fused.launches += 1
    return out


markov_em_fused.launches = 0

"""K16: the Φ stream probe, ``seed·0 + Σφ`` over a whole feature matrix.

Counterpart of the TPU kernel ``drivers/bench-phi-floor.py:stream_kernel``
(its ``pallas_call`` at :111), which the JAX driver chains through a loop
carry to measure the bare read rate of an (F, n) Φ at each storage width.
:func:`phi_stream_sum` computes what that kernel computes: float32 and
bfloat16 summed as float, int16 widened and summed modulo 2³² (the JAX
int32 sum wraps), each result ``seed·0 + Σφ``, so a NaN seed gives NaN and
each call depends on the one before it.

CUDA tensors launch ``csrc/phi_stream.cu`` (contiguous, 16-byte aligned
Φ; anything else raises) and count the launch in
``phi_stream_sum.launches``; CPU tensors take :func:`phi_stream_sum_plain`.
Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

import functools

import torch

from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops.markov_kernels import _device_index

__all__ = ["accumulator_dtype", "phi_stream_sum", "phi_stream_sum_plain", "tile_vectors"]

_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2}
# a tile is a multiple of the kernel's 256 threads' 16-byte vectors
_TILE_VECS_STEP = 256
_DEFAULT_TILE_VECS = 1024


def accumulator_dtype(phi_dtype: torch.dtype) -> torch.dtype:
    """The dtype of the seed and the result: int32 for int16 Φ, else
    float32 (the JAX kernel's ``acc_dtype``)."""
    if phi_dtype not in _KINDS:
        raise ValueError(f"phi must be float32, bfloat16 or int16, got {phi_dtype}")
    return torch.int32 if phi_dtype == torch.int16 else torch.float32


def _check(phi: torch.Tensor, seed: torch.Tensor) -> None:
    acc = accumulator_dtype(phi.dtype)
    if seed.dtype != acc or seed.numel() != 1:
        raise ValueError(f"seed must be one {acc} value, got {seed.dtype} of shape {tuple(seed.shape)}")
    if seed.device != phi.device:
        raise ValueError("phi and seed must be on one device")


def phi_stream_sum_plain(phi: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The plain version: ``seed·0 + Σφ`` with the sum in float64 for
    float32 and bfloat16 Φ (a 0-d float64 tensor), and for int16 in int64,
    then wrapped to int32 (a 0-d int32 tensor)."""
    _check(phi, seed)
    if phi.dtype == torch.int16:
        total = phi.to(torch.int64).sum()
        wrapped = ((total + 2**31) % 2**32) - 2**31
        return (seed.reshape(()).to(torch.int64) * 0 + wrapped).to(torch.int32)
    return seed.reshape(()).to(torch.float64) * 0 + phi.double().sum()


@functools.cache
def _blocks(device: int, kind: int, n: int, tile_vecs: int) -> int:
    got = _build.library().mtm_phi_stream_blocks(device, kind, n, tile_vecs)
    if got == -1:
        raise _build.KernelArgumentError(f"phi_stream: no launch for kind {kind}, n={n}, tile={tile_vecs}")
    if got < 0:
        _build.check(-got, "phi_stream blocks")
    return got


def tile_vectors(phi_dtype: torch.dtype, tile: int | None) -> int:
    """The 16-byte vectors of a tile of ``tile`` elements (the JAX
    driver's ``--bn``; None: the default 1024 vectors); raises unless it
    is a positive multiple of 256 vectors."""
    if tile is None:
        return _DEFAULT_TILE_VECS
    per_vec = 16 // torch.empty((), dtype=phi_dtype).element_size()
    if tile <= 0 or tile % (per_vec * _TILE_VECS_STEP):
        raise ValueError(
            f"tile must be a positive multiple of {per_vec * _TILE_VECS_STEP} elements for {phi_dtype}, got {tile}"
        )
    return tile // per_vec


def phi_stream_sum(phi: torch.Tensor, seed: torch.Tensor, *, tile: int | None = None) -> torch.Tensor:
    """K16: ``seed·0 + Σφ`` over every element of ``phi`` (float32,
    bfloat16 or int16, any shape), as a 0-d float32 tensor (int32 for int16
    Φ).  ``seed`` is one value of that dtype on ``phi``'s device.  ``tile``
    is the elements a block streams a step (:func:`tile_vectors`).  On the
    card ``phi`` must be contiguous and 16-byte aligned; on the CPU the
    plain version runs, its result cast to the kernel's dtype (the tile is
    checked and has no other effect)."""
    _check(phi, seed)
    acc = accumulator_dtype(phi.dtype)
    tile_vecs = tile_vectors(phi.dtype, tile)
    if phi.device.type == "cpu":
        return phi_stream_sum_plain(phi, seed).to(acc)
    if phi.device.type != "cuda":
        raise ValueError(f"unsupported device {phi.device}")
    if not phi.is_contiguous():
        raise ValueError("phi must be contiguous")
    if phi.data_ptr() % 16:
        raise ValueError("phi must be 16-byte aligned")
    if not seed.is_contiguous():
        raise ValueError("seed must be contiguous")
    dev, kind, n = _device_index(phi), _KINDS[phi.dtype], phi.numel()
    blocks = _blocks(dev, kind, n, tile_vecs)
    part = torch.empty(blocks, dtype=torch.float64, device=phi.device)
    out = torch.empty((), dtype=acc, device=phi.device)
    rc = _build.library().mtm_phi_stream(
        dev, kind, phi.data_ptr(), n, tile_vecs, seed.data_ptr(), part.data_ptr(), blocks, out.data_ptr(),
        torch.cuda.current_stream(phi.device).cuda_stream,
    )
    _build.check(rc, "phi_stream_sum")
    phi_stream_sum.launches += 1
    return out


phi_stream_sum.launches = 0

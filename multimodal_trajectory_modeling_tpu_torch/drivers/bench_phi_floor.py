"""Streaming-floor probe for the materialized feature matrix Φ: the bare
read rate of an (F, n) stream at each storage width, measured with K16
(``ops/phi_stream.py``, ``csrc/phi_stream.cu``).

Counterpart of ``drivers/bench-phi-floor.py``.  The same data (Φ = the
normals of ``default_rng(0)``; int16 as ``clip(base·1000, ±32000)``), the
same CLI (``--bn`` is the tile, in elements, that a block streams a step)
and the same final JSON line (``rows``, ``n``, ``results`` of ``dtype``,
``bn``, ``ms``, ``gbps``).  Timing: one warm call, then ``--iters`` calls
chained through the accumulator (each call's seed is the last call's
result), between two CUDA events, the clock stopped after a device
synchronization; on the CPU (``MTM_DEVICE=cpu``: the plain version) by
the host's clock.

Usage::

    python -m multimodal_trajectory_modeling_tpu_torch.drivers.bench_phi_floor \\
        [--n 1000000] [--rows 112] [--iters 30] [--bn 8192,16384] \\
        [--dtypes f32,i16,bf16]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from multimodal_trajectory_modeling_tpu_torch.device import resolve_device
from multimodal_trajectory_modeling_tpu_torch.drivers import configure_from_env
from multimodal_trajectory_modeling_tpu_torch.ops import phi_stream as ps

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i16": torch.int16}


def make_phi(base: np.ndarray, dt: str, device) -> torch.Tensor:
    """The driver's Φ of storage width ``dt`` on ``device``."""
    if dt not in _DTYPES:
        raise SystemExit(f"unknown dtype {dt}")
    if dt == "i16":
        return torch.tensor(np.clip(base * 1000, -32000, 32000).astype(np.int16), device=device)
    return torch.tensor(base, device=device).to(_DTYPES[dt])


def time_chain(phi: torch.Tensor, tile: int, iters: int) -> tuple[float, float, torch.Tensor]:
    """``(seconds of the first call, ms a call, the last call's result)``
    over ``iters`` calls chained through the accumulator.  Each call gives
    ``seed·0 + Σφ``, so the last result is one call's sum."""
    seed = torch.zeros((), dtype=ps.accumulator_dtype(phi.dtype), device=phi.device)
    cuda = phi.device.type == "cuda"
    t0 = time.perf_counter()
    acc = ps.phi_stream_sum(phi, seed, tile=tile)
    acc.item()  # barrier
    t_first = time.perf_counter() - t0
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            acc = ps.phi_stream_sum(phi, acc, tile=tile)
        end.record()
        torch.cuda.synchronize(phi.device)
        return t_first, start.elapsed_time(end) / iters, acc
    t0 = time.perf_counter()
    for _ in range(iters):
        acc = ps.phi_stream_sum(phi, acc, tile=tile)
    acc.item()
    return t_first, (time.perf_counter() - t0) * 1e3 / iters, acc


def main(argv=None) -> dict:
    """Run the probe; returns the printed JSON object with ``sums`` added:
    for each ``(dtype, bn)`` the last chained call's result, a 0-d tensor
    on the device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--rows", type=int, default=112, help="feature rows (compact-layout Fc_pad at the headline shape)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--bn", type=str, default="8192,16384")
    ap.add_argument("--dtypes", type=str, default="f32,i16,bf16")
    args = ap.parse_args(argv)
    configure_from_env()
    dev = resolve_device(None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device: {dev.type} {name}")

    F, n = args.rows, args.n
    rng = np.random.default_rng(0)
    base = rng.normal(size=(F, n)).astype(np.float32)
    results, sums = [], []
    for dt in args.dtypes.split(","):
        phi = make_phi(base, dt, dev)
        nbytes = phi.numel() * phi.element_size()
        for bn in [int(v) for v in args.bn.split(",")]:
            t_first, ms, acc = time_chain(phi, bn, args.iters)
            gbps = nbytes / (ms * 1e-3) / 1e9
            print(
                f"{dt:5s} bn={bn:6d}  {ms:7.3f} ms/pass  {gbps:7.1f} GB/s  "
                f"({nbytes / 2**20:.0f} MiB payload, first {t_first:.1f}s)"
            )
            results.append({"dtype": dt, "bn": bn, "ms": ms, "gbps": gbps})
            sums.append({"dtype": dt, "bn": bn, "sum": acc})
        del phi
    out = {"rows": F, "n": n, "results": results}
    print(json.dumps(out))
    return {**out, "sums": sums}


if __name__ == "__main__":
    main()

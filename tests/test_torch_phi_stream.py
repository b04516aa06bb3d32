"""K16, the Φ stream probe (``ops/phi_stream.py``): the port's plain version
against the JAX driver's Pallas kernel in interpret mode, and the port's
driver against the JAX driver.

``stream_kernel`` is a closure inside ``drivers/bench-phi-floor.py``'s
``main()`` and cannot be imported, so :func:`_jax_stream` transcribes that
driver's :68-126 (the kernel body and the chained ``pallas_call`` over a
padded Φ) and runs it with ``interpret=True``.  Tolerances: int16 equal
(both wrap modulo 2³²), float32 and bfloat16 within 2e-6·Σ|φ| of the
float64 sum (the JAX kernel sums in float32); a NaN seed gives NaN.  The
CUDA kernel itself is held to the plain version on the card in
``tests/test_torch_cuda_kernels.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu_torch.ops import phi_stream as ps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_stream(phi_np, dtype_name, bn, seed_value, K=1):
    """``drivers/bench-phi-floor.py:68-126``: K chained launches of the
    stream kernel over Φ padded to a multiple of ``bn`` columns."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    acc_dtype = jnp.float32 if dtype_name != "i16" else jnp.int32

    def kernel(seed_ref, phi_ref, out_ref):
        blk = phi_ref[...]
        if dtype_name == "i16":
            s = jnp.sum(blk.astype(jnp.int32))
        else:
            s = jnp.sum(blk.astype(jnp.float32))
        s = s.astype(acc_dtype).reshape(1, 1)

        @pl.when(pl.program_id(0) == 0)
        def _():
            out_ref[:, :] = seed_ref[:, :] * 0 + s

        @pl.when(pl.program_id(0) != 0)
        def _():
            out_ref[:, :] = out_ref[:, :] + s

    phi = jnp.asarray(phi_np, jnp.bfloat16) if dtype_name == "bf16" else jnp.asarray(phi_np)
    F, n = phi.shape
    n_pad = -(-n // bn) * bn
    phi_p = jnp.pad(phi, ((0, 0), (0, n_pad - n)))

    def body(i, acc):
        out = pl.pallas_call(
            kernel,
            grid=(n_pad // bn,),
            in_specs=[
                pl.BlockSpec((1, 1), lambda j: (0, 0)),
                pl.BlockSpec((F, bn), lambda j: (0, j)),
            ],
            out_specs=pl.BlockSpec((1, 1), lambda j: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((1, 1), acc_dtype),
            interpret=True,
        )(acc.reshape(1, 1), phi_p)
        return out[0, 0]

    return np.asarray(jax.lax.fori_loop(0, K, body, jnp.asarray(seed_value, acc_dtype)))


def _phi(dtype_name):
    base = np.random.default_rng(0).normal(size=(8, 5000)).astype(np.float32)
    if dtype_name == "i16":
        return np.clip(base * 1000, -32000, 32000).astype(np.int16)
    return base


_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "i16": torch.int16}


@pytest.mark.parametrize("dtype_name", ["f32", "bf16", "i16"])
@pytest.mark.parametrize("chained", [1, 2])
def test_plain_matches_jax_kernel(dtype_name, chained):
    phi_np = _phi(dtype_name)
    want = _jax_stream(phi_np, dtype_name, 1024, 0, K=chained)
    phi = torch.tensor(phi_np).to(_TORCH[dtype_name])
    seed = torch.zeros((), dtype=ps.accumulator_dtype(phi.dtype))
    got = seed
    for _ in range(chained):
        got = ps.phi_stream_sum(phi, got)
    plain = ps.phi_stream_sum_plain(phi, seed)
    assert got.dtype == ps.accumulator_dtype(phi.dtype)
    if dtype_name == "i16":
        assert int(plain) == int(got) == int(want)
    else:
        scale = float(phi.double().abs().sum())
        assert abs(float(plain) - float(want)) <= 2e-6 * scale
        assert abs(float(got) - float(want)) <= 2e-6 * scale


@pytest.mark.parametrize("dtype_name", ["f32", "bf16", "i16"])
def test_driver_chain_ends_on_one_call_s_sum(dtype_name):
    """The port driver's timed chain at each of its tiles returns the last
    call's result, one call's Σφ: the plain version's, and the JAX chain's
    at that ``bn``."""
    from multimodal_trajectory_modeling_tpu_torch.drivers import bench_phi_floor as pbf

    phi_np = _phi(dtype_name)
    phi = pbf.make_phi(np.random.default_rng(0).normal(size=(8, 5000)).astype(np.float32), dtype_name, "cpu")
    assert np.array_equal(phi.float().numpy(), torch.tensor(phi_np).to(_TORCH[dtype_name]).float().numpy())
    plain = ps.phi_stream_sum_plain(phi, torch.zeros((), dtype=ps.accumulator_dtype(phi.dtype)))
    scale = float(phi.double().abs().sum())
    for bn in (8192, 16384):
        _, ms, got = pbf.time_chain(phi, bn, 2)
        want = _jax_stream(phi_np, dtype_name, bn, 0, K=3)
        assert ms > 0 and got.dtype == ps.accumulator_dtype(phi.dtype)
        if dtype_name == "i16":
            assert int(got) == int(plain) == int(want)
        else:
            assert abs(float(got) - float(plain)) <= 2e-6 * scale
            assert abs(float(want) - float(plain)) <= 2e-6 * scale


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_nan_seed_gives_nan(dtype_name):
    phi_np = _phi(dtype_name)
    assert np.isnan(_jax_stream(phi_np, dtype_name, 1024, np.nan))
    phi = torch.tensor(phi_np).to(_TORCH[dtype_name])
    assert bool(torch.isnan(ps.phi_stream_sum(phi, torch.tensor(float("nan")))))
    assert bool(torch.isnan(ps.phi_stream_sum_plain(phi, torch.tensor(float("inf")))))


def test_int16_sum_wraps_as_int32():
    phi = torch.full((4, 1 << 16), 32767, dtype=torch.int16)
    total = 4 * (1 << 16) * 32767
    want = (total + 2**31) % 2**32 - 2**31
    assert int(ps.phi_stream_sum(phi, torch.zeros((), dtype=torch.int32))) == want
    assert int(_jax_stream(phi.numpy(), "i16", 8192, 0)) == want


def test_arguments_are_checked():
    phi = torch.zeros((8, 4096))
    with pytest.raises(ValueError):
        ps.phi_stream_sum(phi, torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError):
        ps.phi_stream_sum(phi.double(), torch.zeros((), dtype=torch.float64))
    with pytest.raises(ValueError):
        ps.phi_stream_sum(phi, torch.zeros(()), tile=1000)  # not a multiple of 256 vectors
    assert ps.tile_vectors(torch.float32, 8192) == 2048
    assert ps.tile_vectors(torch.int16, 16384) == 2048


def test_port_driver_prints_the_jax_drivers_json(tmp_path):
    """Both drivers at ``--n 5000 --rows 8 --iters 2`` end with one JSON
    line of the same keys, dtypes and tiles."""
    args = ["--n", "5000", "--rows", "8", "--iters", "2"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", MTM_DEVICE="cpu", PYTHONPATH=REPO)
    outs = []
    for cmd in (
        [sys.executable, os.path.join(REPO, "drivers", "bench-phi-floor.py"), *args],
        [sys.executable, "-m", "multimodal_trajectory_modeling_tpu_torch.drivers.bench_phi_floor", *args],
    ):
        proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    jax_out, port_out = outs
    assert set(port_out) == set(jax_out) == {"rows", "n", "results"}
    assert (port_out["rows"], port_out["n"]) == (jax_out["rows"], jax_out["n"]) == (8, 5000)
    assert [(r["dtype"], r["bn"]) for r in port_out["results"]] == [(r["dtype"], r["bn"]) for r in jax_out["results"]]
    for r in port_out["results"]:
        assert set(r) == {"dtype", "bn", "ms", "gbps"}
        assert r["ms"] > 0 and r["gbps"] > 0

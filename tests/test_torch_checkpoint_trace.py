"""The port's step checkpoints and profiler hook (``utils/checkpoint.py``,
``utils/trace.profile``), float64 on the CPU, mirroring
``tests/test_checkpoint_trace.py``: a checkpointed fit interrupted and
resumed equals the uninterrupted one (and JAX's ``train_em``),
``max_to_keep`` holds, and ``profile`` writes a Chrome trace."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from multimodal_trajectory_modeling_tpu.models import em as jem
from multimodal_trajectory_modeling_tpu_torch import config
from multimodal_trajectory_modeling_tpu_torch import device as tdevice
from multimodal_trajectory_modeling_tpu_torch import ops as tops
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.utils import trace
from multimodal_trajectory_modeling_tpu_torch.utils.checkpoint import (
    EMCheckpointer,
    train_em_checkpointed,
)


def _problem(seed=0, n=300, T=6, d=2, l=3, C=2):
    """Two LG-SSM clusters drawn by the port's sampler and a random start,
    as numpy: ``(params0, assign0, z, x, v, patterns, pattern_id)``."""
    rng = np.random.default_rng(seed)
    z = np.zeros((T, n, d))
    x = np.zeros((T, n, l))
    labels = rng.integers(0, C, size=n)
    for c in range(C):
        idx = labels == c
        zc, xc = tops.sample_trajectories(
            torch.Generator().manual_seed(c), int(idx.sum()), T, rng.normal(size=d) * 2,
            np.eye(d) / 4, rng.normal(scale=0.4, size=(d, d)), np.eye(d) / 2,
            rng.normal(size=(d, l)), np.eye(l) / 3, device="cpu",
        )
        z[:, idx], x[:, idx] = zc.numpy(), xc.numpy()
    v = tem.pack_joint(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    patterns, pid = tops.pattern_groups(v)
    params0 = (np.ones(C) / C, rng.normal(size=(C, d)), np.stack([np.eye(d)] * C),
               rng.normal(size=(C, d, d)), np.stack([np.eye(d)] * C), rng.normal(size=(C, d, l)),
               np.stack([np.eye(l)] * C))
    return params0, rng.integers(0, C, size=n), z, x, v, np.asarray(patterns), np.asarray(pid)


def _torch_args(p):
    params0, assign0, *data = p
    return (tem.mixture_params_from_numpy(params0, device="cpu"), torch.from_numpy(assign0),
            *map(torch.from_numpy, data))


def test_checkpointed_training_interrupted_and_resumed(tmp_path):
    """A run cut after 2 iterations and resumed from its checkpoint ends
    where the uninterrupted run ends, which is JAX's ``train_em``; a
    resume of a finished run keeps its assignment."""
    p = _problem()
    args = _torch_args(p)
    ref_params, ref_assign, ref_iters, ref_status = tem.train_em(*args, n_steps=100)
    pj, aj, ij, sj = jem.train_em(jem.MixtureParams(*map(jnp.asarray, p[0])),
                                  *map(jnp.asarray, p[1:]), n_steps=100)
    assert (ref_iters, ref_status) == (int(ij), int(sj)) and ref_iters > 2
    np.testing.assert_array_equal(ref_assign.numpy(), np.asarray(aj))

    ckpt = EMCheckpointer(tmp_path / "ckpt")
    _p, _a, done, status = train_em_checkpointed(*args, checkpointer=ckpt, n_steps=2, every=1)
    assert (done, status, ckpt.all_steps()) == (2, tem.STATUS_RUNNING, [1, 2])
    params, assign, done, status = train_em_checkpointed(
        *args, checkpointer=ckpt, n_steps=100, every=2, resume=True
    )
    assert status == ref_status and done == ref_iters
    np.testing.assert_array_equal(assign.numpy(), ref_assign.numpy())
    for a, b in zip(tem.mixture_params_to_numpy(params), tem.mixture_params_to_numpy(ref_params)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for a, b in zip(tem.mixture_params_to_numpy(params), pj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-10)

    _p2, assign2, _d2, _s2 = train_em_checkpointed(*args, checkpointer=ckpt, n_steps=100, every=2)
    np.testing.assert_array_equal(assign2.numpy(), assign.numpy())


def test_checkpointer_keeps_max_to_keep(tmp_path):
    """Only the newest ``max_to_keep`` steps stay; ``restore`` gives the
    latest step's payload, or a given step's, as numpy."""
    params0, assign0, *_ = _problem(n=50)
    params = tem.mixture_params_from_numpy(params0, device="cpu")
    ckpt = EMCheckpointer(tmp_path, max_to_keep=2)
    assert ckpt.restore() is None and ckpt.latest_step() is None
    for step in (2, 4, 6, 8):
        ckpt.save(step, params, torch.from_numpy(assign0 + step))
    assert ckpt.all_steps() == [6, 8]
    assert sorted(os.listdir(tmp_path)) == ["step_6.npz", "step_8.npz"]
    step, got, assign = ckpt.restore()
    assert step == 8
    np.testing.assert_array_equal(assign, assign0 + 8)
    for a, b in zip(got, params0):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ckpt.restore(6)[2], assign0 + 6)


def test_profile_writes_a_chrome_trace(tmp_path, capsys):
    """``trace.profile`` on the CPU: a Chrome trace with the block's ops
    in ``logdir``, JAX's line printed, the profiler yielded."""
    with trace.profile(tmp_path / "prof", device="cpu") as prof:
        torch.ones(64, 64, dtype=torch.float64).matmul(torch.ones(64, 64, dtype=torch.float64))
    files = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key for e in prof.key_averages())
    assert f"profile captured to {tmp_path / 'prof'}" in capsys.readouterr().out


def test_config_sets_the_process_defaults(tmp_path, monkeypatch):
    """``use_cpu_x64`` makes the CPU (float64) the default of entry points
    given no device; ``enable_persistent_compilation_cache`` moves the
    kernels' build directory (here, before any library is loaded)."""
    from multimodal_trajectory_modeling_tpu_torch.ops import _build

    monkeypatch.setattr(tdevice, "_DEFAULT_DEVICE", ["cuda"])
    monkeypatch.setattr(_build, "_BUILD_DIR", _build._BUILD_DIR)
    config.use_cpu_x64()
    p = tem.mixture_params_from_numpy(_problem(n=20)[0])
    assert p.pi.device.type == "cpu" and p.pi.dtype == torch.float64
    if _build.library.cache_info().currsize == 0:
        config.enable_persistent_compilation_cache(tmp_path / "kc")
        assert _build.library_path().parent == tmp_path / "kc"

"""The port's native host path (``native/``, its own copy of
``mtm_native.c``) against the JAX package's ``native``: ``pack_joint``,
``pattern_groups`` (patterns and ids bit for bit, first-appearance order,
and ``np.unique``'s past the cap) and ``finite_lengths``; the mixture's
``_packed`` against the JAX mixture's; the library built into the build
directory, built without OpenMP where the compiler refuses it, and a
failed build raising."""

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu import native as jnative
from multimodal_trajectory_modeling_tpu_torch import native
from multimodal_trajectory_modeling_tpu_torch.ops import _build


def _gappy(n, T=6, d=2, l=3, seed=0, p=0.15):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    z[rng.random(z.shape) < p] = np.nan
    x[rng.random(x.shape) < p] = np.nan
    lens = rng.integers(1, T + 1, size=n)
    z[np.arange(T)[:, None] >= lens[None, :]] = np.nan
    x[np.arange(T)[:, None] >= lens[None, :]] = np.nan
    return z, x


def test_library_lives_in_the_build_directory():
    assert native.available()
    path = native.library_path()
    assert path.parent == _build._BUILD_DIR and path.exists()
    assert path.name.startswith("libmtm_native_")


def test_pack_joint_matches_jax():
    z, x = _gappy(3000)
    got, want = native.pack_joint(z, x), jnative.pack_joint(z, x)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_patterns", [4096, 8])
def test_pattern_groups_match_jax(max_patterns):
    z, x = _gappy(5000, seed=1, p=0.05)
    v = jnative.pack_joint(z, x)
    got = native.pattern_groups(v, max_patterns=max_patterns)
    want = jnative.pattern_groups(v, max_patterns=max_patterns)
    assert got[0].dtype == bool and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][got[1]], np.isfinite(v))
    if max_patterns == 8:  # past the cap: np.unique's order
        unique = np.unique(np.isfinite(v), axis=0)
        np.testing.assert_array_equal(got[0], unique)
    else:  # first appearance
        first = [int(np.flatnonzero(got[1] == k)[0]) for k in range(got[0].shape[0])]
        assert first == sorted(first)


def test_finite_lengths_match_jax():
    z, _x = _gappy(4000, seed=2)
    np.testing.assert_array_equal(native.finite_lengths(z), jnative.finite_lengths(z))


def test_packed_matches_the_jax_mixture():
    from multimodal_trajectory_modeling_tpu.models import MMLinGaussSS_marginalizable as JaxModel
    from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable as PortModel

    z, x = _gappy(700, seed=3)
    np.random.seed(0)
    jm = JaxModel(3, z, x)
    np.random.seed(0)
    pm = PortModel(3, z, x, device="cpu")
    for T0 in (None, 4):
        jT, jz, jx, jv, jpat, jpid = jm._packed(None, None, T0)
        pT, pz, px, pv, ppat, ppid = pm._packed(None, None, T0)
        assert jT == pT
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ppat.numpy(), np.asarray(jpat))
        np.testing.assert_array_equal(np.asarray(ppid), np.asarray(jpid))
        np.testing.assert_array_equal(pz.numpy(), np.asarray(jz))
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    # another dataset, not cached
    z2, x2 = _gappy(300, seed=4)
    j = jm._packed(z2, x2)
    p = pm._packed(z2, x2)
    np.testing.assert_array_equal(p[4].numpy(), np.asarray(j[4]))
    np.testing.assert_array_equal(np.asarray(p[5]), np.asarray(j[5]))


def test_builds_without_openmp_and_raises_when_nothing_builds(tmp_path, monkeypatch):
    """A compiler that refuses ``-fopenmp`` (as one without ``libgomp``
    does) gets the serial build, with the same results; a compiler that
    builds nothing raises."""
    z, x = _gappy(500, seed=5)
    want = native.pattern_groups(jnative.pack_joint(z, x))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_OPENMP_FLAGS", ("-O3", "-fopenmp", "--no-such-flag", "-shared", "-fPIC"))
    native._load.cache_clear()
    try:
        assert not native.uses_openmp()
        assert native.library_path(native._SERIAL_FLAGS).exists()
        got = native.pattern_groups(native.pack_joint(z, x))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        native._load.cache_clear()
        monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
        with pytest.raises(native.NativeBuildError):
            native.pattern_groups(np.zeros((3, 2)))
    finally:
        monkeypatch.undo()
        native._load.cache_clear()
    assert native.available()
    assert torch.equal(torch.from_numpy(native.finite_lengths(np.zeros((2, 3, 1)))), torch.full((3,), 2, dtype=torch.int32))

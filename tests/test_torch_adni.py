"""The ADNI end to end in the port against the JAX package, float64 on the
CPU: the adapter (``utils/adni.py``) and the numpy state-space helpers
(``utils/state_space.py``); the dense multistart, its candidates trained
in batches of ``starts_per_batch`` (``em.train_em_multistart``, stacked)
and held against JAX's vmapped trainer and against the port's own
``train_em`` one candidate at a time; the outcome table, ``print_model``
and ``print_tests`` (the same text); the initial moments (1e-10); the
plots under matplotlib's Agg backend (the same artists' data); and, marked
slow, the README's 1000-start fit, which reprints the published outcome
table (prevalences 0.534/0.340/0.126).  ``np.random.seed`` before each
constructor gives both packages the same draws."""

import os
import time

import matplotlib

matplotlib.use("Agg", force=True)

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from multimodal_trajectory_modeling_tpu.models import em as jem  # noqa: E402
from multimodal_trajectory_modeling_tpu.models import (  # noqa: E402
    MMLinGaussSS_marginalizable as JaxMixture,
)
from multimodal_trajectory_modeling_tpu.ops import gaussian as jg  # noqa: E402
from multimodal_trajectory_modeling_tpu.utils import adni as jadni  # noqa: E402
from multimodal_trajectory_modeling_tpu.utils import state_space as jss  # noqa: E402
from multimodal_trajectory_modeling_tpu_torch.models import em as tem  # noqa: E402
from multimodal_trajectory_modeling_tpu_torch.models import mixture as tmix  # noqa: E402
from multimodal_trajectory_modeling_tpu_torch.models import (  # noqa: E402
    MMLinGaussSS_marginalizable as TorchMixture,
)
from multimodal_trajectory_modeling_tpu_torch.ops import gaussian as gops  # noqa: E402
from multimodal_trajectory_modeling_tpu_torch.utils import adni as tadni  # noqa: E402
from multimodal_trajectory_modeling_tpu_torch.utils import state_space as tss  # noqa: E402

TOL = dict(rtol=1e-10, atol=1e-10)
_PARAM_LISTS = (
    "cluster_propensities",
    "init_state_means",
    "init_state_covs",
    "transition_matrices",
    "transition_covs",
    "measurement_matrices",
    "measurement_covs",
)
# the README's fit (README.md quick start), cut to 7 random starts
_FIT = dict(n_clusters=3, init="k-means", alpha=1.0)
_MULTI = dict(n_starts=7, starts_per_batch=4, use_cache=False, return_objectives=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU E step is many small torch ops (one grouped
    log-density per cluster); beside the other test workers their thread
    pools contend and each op slows ~100×, so this module runs them on one
    thread (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def adni_data():
    z, x, d, _ids, _time = jadni.get_trajectories()
    zs, std_param = jss.standardize(z, return_params=True)
    return zs, x, d, std_param


# ----------------------------------------------------------------------
# the adapter and the helpers
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"return_mmse": True}, {"return_mmse": True, "return_approx_age": True},
                                {"return_approx_age": True}])
def test_get_trajectories_is_jax_s(kw):
    got, want = tadni.get_trajectories(**kw), jadni.get_trajectories(**kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == object:
            assert g.astype(str).tolist() == w.astype(str).tolist()
        else:
            np.testing.assert_array_equal(g, w)


def test_final_diagnoses_and_constants_are_jax_s():
    d = tadni.get_trajectories()[2]
    np.testing.assert_array_equal(tadni.get_final_diagnoses(d), jadni.get_final_diagnoses(d))
    for name in ("diagnosis_list", "hidden_columns", "observed_columns", "diagnosis_column",
                 "cluster_colors", "name"):
        assert getattr(tadni, name) == getattr(jadni, name)
    assert tss.CLUSTER_COLORS == jss.CLUSTER_COLORS
    assert len(tadni.diagnosis_colors) == len(jadni.diagnosis_colors)
    for g, w in zip(tadni.diagnosis_colors, jadni.diagnosis_colors):
        np.testing.assert_array_equal(g, w)
    # the JAX modules set these globally at import; the port only inside
    # its plotters' rc_context
    glob = {k: plt.rcParams[k] for k in tss.PLOT_RC}
    with plt.rc_context(tss.PLOT_RC):
        assert {k: plt.rcParams[k] for k in tss.PLOT_RC} == glob


def test_profiling_dataframe_is_jax_s():
    ids = tadni.get_trajectories()[3]
    got = tadni.return_profiling_dataframe(ids[0])
    want = jadni.return_profiling_dataframe(ids[0])
    assert got.equals(want)


def test_standardize_is_jax_s(adni_data):
    z = tadni.get_trajectories()[0]
    got, gp = tss.standardize(z, return_params=True)
    want, wp = jss.standardize(z, return_params=True)
    np.testing.assert_array_equal(got, want)
    for k in wp:
        np.testing.assert_array_equal(gp[k], wp[k])
    np.testing.assert_array_equal(tss.standardize(z, params=wp), want)
    full = np.isfinite(z).all(axis=(0, 2))  # the inverses assert a round trip, NaN-free
    np.testing.assert_array_equal(tss.unstandardize(got[:, full], gp), jss.unstandardize(want[:, full], wp))
    nz, npar = tss.normalize(z, return_params=True)
    np.testing.assert_array_equal(nz, jss.normalize(z))
    np.testing.assert_array_equal(tss.unnormalize(nz[:, full], npar), jss.unnormalize(nz[:, full], npar))


def test_state_space_helpers_are_jax_s(adni_data):
    zs, x, _d, sp = adni_data
    rng = np.random.default_rng(0)
    mean, cov = rng.normal(size=2), np.array([[2.0, 0.3], [0.3, 1.0]])
    for fn in ("unstandardize_mean_and_cov", "unstandardize_mean_and_cov_diffs"):
        for g, w in zip(getattr(tss, fn)(mean, cov, sp), getattr(jss, fn)(mean, cov, sp)):
            np.testing.assert_allclose(g, w, rtol=1e-15)
    np.testing.assert_array_equal(tss.nancat(zs, zs[:2]), jss.nancat(zs, zs[:2]))
    for fn in ("get_finite_length", "take_final_finite", "add_constant_where_finite"):
        np.testing.assert_array_equal(getattr(tss, fn)(zs), getattr(jss, fn)(zs))
    np.testing.assert_array_equal(tss.take_finite_along_axis(zs, 1), jss.take_finite_along_axis(zs, 1))
    np.testing.assert_array_equal(tss.mask_all_but_time_i(zs, 2), jss.mask_all_but_time_i(zs, 2))
    steps = rng.integers(0, 4, size=zs.shape[1])
    np.testing.assert_array_equal(tss.mask_all_but_time_i_vect(zs, steps), jss.mask_all_but_time_i_vect(zs, steps))
    w = rng.uniform(size=zs.shape[1])
    for g, wv in zip(tss.weighted_mean_and_covariance(zs, w), jss.weighted_mean_and_covariance(zs, w)):
        np.testing.assert_allclose(g, wv, rtol=1e-13)
    X = np.column_stack([zs[0], np.ones(zs.shape[1])])
    X[3, 0] = np.nan
    for g, wv in zip(tss.regress(X, x[0]), jss.regress(X, x[0])):
        np.testing.assert_allclose(g, wv, **TOL)
    for g, wv in zip(tss.regress_alpha(X, x[0], 0.5), jss.regress_alpha(X, x[0], 0.5)):
        np.testing.assert_allclose(g, wv, **TOL)


# ----------------------------------------------------------------------
# the multistart, stacked
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted(adni_data):
    """The README's fit cut to 7 random starts in batches of 4, in both
    packages, relabelled by AD rate."""
    zs, x, d, _sp = adni_data
    np.random.seed(0)
    jb, jo = JaxMixture(states=zs, observations=x, **_FIT).train_with_multiple_random_starts(**_MULTI)
    np.random.seed(0)
    tb, to = TorchMixture(states=zs, observations=x, device="cpu", **_FIT).train_with_multiple_random_starts(**_MULTI)
    jadni.set_model_correspondence(jb, d)
    tadni.set_model_correspondence(tb, d)
    return jb, jo, tb, to


def test_multistart_in_batches_matches_jax(adni_data, fitted):
    """Objectives (rtol 1e-10), winner, assignment and parameters as JAX's
    multistart gives them; every candidate's iterations and statuses as
    JAX's vmapped ``train_em_multistart`` gives them on the same
    candidates in the same batches."""
    zs, x, _d, _sp = adni_data
    jb, jo, tb, to = fitted
    np.testing.assert_allclose(to, jo, rtol=1e-10)
    assert int(np.argmax(to)) == int(np.argmax(jo)) and tb.random_seed == jb.random_seed
    np.testing.assert_array_equal(tb.cluster_assignment, jb.cluster_assignment)
    for name in _PARAM_LISTS:
        np.testing.assert_allclose(np.asarray(getattr(tb, name)), np.asarray(getattr(jb, name)), **TOL)
    assert tb.last_multistart["batches"] == 2
    np.random.seed(0)
    model = TorchMixture(states=zs, observations=x, device="cpu", **_FIT)
    cands = [model._candidate(0, "kmeans")] + [model._candidate(100 + i) for i in range(7)]
    v = np.asarray(jem.pack_joint(jnp.asarray(zs), jnp.asarray(x)))
    patterns, pid = jg.pattern_groups(v)
    iters, status = [], []
    for lo in (0, 4):
        grp = cands[lo : lo + 4]
        out = jem.train_em_multistart(
            jem.MixtureParams(*(jnp.asarray(p.numpy()) for p in TorchMixture._stack_candidates(
                grp, device="cpu", dtype=torch.float64))),
            jnp.asarray(np.stack([c.cluster_assignment for c in grp])),
            *map(jnp.asarray, (zs, x, v, patterns, pid)), n_steps=100, reg_mode="ridge", alpha=1.0,
        )
        iters += np.asarray(out[2]).tolist()
        status += np.asarray(out[3]).tolist()
    assert tb.last_multistart["iterations"] == iters
    assert tb.last_multistart["statuses"] == status


def test_memory_cap_clamps_the_batch(adni_data, monkeypatch):
    """The JAX package's cap of ≈ 4·n·D·C bytes a candidate: with the
    budget cut to hold two candidates, the 4 candidates train in two
    batches of 2 and give the objectives of one batch of 4."""
    zs, x, _d, _sp = adni_data
    zs, x = zs[:, :200], x[:, :200]
    kw = dict(n_starts=3, n_steps=20, use_cache=False, return_objectives=True)
    np.random.seed(3)
    whole = TorchMixture(states=zs, observations=x, device="cpu", **_FIT).train_with_multiple_random_starts(**kw)
    calls = []
    real = tem.train_em_multistart
    monkeypatch.setattr(tem, "train_em_multistart", lambda p, a, *r, **k: calls.append(a.shape[0]) or real(p, a, *r, **k))
    monkeypatch.setattr(tmix, "_DENSE_BATCH_BYTES", 2 * 4 * 200 * 4 * (2 + 4) * 3 + 1)
    np.random.seed(3)
    split = TorchMixture(states=zs, observations=x, device="cpu", **_FIT).train_with_multiple_random_starts(**kw)
    assert calls == [2, 2] and split[0].last_multistart["batches"] == 2
    assert whole[0].last_multistart["batches"] == 1
    np.testing.assert_allclose(split[1], whole[1], rtol=1e-12)
    assert split[0].last_multistart["statuses"] == whole[0].last_multistart["statuses"]


def _seq_case():
    """Five candidates on two well separated synthetic clusters at C = 3:
    random assignments, an init abort (one cluster), and a warm start with
    six rows in the third cluster that empties it after one iteration."""
    rng = np.random.default_rng(2)
    n, T, d, l = 300, 4, 2, 3
    labels = rng.integers(0, 2, size=n)
    z, x = np.empty((T, n, d)), np.empty((T, n, l))
    for c in range(2):
        sel = labels == c
        A, H = rng.normal(scale=0.4, size=(d, d)), rng.normal(size=(d, l))
        zc = rng.normal(loc=3.0 * c, size=(int(sel.sum()), d))
        for t in range(T):
            z[t, sel] = zc
            x[t, sel] = zc @ H + 0.3 * rng.normal(size=zc.shape[:1] + (l,))
            zc = zc @ A + 0.5 * rng.normal(size=zc.shape)
    past = np.arange(T)[:, None] >= rng.choice([3, 4], size=n)[None, :]
    z[past], x[past] = np.nan, np.nan
    warm = labels.copy()
    warm[rng.choice(np.where(labels == 0)[0], 6, replace=False)] = 2
    assigns = np.stack([rng.integers(0, 3, size=n), np.zeros(n, int), warm,
                        rng.integers(0, 3, size=n), rng.integers(0, 3, size=n)])
    C = 3
    params = (np.full((5, C), 1 / C), rng.normal(size=(5, C, d)), np.tile(np.eye(d), (5, C, 1, 1)),
              rng.normal(scale=0.3, size=(5, C, d, d)), np.tile(np.eye(d), (5, C, 1, 1)),
              rng.normal(size=(5, C, d, l)), np.tile(np.eye(l), (5, C, 1, 1)))
    return z, x, assigns, params


@pytest.mark.parametrize("reg_mode", ["lstsq", "ridge"])
def test_stacked_equals_sequential(reg_mode):
    """Five candidates trained together equal five ``train_em`` runs: the
    same iterations, statuses and assignments, parameters and objectives
    to 1e-10, an init abort (its ``params0``, 0 iterations) and an emptied
    cluster (status 2 after one iteration) among them."""
    z, x, assigns, params = _seq_case()
    zt, xt = torch.from_numpy(z), torch.from_numpy(x)
    v = tem.pack_joint(zt, xt)
    patterns, pid = gops.pattern_groups(v.numpy())
    data = (zt, xt, v, torch.from_numpy(patterns), torch.from_numpy(pid))
    kw = dict(n_steps=50, reg_mode=reg_mode, alpha=0.5)
    out = tem.train_em_multistart(tem.mixture_params_from_numpy(params, device="cpu"),
                                  torch.from_numpy(assigns), *data, **kw)
    assert out[3].tolist()[1:3] == [tem.STATUS_INIT_ABORT, tem.STATUS_EMPTY_CLUSTER]
    assert int(out[2][2]) == 1 and int(out[2].max()) > 2
    for r in range(5):
        p0 = tem.mixture_params_from_numpy(tuple(a[r] for a in params), device="cpu")
        fit = tem.train_em(p0, torch.from_numpy(assigns[r]), *data, **kw)
        assert (fit[2], fit[3]) == (int(out[2][r]), int(out[3][r]))
        np.testing.assert_array_equal(fit[1].numpy(), out[1][r].numpy())
        for a, b in zip(tem.mixture_params_to_numpy(fit[0]), tem.mixture_params_to_numpy(out[0])):
            np.testing.assert_allclose(a, b[r], **TOL)
        obj = tem.complete_data_loglik(fit[0], *data[2:], T=4)
        np.testing.assert_allclose(float(out[4][r]), float(obj), rtol=1e-10)
    for a, b in zip(tem.mixture_params_to_numpy(out[0]), params):
        np.testing.assert_array_equal(a[1], b[1])  # the init abort keeps params0


def test_stacked_loop_skips_stopped_restarts(monkeypatch):
    """Each E step of the stacked loop takes the clusters of the restarts
    still running alone: the init abort never, the emptied restart after
    its one iteration no more, and the objectives all R·C clusters."""
    z, x, assigns, params = _seq_case()
    zt, xt = torch.from_numpy(z), torch.from_numpy(x)
    v = tem.pack_joint(zt, xt)
    patterns, pid = gops.pattern_groups(v.numpy())
    seen = []
    real = tem._masked_logliks
    monkeypatch.setattr(tem, "_masked_logliks", lambda means, *a: seen.append(means.shape[0]) or real(means, *a))
    out = tem.train_em_multistart(tem.mixture_params_from_numpy(params, device="cpu"), torch.from_numpy(assigns),
                                  zt, xt, v, torch.from_numpy(patterns), torch.from_numpy(pid),
                                  n_steps=50, reg_mode="ridge", alpha=0.5)
    iters = out[2].tolist()
    assert seen == [3 * sum(i > k for i in iters) for k in range(max(iters))] + [15]
    assert seen[0] == 12 and seen[1] <= 9


# ----------------------------------------------------------------------
# the reports
# ----------------------------------------------------------------------


def _printed(capsys, fn):
    capsys.readouterr()
    fn()
    return [ln for ln in capsys.readouterr().out.splitlines() if "last_trained" not in ln]


@pytest.mark.parametrize("report", ["outcome_table", "print_model", "print_model_verbose", "print_tests"])
def test_reports_print_jax_s_text(adni_data, fitted, capsys, report):
    d = adni_data[2]
    jb, _jo, tb, _to = fitted
    calls = {
        "outcome_table": lambda m, mod: mod.generate_outcome_table(m, d),
        "print_model": lambda m, mod: m.print_model(),
        "print_model_verbose": lambda m, mod: m.print_model(verbose=True),
        "print_tests": lambda m, mod: m.print_tests(test_1=True, test_01=True, test_obs=True),
    }[report]
    got = _printed(capsys, lambda: calls(tb, tadni))
    want = _printed(capsys, lambda: calls(jb, jadni))
    assert len(got) >= 5
    assert got == want


def test_outcome_prevalences_are_the_table_s(adni_data, fitted):
    d = adni_data[2]
    jb, _jo, tb, _to = fitted
    finals = tadni.get_final_diagnoses(d)
    labels, overall, within = tadni.outcome_prevalences(tb, tb.cluster_assignment, finals)
    assert labels == "ABC" and within.shape == (3, 4)
    np.testing.assert_allclose(overall.sum(), 1.0)
    for k, c in enumerate(labels):
        sel = jb.cluster_assignment == jb.inverse_correspondence[c]
        assert overall[k] == np.mean(sel)
        np.testing.assert_array_equal(within[k], [np.mean(finals[sel] == dx) for dx in jadni.diagnosis_list])


@pytest.mark.parametrize("method", ["get_initial_means_and_stds", "get_initial_diffs_means_and_stds"])
@pytest.mark.parametrize("std", [False, True])
def test_initial_moments_match_jax(adni_data, fitted, method, std):
    sp = adni_data[3] if std else None
    jb, _jo, tb, _to = fitted
    got, want = getattr(tb, method)(std_param=sp), getattr(jb, method)(std_param=sp)
    assert list(got) == list(want)
    for k in want:
        for key in ("μ", "σ"):
            np.testing.assert_allclose(got[k][key], want[k][key], **TOL)


# ----------------------------------------------------------------------
# the plots
# ----------------------------------------------------------------------


def _artists(figs):
    """What a figure draws, as comparable data: titles, labels and limits,
    line data, images, texts, and each collection's offsets, colours,
    segments, quiver arrows and contour levels."""
    out = []
    for fig in figs:
        for ax in fig.axes:
            out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(), ax.get_xlim(), ax.get_ylim(),
                        [t.get_text() for t in ax.get_xticklabels()]))
            out += [np.asarray(ln.get_xydata(), float) for ln in ax.lines]
            out += [np.asarray(im.get_array(), float) for im in ax.images]
            out += [(t.get_text(), t.get_position(), str(t.get_color())) for t in ax.texts]
            for c in ax.collections:
                out.append(type(c).__name__)
                out.append(np.asarray(c.get_offsets(), float))
                out.append(np.asarray(c.get_facecolors(), float))
                if hasattr(c, "levels"):
                    out.append(np.asarray(c.levels, float))
                    out += [np.asarray(p.vertices, float) for p in c.get_paths()]
                if hasattr(c, "U"):
                    out += [np.asarray(c.U, float), np.asarray(c.V, float)]
                if hasattr(c, "get_segments") and not hasattr(c, "levels"):
                    out += [np.asarray(s, float) for s in c.get_segments()]
    return out


def _same(got, want, rtol=1e-9):
    """Equal strings and structure; numbers and arrays within ``rtol``
    (autoscaled limits and the data carry the fits' round-off)."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol)
    elif isinstance(want, (np.ndarray, float, np.floating)):
        assert np.shape(got) == np.shape(want)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12)
    else:
        assert got == want


def _drawn(fn):
    """The data of the figures ``fn`` opens, which are then closed."""
    before = set(plt.get_fignums())
    fn()
    new = [plt.figure(k) for k in plt.get_fignums() if k not in before]
    try:
        return _artists(new)
    finally:
        for f in new:
            plt.close(f)


@pytest.mark.parametrize("plot", ["observed", "overall"])
def test_propensity_plots_match_jax(fitted, tmp_path, plot):
    jb, _jo, tb, _to = fitted
    name = {"observed": "plot_cluster_propensity_evolution",
            "overall": "plot_overall_cluster_propensity_evolution"}[plot]
    got = _drawn(lambda: getattr(tb, name)(str(tmp_path / "t.png")))
    want = _drawn(lambda: getattr(jb, name)(str(tmp_path / "j.png")))
    assert len(got) > 10
    _same(got, want)


def test_plot_matrix_and_model_plots_match_jax(fitted, tmp_path):
    jb, _jo, tb, _to = fitted
    mat = np.arange(6.0).reshape(2, 3) / 7
    kw = dict(show_colorbar=True, xticks=["a", "b", "c"], yticks=["u", "v"], xlabel="x", ylabel="y",
              title="m", savename=None)
    _same(_drawn(lambda: TorchMixture.plot_matrix(mat, **kw)), _drawn(lambda: JaxMixture.plot_matrix(mat, **kw)))
    got = _drawn(lambda: tb.generate_model_plots(str(tmp_path / "t")))
    want = _drawn(lambda: jb.generate_model_plots(str(tmp_path / "j")))
    _same(got, want)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    (sub,) = os.listdir(tmp_path / "t")
    assert sorted(os.listdir(tmp_path / "t" / sub)) == sorted(os.listdir(tmp_path / "j" / sub))
    assert len(os.listdir(tmp_path / "t" / sub)) == 1 + 6 * 3


def test_trajectory_plot_with_the_model_matches_jax(adni_data, fitted, tmp_path):
    """``plot_2d_trajectories`` on the raw (unstandardized) states, shaded
    by intensities, with the model's initial-state contours superimposed."""
    _zs, _x, _d, sp = adni_data
    jb, _jo, tb, _to = fitted
    z = tadni.get_trajectories()[0]
    kw = dict(states=z, std_param=sp, drop_superimposed_model=False, intensities=np.linspace(0, 1, z.shape[1]))
    got = _drawn(lambda: tadni.plot_2d_trajectories(tb, str(tmp_path / "t.png"), **kw))
    want = _drawn(lambda: jadni.plot_2d_trajectories(jb, str(tmp_path / "j.png"), **kw))
    assert sum(isinstance(a, str) and "Contour" in a for a in got) == 3
    _same(got, want)


def test_ponder_opens_the_paper(monkeypatch):
    import webbrowser

    opened = []
    monkeypatch.setattr(webbrowser, "open_new_tab", opened.append)
    TorchMixture.ponder()
    JaxMixture.ponder()
    assert opened == ["https://doi.org/10.1017/prm.2023.96"] * 2


# ----------------------------------------------------------------------
# the README's fit
# ----------------------------------------------------------------------


@pytest.mark.slow
def test_published_fit_reprints_the_outcome_table(adni_data, capsys):
    """The 3-cluster 1000-start fit of the README in both packages, float64
    on the CPU: the same objectives and winner, the same printed outcome
    table, the same prevalences, and the published row 0.534/0.340/0.126.
    Prints each package's seconds and the within-cluster rows, which
    ``chip_smoke.py`` phase 23 holds the card's fit to."""
    zs, x, d, _sp = adni_data
    kw = dict(n_starts=1000, use_cache=False, return_objectives=True)
    seconds = {}
    fits = {}
    for name, cls, extra, mod in (("jax", JaxMixture, {}, jadni), ("torch", TorchMixture, {"device": "cpu"}, tadni)):
        np.random.seed(0)
        t0 = time.perf_counter()
        fits[name] = cls(states=zs, observations=x, **_FIT, **extra).train_with_multiple_random_starts(**kw)
        seconds[name] = time.perf_counter() - t0
        mod.set_model_correspondence(fits[name][0], d)
    (jb, jo), (tb, to) = fits["jax"], fits["torch"]
    np.testing.assert_allclose(to, jo, rtol=1e-10)
    assert int(np.argmax(to)) == int(np.argmax(jo))
    table = {}
    for name, m, mod in (("jax", jb, jadni), ("torch", tb, tadni)):
        table[name] = _printed(capsys, lambda m=m, mod=mod: mod.generate_outcome_table(m, d))
    assert table["torch"] == table["jax"]
    finals = tadni.get_final_diagnoses(d)
    _labels, overall, within = tadni.outcome_prevalences(tb, tb.cluster_assignment, finals)
    _labels, j_overall, j_within = tadni.outcome_prevalences(jb, jb.cluster_assignment, finals)
    np.testing.assert_array_equal(overall, j_overall)
    np.testing.assert_array_equal(within, j_within)
    assert np.round(overall, 3).tolist() == [0.534, 0.340, 0.126]
    with capsys.disabled():
        print(f"\nADNI 1000-start fit, CPU float64: jax {seconds['jax']:.2f} s, torch {seconds['torch']:.2f} s "
              f"(k-means {tb.last_multistart['kmeans_seconds']:.3f} s, {tb.last_multistart['batches']} batches); "
              f"winner {int(np.argmax(to))} objective {float(np.max(to))!r}")
        print("within-cluster rows (both packages):", repr(j_within.tolist()))
        print("\n".join(table["torch"]))

#!/usr/bin/env python3
"""Where K7's time goes on the card, on ``chip_smoke.py`` phase 12's data
(the bench batch at n = 1e6, T = 10, d = 5, l = 3 with every coordinate
also missing with p = 0.05 and every 100 003rd row all NaN, C = 16),
under two parameter sets: phase 12's random ones and those of phase 13's
masked fit on the same batch (``train(fast=True, n_steps=30)``); with
``--long`` on phase 12's T = 128, n = 2.5e5 batch (lengths {64, 100,
128}) under the random ones, without the variants.

For each parameter set it prints K7's milliseconds on the planned batch
(the trainer's call) by CUDA events over ``--reps`` calls and by
``torch.profiler`` (the kernel's device time), the SM clock and power
``nvidia-smi`` reads while K7 runs back to back, the plan's milliseconds
(``plan_masked_batch`` from the device batch, against
``pack_masked_kalman`` alone) and the per-call path (no plan given);
then, for builds of ``csrc/masked_kalman.cu`` compiled alone from edited
copies (``tools/variant_build.py``), the milliseconds on both parameter
sets, ``ptxas -v`` and the SASS counts of every instantiation
(``chip_smoke.k7_sass``):

- ``full``: the source as it is (the package's own build);
- ``no_z``, ``no_x``, ``no_predict``: the step without its z
  conditioning, its x update or its predict;
- ``no_log``: the step's one log replaced by its argument;
- ``params_in_smem``: A, G and L read from shared memory each step in
  float32 too, not held in registers;
- with ``--sweep``, ``min_blocks_5`` and ``min_blocks_6``: the fixed
  shapes' ``__launch_bounds__`` asking for 5 or 6 blocks an SM (the
  source asks for 4).

With ``--old DIR`` (the root of an older tree, e.g. a ``git archive`` of
the parent commit) that tree's K7 is built alone, as it is and without
its logs, and timed on the same inputs in a subprocess with the same
clocks, before and after this tree's (old, new, new, old), with its SASS
counts; with ``--fit-trace`` as well, phase 13's fit runs again with
that tree's K7 from the same start, and where the two fits differ each
E step of this tree's trajectory is taken with both kernels, the rows
whose assignments differ printed with their float64 score gap.  With
``--dump DIR`` the (5,3) SASS listings of both trees are written to DIR.

Usage, on a machine with the card and ``nvcc``::

    python3 tools/k7_phase_split.py [--old DIR [--fit-trace]] [--long] [--sweep] [--dump DIR] [--reps 10]

Prints the card's name and power limit first, then one JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from variant_build import build, card_line, event_ms  # noqa: E402  (tools/, the script's own directory)

# each variant's edits of csrc/masked_kalman.cu: (text, replacement)
_STEP = {
    "z": "      // 1. the observed z coordinates, one at a time\n      {\n",
    "x": "      // 2. the observed x coordinates against the conditioned moments\n      {\n",
    "predict": "      // 3. predict: mu' = mu A, P' = A'P A + G (lower triangle), A by rows\n      {\n",
}
VARIANTS = {
    **{f"no_{k}": [(v, v.replace("      {\n", "      if (false) {\n"))] for k, v in _STEP.items()},
    "no_log": [("log_(pz.f * px.f)", "(pz.f * px.f)")],
    "params_in_smem": [("constexpr bool kHold = FIXED && sizeof(T) == 4;", "constexpr bool kHold = false;")],
}
SWEEP = {f"min_blocks_{b}": [("constexpr int kMinBlocks = 4;", f"constexpr int kMinBlocks = {b};")] for b in (5, 6)}
OLD_VARIANTS = {
    "full": [],
    "no_log": [("__device__ __forceinline__ float log_(float v) { return logf(v); }",
                "__device__ __forceinline__ float log_(float v) { return v; }")],
}


def profiled_ms(fn, reps: int) -> dict:
    """K7's device time under ``torch.profiler`` over ``reps`` calls,
    after one warm-up call: ``{"ms": per recorded execution, "recorded":
    executions the trace holds}`` (a trace can miss one)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and "masked_kalman" in e.key:
            us, count = us + t, count + e.count
    return {"ms": us / 1e3 / max(count, 1), "recorded": count, "of": reps}


def clocks_under(fn, seconds: float = 2.0) -> dict:
    """``nvidia-smi``'s SM clock, power draw and temperature, read once
    while ``fn`` runs back to back for ``seconds``."""
    import torch

    got = {}

    def read():
        time.sleep(seconds / 2)
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
        got["sm_mhz, max_mhz, power, temp"] = out

    th = threading.Thread(target=read)
    t0 = time.perf_counter()
    th.start()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    th.join()
    return got


def idle_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


# the older tree's side (run in a subprocess with that tree first on the
# path): its K7, built alone as it is and without its logs, on the saved
# inputs
_OLD = r"""
import ctypes, json, sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
import numpy as np, torch
root, tools, data, reps = Path(sys.argv[1]), sys.argv[2], Path(sys.argv[3]), int(sys.argv[4])
variants, built, set_names = json.loads(sys.argv[5]), json.loads(sys.argv[6]), json.loads(sys.argv[7])
sys.path[:0] = [str(root), tools]
from variant_build import build, event_ms
from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk
import k7_phase_split as ps  # after the older tree's package: it puts this tree on the path
sigs = {k: t for k, t in _build._SIGNATURES.items() if "masked_kalman" in k}


def load(path):
    lib = ctypes.CDLL(path)
    for name, argtypes in sigs.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, ""


src = root / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
with ThreadPoolExecutor(len(variants)) as pool:
    libs = {v: pool.submit(load, built[v]) if v in built else
            pool.submit(build, src, ["masked_kalman.cu"], data, edits={"masked_kalman.cu": [tuple(e) for e in edits]},
                        signatures=sigs) for v, edits in variants.items()}
    libs = {v: f.result() for v, f in libs.items()}
dev = torch.device("cuda")
zp = torch.tensor(np.load(data / "zp.npy"), device=dev)
xp = torch.tensor(np.load(data / "xp.npy"), device=dev)
sets = {name: [torch.tensor(np.load(data / f"{name}_{k}.npy"), device=dev) for k in "mSAGHL"] for name in set_names}
out = {}
for variant, (lib, log) in libs.items():
    _build.library = lambda lib=lib: lib
    res = {"lib": lib._name, "log": log}
    for name, p in sets.items():
        fn = lambda p=p: kk.kalman_masked_logliks_packed(zp, xp, *p)
        res[name] = {"events_ms": event_ms(fn, reps), "profiler": ps.profiled_ms(fn, reps)}
        if variant == "full":
            res[name]["clocks"] = ps.clocks_under(fn)
    out[variant] = res
print(json.dumps(out))
"""


def old_filter_logliks(lib_path):
    """The older tree's K7 (its launch function of 12 arguments, the rows in
    the order given) in the place of ``em._filter_logliks``: the planned
    batch through it, the result put back in the caller's order."""
    import ctypes

    import torch

    from multimodal_trajectory_modeling_tpu_torch.ops import _build

    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(lib_path).mtm_masked_kalman
    fn.argtypes = [I_, I_, P_, P_, P_, P_, ctypes.c_longlong, I_, I_, I_, I_, P_]
    fn.restype = I_

    def filter_logliks(params, packed):
        zp, xp = packed.zp, packed.xp
        T, d, n = zp.shape
        C = params.m.shape[0]
        rows = torch.cat([a.to(zp.dtype).reshape(C, -1) for a in params[1:]], 1).contiguous()
        ll = torch.empty((C, n), dtype=zp.dtype, device=zp.device)
        rc = fn(zp.device.index or 0, {torch.float32: 0, torch.float64: 1}[zp.dtype], zp.data_ptr(), xp.data_ptr(),
                rows.data_ptr(), ll.data_ptr(), n, T, d, xp.shape[1], C, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "the older K7")
        out = torch.empty_like(ll)
        out[:, packed.plan.rows.long()] = ll
        return out

    return filter_logliks


def fit(z, x, filter_logliks=None):
    """Phase 13's masked fit (``np.random.seed(13)``, ``train(fast=True,
    n_steps=30)``), with ``filter_logliks`` in the place of
    ``em._filter_logliks`` if given: ``(model, seconds, the trainer's
    arguments)``."""
    import numpy as np

    from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable
    from multimodal_trajectory_modeling_tpu_torch.models import em

    starts, train, real = [], em.train_em_masked_kalman, em._filter_logliks

    def keep(*a, **k):
        starts.append((a, k))
        return train(*a, **k)

    np.random.seed(13)
    model = MMLinGaussSS_marginalizable(n_clusters=16, states=z, observations=x, device="cuda")
    em.train_em_masked_kalman = keep
    em._filter_logliks = filter_logliks or real
    t0 = time.perf_counter()
    try:
        model.train(fast=True, n_steps=30)
    finally:
        em.train_em_masked_kalman, em._filter_logliks = train, real
    return model, time.perf_counter() - t0, starts[0]


def fit_trace(start, old_filter_logliks) -> None:
    """Phase 13's fit from its start along this tree's trajectory: at each
    E step both trees' K7, the rows whose assignments differ and their
    float64 score gap (top-2 gap over 1 + |top score|, the plain version
    in float64 on those rows)."""
    import torch

    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk

    (params, a, z, x), kw = start
    C = params.pi.shape[0]
    packed = kk.plan_masked_batch(z, x)
    a = a.to(torch.int32)
    params = em.mstep(z, x, a, n_clusters=C)
    for it in range(1, kw.get("n_steps", 30) + 1):
        a_new, counts, sw = em._hard_estep(params.pi, em._filter_logliks(params, packed), a, C)
        a_old, _c, sw_old = em._hard_estep(params.pi, old_filter_logliks(params, packed), a, C)
        diff = torch.nonzero(a_new != a_old).squeeze(1)
        line = {"iteration": it, "switches_new": int(sw), "switches_old": int(sw_old), "rows_differing": int(diff.numel())}
        if diff.numel():
            p64 = em.MixtureParams(*(t.double() for t in params))
            zc, xc = kk.pack_masked_kalman(z[:, diff].double(), x[:, diff].double())
            scores = torch.log(p64.pi)[:, None] + kk.kalman_masked_logliks_packed_plain(zc, xc, *p64[1:])
            top2 = scores.topk(2, dim=0).values
            line["max_rel_score_gap"] = float(((top2[0] - top2[1]) / (1 + top2[0].abs())).max())
        print(json.dumps(line), flush=True)
        status = int(em._em_termination(sw, counts, em.STATUS_RUNNING, min_members=3)[3])
        a = a_new
        if status != em.STATUS_RUNNING:
            print(json.dumps({"trajectory_status": status, "iterations": it}), flush=True)
            break
        params = em.mstep(z, x, a, n_clusters=C)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="root of the tree whose K7 to time beside this one")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true", help="also build with 5 and 6 blocks an SM asked of ptxas")
    ap.add_argument("--dump", type=Path, help="write the (5,3) SASS listings here")
    ap.add_argument("--long", action="store_true",
                    help="phase 12's T=128, n=2.5e5 batch under its random parameters, no variants")
    ap.add_argument("--fit-trace", action="store_true",
                    help="with --old: phase 13's fit with both trees' K7, and its flips traced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_phase_split: no CUDA card", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    T, D, L, C, N = cs.T, cs.D, cs.L, cs.C, cs.N
    t0 = time.perf_counter()
    _build.library()
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)
    # the variants compile while the fit and the timings run
    data = Path(tempfile.mkdtemp())
    sigs = {k: t for k, t in _build._SIGNATURES.items() if "masked_kalman" in k}
    variants = {} if args.long else {**VARIANTS, **(SWEEP if args.sweep else {})}
    pool = ThreadPoolExecutor(max(len(variants), 1))
    builds = {v: pool.submit(build, _build._SRC_DIR, ["masked_kalman.cu"], data, edits={"masked_kalman.cu": e},
                             signatures=sigs) for v, e in variants.items()}

    # phase 12's batch and random parameters, phase 13's fit on it (or
    # phase 12's T=128 batch)
    rng = np.random.default_rng(12)
    random = em.mixture_params_from_numpy(cs.random_params(rng, (C,)), device=dev, dtype=torch.float32)
    sets = {"random": list(random[1:])}
    zx = None
    if args.long:
        N, T = 250_000, 128
        z, x, _lens = cs.bench_batch(N, seed=122, steps=T, lengths=(64, 100, 128))
        z, x = cs.scatter_nans(z, x, seed=122)
    else:
        z, x, _lens = cs.bench_batch(N, seed=12)
        z, x = cs.scatter_nans(z, x, seed=12)
        z[:, ::100_003] = np.nan
        x[:, ::100_003] = np.nan
        model, seconds, start = fit(z, x)
        sets["fitted"] = list(model._stacked_params()[1:])
        fit_new = (model.last_iterations, model.last_status, np.asarray(model.cluster_assignment))
        print(json.dumps({"fit": "new", "seconds": seconds, "iterations": fit_new[0], "status": fit_new[1]}),
              flush=True)
        zx = (z, x) if args.fit_trace else None
        del model
    zd, xd = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (z, x))
    del z, x
    zp, xp = kk.pack_masked_kalman(zd, xd)
    batch = kk.plan_masked_batch(zd, xd)
    ext = batch.plan.extent
    print(json.dumps({"n": N, "T": T, "C": C, "mean_extent": float(ext.double().mean()),
                      "extent_counts": torch.bincount(ext.long(), minlength=T + 1).tolist(),
                      "plan_ms": event_ms(lambda: kk.plan_masked_batch(zd, xd), args.reps),
                      "pack_only_ms": event_ms(lambda: kk.pack_masked_kalman(zd, xd), args.reps)}), flush=True)

    dump = args.dump
    old = None
    if args.old is not None:
        np.save(data / "zp.npy", zp.cpu().numpy())
        np.save(data / "xp.npy", xp.cpu().numpy())
        for name, p in sets.items():
            for k, a in zip("mSAGHL", p):
                np.save(data / f"{name}_{k}.npy", a.cpu().numpy())

        old_libs = {}

        def old():
            proc = subprocess.run([sys.executable, "-c", _OLD, str(args.old.resolve()), str(TOOLS), str(data),
                                   str(args.reps), json.dumps(OLD_VARIANTS), json.dumps(old_libs), json.dumps(list(sets))],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"the old tree failed:\n{proc.stderr[-3000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            first = not old_libs
            for variant, r in res.items():
                old_libs[variant] = r.pop("lib")
                log = r.pop("log")
                print(json.dumps({"tree": "old", "variant": variant, **r}), flush=True)
                if not first or variant != "full":
                    continue
                sass = cs.k7_sass(old_libs[variant], dump / "old" if dump else None)
                ptxas = cs.ptxas_usage(log, cs.k7_label)
                for name, c in sass.items():
                    print(json.dumps({"tree": "old", "sass": name, "ptxas": ptxas.get(name, (0, None))[1], **c}),
                          flush=True)

        old()
    print(json.dumps({"idle_clock": idle_clock()}), flush=True)

    def time_sets(tag, clocks=False):
        for name, p in sets.items():
            fn = lambda p=p: kk.kalman_masked_logliks_packed(batch.zp, batch.xp, *p, plan=batch.plan)  # noqa: E731
            line = {"tree": "new", "variant": tag, "params": name, "events_ms": event_ms(fn, args.reps),
                    "profiler": profiled_ms(fn, args.reps)}
            if clocks:
                line["clocks"] = clocks_under(fn)
                line["per_call_plan_ms"] = event_ms(lambda p=p: kk.kalman_masked_logliks_packed(zp, xp, *p),
                                                    args.reps)
            print(json.dumps(line), flush=True)

    time_sets("full", clocks=not args.long)
    log = _build.library_path().with_suffix(".log")
    ptxas = cs.ptxas_usage(log.read_text() if log.exists() else "", cs.k7_label)
    for name, c in cs.k7_sass(_build.library_path(), dump / "new" if dump else None).items():
        print(json.dumps({"tree": "new", "variant": "full", "sass": name, "ptxas": ptxas.get(name, (0, None))[1], **c}),
              flush=True)
    real = _build.library
    try:
        for variant, fut in builds.items():
            lib, log = fut.result()
            _build.library = lambda lib=lib: lib
            time_sets(variant)
            ptxas = cs.ptxas_usage(log, cs.k7_label)
            sass = cs.k7_sass(lib._name)
            for name in sorted(set(ptxas) | set(sass)):
                if variant in SWEEP or name == "masked_kalman<f,5,3>":
                    print(json.dumps({"tree": "new", "variant": variant, "sass": name,
                                      "ptxas": ptxas.get(name, (0, None))[1], **sass.get(name, {})}), flush=True)
    finally:
        _build.library = real
        pool.shutdown()
    if old is not None:
        old()
        if zx is not None:
            old_fl = old_filter_logliks(old_libs["full"])
            model, seconds, _start = fit(*zx, old_fl)
            same = bool((np.asarray(model.cluster_assignment) == fit_new[2]).all())
            print(json.dumps({"fit": "old", "seconds": seconds, "iterations": model.last_iterations,
                              "status": model.last_status, "same_assignment_as_new": same}), flush=True)
            if not same or (model.last_iterations, model.last_status) != fit_new[:2]:
                fit_trace(start, old_fl)
    shutil.rmtree(data, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

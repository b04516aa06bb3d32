#!/usr/bin/env python3
"""Where K9's time goes on the card, on ``chip_smoke.py`` phase 10's data
(the gapped bench batch at n = 1e6, T = 10, d = 5, l = 3, C = 16, sorted
by pattern, 40 segments) under four assignments: the sorted fit's own,
uniformly random, 90% in one cluster, every row in one cluster.

For each assignment it prints the milliseconds (CUDA events over
``--reps`` calls after a warm-up) of the Gram kernels alone
(``mstep_kernels._grams_kernel``: the plan, the pieces and the reduce)
and of the whole wrapper (with ``_select_stats`` in torch), for three
builds of ``csrc/mstep_gram.cu``, each compiled alone into a library of
its own from a copy of the source:

- ``full``: the source as it is;
- ``no_fma``: the FMAs of ``gram_pieces`` removed (the plan, the row
  gather with its clean-up and barriers, the reduce);
- ``no_gather``: the ``cp.async`` copies removed (the plan, the FMAs on
  whatever the stage buffers hold, the reduce);

then each kernel's device time in the full build under ``torch.profiler``
(``gram_count``, ``gram_scan``, ``gram_scatter``: the plan;
``gram_pieces``; ``gram_reduce``), and the registers and spills
``ptxas -v`` gives each kernel.  With ``--old DIR`` (the root of an
older tree, e.g. a ``git archive`` of the parent commit), that tree's K9
wrapper and Gram kernel are timed on the same inputs in a subprocess,
before and after this tree's (old, new, new, old).

With ``--old`` and ``--fit-trace`` it also follows phase 10's fit from
its start, iteration by iteration: at each step the M step runs on the
trajectory's assignment with both trees' K9, each set of parameters goes
through one E step (K8), and the rows whose new assignments differ are
printed with their float64 score gap under this tree's parameters
(top-2 gap over 1 + |top score|), so that a different iteration count
can be traced to the near ties it flips.

Usage, on a machine with the card and ``nvcc``::

    python3 tools/k9_phase_split.py [--old chip_scratch/parent [--fit-trace]] [--reps 20]

Prints the card's name and power limit first, then one JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from variant_build import build, card_line, event_ms  # noqa: E402  (tools/, the script's own directory)

# each variant's edits of csrc/mstep_gram.cu: (text, replacement)
VARIANTS = {
    "full": [],
    "no_fma": [("            acc[ia][ib] = fused_ma(a[ia], b[ib], acc[ia][ib]);\n", "{}\n")],
    "no_gather": [("        cp_async<BYTES>(dst + (size_t)rr * ld + swz(b), src + b);\n", "{}\n")],
}

# the older tree's side (run in a subprocess with that tree first on the
# path): its wrapper and Gram kernel on the saved inputs
_OLD = r"""
import json, sys
from pathlib import Path
import numpy as np, torch
root, tools, data, reps = Path(sys.argv[1]), sys.argv[2], Path(sys.argv[3]), int(sys.argv[4])
sys.path[:0] = [str(root), tools]
from variant_build import build, event_ms
from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import mstep_kernels as msk
sigs = {k: t for k, t in _build._SIGNATURES.items() if "mstep_gram" in k}
lib = build(root / "multimodal_trajectory_modeling_tpu_torch" / "csrc", ["mstep_gram.cu"], signatures=sigs)[0]
_build.library = lambda: lib
dev = torch.device("cuda")
v = torch.tensor(np.load(data / "v.npy"), device=dev)
pat = torch.tensor(np.load(data / "pat.npy"), device=dev)
meta = json.loads((data / "meta.json").read_text())
sizes = tuple(meta["sizes"])
kw = dict(sizes=sizes, T=meta["T"], d=meta["d"], l=meta["l"], n_clusters=meta["C"])
out = {}
for name in meta["assignments"]:
    a = torch.tensor(np.load(data / f"a_{name}.npy"), device=dev)
    out[name] = {"kernel_ms": event_ms(lambda: msk._grams_kernel(v, a, sizes, meta["C"]), reps),
                 "wrapper_ms": event_ms(lambda: msk.mstep_stats_gram_sorted(v, a, pat, **kw), reps)}
print(json.dumps(out))
"""


def build_variant(edits: list, out_dir: Path, report: bool = False) -> ctypes.CDLL:
    """``csrc/mstep_gram.cu`` compiled alone after ``edits`` (pairs of text
    and its replacement), its functions' argument types set; with
    ``report`` its kernels' ``ptxas -v`` lines printed."""
    from multimodal_trajectory_modeling_tpu_torch.ops import _build

    sigs = {k: t for k, t in _build._SIGNATURES.items() if "mstep_gram" in k}
    lib, out = build(_build._SRC_DIR, ["mstep_gram.cu"], out_dir, edits={"mstep_gram.cu": edits},
                     signatures=sigs)
    if report:
        lines = out.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and "gram_" in ln:
                props = [x.split(":", 1)[-1].strip() for x in lines[i + 1 : i + 4]
                         if "registers" in x or "spill" in x]
                print(json.dumps({"ptxas": ln.split("'")[1], "usage": "; ".join(props)}), flush=True)
    return lib


def old_grams_fn(root: Path, out_dir: Path):
    """The older tree's K9 Gram kernels (its ``csrc/mstep_gram.cu`` built
    alone; the per-(chunk, cluster) body of the ``mtm_mstep_gram`` with 13
    arguments) as a function ``(v, assign, sizes, C) -> G``."""
    import torch

    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import estep_kernels as ek

    P_, I_ = ctypes.c_void_p, ctypes.c_int
    sigs = {"mtm_mstep_gram_padded": [I_],
            "mtm_mstep_gram": [I_, I_, P_, P_, P_, P_, P_, P_, I_, I_, I_, I_, P_]}
    lib = build(root / "multimodal_trajectory_modeling_tpu_torch" / "csrc", ["mstep_gram.cu"], out_dir,
                signatures=sigs)[0]

    def grams(v, assign, sizes, C):
        n, D = v.shape
        P = len(sizes)
        up = lib.mtm_mstep_gram_padded(D)
        chunk = 16384
        while chunk < n and (n // chunk + P) * C * up * up * v.element_size() > 512 * 2**20:
            chunk *= 2
        table, first = ek.segment_table(tuple(sizes), chunk, v.device)
        part = torch.empty((table.shape[0], C, up, up), dtype=v.dtype, device=v.device)
        G = torch.empty((P, C, D + 1, D + 1), dtype=v.dtype, device=v.device)
        rc = lib.mtm_mstep_gram(v.device.index or 0, {torch.float32: 0, torch.float64: 1}[v.dtype],
                                v.data_ptr(), assign.data_ptr(), table.data_ptr(), first.data_ptr(),
                                part.data_ptr(), G.data_ptr(), D, P, C, table.shape[0],
                                torch.cuda.current_stream(v.device).cuda_stream)
        _build.check(rc, "old mstep_stats_gram_sorted")
        return G

    return grams


def fit_trace(start, old_grams) -> None:
    """Phase 10's fit from ``start`` (``em.train_em_sorted``'s arguments),
    along this tree's trajectory, with both trees' M steps at each step."""
    import torch

    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.ops import estep_kernels as ek
    from multimodal_trajectory_modeling_tpu_torch.ops import mstep_kernels as msk

    args, kw = start
    params0, a, _z, _x, v, pat = args
    sizes, T, C = kw["sizes"], _z.shape[0], params0.pi.shape[0]
    d, l = _z.shape[-1], _x.shape[-1]
    v_t, v64_t = v.T.contiguous(), v.T.double().contiguous()
    new_grams = msk._grams_kernel

    def mstep(grams, assign):
        msk._grams_kernel = grams
        try:
            return em.mstep_sorted(v, assign, pat, sizes=sizes, T=T, d=d, l=l, n_clusters=C)
        finally:
            msk._grams_kernel = new_grams

    a = a.to(torch.int32)
    for it in range(1, kw.get("n_steps", 30) + 1):
        p_new, p_old = mstep(new_grams, a), mstep(old_grams, a)
        rel = max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30)) for x, y in zip(p_new, p_old))
        a_new, counts, sw = em.estep_assign_sorted(p_new, v, pat, a, sizes=sizes, T=T, v_sorted_t=v_t)
        a_old, _c, sw_old = em.estep_assign_sorted(p_old, v, pat, a, sizes=sizes, T=T, v_sorted_t=v_t)
        diff = torch.nonzero(a_new != a_old).squeeze(1)
        line = {"iteration": it, "params_max_rel_diff": rel, "switches_new": int(sw), "switches_old": int(sw_old),
                "rows_differing": int(diff.numel())}
        if diff.numel():
            p64 = em.MixtureParams(*(t.double() for t in p_new))
            means, covs = em.cluster_joint_moments(p64, T)
            minv, const = ek.precompute_cluster_pattern_inverses(means, covs, pat)
            top2 = ek.sorted_scores(v64_t, means, minv, const, torch.log(p64.pi), pat,
                                    sizes=sizes)[:, diff].topk(2, dim=0).values
            gap = (top2[0] - top2[1]) / (1 + top2[0].abs())
            line["max_rel_score_gap"] = float(gap.max())
        print(json.dumps(line), flush=True)
        status = int(em._em_termination(sw, counts, em.STATUS_RUNNING, min_members=3)[3])
        a = a_new
        if status != em.STATUS_RUNNING:
            print(json.dumps({"trajectory_status": status, "iterations": it}), flush=True)
            break


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable
    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import mstep_kernels as msk

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="root of the tree whose K9 to time beside this one")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--fit-trace", action="store_true", help="with --old: follow phase 10's fit with both K9s")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_phase_split: no CUDA card", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    T, d, l, C, N = cs.T, cs.D, cs.L, cs.C, cs.N

    # phase 10's data and fit (the fit builds the whole library)
    z, x, _lens = cs.bench_batch(N, seed=10)
    z, x = cs.add_gaps(z, x, seed=10)
    np.random.seed(10)
    model = MMLinGaussSS_marginalizable(n_clusters=C, states=z, observations=x, device="cuda")
    del z, x
    from multimodal_trajectory_modeling_tpu_torch.models import em

    start = []
    train_sorted = em.train_em_sorted

    def keep_start(*a, **k):  # the fit's own starting point, for --fit-trace
        start.append((a, k))
        return train_sorted(*a, **k)

    em.train_em_sorted = keep_start
    t0 = time.perf_counter()
    try:
        model.train(fast=True, n_steps=30)
    finally:
        em.train_em_sorted = train_sorted
    order, sizes, _z, _x, v, pat, _pid = model._sorted_batch()
    fit = torch.tensor(model.cluster_assignment, dtype=torch.int32, device=dev)[order]
    print(json.dumps({"fit_seconds": time.perf_counter() - t0, "iterations": model.last_iterations,
                      "status": model.last_status, "segments": len(sizes),
                      "fit_cluster_sizes": torch.bincount(fit.long(), minlength=C).tolist()}), flush=True)
    rng = np.random.default_rng(3)
    n = v.shape[0]
    assignments = {
        "fit": fit,
        "random": torch.tensor(rng.integers(0, C, n).astype(np.int32), device=dev),
        "ninety": torch.tensor(np.where(rng.random(n) < 0.9, 3, rng.integers(0, C, n)).astype(np.int32),
                               device=dev),
        "one": torch.zeros(n, dtype=torch.int32, device=dev),
    }
    kw = dict(sizes=sizes, T=T, d=d, l=l, n_clusters=C)

    def time_all(tag):
        out = {name: {"kernel_ms": event_ms(lambda: msk._grams_kernel(v, a, sizes, C), args.reps),
                      "wrapper_ms": event_ms(lambda: msk.mstep_stats_gram_sorted(v, a, pat, **kw), args.reps)}
               for name, a in assignments.items()}
        print(json.dumps({"body": tag, **out}), flush=True)

    data = Path(tempfile.mkdtemp())
    old = None
    if args.old is not None:
        np.save(data / "v.npy", v.cpu().numpy())
        np.save(data / "pat.npy", pat.cpu().numpy())
        for name, a in assignments.items():
            np.save(data / f"a_{name}.npy", a.cpu().numpy())
        (data / "meta.json").write_text(json.dumps({"sizes": list(sizes), "T": T, "d": d, "l": l, "C": C,
                                                    "assignments": list(assignments)}))

        def old():
            proc = subprocess.run([sys.executable, "-c", _OLD, str(args.old.resolve()), str(TOOLS), str(data),
                                   str(args.reps)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"the old tree failed:\n{proc.stderr[-3000:]}")
            print(json.dumps({"body": "old", **json.loads(proc.stdout.strip().splitlines()[-1])}), flush=True)

        old()
    real = _build.library
    try:
        for variant, edits in VARIANTS.items():
            lib = build_variant(edits, data, report=variant == "full")
            _build.library = lambda lib=lib: lib
            time_all(variant)
            if variant == "full":
                time_all("full")
                # each kernel's device time under the profiler
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                for name, a in assignments.items():
                    msk._grams_kernel(v, a, sizes, C)
                    with torch.profiler.profile(activities=acts) as prof:
                        for _ in range(5):
                            msk._grams_kernel(v, a, sizes, C)
                        torch.cuda.synchronize()
                    split = {}
                    for e in prof.key_averages():
                        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
                            key = next((k for k in ("gram_count", "gram_scan", "gram_scatter", "gram_pieces",
                                                    "gram_reduce", "Memset") if k in e.key), e.key[:40])
                            split[key] = split.get(key, 0.0) + us / 1e3 / 5
                    print(json.dumps({"profile": name, "device_ms": split}), flush=True)
    finally:
        _build.library = real
    if old is not None:
        old()
        if args.fit_trace:
            fit_trace(start[0], old_grams_fn(args.old.resolve(), data))
    shutil.rmtree(data, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

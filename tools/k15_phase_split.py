#!/usr/bin/env python3
"""Where K15's time goes on the card (``mstep_stats_zx`` / ``mstep_stats_pallas``:
the per-cluster Khatri-Rao statistics of the masked M step), at the masked
route's shapes: ``chip_smoke.py`` phase 13's batch (the bench batch with
every coordinate also missing with p = 0.05, n = 1e6, T = 10, d = 5, l = 3)
and phase 14's gapped batch (T = 128, n = 2.5e5), C = 16, float32, on
uniformly random assignments and with every row in one cluster; and at
ADNI's (d, l) = (2, 4), n = 1e6, T = 10, on random assignments (the full,
general and packed forms and, with ``--old``, the old body).

This tree's ``csrc/mstep_stats.cu`` is built from edited copies
(``tools/variant_build.py``) and called through its C interface on the
(T, n, ·) tensors as the masked trainer holds them; each variant is timed
by CUDA events over ``--reps`` calls after a warm-up and by
``torch.profiler`` (the body's and the reduce's device time):

- ``full``: the source as it is (the fast body);
- ``general``: the general body on the same inputs;
- ``no_copies``: the ring filled for the first two items only (the body
  sums what the stages hold);
- ``no_flags``: every pair taken as finite (no finiteness tests);
- ``no_sums``: no multiply-adds (the row sums are zeros);
- ``no_combine``: the runs' shuffle tree and the table's update left out
  (the rows' order by cluster still taken; the sums kept live);
- ``copies_only``: neither the sums nor the combine;
- ``packed``: the full body on views of the packed batch (row-major
  copies);
- design choices, each held to ``full`` bit for bit: ``lb4`` (the fast
  body built for four blocks an SM, not three) and ``ring3`` (a ring of
  three stages);
- ``clocks``: lane 0 of each warp reads ``clock64`` at the item's phase
  boundaries; the mean SM cycles an item spends waiting for its stage
  (copies and the leading barrier), in the part's steps, in the runs' sums
  into the table, and at the trailing barrier.

With ``--old DIR`` (the root of an older tree, e.g. a ``git archive`` of
the parent commit), that tree's ``csrc/mstep_stats.cu`` (the float32
kernel with a thread an entry) is built alone and called as its wrapper
called it, on the packed batch, in turns with this tree's body and its
general body (old, new, general, general, new, old), its outputs held to
the float64 sums within 1e-4 of the magnitudes;
and its own variants: ``old_no_copies`` (the tile filled with ones, not
read), ``old_no_flags`` (the finiteness tests left out), ``old_no_sums``
(the step loop's multiply-adds left out; the per-row table update stays),
``old_no_rows`` (the whole entry loop left out: copies, flags, reduce).

With ``--fit-trace``, ``chip_smoke.py`` phase 13's masked fit (its data,
seed and start) runs four times from the same start: K15's M step and the
plain einsum form's, each in float32 and in float64 (K7 and K15 in
float64 too); each fit's iterations and status, and at each iteration the
rows whose float32 assignments differ from the float64 K15 fit's and
between the two float32 fits, with their score gaps under the float32
fit's own parameters; then ``chip_smoke.masked_first_parting`` on phase
13's start and on phase 14's gapped fit's start (``K15_TRACE_LONG=0``
leaves the latter out): the first iteration at which the two float32 fits
part, each differing row's float64 gap in float32 ulps of its score, each
form's largest score error and its rows off the float64 assignment.

Usage, on a machine with the card and ``nvcc``::

    mkdir -p chip_scratch/parent
    git archive <old commit> multimodal_trajectory_modeling_tpu_torch | tar -x -C chip_scratch/parent
    python3 tools/k15_phase_split.py [--old chip_scratch/parent] [--fit-trace] [--reps 20]

Prints the card's name and power limit first, then one JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from variant_build import build, card_line, event_ms  # noqa: E402  (tools/, the script's own directory)

_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
NEW_SIG = {
    "mtm_mstep_stats_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    "mtm_mstep_stats": [_I, _I, _P, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
}
OLD_SIG = {
    "mtm_mstep_stats_tile": [_I, _I, _I, _I, _I, _I],
    "mtm_mstep_stats": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P],
}
SRC = "mstep_stats.cu"
NEW_EDITS = {
    "no_copies": [("if (k < nitems) {", "if (k < 2 && k < nitems) {")],
    "no_flags": [
        ("fz = fz && finite(v);\n      u[j] = zp[j];", "u[j] = zp[j];"),
        ("fz = fz && finite(v);\n      u[j] = static_cast<double>(v);", "u[j] = static_cast<double>(v);"),
        ("fx = fx && finite(v);", ""),
    ],
    "no_sums": [
        ("if (act && t > 0 && fz && fp) add_rows<UT, A0, A1>(acc, u);", ""),
        ("if (act && fz && fx) add_rows<UM, A0, A1>(acc, u);", ""),
        ("add_rows<UI, I0, I1>(acc + tri_rows(UM, A0, A1), ui);", ""),
    ],
    "no_combine": [("for (int o = 1; o < maxrun; o <<= 1) {", "for (int o = 1; o < maxrun && key < -1; o <<= 1) {"),
                   ("|| c < 0) return;", "|| c < 0x7ffffff0) return;")],
}
NEW_EDITS["copies_only"] = NEW_EDITS["no_sums"] + NEW_EDITS["no_combine"]
# design choices, each held to ``full`` bit for bit
NEW_EDITS["lb4"] = [("__launch_bounds__(kFastThreads, 3) stats_fast", "__launch_bounds__(kFastThreads, 4) stats_fast")]
NEW_EDITS["ring3"] = [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]
# lane 0 of each warp of the fast body reads clock64 at the item's phase
# boundaries: the wait for the stage (copies and the leading barrier), the
# part's steps, the runs' sums into the table, the trailing barrier
CLOCKS = [
    ("constexpr int kRows = 32;", "__device__ unsigned long long g_k15_clk[8];\nconstexpr int kRows = 32;"),
    ("  bool fp = false;\n  int c = -1, rr = r;",
     "  long long ck_prev = clock64();\n  unsigned long long ck[4] = {0, 0, 0, 0};\n  bool fp = false;\n  int c = -1, rr = r;"),
    ("    __syncthreads();  // item k has landed for every thread\n    const T* s = w.stage(ring, k);\n    const int nr = w.rows(k), t0 = w.t0(k), t1 = w.t1(k), tz = w.tz(k);\n    if (t0 == 0) {\n      // the tile's",
     "    __syncthreads();  // item k has landed for every thread\n    long long ck0 = clock64();\n    ck[0] += ck0 - ck_prev;\n    const T* s = w.stage(ring, k);\n    const int nr = w.rows(k), t0 = w.t0(k), t1 = w.t1(k), tz = w.tz(k);\n    if (t0 == 0) {\n      // the tile's"),
    ("      part_chunk<T, DD, LL, 3>(acc, zp, fp, zs, zst, xs, xst, t0, t1, tz, act);\n    if (t1 == w.T_) {",
     "      part_chunk<T, DD, LL, 3>(acc, zp, fp, zs, zst, xs, xst, t0, t1, tz, act);\n    long long ck1 = clock64();\n    ck[1] += ck1 - ck0;\n    if (t1 == w.T_) {"),
    ("    __syncthreads();  // the stage may be refilled",
     "    long long ck2 = clock64();\n    ck[2] += ck2 - ck1;\n    __syncthreads();  // the stage may be refilled\n    ck_prev = clock64();\n    ck[3] += ck_prev - ck2;"),
    ("  write_partial<T>(s_acc, part, a, c_lo);\n}\n\n// ---------------------------------------------------------------------\n// The general body",
     "  if ((threadIdx.x & 31) == 0) {\n    for (int q = 0; q < 4; ++q) atomicAdd(&g_k15_clk[q], ck[q]);\n    atomicAdd(&g_k15_clk[4], (unsigned long long)w.nitems);\n  }\n  write_partial<T>(s_acc, part, a, c_lo);\n}\n\n// ---------------------------------------------------------------------\n// The general body"),
    ("                       T, d, l, C, s);\n  return -1;\n}\n",
     "                       T, d, l, C, s);\n  return -1;\n}\n\nextern \"C\" int mtm_k15_clocks(unsigned long long* out, int reset) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, g_k15_clk, sizeof(unsigned long long) * 8);\n"
     "  if (e == cudaSuccess && reset) {\n    unsigned long long z[8] = {0};\n    e = cudaMemcpyToSymbol(g_k15_clk, z, sizeof(z));\n  }\n"
     "  return (int)e;\n}\n"),
]
NEW_EDITS["clocks"] = CLOCKS
SAME_BITS = ("packed", "lb4", "ring3", "clocks")
OLD_EDITS = {
    "old_no_copies": [("s_u[r * W + k] = v[(t0 + r) * D + k];", "s_u[r * W + k] = T(1);")],
    "old_no_flags": [
        ("for (int j = 0; j < d; ++j) zf = zf && isfinite(u[t * d + j]);", ""),
        ("for (int j = 0; j < l; ++j) xf = xf && isfinite(u[T_ * d + t * l + j]);", ""),
        ("for (int j = 0; j < d; ++j) zn = zn && isfinite(u[(t + 1) * d + j]);", ";"),
    ],
    "old_no_sums": [("if (ok[t]) s = fused_ma(u[a0 + t * sa], u[b0 + t * sb], s);", "")],
    "old_no_rows": [("const int* en = s_ent + e * kEntry;", "continue;\n      const int* en = s_ent + e * kEntry;")],
}
C, D, L = 16, 5, 3


def device_ms(torch, fn, reps):
    """Device ms a call of the body and of the reduce (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, rec = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and "stats" in e.key:
            k = "reduce" if "reduce" in e.key else "body"
            out[k] = out.get(k, 0.0) + us / 1e3
            rec[k] = rec.get(k, 0) + e.count
    res = {k: round(v / max(rec[k], 1), 4) for k, v in out.items()}
    res["recorded"] = rec
    return res


def parting(part):
    """``chip_smoke.masked_first_parting``'s result with its gaps cut to the
    largest and the first eight."""
    if part is None:
        return {"iteration": None}
    gaps = part.pop("gaps_ulps")
    return {**part, "max_gap_ulps": gaps[0], "gaps_ulps_first": [round(g, 1) for g in gaps[:8]]}


def fit_trace():
    """Phase 13's masked fit from its start, four ways (see the module's
    docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable, em
    from multimodal_trajectory_modeling_tpu_torch.ops import kalman_kernels as kk

    import os

    n, device = int(os.environ.get("K15_TRACE_N", cs.N)), os.environ.get("K15_TRACE_DEVICE", "cuda")
    if device == "cuda":
        print(card_line(), flush=True)
    z, x, _lens = cs.bench_batch(n, seed=12)
    z, x = cs.scatter_nans(z, x, seed=12)
    z[:, ::100_003] = np.nan
    x[:, ::100_003] = np.nan
    np.random.seed(13)
    model = MMLinGaussSS_marginalizable(n_clusters=C, states=z, observations=x, device=device)
    starts, real_train = [], em.train_em_masked_kalman

    def keep(*a, **k):
        starts.append((a, k))
        return real_train(*a, **k)

    em.train_em_masked_kalman = keep
    try:
        model.train(fast=True, n_steps=30)
    finally:
        em.train_em_masked_kalman = real_train
    (p0, a0, zd, xd), kw = starts[0][0][:4], starts[0][1]
    print(json.dumps({"fit": "model.train", "iterations": model.last_iterations, "status": model.last_status}), flush=True)
    print(json.dumps({"first_parting": "masked", **parting(cs.masked_first_parting(starts[0], C))}), flush=True)
    if os.environ.get("K15_TRACE_LONG", "1") == "1":
        # phase 14's gapped fit: its data, seed and start
        zl, xl, _l = cs.near_clusters(250_000 if device == "cuda" else n, seed=14, steps=128, lengths=(64, 100, 128))
        zl, xl = cs.add_gaps(zl, xl, seed=14)
        np.random.seed(14)
        long_model = MMLinGaussSS_marginalizable(n_clusters=C, states=zl, observations=xl, device=device)
        em.train_em_masked_kalman = keep
        try:
            long_model.train(fast=True, n_steps=10)
        finally:
            em.train_em_masked_kalman = real_train
        print(json.dumps({"fit": "long-T-masked", "iterations": long_model.last_iterations,
                          "status": long_model.last_status}), flush=True)
        print(json.dumps({"first_parting": "long-T-masked", **parting(cs.masked_first_parting(starts[-1], C))}),
              flush=True)
        del long_model, zl, xl

    def trajectory(impl, dtype):
        zt, xt = zd.to(dtype), xd.to(dtype)
        packed = kk.plan_masked_batch(zt, xt)
        mkw = dict(n_clusters=C, impl=impl, reg_mode=kw.get("reg_mode", "lstsq"), alpha=kw.get("alpha", 0.0))
        p = em.mstep(zt, xt, a0.to(torch.int32), **mkw)
        a, hist = a0.to(torch.int32), []
        for _it in range(kw.get("n_steps", 30)):
            ll = em._filter_logliks(p, packed)
            a_new, counts, sw = em._hard_estep(p.pi, ll, a, C)
            status = int(em._em_termination(sw, counts, em.STATUS_RUNNING, min_members=kw.get("min_members", 3))[3])
            sc = torch.log(p.pi)[:, None] + ll
            hist.append((a_new, sc.float(), int(counts.min())))
            a = a_new
            if status != em.STATUS_RUNNING:
                break
            p = em.mstep(zt, xt, a, **mkw)
        return hist, status

    runs = {(impl, str(dt)[6:]): trajectory(impl, dt) for impl in ("pallas", "xla") for dt in (torch.float32, torch.float64)}
    for key, (hist, status) in runs.items():
        print(json.dumps({"fit": key, "iterations": len(hist), "status": status,
                          "smallest_cluster": [h[2] for h in hist]}), flush=True)
    ref = runs[("pallas", "float64")][0]
    for key in (("pallas", "float32"), ("xla", "float32")):
        hist = runs[key][0]
        for it in range(min(len(hist), len(ref))):
            a, sc, _m = hist[it]
            diff = torch.nonzero(a != ref[it][0]).squeeze(1)
            if diff.numel():
                s1 = sc[:, diff].gather(0, a[diff].long()[None])[0].double()
                s2 = sc[:, diff].gather(0, ref[it][0][diff].long()[None])[0].double()
                gap = float(((s1 - s2).abs() / (1 + s1.abs())).max())
            else:
                gap = 0.0
            print(json.dumps({"trace": key, "vs": "pallas float64", "iteration": it + 1,
                              "rows_differing": int(diff.numel()), "max_rel_gap": f"{gap:.3e}"}), flush=True)
    h1, h2 = runs[("pallas", "float32")][0], runs[("xla", "float32")][0]
    for it in range(min(len(h1), len(h2))):
        diff = int((h1[it][0] != h2[it][0]).sum())
        print(json.dumps({"trace": "pallas float32 vs xla float32", "iteration": it + 1, "rows_differing": diff}),
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--fit-trace", action="store_true")
    ap.add_argument("--skip-split", action="store_true", help="only the fit trace")
    args = ap.parse_args()
    if args.fit_trace:
        fit_trace()
    if args.skip_split:
        return
    import numpy as np
    import torch

    import chip_smoke as cs
    from multimodal_trajectory_modeling_tpu_torch.ops import mstep_kernels as msk

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    csrc = ROOT / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
    # every variant's nvcc at once
    jobs = {name: (csrc, edits, {**NEW_SIG, "mtm_k15_clocks": [_P, _I]} if name == "clocks" else NEW_SIG)
            for name, edits in [("full", None), *NEW_EDITS.items()]}
    if args.old:
        old_csrc = args.old / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
        jobs.update({name: (old_csrc, edits, OLD_SIG) for name, edits in [("old", None), *OLD_EDITS.items()]})
    (ROOT / "chip_scratch").mkdir(exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {name: pool.submit(build, src, [SRC], ROOT / "chip_scratch", {SRC: ed} if ed else None, sig)
                   for name, (src, ed, sig) in jobs.items()}
        built = {name: f.result() for name, f in futures.items()}
    libs = {name: lib for name, (lib, _log) in built.items()}
    for name in ("full", "lb4"):
        for ln in built[name][1].splitlines():
            if ("Used" in ln or "spill" in ln or "Compiling entry" in ln) and "general" not in ln:
                print(json.dumps({"ptxas": ln.strip(), "variant": name}))

    def new_call(lib, z, x, a, body=-1):
        T, n, d = z.shape
        l = x.shape[2]
        plan = (ctypes.c_int * 6)()
        zt, xt = msk._time_major(z), msk._time_major(x)
        rc = lib.mtm_mstep_stats_plan(0, msk._KINDS[z.dtype], body, int(zt), int(xt), T, d, l, C, n, plan)
        assert rc == 0, rc
        ent = msk._stats_entries(d, l, dev)
        part = torch.empty(plan[4] * C * ent.shape[0], dtype=torch.float64, device=dev)
        outs = tuple(torch.empty((u, C * u), dtype=z.dtype, device=dev) for u in msk._stats_widths(d, l))
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = lib.mtm_mstep_stats(0, msk._KINDS[z.dtype], plan, z.data_ptr(), z.stride(0), z.stride(1),
                                     x.data_ptr(), x.stride(0), x.stride(1), a.data_ptr(), ent.data_ptr(),
                                     part.data_ptr(), *(o.data_ptr() for o in outs), n, T, d, l, C, stream)
            assert rc == 0, rc
            return outs

        return call, list(plan)

    def old_call(lib, v, a, T, D, L):
        n = v.shape[0]
        u_t, u_m, u_i = msk._stats_widths(D, L)
        Dv = T * (D + L)

        def factor(rule, j):
            if rule == 0:
                return (j, D) if j < 2 * D else (Dv, 0)
            if rule == 1:
                if j < D:
                    return (j, D)
                return (T * D + j - D, L) if j < D + L else (Dv, 0)
            return (j, D) if j < D else (Dv, 0)

        rows = [(*factor(r, j), *factor(r, k), s, r, r, j, k)
                for r, (u, s) in enumerate(zip((u_t, u_m, u_i), (T - 1, T, 1))) for j in range(u) for k in range(j, u)]
        ent = torch.tensor(rows, dtype=torch.int32, device=dev)
        E = ent.shape[0]
        per_block = -(-n // min(528, n))
        blocks = -(-n // per_block)
        part = torch.empty((blocks, C, E), dtype=v.dtype, device=dev)
        outs = tuple(torch.empty((u, C * u), dtype=v.dtype, device=dev) for u in (u_t, u_m, u_i))
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = lib.mtm_mstep_stats(0, 0, v.data_ptr(), a.data_ptr(), ent.data_ptr(), part.data_ptr(),
                                     *(o.data_ptr() for o in outs), n, per_block, blocks, T, D, L, C, E, stream)
            assert rc == 0, rc
            return outs

        return call

    cases = {}
    z, x, _lens = cs.bench_batch(1_000_000, seed=12)
    cases["masked-T10"] = cs.scatter_nans(z, x, seed=12)
    z, x, _lens = cs.near_clusters(250_000, seed=14, steps=128, lengths=(64, 100, 128))
    cases["gapped-T128"] = cs.add_gaps(z, x, seed=14)
    # ADNI's (d, l) = (2, 4) at the bench's n and T: normal values, every
    # coordinate missing with p = 0.05
    rng = np.random.default_rng(24)
    cases["adni-shape-T10"] = cs.scatter_nans(rng.normal(size=(10, 1_000_000, 2)) * 3.0,
                                              rng.normal(size=(10, 1_000_000, 4)) * 3.0, seed=24)
    for label, (z_np, x_np) in cases.items():
        T, n, d = z_np.shape
        l = x_np.shape[2]
        z = torch.tensor(z_np, dtype=torch.float32, device=dev)
        x = torch.tensor(x_np, dtype=torch.float32, device=dev)
        v = torch.cat([z.permute(1, 0, 2).reshape(n, -1), x.permute(1, 0, 2).reshape(n, -1)], 1).contiguous()
        zv, xv = msk._joint_views(v, T, d, l)
        nbytes = 4 * (z.numel() + x.numel() + n)
        bound = nbytes / 3.35e12 * 1e3
        rng = np.random.default_rng(15)
        assigns = (("random", rng.integers(0, C, size=n)), ("one-cluster", np.full(n, 3)))
        for akind, a_np in assigns[:1] if (d, l) != (D, L) else assigns:
            a = torch.tensor(a_np.astype(np.int32), device=dev)
            ref, plan = new_call(libs["full"], z, x, a)
            want = tuple(o.clone() for o in ref())
            mag = msk.mstep_stats_zx_plain(z.double().abs(), x.double().abs(), a, n_clusters=C)
            exact = msk.mstep_stats_zx_plain(z.double(), x.double(), a, n_clusters=C)
            err = max(float(((w.double() - e).abs() / (m + 1e-300)).max()) for w, e, m in zip(want, exact, mag))
            print(json.dumps({"case": label, "assign": akind, "n": n, "T": T, "plan": plan, "bound_ms": round(bound, 4),
                              "bytes": nbytes, "full_err_over_magnitude": err}), flush=True)
            variants = {"full": ref, "general": new_call(libs["full"], z, x, a, body=1)[0],
                        "packed": new_call(libs["full"], zv, xv, a)[0]}
            if akind == "random" and (d, l) == (D, L):
                variants.update({k: new_call(libs[k], z, x, a)[0] for k in NEW_EDITS})
            for name, fn in variants.items():
                if name == "clocks":
                    clk = (ctypes.c_ulonglong * 8)()
                    fn()
                    torch.cuda.synchronize()
                    libs["clocks"].mtm_k15_clocks(clk, 1)
                    fn()
                    torch.cuda.synchronize()
                    libs["clocks"].mtm_k15_clocks(clk, 1)
                    items = max(clk[4], 1)  # each warp's lane 0 adds its cycles and its block's items
                    print(json.dumps({"case": label, "assign": akind, "variant": "clocks",
                                      "cycles_per_item_per_warp": {
                                          k: round(clk[i] / items, 1) for i, k in
                                          enumerate(("wait_for_stage", "steps", "runs_into_table", "trailing_barrier"))}}),
                          flush=True)
                out = fn()
                if name in ("general", *SAME_BITS):
                    same = all(torch.equal(p, q) for p, q in zip(out, want)) if name in SAME_BITS else None
                    gerr = max(float(((o.double() - e).abs() / (m + 1e-300)).max()) for o, e, m in zip(out, exact, mag))
                else:
                    same, gerr = None, None
                print(json.dumps({"case": label, "assign": akind, "variant": name,
                                  "events_ms": round(event_ms(fn, args.reps), 4),
                                  "device": device_ms(torch, fn, 10), "bit_equal_to_full": same,
                                  "err_over_magnitude": gerr}), flush=True)
            if args.old:
                old = old_call(libs["old"], v, a, T, d, l)
                got = old()
                oerr = max(float(((g.double() - e).abs() / (m + 1e-300)).max()) for g, e, m in zip(got, exact, mag))
                turns = {"old": [], "new": [], "general": []}
                for who in ("old", "new", "general", "general", "new", "old"):
                    fn = {"old": old, "new": ref, "general": variants["general"]}[who]
                    turns[who].append({"events_ms": round(event_ms(fn, args.reps), 4), "device": device_ms(torch, fn, 10)})
                print(json.dumps({"case": label, "assign": akind, "old_vs_new": turns,
                                  "old_err_over_magnitude": oerr}), flush=True)
                if akind == "random" and (d, l) == (D, L):
                    for name in OLD_EDITS:
                        fn = old_call(libs[name], v, a, T, d, l)
                        print(json.dumps({"case": label, "assign": akind, "variant": name,
                                          "events_ms": round(event_ms(fn, args.reps), 4),
                                          "device": device_ms(torch, fn, 10)}), flush=True)
            del a, ref, want, mag, exact
        del z, x, v, zv, xv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

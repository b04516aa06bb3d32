#!/usr/bin/env python3
"""Where the raw-batch EM kernel's time goes on the card (K6
``markov_em_fused_longT``, and K10/K11, the same body), on
``chip_smoke.py`` phase 16's data: phase 14's ``near_clusters`` batch at
n = 2.5e5, T = 128, lengths {64, 100, 128}, C = 16, under the weights of
phase 14's fit (``train(fast=True, n_steps=30)`` through Φ), and the bench
batch at n = 1e6, T = 10 under random weights for K10 and K11.

For each build of ``csrc/markov_em_batch.cu`` it prints the milliseconds
of K6 (the rows in the caller's order and, where the tree has a plan,
on the planned batch as the fit calls it), K10 and K11 by CUDA events over
``--reps`` calls after a warm-up, and under ``torch.profiler`` each
kernel's device time (the EM body and its reduce).  The builds, each
compiled alone from an edited copy of the source
(``tools/variant_build.py``):

- ``full``: the source as it is (the package's own build);
- ``build``: the row build alone (no scores, no statistics);
- ``build_scores``: the build and the scores (no statistics);
- ``sorted_stats``: the statistics by a stable per-tile counting sort of
  the columns by cluster and per-row register sums of each cluster's
  columns, in place of ``ordered_add`` (``markov_common.cuh``);
- ``no_copies``, ``no_window_sync``: the ring's copies, or its barrier,
  left out (wrong results; the time without that part);
  ``build_no_copies``: the build alone without its copies;
  ``copies_only``: the ring's copies and waits without the build;
- ``deep_ring``: the launch with the deepest ring that fits (8 stages, 2
  blocks an SM) in place of the one with the most warps an SM;
  ``one_step_stages``: stages of one step (the ring's 8 stages then run
  6 steps ahead, not 4).

An older tree's builds are its ``full``, ``build`` and ``build_scores``.

It prints ``ptxas -v`` for every instantiation of the body, with the
blocks and warps an SM that the registers and shared memory allow at the
timed shapes, and the SM clock and power ``nvidia-smi`` reads while K6
runs back to back.

With ``--old DIR`` (the root of an older tree, e.g. a ``git archive`` of
the parent commit) that tree's kernel and its variants are built and
timed on the same inputs in a subprocess, before and after this tree's
(old, new, new, old).  With ``--fit-trace`` as well, phase 17's fit
(``MTM_MARKOV_PRECOMP=0``: K6 every iteration) runs again with the older
tree's kernel in the place of this one's, from the same start; where the
two fits differ, each iteration of this tree's trajectory is taken with
both kernels (:func:`fit_trace`), and the rows whose assignments differ
are printed with their float64 score gap (top-2 gap over 1 + |top
score|).

Usage, on a machine with the card and ``nvcc``::

    python3 tools/k6_phase_split.py [--old DIR [--fit-trace]] [--reps 10]

Prints the card's name and power limit first, then one JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from variant_build import card_line  # noqa: E402  (tools/, the script's own directory)

# each variant's edits of csrc/markov_em_batch.cu: (text, replacement)
_NO_SCORES = [("    if constexpr (ARGMAX) {\n      T best = T(0);", "    if constexpr (false) {\n      T best = T(0);"),
              ("        if constexpr (ARGMAX) {\n          T best = s_best[j];",
               "        if constexpr (false) {\n          T best = s_best[j];")]
_ORDERED_ADD = "      ordered_add(s_acc, cs, s_na, tile, s_tile, ts, Fpad);\n"
_NO_STATS = [(_ORDERED_ADD, "")]
# the statistics by a stable per-tile counting sort of the columns by
# cluster (warp matches, one warp) and per-row register sums of each
# cluster's columns, in cluster order; its lists in the scores' scratch
_SORTED_STATS = r"""      if (ARGMAX && tile + 2 * C + 1 <= kParts * tile) {
        int* s_list = s_seg;
        int* s_start = s_list + tile;
        int* s_run = s_start + C + 1;
        const int lane = tid & 31;
        if (tid < 32) {
          const unsigned lt = (1u << lane) - 1u;
          for (int c = lane; c < C; c += 32) s_run[c] = 0;
          __syncwarp();
          for (int r0 = 0; r0 < tile; r0 += 32) {
            const int v = s_na[r0 + lane];
            const unsigned m = __match_any_sync(0xffffffffu, v);
            if (v >= 0 && (m & lt) == 0) s_run[v] += __popc(m);
            __syncwarp();
          }
          const int cnt = lane < C ? s_run[lane] : 0;
          int inc = cnt;
          for (int off = 1; off < 32; off <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, inc, off);
            if (lane >= off) inc += u;
          }
          __syncwarp();
          if (lane < C) s_start[lane] = s_run[lane] = inc - cnt;
          if (lane == C - 1) s_start[C] = inc;
          __syncwarp();
          for (int r0 = 0; r0 < tile; r0 += 32) {
            const int v = s_na[r0 + lane];
            const unsigned m = __match_any_sync(0xffffffffu, v);
            if (v >= 0) s_list[s_run[v] + __popc(m & lt)] = r0 + lane;
            __syncwarp();
            if (v >= 0 && (m & lt) == 0) s_run[v] += __popc(m);
            __syncwarp();
          }
        }
        cta_sync();
        for (int f = tid; f < Fpad; f += nt) {
          const T* row = s_tile + f * ts;
          T* a = s_acc + (size_t)f * cs;
          for (int c = 0; c < C; ++c) {
            const int b = s_start[c], e = s_start[c + 1];
            if (b == e) continue;
            T sum = row[s_list[b]];
#pragma unroll 4
            for (int q = b + 1; q < e; ++q) sum += row[s_list[q]];
            a[c] += sum;
          }
        }
      } else {
        ordered_add(s_acc, cs, s_na, tile, s_tile, ts, Fpad);
      }
"""
_NO_COPIES = [("    if (k + ns - 1 < nwin) issue(k + ns - 1);", "    if (false) issue(k + ns - 1);"),
              ("      if (k < nwin) issue(k);", "      if (false) issue(k);")]
VARIANTS = {
    "build": _NO_SCORES + _NO_STATS,
    "build_scores": _NO_STATS,
    "sorted_stats": [(_ORDERED_ADD, _SORTED_STATS)],
    # the build on whatever the stages hold: no copies issued (timing only)
    "no_copies": _NO_COPIES,
    "build_no_copies": _NO_SCORES + _NO_STATS + _NO_COPIES,
    # the copies alone: no step of the build (timing only)
    "copies_only": _NO_SCORES + _NO_STATS + [
        ("          if (t < ext) {\n            T zc[DM];\n            load_z(", "          if (false) {\n            T zc[DM];\n            load_z("),
        ("          if (t < ext) {\n            T zc[DM];\n#pragma unroll", "          if (false) {\n            T zc[DM];\n#pragma unroll"),
        ("          if (t < ext) {\n            const T* slab", "          if (false) {\n            const T* slab")],
    # one step a stage: the ring's 8 stages then run 6 steps ahead
    "one_step_stages": [("constexpr int kWin = 2;", "constexpr int kWin = 1;")],
    # the deepest ring that fits (8 stages, 2 blocks an SM) in place of
    # the most warps an SM
    "deep_ring": [("      if (blocks * tile > best.blocks * best.tile)", "      if (best.blocks == 0 && blocks > 0)")],
    # the stages' barrier left out (timing only)
    "no_window_sync": [("    cp_async_wait(ns - 3);\n    cta_sync();", "    cp_async_wait(ns - 3);")],
}
# the first port's body (one block per chunk, 64 of 192 threads scoring)
OLD_VARIANTS = {
    "build": [("        if constexpr (ARGMAX) {\n          T sc[CB];", "        if constexpr (false) {\n          T sc[CB];"),
              ("    if constexpr (STATS) ordered_add(", "    if constexpr (false) ordered_add(")],
    "build_scores": [("    if constexpr (STATS) ordered_add(", "    if constexpr (false) ordered_add(")],
}


def kernel_label(mangled):
    """``em_batch_kernel<f,5,3,1,16,1,1>`` (the template arguments in
    order) from a mangled name, or None."""
    m = re.search(r"(em_batch_(?:kernel|reduce))I([fd])((?:L[ib]\d+E)*)E", mangled)
    return m and f"{m.group(1)}<{m.group(2)},{','.join(re.findall(r'L[ib](\d+)E', m.group(3)))}>"


def occupancy(regs: int, threads: int, smem: int) -> dict:
    """Blocks and warps an SM that ``regs`` registers a thread, ``threads``
    a block and ``smem`` bytes of shared memory a block allow on an H100
    (64 K registers, allocated 256 a warp; 228 KB of shared memory, 1 KB
    of it reserved a block; 2048 threads; 32 blocks)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps if regs else 32
    by_smem = 233472 // (smem + 1024)
    blocks = min(by_regs, by_smem, 2048 // threads, 32)
    return {"threads": threads, "smem_bytes": smem, "blocks_per_sm": blocks, "warps_per_sm": blocks * warps,
            "limited_by": min((by_regs, "registers"), (by_smem, "shared memory"), (2048 // threads, "threads"))[1]}


def ptxas_lines(log: str) -> dict:
    """``{label: {"registers": R, "spill_stores": S, "spill_loads": L,
    "stack": B}}`` for the body's instantiations in an ``nvcc -Xptxas -v``
    log."""
    out, lines = {}, log.splitlines()
    for i, ln in enumerate(lines):
        name = kernel_label(ln) if "Compiling entry function" in ln else None
        if not name:
            continue
        text = " ".join(lines[i + 1 : i + 4])
        num = lambda pat: int(m.group(1)) if (m := re.search(pat, text)) else 0  # noqa: E731
        out[name] = {"registers": num(r"Used (\d+) registers"), "spill_stores": num(r"(\d+) bytes spill stores"),
                     "spill_loads": num(r"(\d+) bytes spill loads"), "stack": num(r"(\d+) bytes stack frame")}
    return out


# One tree's side, run in a subprocess with that tree first on the path:
# its library, its variants built alone, K6/K10/K11 timed on the saved
# inputs through the tree's own wrappers, the variants swapped in for the
# body's launch function.
_SIDE = r"""
import ctypes, hashlib, json, sys, subprocess, threading, time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
import numpy as np, torch
root, tools, data, reps = Path(sys.argv[1]), sys.argv[2], Path(sys.argv[3]), int(sys.argv[4])
variants, built = json.loads(sys.argv[5]), json.loads(sys.argv[6])
sys.path[:0] = [str(root), tools]
from variant_build import build, event_ms
from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
real = _build.library()
sigs = {k: t for k, t in _build._SIGNATURES.items() if k.startswith("mtm_markov_em_batch")}


class Swapped:  # the variant's body, everything else from the tree's library
    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib if name in sigs else real, name)


def load(path):
    lib = ctypes.CDLL(path)
    for name, argtypes in sigs.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, ""


src = root / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
with ThreadPoolExecutor(max(len(variants), 1)) as pool:
    futs = {v: pool.submit(load, built[v]) if v in built else
            pool.submit(build, src, ["markov_em_batch.cu"], data, edits={"markov_em_batch.cu": [tuple(e) for e in edits]},
                        signatures=sigs) for v, edits in variants.items()}
    libs = {v: f.result() for v, f in futs.items()}
log_path = _build.library_path().with_suffix(".log")
libs = {"full": (real, log_path.read_text() if log_path.exists() else ""), **libs}
dev = torch.device("cuda")
ld_ = lambda name: torch.tensor(np.load(data / f"{name}.npy"), device=dev)
k6 = {k: ld_("k6_" + k) for k in ("zt", "xt", "lens", "prev", "W1", "W2", "W3")}
b10 = {k: ld_("b10_" + k) for k in ("zt", "xt", "lens", "prev", "W1", "W2", "W3", "Wg")}
T14, T10, d, l = (int(v) for v in np.load(data / "shape.npy"))
planned = hasattr(mk, "plan_raw_batch")
if planned:
    raw = mk.plan_raw_batch(k6["zt"].view(T14, d, -1).permute(0, 2, 1), k6["xt"].view(T14, l, -1).permute(0, 2, 1),
                            k6["lens"])
    prev_p = k6["prev"][raw.plan.rows.long()]
calls = {
    "k6_ms": lambda: mk.markov_em_fused_longT(k6["zt"], k6["xt"], k6["lens"], k6["prev"], k6["W1"], k6["W2"], k6["W3"],
                                              T=T14, d=d, l=l),
    "k10_ms": lambda: mk.markov_assign_suffix(b10["zt"], b10["xt"], b10["lens"], b10["prev"], b10["W1"], b10["W2"],
                                              b10["W3"], T=T10, d=d, l=l),
    "k11_ms": lambda: mk.markov_em_fused(b10["zt"], b10["xt"], b10["lens"], b10["prev"], b10["Wg"], T=T10, d=d, l=l),
}
if planned:
    # the plan from a (T, n, d) batch against the transposing copy it folds in
    z3, x3 = (k6[k].view(T14, m, -1).permute(0, 2, 1).contiguous() for k, m in (("zt", d), ("xt", l)))
    calls["plan_ms"] = lambda: mk.plan_raw_batch(z3, x3, k6["lens"])
    calls["transpose_only_ms"] = lambda: (z3.permute(0, 2, 1).reshape(T14 * d, -1), x3.permute(0, 2, 1).reshape(T14 * l, -1))
    calls["k6_planned_ms"] = lambda: mk.markov_em_fused_longT(raw.z_t, raw.x_t, raw.lens, prev_p, k6["W1"], k6["W2"],
                                                             k6["W3"], T=T14, d=d, l=l, plan=raw.plan)


def profiled(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and "em_batch" in e.key and t > 0:
            name = "reduce" if "reduce" in e.key else "body"
            us, cnt = out.get(name, (0.0, 0))
            out[name] = (us + t, cnt + e.count)
    return {k: {"ms": us / 1e3 / max(c, 1), "recorded": c, "of": reps} for k, (us, c) in out.items()}


def clocks_under(fn, seconds=2.0):
    got = {}

    def read():
        time.sleep(seconds / 2)
        got["sm_mhz, max_mhz, power, temp"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()

    th = threading.Thread(target=read)
    t0 = time.perf_counter()
    th.start()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    th.join()
    return got


config = {}
if hasattr(real, "mtm_markov_em_batch_config"):
    cfg = (ctypes.c_int * 6)()
    for what, kind, argmax, stats in (("k6_f32", 0, 1, 1), ("k10_f32", 0, 1, 0), ("k6_f64", 1, 1, 1)):
        rc = real.mtm_markov_em_batch_config(kind, d, l, mk._canonical_rows(d, l), int(k6["W1"].shape[0]), argmax, stats, cfg)
        config[what] = {"rc": rc, "tile": cfg[0], "threads": cfg[1], "smem_bytes": cfg[2], "blocks_per_sm": cfg[3],
                        "stages": cfg[4], "sms": cfg[5]}
out = {"config": config}
# K5's Φ on phase 16's batch, to hold the tree's row build against another's bit for bit
phi5 = mk.markov_materialize_features_longT(k6["zt"], k6["xt"], k6["lens"], T=T14, d=d, l=l)
out["config"]["k5_phi_sha256"] = hashlib.sha256(phi5.cpu().numpy().tobytes()).hexdigest()
del phi5
for variant, (lib, log) in libs.items():
    _build.library = (lambda: real) if variant == "full" else (lambda lib=lib: Swapped(lib))
    if hasattr(mk, "_batch_config"):  # the launch is the build's own
        mk._batch_config.cache_clear()
    res = {"lib": getattr(lib, "_name", ""), "log": log}
    for name, fn in calls.items():
        res[name] = event_ms(fn, reps)
    if variant == "full":
        res["profiler"] = {name: profiled(fn) for name, fn in calls.items() if name.startswith("k")}
        res["clocks"] = clocks_under(calls["k6_planned_ms" if planned else "k6_ms"])
    out[variant] = res
_build.library = lambda: real
print(json.dumps(out))
"""


def old_batch_kernel(lib_path):
    """The first port's K6 (its launch function of 26 arguments, one block
    per chunk of rows, no plan) in the place of ``mk.markov_em_fused_longT``:
    the rows in the order given, ``plan`` ignored."""
    import ctypes
    import functools

    import torch

    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
    from multimodal_trajectory_modeling_tpu_torch.ops.markov import canonical_weights

    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(lib_path).mtm_markov_em_batch
    fn.argtypes = [I_, I_, *[P_] * 14, ctypes.c_longlong, *[I_] * 8, P_]
    fn.restype = I_

    def launch(z_t, x_t, lens, prev, W1, W2, W3, *, T, d, l, assign_mode="argmax", plan=None):
        Wc = canonical_weights(W1, W2, W3, d=d, l=l)
        n, C, F = z_t.shape[1], Wc.shape[0], Wc.shape[1]
        F_pad = mk._canonical_rows(d, l)
        wc = torch.zeros((C, F_pad), dtype=Wc.dtype, device=Wc.device)
        wc[:, :F] = Wc
        chunk = min(1024, max(256, 64 * -(-(-(-n // 528)) // 64)))
        nb = -(-n // chunk)
        empty = functools.partial(torch.empty, device=z_t.device)
        ps, pc = empty((nb, F_pad, C), dtype=z_t.dtype), empty((nb, C), dtype=torch.int32)
        psw, po = empty((nb,), dtype=torch.int32), empty((nb,), dtype=z_t.dtype)
        assign, counts = empty((n,), dtype=torch.int32), empty((C,), dtype=torch.int32)
        sw, macc, obj = empty((), dtype=torch.int32), empty((F_pad, C), dtype=z_t.dtype), empty((), dtype=z_t.dtype)
        ptrs = [t.data_ptr() for t in (z_t, x_t, lens, prev, wc, assign, ps, pc, psw, po, macc, counts, sw, obj)]
        rc = fn(z_t.device.index or 0, {torch.float32: 0, torch.float64: 1}[z_t.dtype], *ptrs, n, T, d, l, F_pad, C,
                chunk, int(assign_mode == "argmax"), 1, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "the older K6")
        return assign, counts, sw, macc[:F], obj

    return launch


def fit17(z, x, k6=None):
    """Phase 17's fit (``np.random.seed(14)``, ``MTM_MARKOV_PRECOMP=0``,
    ``train(fast=True, n_steps=30)``) with ``k6`` in the place of
    ``mk.markov_em_fused_longT`` if given: ``(model, seconds, the
    trainer's arguments)``."""
    import numpy as np

    from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable
    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    starts, train, real = [], em.train_em_markov, mk.markov_em_fused_longT

    def keep(*a, **k):
        starts.append((a, k))
        return train(*a, **k)

    np.random.seed(14)
    model = MMLinGaussSS_marginalizable(n_clusters=16, states=z, observations=x, device="cuda")
    em.train_em_markov, mk.markov_em_fused_longT = keep, k6 or real
    os.environ["MTM_MARKOV_PRECOMP"] = "0"
    t0 = time.perf_counter()
    try:
        model.train(fast=True, n_steps=30)
    finally:
        em.train_em_markov, mk.markov_em_fused_longT = train, real
        del os.environ["MTM_MARKOV_PRECOMP"]
    return model, time.perf_counter() - t0, starts[0]


def fit_trace(start, old_k6) -> None:
    """Phase 17's fit from its start along this tree's trajectory.  At each
    iteration both trees' K6 run on the planned batch with the same
    parameters and assignment: the rows whose assignments differ (the
    scores are one FMA chain in both, so none are expected) and the
    statistics' largest relative difference (another summation order);
    then the M step on each tree's statistics and one more E step (this
    tree's K6) from each set of parameters: the rows whose assignments
    differ there, with their float64 score gap (top-2 gap over 1 + |top
    score|, K5's plain Φ in float64, under this tree's parameters)."""
    import torch

    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.ops import markov
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    (params, a0, z, x, lens), kw = start
    T, n, d = z.shape
    l = x.shape[-1]
    reg = dict(reg_mode=kw.get("reg_mode", "lstsq"), alpha=kw.get("alpha", 0.0))
    raw = em._markov_features(z, x, lens.to(torch.int32), precompute=False)[0]
    a = a0.to(torch.int32)[raw.plan.rows.long()]

    def estep(fn, p, prev, mode="argmax"):
        return fn(raw.z_t, raw.x_t, raw.lens, prev, *em._grouped_weights(p), T=T, d=d, l=l, assign_mode=mode,
                  plan=raw.plan)

    def msolve(out):
        return em._msolve(out[3], out[1], n, d, l, **reg)

    params = msolve(estep(mk.markov_em_fused_longT, params, a, "prev"))
    for it in range(1, kw.get("n_steps", 30) + 1):
        new, old = estep(mk.markov_em_fused_longT, params, a), estep(old_k6, params, a)
        p_new, p_old = msolve(new), msolve(old)
        a_nn, a_no = estep(mk.markov_em_fused_longT, p_new, new[0])[0], estep(mk.markov_em_fused_longT, p_old, new[0])[0]
        diff = torch.nonzero(a_nn != a_no).squeeze(1)
        line = {"iteration": it, "switches_new": int(new[2]), "switches_old": int(old[2]),
                "rows_differing_same_parameters": int((new[0] != old[0]).sum()),
                "stats_max_rel_diff": float((new[3] - old[3]).abs().max() / new[3].abs().max()),
                "rows_differing_after_m_step": int(diff.numel())}
        if diff.numel():
            zt, xt = raw.z_t[:, diff].double(), raw.x_t[:, diff].double()
            phi = mk.markov_materialize_features_longT_plain(zt, xt, raw.lens[diff], T=T, d=d, l=l)
            Wg = markov.canonical_weights(*em._grouped_weights(em.MixtureParams(*(t.double() for t in p_new))),
                                          d=d, l=l)
            top2 = (Wg @ phi[: Wg.shape[1]]).topk(2, dim=0).values
            line["max_rel_score_gap"] = float(((top2[0] - top2[1]) / (1 + top2[0].abs())).max())
        print(json.dumps(line), flush=True)
        status = int(em._em_termination(new[2], new[1], em.STATUS_RUNNING, min_members=kw.get("min_members", 3))[3])
        a = new[0]
        if status != em.STATUS_RUNNING:
            print(json.dumps({"trajectory_status": status, "iterations": it}), flush=True)
            break
        params = p_new


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable
    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import markov as mops

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="root of the tree whose kernel to time beside this one")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--fit-trace", action="store_true",
                    help="with --old: phase 17's fit with both trees' K6, and its flips traced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_phase_split: no CUDA card", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    T, D, L, C, N = cs.T, cs.D, cs.L, cs.C, cs.N
    n14, T14, lengths14 = 250_000, 128, (64, 100, 128)
    t0 = time.perf_counter()
    _build.library()
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)

    # phase 14's batch and fit (its weights), phase 16's inputs
    z14, x14, lens14 = cs.near_clusters(n14, seed=14, steps=T14, lengths=lengths14)
    np.random.seed(14)
    model = MMLinGaussSS_marginalizable(n_clusters=C, states=z14, observations=x14, device="cuda")
    t0 = time.perf_counter()
    model.train(fast=True, n_steps=30)
    print(json.dumps({"fit14": "through Φ", "seconds": time.perf_counter() - t0, "iterations": model.last_iterations,
                      "status": model.last_status}), flush=True)
    p14 = model._stacked_params()
    del model
    data = Path(tempfile.mkdtemp())
    save = lambda name, a: np.save(data / f"{name}.npy", a.cpu().numpy() if torch.is_tensor(a) else a)  # noqa: E731
    rng = np.random.default_rng(16)
    save("k6_zt", z14.transpose(0, 2, 1).reshape(T14 * D, n14).astype(np.float32))
    save("k6_xt", x14.transpose(0, 2, 1).reshape(T14 * L, n14).astype(np.float32))
    save("k6_lens", lens14.astype(np.int32))
    save("k6_prev", rng.integers(0, C, size=n14).astype(np.int32))
    for k, w in zip(("W1", "W2", "W3"), em._grouped_weights(p14)):
        save("k6_" + k, w.float())
    z, x, lens = cs.bench_batch(N, seed=1)
    save("b10_zt", z.transpose(0, 2, 1).reshape(T * D, N).astype(np.float32))
    save("b10_xt", x.transpose(0, 2, 1).reshape(T * L, N).astype(np.float32))
    save("b10_lens", lens.astype(np.int32))
    save("b10_prev", rng.integers(0, C, size=N).astype(np.int32))
    p16 = em.mixture_params_from_numpy(cs.random_params(rng, (C,)), device=dev, dtype=torch.float32)
    W = em._grouped_weights(p16)
    for k, w in zip(("W1", "W2", "W3"), W):
        save("b10_" + k, w)
    save("b10_Wg", mops.canonical_weights(*W, d=D, l=L))
    save("shape", np.array([T14, T, D, L]))
    del z, x, lens
    ext = (~np.isnan(z14).all(-1) | ~np.isnan(x14).all(-1))
    extent = np.where(ext.any(0), T14 - np.argmax(ext[::-1], axis=0), 0)
    print(json.dumps({"n": n14, "T": T14, "C": C, "mean_extent": float(extent.mean()),
                      "extent_counts": {int(k): int(v) for k, v in zip(*np.unique(extent, return_counts=True))}}),
          flush=True)

    built = {"old": {}, "new": {}}

    def side(tree, root, variants):
        proc = subprocess.run([sys.executable, "-c", _SIDE, str(root.resolve()), str(TOOLS), str(data),
                               str(args.reps), json.dumps(variants), json.dumps(built[tree])],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"the {tree} tree failed:\n{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        config = res.pop("config")
        first = not built[tree]
        if first:
            print(json.dumps({"tree": tree, "k5_phi_sha256": config.pop("k5_phi_sha256"), "launch": config}),
                  flush=True)
        for variant, r in res.items():
            built[tree][variant] = r.pop("lib")
            log = r.pop("log")
            print(json.dumps({"tree": tree, "variant": variant, **r}), flush=True)
            if first and variant == "full":
                for name, use in ptxas_lines(log).items():
                    args_ = name.split("<")[1].rstrip(">").split(",")
                    line = {"tree": tree, "ptxas": name, **use}
                    if args_[1:3] == ["5", "3"]:
                        f32 = args_[0] == "f"
                        key = ("k6_f32" if args_[-1] == "1" else "k10_f32") if f32 else "k6_f64"
                        cfg = config.get(key) if key != "k6_f64" or args_[-1] == "1" else None
                        if cfg is None and not config:  # the first port's launch: 64 rows x 3 threads
                            stats = args_[-1] == "1"
                            Fp, nw, tile = 144, 6, 64
                            smem = (4 if f32 else 8) * (nw + Fp * (tile + 1) + tile + Fp * int(args_[4])
                                                        + (Fp * (C | 1) if stats else 0)) + 4 * (C + nw + tile)
                            cfg = {"threads": 192, "smem_bytes": smem}
                        if cfg:
                            line["occupancy"] = occupancy(use["registers"], cfg["threads"], cfg["smem_bytes"])
                            if "blocks_per_sm" in cfg:
                                line["occupancy"]["runtime_blocks_per_sm"] = cfg["blocks_per_sm"]
                    print(json.dumps(line), flush=True)

    if args.old is not None:
        side("old", args.old, OLD_VARIANTS)
    side("new", ROOT, VARIANTS)
    side("new", ROOT, VARIANTS)
    if args.old is not None:
        side("old", args.old, OLD_VARIANTS)
        if args.fit_trace:
            model, seconds, start = fit17(z14, x14)
            fit_new = (model.last_iterations, model.last_status, np.asarray(model.cluster_assignment))
            print(json.dumps({"fit17": "new", "seconds": seconds, "iterations": fit_new[0], "status": fit_new[1]}),
                  flush=True)
            old_k6 = old_batch_kernel(built["old"]["full"])
            model, seconds, _start = fit17(z14, x14, old_k6)
            differ = int((np.asarray(model.cluster_assignment) != fit_new[2]).sum())
            same = differ == 0
            print(json.dumps({"fit17": "old", "seconds": seconds, "iterations": model.last_iterations,
                              "status": model.last_status, "rows_differing_from_new": differ}), flush=True)
            if not same or (model.last_iterations, model.last_status) != fit_new[:2]:
                fit_trace(start, old_k6)
    shutil.rmtree(data, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

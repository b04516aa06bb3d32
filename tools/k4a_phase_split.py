#!/usr/bin/env python3
"""Where K4a's time goes on the card (``markov_em_fused_packed``, float32:
one EM iteration that rebuilds Φ from the packed batch), on
``chip_smoke.py`` phase 6's data: the bench batch at n = 1e6 and 1e6+37
(T = 10, d = 5, l = 3, C = 16), slot 0's weights and ``prev``.

For each tree (this one and, with ``--old DIR``, an older one, e.g. a
``git archive`` of the parent commit) it builds the tree's K4a sources
(``csrc/markov_em_packed*.cu``) alone from edited copies
(``tools/variant_build.py``) and times each build through the tree's own
wrapper, by CUDA events over ``--reps`` calls after a warm-up:

- ``full``: the sources as they are (the package's own build);
- ``build``: the Φ build alone (``assign_mode="prev"``, which skips the
  scores, and the statistics left out);
- ``build_scores``: the build and the scores (the statistics left out);
- ``prev``: the build and the statistics (no scores);
- ``reduce``: the partials' reduce alone (the EM kernel not launched);
- the header's body (``csrc/markov_em_multi.cuh``, the older trees') has
  ``variant0``: K4b's float32 body (``csrc/markov_em_packed_mma.cu``) at
  R = 1 with K4a's argmax rule (the first maximum, NaN counted as the
  maximum), its assignments, counts, switches and objective held to the
  tree's K4a;
- the staged body (``csrc/markov_em_packed_one.cu``) has ``nt64``,
  ``nt32`` (the tile forced), ``ring1`` (one slot: the next tile's copies
  after the build), ``q2`` (two threads an instance build the bench
  shape's rows),
  ``no_copies`` (the build on whatever the ring holds: the time without
  the copies), ``no_build`` (the scores and statistics on whatever the Φ
  tile holds), ``no_sort_stats`` (copies, build and scores),
  ``copies_only`` (the copies and their waits, and the assignments taken
  from ``prev``), and ``scores_unroll2``, ``scores_unroll4`` and
  ``build_unroll2`` (the scores' loop over Φ's rows, or the build's loop
  over the steps, unrolled, so that the next rows' or step's loads go out
  ahead of this one's FMAs).

Every build also runs under ``torch.profiler`` (each kernel's device
time: the EM body, the reduce and the objective's sum, which the CUDA
events' time exceeds by the wrapper's host time between calls), and its
host time a call is read with the calls enqueued back to back; while
``full`` runs back to back ``nvidia-smi`` reads the SM clock and power.  Every instantiation's
``ptxas -v`` line (registers, spills, shared memory) is printed with the
blocks and warps an SM that its registers and the launch's threads and
shared memory allow.

With ``--old DIR`` the older tree runs before and after this one (old,
new, new, old).  With ``--fit-trace`` as well, ``chip_smoke.py`` phase
4b's fit (n = 1e6, ``MTM_MARKOV_PRECOMP=0``: K4a every iteration) runs
with this tree's K4a and again with the older tree's from the same
start; where they differ, this tree's trajectory is followed with both
kernels (``chip_smoke.markov_fit_trace``: the same E step from the same
parameters, then the rows whose assignments differ after each tree's M
step, with their float64 score gaps).  With ``--clocks`` this tree's
body is built with ``clock64()`` read by thread 0 of each block at the
tile loop's phase boundaries and the mean SM cycles a tile spends in each
phase are printed.

Usage, on a machine with the card and ``nvcc``::

    mkdir -p chip_scratch/parent && git archive <old commit> | tar -x -C chip_scratch/parent
    python3 tools/k4a_phase_split.py [--old chip_scratch/parent [--fit-trace]] [--clocks] [--reps 10]

Prints the card's name and power limit first, then one JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from variant_build import card_line  # noqa: E402  (tools/, the script's own directory)

# The header's body (markov_em_multi.cuh, PACKED): the statistics call and
# the EM kernel's launch
_OLD_STATS = "        ordered_add(s_acc + rr * FS, cs, s_na, nt, tile, tstride, Fcp);\n"
_OLD_LAUNCH = "  kern<<<grid, nt, smem, a.stream>>>("
OLD_VARIANTS = {
    "build": {"mode": "prev", "edits": {"markov_em_multi.cuh": [(_OLD_STATS, "")]}},
    "build_scores": {"mode": "argmax", "edits": {"markov_em_multi.cuh": [(_OLD_STATS, "")]}},
    "prev": {"mode": "prev", "edits": {}},
    "reduce": {"mode": "argmax", "edits": {"markov_em_multi.cuh": [(_OLD_LAUNCH, "  if (false) " + _OLD_LAUNCH[2:])]}},
    # K4b's float32 body at R = 1 (its plan: 128-instance tiles, one
    # restart a block, clusters of one block) with K4a's argmax rule
    "variant0": {"mode": "argmax", "check": True, "edits": {
        "markov_em_packed.cu": [("  if (w_kind == 1 && strict)\n",
                                 "  if (w_kind == 1 && !strict) {\n    nt = 128;\n    rg = 1;\n    cs = 1;\n  }\n"
                                 "  if (w_kind == 1)\n")],
        "markov_em_packed_mma.cu": [("            if (c < C && sc[v][c] > best) {",
                                     "            if (c < C && (sc[v][c] > best || (sc[v][c] != sc[v][c] && best == best))) {")],
    }},
}

# The staged body (markov_em_packed_one.cu); "plan" fixes fields of the
# plan of ops/markov_kernels.py:packed_one_plan (the side's forced_plan)
_NEW = "markov_em_packed_one.cu"
_NEW_STATS = "    stats_tile();\n"
_NEW_LAUNCH = "  kern<<<(unsigned)a.grid, a.nt * a.q, smem, a.stream>>>("
_NEW_ISSUE = "  auto issue = [&](int64_t tile, int slot) {\n"
_NEW_BUILD = "    build_tile(it % ring);\n"
_NEW_SORT = "    if (warp == 0) counts += mtm::sort_tile<CB>(s_na, s_perm, s_seg, NT);\n"
_NEW_SCORE_LOOP = "      for (int f = 0; f < Fcp; ++f) {\n        const float v = col[f * pitch];\n"
_NEW_STEP_LOOP = "  for (int t = 0; t < steps; ++t) {\n    const bool more = t + 1 < steps;\n"
NEW_VARIANTS = {
    "build": {"mode": "prev", "edits": {_NEW: [(_NEW_STATS, "")]}},
    "build_scores": {"mode": "argmax", "edits": {_NEW: [(_NEW_STATS, "")]}},
    "prev": {"mode": "prev", "edits": {}},
    "reduce": {"mode": "argmax", "edits": {_NEW: [(_NEW_LAUNCH, "  if (false) " + _NEW_LAUNCH[2:])]}},
    "nt64": {"mode": "argmax", "check": True, "plan": {"nt": 64}, "edits": {}},
    "nt32": {"mode": "argmax", "check": True, "plan": {"nt": 32}, "edits": {}},
    "ring1": {"mode": "argmax", "check": True, "plan": {"ring": 1}, "edits": {}},
    "q2": {"mode": "argmax", "check": True, "plan": {"q": 2},
           "edits": {_NEW: [("constexpr int kQ53 = 4;", "constexpr int kQ53 = 2;")]}},
    "no_copies": {"mode": "argmax", "edits": {_NEW: [(_NEW_ISSUE, _NEW_ISSUE + "    return;\n")]}},
    "no_build": {"mode": "argmax", "edits": {_NEW: [(_NEW_BUILD, "")]}},
    "no_sort_stats": {"mode": "argmax", "edits": {_NEW: [(_NEW_STATS, ""), (_NEW_SORT, "")]}},
    "copies_only": {"mode": "prev", "edits": {_NEW: [(_NEW_STATS, ""), (_NEW_SORT, ""), (_NEW_BUILD, "")]}},
    "scores_unroll2": {"mode": "argmax", "check": True, "edits": {_NEW: [(_NEW_SCORE_LOOP, "#pragma unroll 2\n" + _NEW_SCORE_LOOP)]}},
    "scores_unroll4": {"mode": "argmax", "check": True, "edits": {_NEW: [(_NEW_SCORE_LOOP, "#pragma unroll 4\n" + _NEW_SCORE_LOOP)]}},
    "build_unroll2": {"mode": "argmax", "check": True, "edits": {_NEW: [(_NEW_STEP_LOOP, "#pragma unroll 2\n" + _NEW_STEP_LOOP)]}},
}

# --clocks: thread 0 of each block reads clock64() at the tile loop's
# phase boundaries of the staged body and adds the cycles to a device
# array: the copies' wait and the barrier, the build, the scores, the sort,
# thread 0's share of the statistics (the rest shows in the next wait)
_CLOCKS = [
    ("using mtm::is_nan;\n", "using mtm::is_nan;\n__device__ unsigned long long g_clk[6];\n"),
    ("    cp_async_wait(ring > 1 ? ring - 1 : 0);\n    __syncthreads();  // the tile's u and lengths are in; the last tile's statistics are done\n",
     "    const long long c0 = clock64();\n    cp_async_wait(ring > 1 ? ring - 1 : 0);\n"
     "    __syncthreads();  // the tile's u and lengths are in; the last tile's statistics are done\n"
     "    const long long c1 = clock64();\n"),
    ("    __syncthreads();  // s_phi\n", "    __syncthreads();  // s_phi\n    const long long c2 = clock64();\n"),
    ("    __syncthreads();  // s_na\n", "    __syncthreads();  // s_na\n    const long long c3 = clock64();\n"),
    ("    __syncthreads();  // s_perm, s_seg\n    stats_tile();\n",
     "    __syncthreads();  // s_perm, s_seg\n    const long long c4 = clock64();\n    stats_tile();\n"
     "    if (tid == 0) {\n      const long long c5 = clock64();\n"
     "      const long long dd[6] = {c1 - c0, c2 - c1, c3 - c2, c4 - c3, c5 - c4, 1};\n"
     "      for (int k = 0; k < 6; ++k) atomicAdd(&g_clk[k], (unsigned long long)dd[k]);\n    }\n"),
    ("}  // namespace\n",
     "}  // namespace\nextern \"C\" int mtm_clocks(unsigned long long* out, int zero) {\n"
     "  unsigned long long z[6] = {};\n"
     "  return zero ? (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z))\n"
     "              : (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(z));\n}\n"),
]

# One tree's side, run in a subprocess with that tree first on the path:
# its library, its variants built alone, K4a timed on the saved inputs
# through the tree's own wrapper with each variant's library in the place
# of the package's for the K4 launch functions.
_SIDE = r"""
import ctypes, json, re, shutil, subprocess, sys, threading, time
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
sigs = {k: t for k, t in _build._SIGNATURES.items() if k.startswith("mtm_markov_em_packed")}


class Swapped:  # the variant's K4 launch functions, everything else from the tree's library
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
srcs = sorted(p.name for p in src.glob("markov_em_packed*.cu"))
with ThreadPoolExecutor(max(len(variants), 1)) as pool:
    futs = {v: pool.submit(load, built[v]) if v in built else
            pool.submit(build, src, srcs, data, edits={f: [tuple(e) for e in es] for f, es in spec["edits"].items()},
                        signatures=sigs) for v, spec in variants.items() if spec["edits"]}
    libs = {v: futs[v].result() if v in futs else (real, "") for v in variants}
log_path = _build.library_path().with_suffix(".log")
libs = {"full": (real, log_path.read_text() if log_path.exists() else ""), **libs}
modes = {"full": "argmax", **{v: spec["mode"] for v, spec in variants.items()}}
checks = {v for v, spec in variants.items() if spec.get("check")}
dev = torch.device("cuda")
T, d, l = 10, 5, 3
inputs = {}
for key in ("n", "n37"):
    ld_ = lambda name: torch.tensor(np.load(data / f"{key}_{name}.npy"), device=dev)
    inputs[key] = (ld_("u"), ld_("lens"), ld_("prev"), ld_("Wg"))


def call(key, mode):
    u, lens, prev, Wg = inputs[key]
    return lambda: mk.markov_em_fused_packed(u, lens, prev, Wg, T=T, d=d, l=l, assign_mode=mode)


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
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0 and re.search("em_multi|packed_one|packed_mma", e.key):
            name = "reduce" if "reduce" in e.key else "objective" if "objective" in e.key else "body"
            us, cnt = out.get(name, (0.0, 0))
            out[name] = (us + t, cnt + e.count)
    return {k: {"ms": us / 1e3 / max(c, 1), "recorded": c, "of": reps} for k, (us, c) in out.items()}


def host_ms(fn):
    # the wrapper's host time a call: the calls enqueued back to back, no sync
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


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


def demangle(names):
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
        return out if len(out) == len(names) else names
    except OSError:
        return names


def ptxas(log):
    # each K4 kernel's entry: registers, spills, shared memory
    entries, lines = [], log.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if not m or not re.search("em_multi_kernel|em_multi_reduce|packed_one|packed_mma_kernel", m.group(1)):
            continue
        text = " ".join(lines[i + 1 : i + 4])
        num = lambda pat: int(g.group(1)) if (g := re.search(pat, text)) else 0
        entries.append((m.group(1), {"registers": num(r"Used (\d+) registers"), "spill_stores": num(r"(\d+) bytes spill stores"),
                                     "spill_loads": num(r"(\d+) bytes spill loads"), "stack": num(r"(\d+) bytes stack frame"),
                                     "static_smem": num(r"(\d+) bytes smem")}))
    names = demangle([e[0] for e in entries])
    return [dict(kernel=n, **u) for n, (_m, u) in zip(names, entries)]


out = {"plan": None}
if hasattr(mk, "packed_one_plan"):
    plan = mk.packed_one_plan(T, d, l, int(inputs["n"][3].shape[0]))
    out["plan"] = plan._asdict()
    if hasattr(mk, "_packed_one_config"):
        out["launch"] = mk._packed_one_config(0, T, d, l, int(inputs["n"][3].shape[0]), True)._asdict()
ref = {key: [t.clone() for t in call(key, "argmax")()] for key in inputs}
real_plan = getattr(mk, "packed_one_plan", None)


# packed_one_plan with `fields` (the tile nt, the threads an instance q or
# the ring's depth) fixed, its shared memory, threads and blocks an SM
# worked out again as the plan works them out
def forced_plan(fields):
    def plan(T, d, l, C, *, argmax=True):
        p = real_plan(T, d, l, C, argmax=argmax)
        if p is None or not fields:
            return p
        p = p._replace(**fields)
        Fcp = mk.markov_compact_spec(T, d, l)[0]
        smem = mk.packed_one_smem(Fcp, T * 8 * ((d + l + 7) // 8), C, p.nt, p.ring, argmax=argmax)
        threads = p.nt * p.q
        return p._replace(smem=smem, threads=threads,
                          blocks_per_sm=min(mk._SM_SMEM // (smem + 1024), 2048 // threads, 32))
    return plan


for variant, (lib, log) in libs.items():
    _build.library = (lambda: real) if lib is real else (lambda lib=lib: Swapped(lib))
    if real_plan is not None:  # the launch is the build's own, on the variant's plan
        mk.packed_one_plan = forced_plan(variants.get(variant, {}).get("plan", {}))
        mk._packed_one_config.cache_clear()
    res = {"lib": getattr(lib, "_name", ""), "ptxas": ptxas(log) if log else []}
    for key in inputs:
        fn = call(key, modes[variant])
        res[key + "_ms"] = event_ms(fn, reps)
        res[key + "_device"] = profiled(fn)
        res[key + "_host_ms"] = host_ms(fn)
        if variant in checks:
            got = fn()
            a, c, s, g, o = ref[key]
            res[key + "_vs_full"] = {
                "assign_counts_switches_equal": bool(torch.equal(got[0], a) and torch.equal(got[1], c) and torch.equal(got[2], s)),
                "objective_bit_equal": bool(got[4].view(torch.int32) == o.view(torch.int32)),
                "stats_max_rel": float(((got[3] - g).abs().max() / g.abs().max()).item()),
            }
    if variant == "full":
        res["clocks"] = clocks_under(call("n", "argmax"))
    out[variant] = res
_build.library = lambda: real
if real_plan is not None:
    mk.packed_one_plan = real_plan
print(json.dumps(out))
"""


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


def launch_of(kernel: str, plan: dict | None, Fcp: int, C: int) -> dict | None:
    """The threads and shared memory of the timed launch of a K4 kernel
    (bench shape, float32, argmax), from its demangled name."""
    cb = 8 if C <= 8 else 16 if C <= 16 else 32
    if "em_multi_kernel<float, float, 16, true, false, true>" in kernel:  # the header's K4a: 128 threads
        nt, nw = 128, 4
        return {"threads": nt, "smem": 4 * (nw + Fcp * (nt + 1) + nt + Fcp * cb + Fcp * (C | 1)) + 4 * (C + nt + nw + nt)}
    if "packed_mma_kernel<16, true>" in kernel:  # variant 0: 512 threads, R = 1's plan
        nt, Ts = 128, 80
        return {"threads": 512, "smem": 4 * (Fcp * (cb + cb + 1) + Fcp * (nt + 1) + Ts * nt + 128 + Fcp + nt
                                             + 2 * nt + 2 * 33 + 1)}
    if "packed_one_kernel<16, true" in kernel and plan is not None:
        return {"threads": plan["threads"], "smem": plan["smem"]}
    return None


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="root of the tree whose K4a to time beside this one")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--fit-trace", action="store_true",
                    help="with --old: phase 4b's fit with both trees' K4a, and its flips traced")
    ap.add_argument("--clocks", action="store_true", help="the staged body's SM cycles a tile in each phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4a_phase_split: no CUDA card", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    T, D, L, C, N = cs.T, cs.D, cs.L, cs.C, cs.N
    t0 = time.perf_counter()
    _build.library()
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)

    # phase 6's inputs: its 32 slots' parameters from seed 6, prev drawn
    # for n = 1e6 and then for 1e6+37; slot 0's weights and prev
    R = 32
    rng = np.random.default_rng(6)
    eye = lambda k: np.broadcast_to(np.eye(k), (R, C, k, k))  # noqa: E731
    params_r = em.mixture_params_from_numpy(
        (np.full((R, C), 1.0 / C), rng.normal(size=(R, C, D)), eye(D),
         rng.normal(scale=0.4, size=(R, C, D, D)), eye(D), rng.normal(size=(R, C, D, L)), eye(L)),
        device=dev,
    )
    Wg0 = em._stacked_weights(params_r)[0].cpu().numpy()
    data = Path(tempfile.mkdtemp(dir=os.environ.get("TMPDIR")))
    for key, n in (("n", N), ("n37", N + 37)):
        z, x, lens = cs.bench_batch(n, seed=1)
        z_t = torch.tensor(z.transpose(0, 2, 1).reshape(T * D, n), dtype=torch.float32, device=dev)
        x_t = torch.tensor(x.transpose(0, 2, 1).reshape(T * L, n), dtype=torch.float32, device=dev)
        del z, x
        u = mk.pack_markov_u(z_t, x_t, T=T, d=D, l=L)
        prev = rng.integers(0, C, size=(R, n)).astype(np.int32)
        prev[:, ::1009] = -1
        np.save(data / f"{key}_u.npy", u.cpu().numpy())
        np.save(data / f"{key}_lens.npy", lens.astype(np.int32))
        np.save(data / f"{key}_prev.npy", np.ascontiguousarray(prev[0]))
        np.save(data / f"{key}_Wg.npy", Wg0)
        del z_t, x_t, u, prev
    torch.cuda.empty_cache()
    Fcp = mk.markov_compact_spec(T, D, L)[0]

    built = {"old": {}, "new": {}}

    def side(tree, root):
        staged = (root / "multimodal_trajectory_modeling_tpu_torch" / "csrc" / _NEW).exists()
        variants = NEW_VARIANTS if staged else OLD_VARIANTS
        proc = subprocess.run([sys.executable, "-c", _SIDE, str(root.resolve()), str(TOOLS), str(data),
                               str(args.reps), json.dumps(variants), json.dumps(built[tree])],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"the {tree} tree failed:\n{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        plan = res.pop("plan")
        launch = res.pop("launch", None)
        res.pop("launches", None)
        first = not built[tree]
        if first:
            print(json.dumps({"tree": tree, "body": "staged" if staged else "header", "plan": plan, "launch": launch}),
                  flush=True)
        for variant, r in res.items():
            built[tree][variant] = r.pop("lib")
            for use in r.pop("ptxas"):
                lau = launch_of(use["kernel"], plan, Fcp, C)
                line = {"tree": tree, "variant": variant, "ptxas": use}
                if lau:
                    line["occupancy"] = occupancy(use["registers"], lau["threads"], lau["smem"])
                print(json.dumps(line), flush=True)
            print(json.dumps({"tree": tree, "variant": variant, **r}), flush=True)

    if args.old is not None:
        side("old", args.old)
    side("new", ROOT)
    side("new", ROOT)
    if args.old is not None:
        side("old", args.old)
        if args.fit_trace:
            fit_trace(cs, built["old"]["full"])
    if args.clocks:
        clocks(mk, data, dev)
    import shutil

    shutil.rmtree(data, ignore_errors=True)
    return 0


def clocks(mk, data, dev) -> None:
    """This tree's K4a at n = 1e6 with the phase clocks (_CLOCKS): the mean
    SM cycles a tile spends in each phase, and the SM clock."""
    import ctypes

    import numpy as np
    import torch

    from variant_build import build
    from multimodal_trajectory_modeling_tpu_torch.ops import _build

    src = ROOT / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
    sigs = {k: t for k, t in _build._SIGNATURES.items() if k.startswith("mtm_markov_em_packed")}
    lib, _log = build(src, sorted(p.name for p in src.glob("markov_em_packed*.cu")), data, edits={_NEW: _CLOCKS},
                      signatures={**sigs, "mtm_clocks": [ctypes.c_void_p, ctypes.c_int]})
    real = _build.library()

    class Swapped:
        def __getattr__(self, name):
            return getattr(lib if name in sigs or name == "mtm_clocks" else real, name)

    _build.library = lambda: Swapped()
    mk._packed_one_config.cache_clear()
    ld = lambda name: torch.tensor(np.load(data / f"n_{name}.npy"), device=dev)  # noqa: E731
    u, lens, prev, Wg = ld("u"), ld("lens"), ld("prev"), ld("Wg")
    call = lambda: mk.markov_em_fused_packed(u, lens, prev, Wg, T=10, d=5, l=3)  # noqa: E731
    call()
    torch.cuda.synchronize()
    clk = (ctypes.c_ulonglong * 6)()
    assert lib.mtm_clocks(clk, 1) == 0
    call()
    torch.cuda.synchronize()
    assert lib.mtm_clocks(clk, 0) == 0
    _build.library = lambda: real
    mk._packed_one_config.cache_clear()
    names = ("wait_copies_and_barrier", "build", "scores_assign", "sort", "stats_thread0")
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"body": "staged", "clocks": True, "tiles": clk[5], "sm_clock": sm,
                      **{f"{k}_cycles_per_tile": round(clk[q] / max(clk[5], 1), 1) for q, k in enumerate(names)}}),
          flush=True)


def old_k4a(lib_path):
    """The older tree's K4a (the header's body, its launch function of 32
    arguments) in the place of ``mk.markov_em_fused_packed``."""
    import ctypes

    import torch

    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(lib_path).mtm_markov_em_packed
    fn.argtypes = [I_, I_, *[P_] * 15, ctypes.c_longlong, *[I_] * 13, P_]
    fn.restype = I_

    def launch(u, lens, prev, Wg, *, T, d, l, assign_mode="argmax"):
        wc = mk.fold_weights(Wg, T=T, d=d, l=l)[None]
        n, (R, C, Fcp) = u.shape[1], wc.shape
        force = torch.zeros((1,), dtype=torch.int32, device=u.device)
        parts, outs = mk._multi_buffers(R, n, Fcp, C, quant=False, wdtype=wc.dtype, device=u.device)
        Fc = int(mk.markov_compact_spec(T, d, l)[1].shape[0])
        desc = mk._row_desc(T, d, l, u.device)
        rc = fn(u.device.index or 0, 1, u.data_ptr(), lens.data_ptr(), desc.data_ptr(), prev[None].contiguous().data_ptr(),
                force.data_ptr(), wc.data_ptr(), outs[0].data_ptr(), *(p.data_ptr() for p in parts),
                *(o.data_ptr() for o in outs[3:4] + outs[1:3] + outs[4:]), n, T, u.shape[0] // T, Fc, Fcp, C, R,
                mk._multi_chunk(R), mk._EM_CHUNK, int(assign_mode == "argmax"), 0, 0, 0, 0,
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "the older K4a")
        a, c, s, macc, o = outs
        return a[0], c[0], s[0], macc[0][mk._positions(T, d, l, u.device)], o[0]

    return launch


def fit_trace(cs, old_lib) -> None:
    """Phase 4b's fit with this tree's K4a and with the older tree's, from
    the same start; where they differ, this tree's trajectory followed
    with both kernels (``cs.markov_fit_trace``)."""
    import numpy as np

    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    old = old_k4a(old_lib)
    fits = {}
    for tree, k4a in (("new", None), ("old", old)):
        model, seconds, start = cs.fit_4b(k4a)
        fits[tree] = (model.last_iterations, model.last_status, np.asarray(model.cluster_assignment))
        print(json.dumps({"fit4b": tree, "seconds": seconds, "iterations": fits[tree][0], "status": fits[tree][1],
                          "rows_differing_from_new": int((fits[tree][2] != fits["new"][2]).sum())}), flush=True)
    if fits["new"][:2] != fits["old"][:2] or not np.array_equal(fits["new"][2], fits["old"][2]):
        for line in cs.markov_fit_trace(start, mk.markov_em_fused_packed, old):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())

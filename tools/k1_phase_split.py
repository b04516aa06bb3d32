#!/usr/bin/env python3
"""Where K1's time goes on the card (``markov_em_compact`` under int16 Φ:
one EM iteration over the materialized features), at ``chip_smoke.py``
phase 3's shape: the bench batch's int16 Φ at n = 1e6 and 1e6+37 (T = 10,
d = 5, l = 3: Fcp = 112), C = 16, float32 weights from phase 3's random
parameters.

This tree's int16 body (``csrc/markov_em_one.cu``) is built from edited
copies (``tools/variant_build.py``) and timed through the package's own
wrapper, by CUDA events over ``--reps`` calls after a warm-up, by
``torch.profiler`` (each kernel's device time: the body, the reduce and
the objective's sum) and by the host's clock with the calls enqueued back
to back (the wrapper's host time a call):

- ``full``: the source as it is (the package's own build);
- ``copies_only``: the copies and their waits (``assign_mode="prev"``,
  which skips the scores, and the statistics left out);
- ``scores_only``: the scores and the assignment (no copies: whatever the
  ring holds; no statistics);
- ``stats_only``: the statistics (``prev`` mode, no copies);
- ``no_stats``, ``no_copies``: the full body less one part;
- ``reduce``: the partials' reduce and the objective's sum alone;
- ``ipt1`` (one instance and all its clusters a thread), ``pairs`` (a
  group's two threads neighbouring lanes, not half a warp apart),
  ``mg1`` (one m-tile of the statistics at a time, not two interleaved),
  ``loads4`` (four plain loads in flight a thread where n is odd, not 16)
  and ``ring1`` (one tile slot: the next tile's copies after the
  statistics), each held to ``full`` bit for bit.

Each variant runs on random assignments (``prev`` drawn uniformly, every
1009th row left out); ``full`` also with every instance in one cluster
(all clusters given the same weights: the first maximum is cluster 0).
Every instantiation's ``ptxas -v`` line (registers, spills) is printed
with the blocks and warps an SM its registers and shared memory allow.

With ``--old DIR`` (the root of an older tree, e.g. a ``git archive`` of
the parent commit) the older tree's ``csrc/markov_em.cu`` is built alone
and called as that tree's wrapper called it; both trees run on every
assignment kind in turns (old, new, new, old) and their five outputs are
held equal bit for bit; then each tree's own ``markov_em_compact`` (the
older tree's whole package, built in a subprocess of its own) is timed
on the same seeded inputs, old, new, new, old: its host time a call with
the calls enqueued back to back, and CUDA events.  With ``--fit-trace`` as well, ``chip_smoke.py``
phase 4's fit (n = 1e6, ``train(fast=True, n_steps=30)``: K1 every
iteration) runs with this tree's K1 and again with the older tree's from
the same start: the same iterations, status and assignments; then both
are timed on the fit's own assignments and parameters.  With
``--clocks`` the body is built with ``clock64()`` read by thread 0 of each
block at the tile loop's phase boundaries, and the mean SM cycles a tile
spends in each phase are printed.

Usage, on a machine with the card and ``nvcc``::

    mkdir -p chip_scratch/parent
    git archive <old commit> multimodal_trajectory_modeling_tpu_torch | tar -x -C chip_scratch/parent
    python3 tools/k1_phase_split.py [--old chip_scratch/parent [--fit-trace]] [--clocks] [--reps 20]

Prints the card's name and power limit first, then one JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from variant_build import build, card_line, event_ms  # noqa: E402  (tools/, the script's own directory)

_SRC = "markov_em_one.cu"
_STATS = "    stats_tile(cur);\n"
_ISSUE = "  auto issue = [&](int64_t tile, int slot) {\n"
_LAUNCH = "  kern<<<(unsigned)a.grid, kThreads, smem, a.stream>>>("
VARIANTS = {
    "copies_only": {"mode": "prev", "edits": [(_STATS, "")]},
    "scores_only": {"mode": "argmax", "edits": [(_STATS, ""), (_ISSUE, _ISSUE + "    return;\n")]},
    "stats_only": {"mode": "prev", "edits": [(_ISSUE, _ISSUE + "    return;\n")]},
    "no_stats": {"mode": "argmax", "edits": [(_STATS, "")]},
    "no_copies": {"mode": "argmax", "edits": [(_ISSUE, _ISSUE + "    return;\n")]},
    "reduce": {"mode": "argmax", "edits": [(_LAUNCH, "  if (false) " + _LAUNCH[2:])]},
    "ipt1": {"mode": "argmax", "check": True, "edits": [("constexpr int kIpt = 2; ", "constexpr int kIpt = 1; ")]},
    "loads4": {"mode": "argmax", "check": True, "edits": [("constexpr int kLoads = 16; ", "constexpr int kLoads = 4; ")]},
    "pairs": {"mode": "argmax", "check": True, "edits": [("constexpr int kPartStride = 16; ", "constexpr int kPartStride = 1; ")]},
    "mg1": {"mode": "argmax", "check": True, "edits": [("constexpr int kMG = 2; ", "constexpr int kMG = 1; ")]},
    "ring1": {"mode": "argmax", "check": True, "ring": 1, "edits": []},
}

# --clocks: thread 0 of each block reads clock64() around the copies' wait
# and barrier, its own scores, the barrier before the statistics and its
# warp's statistics, and adds the cycles to a device array
_CLOCKS = [
    ("using mtm::is_nan;\n", "using mtm::is_nan;\n__device__ unsigned long long g_clk[5];\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();  // the tile's rows are in `slot`; the last tile's statistics are done\n",
     "    const long long c0 = clock64();\n    cp_async_wait<0>();\n"
     "    __syncthreads();  // the tile's rows are in `slot`; the last tile's statistics are done\n"
     "    const long long c1 = clock64();\n"),
    ("    score_tile(cur, tile * kNT);\n    __syncthreads();  // s_na\n    stats_tile(cur);\n",
     "    score_tile(cur, tile * kNT);\n    const long long c2 = clock64();\n    __syncthreads();  // s_na\n"
     "    const long long c3 = clock64();\n    stats_tile(cur);\n"
     "    if (tid == 0) {\n      const long long c4 = clock64();\n"
     "      const long long dd[5] = {c1 - c0, c2 - c1, c3 - c2, c4 - c3, 1};\n"
     "      for (int k = 0; k < 5; ++k) atomicAdd(&g_clk[k], (unsigned long long)dd[k]);\n    }\n"),
    ("}  // namespace\n",
     "}  // namespace\nextern \"C\" int mtm_clocks(unsigned long long* out, int zero) {\n"
     "  unsigned long long z[5] = {};\n"
     "  return zero ? (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z))\n"
     "              : (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(z));\n}\n"),
]


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def same_bits(p, q) -> bool:
    import torch

    if p.dtype != q.dtype:
        return False
    if p.is_floating_point():
        iv = torch.int32 if p.dtype == torch.float32 else torch.int64
        return bool(torch.equal(p.view(iv), q.view(iv)))
    return bool(torch.equal(p, q))


def old_k1(lib_path: str):
    """The older tree's K1 (``csrc/markov_em.cu``'s ``mtm_markov_em``) as
    that tree's wrapper called it: nine tensors a call, ``_EM_CHUNK``
    instances a block."""
    import torch

    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(lib_path).mtm_markov_em
    fn.argtypes = [I_, I_, I_, *[P_] * 12, ctypes.c_longlong, I_, I_, I_, I_, P_]
    fn.restype = I_

    def launch(phi, prev, wc, *, assign_mode="argmax"):
        (Fcp, n), C = phi.shape, wc.shape[0]
        quant = phi.dtype == torch.int16
        nb = -(-n // mk._EM_CHUNK)
        e = lambda shape, dt: torch.empty(shape, dtype=dt, device=phi.device)  # noqa: E731
        parts = (e((nb, Fcp, C), torch.int32 if quant else wc.dtype), e((nb, C), torch.int32), e((nb,), torch.int32),
                 e((nb,), wc.dtype))
        assign, counts, switches = e((n,), torch.int32), e((C,), torch.int32), e((), torch.int32)
        macc, obj = e((Fcp, C), torch.int64 if quant else wc.dtype), e((), wc.dtype)
        rc = fn(phi.device.index or 0, mk._PHI_KINDS[phi.dtype], mk._W_KINDS[wc.dtype], phi.data_ptr(),
                prev.data_ptr(), wc.data_ptr(), assign.data_ptr(), *(p.data_ptr() for p in parts), macc.data_ptr(),
                counts.data_ptr(), switches.data_ptr(), obj.data_ptr(), n, Fcp, C, mk._EM_CHUNK,
                int(assign_mode == "argmax"), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the older K1 returned {rc}")
        return assign, counts, switches, macc, obj

    return launch


def profiled(fn, reps: int) -> dict:
    """Each K1 kernel's device time a call by torch.profiler (the body,
    the reduce, the objective's sum; the older body and its reduce), with
    the executions the trace recorded."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and t > 0 and re.search("em_one|markov_em_", ev.key):
            name = "reduce" if "reduce" in ev.key else "objective" if "objective" in ev.key else "body"
            us, cnt = out.get(name, (0.0, 0))
            out[name] = (us + t, cnt + ev.count)
    res = {k: {"ms": us / 1e3 / max(c, 1), "recorded": c, "of": reps} for k, (us, c) in out.items()}
    res["total_ms"] = sum(v["ms"] for v in res.values())
    return res


def host_ms(fn, reps: int) -> float:
    """The wrapper's host time a call: the calls enqueued back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def ptxas(log: str) -> list:
    """Each K1 kernel's entry in an ``nvcc -Xptxas -v`` log: registers,
    spills, demangled name."""
    entries, lines = [], log.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if not m or not re.search("em_one_kernel|markov_em_kernel", m.group(1)):
            continue
        text = " ".join(lines[i + 1 : i + 4])
        num = lambda pat: int(g.group(1)) if (g := re.search(pat, text)) else 0  # noqa: E731
        entries.append((m.group(1), {"registers": num(r"Used (\d+) registers"),
                                     "spill_stores": num(r"(\d+) bytes spill stores"),
                                     "spill_loads": num(r"(\d+) bytes spill loads")}))
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = [e[0] for e in entries]
    try:
        out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
        names = out if len(out) == len(names) else names
    except OSError:
        pass
    return [dict(kernel=nm, **u) for nm, (_m, u) in zip(names, entries)]


def occupancy(regs: int, threads: int, smem: int) -> dict:
    """Blocks and warps an SM that ``regs`` registers a thread, ``threads``
    a block and ``smem`` bytes a block allow on an H100 (64 K registers,
    allocated 256 a warp; 228 KB of shared memory, 1 KB reserved a block;
    2048 threads; 32 blocks)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps if regs else 32
    by_smem = 233472 // (smem + 1024)
    blocks = min(by_regs, by_smem, 2048 // threads, 32)
    return {"threads": threads, "smem_bytes": smem, "blocks_per_sm": blocks, "warps_per_sm": blocks * warps}


# One tree's own wrapper in a subprocess with that tree first on the path:
# its library, then its markov_em_compact on seeded int16 Φ at the bench
# shape, the host time a call (calls enqueued back to back) and CUDA events
_WRAPPER = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from multimodal_trajectory_modeling_tpu_torch.ops import _build
from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
_build.library()
reps, n = int(sys.argv[2]), 1_000_000
g = torch.Generator(device="cuda").manual_seed(0)
q = torch.randint(-3000, 3000, (112, n), dtype=torch.int16, device="cuda", generator=g)
prev = torch.randint(0, 16, (n,), dtype=torch.int32, device="cuda", generator=g)
wc = torch.randn(16, 112, device="cuda", generator=g) * 1e-3
fn = lambda: mk.markov_em_compact(q, prev, wc)
out = {}
for rnd in range(2):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    out[f"round{rnd}"] = {"host_ms": (t1 - t0) * 1e3 / reps, "events_ms": e0.elapsed_time(e1) / reps}
print(json.dumps(out))
"""


def wrapper_times(trees: dict, reps: int) -> None:
    """Each tree's own ``markov_em_compact`` (``_WRAPPER``), in turns."""
    for tree in ("old", "new", "new", "old"):
        proc = subprocess.run([sys.executable, "-c", _WRAPPER, str(trees[tree].resolve()), str(max(reps, 50))],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            emit(tree=tree, wrapper="failed", stderr=proc.stderr[-2000:])
            continue
        emit(tree=tree, wrapper="markov_em_compact", **json.loads(proc.stdout.strip().splitlines()[-1]))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import markov as mops
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="root of the tree whose K1 to time beside this one")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--fit-trace", action="store_true",
                    help="with --old: phase 4's fit with both trees' K1, then both timed on its assignments")
    ap.add_argument("--clocks", action="store_true", help="the body's SM cycles a tile in each phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_phase_split: no CUDA card", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    T, D, L, C, N = cs.T, cs.D, cs.L, cs.C, cs.N
    t0 = time.perf_counter()
    real = _build.library()
    emit(build_seconds=time.perf_counter() - t0)
    work = Path(tempfile.mkdtemp(dir=os.environ.get("TMPDIR")))
    src = ROOT / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
    sigs = {k: t for k, t in _build._SIGNATURES.items() if k.startswith("mtm_markov_em_one")}

    # the variants' libraries, built together
    from concurrent.futures import ThreadPoolExecutor

    specs = {v: s for v, s in VARIANTS.items() if s["edits"]}
    if args.clocks:
        specs["clocks"] = {"edits": _CLOCKS}
    old_lib = None
    with ThreadPoolExecutor(len(specs) + 1) as pool:
        futs = {v: pool.submit(build, src, [_SRC], work, edits={_SRC: s["edits"]},
                               signatures={**sigs, **({"mtm_clocks": [ctypes.c_void_p, ctypes.c_int]}
                                                      if v == "clocks" else {})})
                for v, s in specs.items()}
        if args.old is not None:
            old_src = args.old / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
            old_fut = pool.submit(build, old_src, ["markov_em.cu"], work)
        libs = {v: f.result() for v, f in futs.items()}
        if args.old is not None:
            old_lib, old_log = old_fut.result()
    log_path = _build.library_path().with_suffix(".log")
    logs = {"full": log_path.read_text() if log_path.exists() else "", **{v: lg for v, (_l, lg) in libs.items()}}
    plan = mk.k1_plan(112, C, torch.float32, N)
    launch = mk._k1_config(torch.cuda.current_device(), 112, C, 1, True, plan.ring)
    emit(plan=plan._asdict(), launch=launch._asdict())
    for v, lg in logs.items():
        for use in ptxas(lg):
            line = {"variant": v, "ptxas": use}
            if "em_one_kernel" in use["kernel"]:
                line["occupancy"] = occupancy(use["registers"], launch.threads, plan.smem)
            emit(**line)

    class Swapped:  # a variant's K1 launch functions, everything else from the package's library
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib if name in sigs or name == "mtm_clocks" else real, name)

    real_plan = mk.k1_plan

    def use(variant):
        lib = libs.get(variant, (real, ""))[0]
        _build.library = (lambda: real) if lib is real else (lambda lib=lib: Swapped(lib))
        ring = VARIANTS.get(variant, {}).get("ring")
        if ring is None:
            mk.k1_plan = real_plan
        else:
            def forced(Fcp, C_, dtype, n, *, argmax=True):
                p = real_plan(Fcp, C_, dtype, n, argmax=argmax)
                return p and p._replace(ring=ring, smem=mk.k1_smem(Fcp, C_, dtype, ring, argmax=argmax))
            mk.k1_plan = forced
        mk._k1_config.cache_clear()

    # phase 3's int16 Φ (the bench batch, seed 1) and weights (seed 2)
    rng = np.random.default_rng(2)
    params = em.mixture_params_from_numpy(
        (np.full(C, 1.0 / C), rng.normal(size=(C, D)), np.stack([np.eye(D)] * C),
         rng.normal(scale=0.4, size=(C, D, D)), np.stack([np.eye(D)] * C), rng.normal(size=(C, D, L)),
         np.stack([np.eye(L)] * C)), device=dev)
    Wg = mops.markov_em_weights(params.m, params.S, params.A, params.G, params.H, params.L)
    Wg[:, -1] += torch.log(params.pi)
    cases = {}
    for key, n in (("n", N), ("n37", N + 37)):
        z, x, lens = cs.bench_batch(n, seed=1)
        z_t = torch.tensor(z.transpose(0, 2, 1).reshape(T * D, n), dtype=torch.float32, device=dev)
        x_t = torch.tensor(x.transpose(0, 2, 1).reshape(T * L, n), dtype=torch.float32, device=dev)
        del z, x
        u = mk.pack_markov_u(z_t, x_t, T=T, d=D, l=L)
        del z_t, x_t
        pq = mk.quantize_phi(mk.markov_materialize_features(u, torch.tensor(lens, device=dev), T=T, d=D, l=L))
        del u
        wc = mk.fold_weights(Wg, T=T, d=D, l=L, scale=pq.scale)
        prev = torch.tensor(np.random.default_rng(3).integers(0, C, size=n).astype(np.int32), device=dev)
        prev[::1009] = -1
        cases[f"{key}_random"] = (pq.q, prev, wc)
        cases[f"{key}_one_cluster"] = (pq.q, prev, wc[:1].expand(C, -1).contiguous())
    torch.cuda.empty_cache()

    def measure(fn, reps):
        return {"events_ms": event_ms(fn, reps), "device": profiled(fn, reps), "host_ms": host_ms(fn, reps)}

    # this tree's variants on random assignments (full: every case)
    ref = {k: [t.clone() for t in mk.markov_em_compact(*c)] for k, c in cases.items()}
    for variant in ["full", *VARIANTS]:
        use(variant)
        mode = VARIANTS.get(variant, {}).get("mode", "argmax")
        for key, (q, prev, wc) in cases.items():
            if variant != "full" and not key.endswith("random"):
                continue
            fn = lambda q=q, prev=prev, wc=wc: mk.markov_em_compact(q, prev, wc, assign_mode=mode)  # noqa: E731
            line = {"tree": "new", "variant": variant, "case": key, "mode": mode, **measure(fn, args.reps)}
            if VARIANTS.get(variant, {}).get("check"):
                line["bit_equal_to_full"] = all(same_bits(p, r) for p, r in zip(fn(), ref[key]))
            emit(**line)
    use("full")

    if args.clocks:
        lib = libs["clocks"][0]
        _build.library = lambda: Swapped(lib)
        mk._k1_config.cache_clear()
        q, prev, wc = cases["n_random"]
        mk.markov_em_compact(q, prev, wc)
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * 5)()
        assert lib.mtm_clocks(clk, 1) == 0
        mk.markov_em_compact(q, prev, wc)
        torch.cuda.synchronize()
        assert lib.mtm_clocks(clk, 0) == 0
        use("full")
        names = ("wait_copies_and_barrier", "issue_and_scores", "barrier_before_stats", "stats_warp0")
        sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
        emit(clocks=True, tiles=clk[4], sm_clock=sm,
             **{f"{k}_cycles_per_tile": round(clk[i] / max(clk[4], 1), 1) for i, k in enumerate(names)})

    if old_lib is not None:
        old = old_k1(old_lib._name)
        for key, (q, prev, wc) in cases.items():
            new_out = mk.markov_em_compact(q, prev, wc)
            old_out = old(q, prev, wc)
            emit(case=key, old_vs_new_bit_equal=[same_bits(p, r) for p, r in zip(new_out, old_out)])
            for tree in ("old", "new", "new", "old"):
                fn = (lambda: old(q, prev, wc)) if tree == "old" else (lambda: mk.markov_em_compact(q, prev, wc))
                emit(tree=tree, variant="full", case=key, **measure(fn, args.reps))
        del cases
        torch.cuda.empty_cache()
        if (args.old / "multimodal_trajectory_modeling_tpu_torch" / "ops").exists():
            wrapper_times({"old": args.old, "new": ROOT}, args.reps)
        if args.fit_trace:
            fit_trace(cs, em, mk, old, args.reps, measure)
    shutil.rmtree(work, ignore_errors=True)
    return 0


def fit_trace(cs, em, mk, old, reps, measure) -> None:
    """Phase 4's fit (its data and start) with this tree's K1 and with the
    older tree's: iterations, status and assignments; then both K1s on the
    fit's own Φ, parameters and assignments, held equal and timed."""
    import numpy as np
    import torch

    from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable

    fits = {}
    for tree in ("new", "old"):
        z, x, _lens = cs.bench_batch(cs.N, seed=0)
        np.random.seed(0)
        model = MMLinGaussSS_marginalizable(n_clusters=cs.C, states=z, observations=x, device="cuda")
        del z, x
        real = mk.markov_em_compact
        mk.markov_em_compact = real if tree == "new" else old
        t0 = time.perf_counter()
        try:
            model.train(fast=True, n_steps=30)
        finally:
            mk.markov_em_compact = real
        fits[tree] = (model.last_iterations, model.last_status, np.asarray(model.cluster_assignment), model)
        emit(fit=tree, seconds=time.perf_counter() - t0, iterations=fits[tree][0], status=fits[tree][1],
             rows_differing_from_new=int((fits[tree][2] != fits["new"][2]).sum()))
    emit(fit_trace="same iterations, status and assignments",
         holds=bool(fits["new"][:2] == fits["old"][:2] and np.array_equal(fits["new"][2], fits["old"][2])))
    model = fits["new"][3]
    dev = torch.device("cuda")
    lens = torch.tensor(model._suffix_instance_lens(model.states, model.observations), device=dev)
    zd = torch.tensor(model.states, dtype=torch.float32, device=dev)
    xd = torch.tensor(model.observations, dtype=torch.float32, device=dev)
    pq = em._markov_features(zd, xd, lens)[1]
    del zd, xd
    p = model._stacked_params()
    wc = mk.fold_weights(em._weights(p), T=cs.T, d=cs.D, l=cs.L, scale=pq.scale)
    prev = torch.tensor(model.cluster_assignment, dtype=torch.int32, device=dev)
    new_out, old_out = mk.markov_em_compact(pq.q, prev, wc), old(pq.q, prev, wc)
    emit(case="n_fitted", old_vs_new_bit_equal=[same_bits(a, b) for a, b in zip(new_out, old_out)],
         cluster_sizes=torch.bincount(new_out[0].long(), minlength=cs.C + 1).tolist())
    for tree in ("old", "new", "new", "old"):
        fn = (lambda: old(pq.q, prev, wc)) if tree == "old" else (lambda: mk.markov_em_compact(pq.q, prev, wc))
        emit(tree=tree, variant="full", case="n_fitted", **measure(fn, reps))


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())

#!/usr/bin/env python3
"""Where K5's time goes on the card (``markov_materialize_features_longT``:
the canonical Φ at any T, once per long-T fit).

Cases: ``chip_smoke.py`` phase 14's shape (T = 128, (d, l) = (5, 3), n =
2.5e5 and 2.5e5 + 37, lengths 64, 100 or 128, NaN past them, values
N(0, 3²)) in float32; ADNI's (2, 4) and the generic instantiation's (4, 4)
at n = 2.5e5 in float32; phase 14's shape in float64.

This tree's ``csrc/markov_features_longT.cu`` is built from edited copies
(``tools/variant_build.py``) and called through its C interface; each
variant is timed by CUDA events over ``--reps`` calls after a warm-up and
by ``torch.profiler`` (device time a call):

- ``staged``: the source as it is, on the wrapper's plan
  (``mk.k5_plan``, the runtime's blocks an SM); ``global``: the
  global-memory body of the same library;
- at phase 14's shape, n = 2.5e5 and 2.5e5 + 37, parts left out:
  ``copies_only`` (the ring walked, no build, no stores), ``no_stores``
  (copies and build, each row folded into a checksum that is stored once
  in 2^64 tiles: an empty asm sink let the compiler drop the build),
  ``build_only`` (build and stores, no copies: the stages hold whatever
  shared memory held), ``compute_only`` (the build alone), ``stores_only``
  (no copies, no build: every row of Φ stored as zeros), ``stores_l2``
  (every row stored to a 2.4 MB region that stays in L2); and design
  choices, each held to the plain version bit for bit: ``q3`` (a row part
  a thread at the compiled shapes, 64-instance tiles), ``plain_stores``
  (Φ stored without the streaming hint), ``fused_mask`` (the masked sums
  vm·v + acc as one fused multiply-add: vm is 0 or 1, so vm·v is exact and
  the one rounding is the sum's, the same bits),
  ``offsets_always`` (every row's offset into its 16-byte line added even
  where n % 4 == 0: the aligned path's gain, at n = 2.5e5 alone);
- in every case, the plans the wrapper did not pick (2, 4, 8 or 16 steps
  a stage, 2 or 3 stages, on the plan's tile), each held to the plain
  version bit for bit.

Every output is held bit for bit to ``markov_materialize_features_longT_plain``
on the card and to the global-memory body, and two calls to each other.
With ``--clocks`` lane 0 of each warp reads ``clock64`` around each
window's wait (the copies, the barrier and the next window's copies
issued), each tile's steps and each tile's stores: the mean SM cycles a
tile per warp (the compiler may move the build's arithmetic across a
clock read, so the split between wait and steps is approximate; their
sum is not).  ``--cases`` runs only the named cases.

With ``--old DIR`` (the root of an older tree, e.g. a ``git archive`` of
the parent commit) that tree's ``csrc/markov_features_longT.cu`` is built
alone and timed in turns with this tree's body (old, new, new, old), its
Φ held to this tree's bit for bit in every case.

Usage, on a machine with the card and ``nvcc``::

    mkdir -p chip_scratch/parent
    git archive <old commit> multimodal_trajectory_modeling_tpu_torch | tar -x -C chip_scratch/parent
    python3 tools/k5_phase_split.py [--old chip_scratch/parent] [--clocks] [--reps 20] [--cases bench,bench-n37]

Prints the card's name and power limit first, then one JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from variant_build import build, card_line, event_ms  # noqa: E402  (tools/, the script's own directory)

_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
OLD_SIG = {"mtm_markov_features_longT": [_I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]}
SIG = {
    **OLD_SIG,
    "mtm_markov_features_longT_staged": [_I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mtm_markov_features_longT_staged_config": [_I, _I, _I, _I, _I, _I, _I, _P],
}
SRC = "markov_features_longT.cu"
ROWS = "markov_longT_rows.cuh"
BUILD = "      if (active) {\n        const T* s = st + w * slab;"
FINISH = "    if (active) {\n      if constexpr ((PARTS & 1) != 0) r0.finish(o, true, put);"
PUT = "    auto put = [&](int row, T v) { __stcs(col + (int64_t)row * n, v); };"
TILE_END = "      if constexpr ((PARTS & 4) != 0) r2.finish(o, len, Fpad, put);\n    }\n"
# each row folded into a checksum that is stored only if it takes one
# value in 2^64, so the build stays live (an empty asm sink does not keep it)
NO_STORES = [
    (PUT, "    unsigned long long sink = 0;\n    auto put = [&](int, T v) {\n"
          "      if constexpr (sizeof(T) == 4) sink ^= __float_as_uint(v);\n"
          "      else sink ^= (unsigned long long)__double_as_longlong(v);\n    };"),
    (TILE_END, TILE_END + "    if (sink == 0x9e3779b97f4a7c15ull) phi[i] = T(0);\n"),
]
PROLOGUE = "  for (int g = 0; g < ns - 1; ++g) ring.issue(g);\n"
NO_COPIES = [(PROLOGUE, ""), ("    issue(g + ns - 1);\n  }", "  }")]
ZEROS = ("  for (int64_t tl = blockIdx.x; tl < ntiles; tl += G) {\n"
         "    const int64_t i = tl * NT + threadIdx.x % NT;\n"
         "    if (i < n)\n      for (int f = Q == 1 ? 0 : threadIdx.x / NT; f < Fpad; f += Q)"
         " __stcs(phi + (int64_t)f * n + i, T(0));\n  }\n  return;\n")
EDITS = {
    "copies_only": {SRC: [(BUILD, BUILD.replace("(active)", "(false)")), (FINISH, FINISH.replace("(active)", "(false)"))]},
    "no_stores": {SRC: NO_STORES},
    "stores_only": {SRC: [(PROLOGUE, ZEROS)]},
    "build_only": {SRC: NO_COPIES},
    "compute_only": {SRC: NO_COPIES + NO_STORES},
    "q3": {SRC: [("constexpr int kQ = FIXED && sizeof(T) == 4 ? 1 : 3;", "constexpr int kQ = 3;")]},
    "plain_stores": {SRC: [(PUT, PUT.replace("__stcs(col + (int64_t)row * n, v)", "col[(int64_t)row * n] = v"))]},
    "fused_mask": {ROWS: [("a2[a * DM + b] = add_rn(a2[a * DM + b], mul_rn(vm, zz));",
                           "a2[a * DM + b] = fused_ma(vm, zz, a2[a * DM + b]);"),
                          ("a7[a] = add_rn(a7[a], mul_rn(vm, zc[a]));", "a7[a] = fused_ma(vm, zc[a], a7[a]);")]},
    "stores_l2": {SRC: [(PUT, PUT.replace("__stcs(col + (int64_t)row * n, v)",
                                          "phi[((int64_t)row << 12) + (i & 4095)] = v"))]},
    "offsets_always": {SRC: [("  if (extra) walk_parts<Q, false>(ring, lens, phi, Fpad, mine);\n"
                              "  else walk_parts<Q, true>(ring, lens, phi, Fpad, mine);\n",
                              "  walk_parts<Q, false>(ring, lens, phi, Fpad, mine);\n")]},
}
PARTS = ("copies_only", "no_stores", "stores_only", "build_only", "compute_only", "stores_l2")  # variants whose Φ is not built
ALIGNED_ONLY = ("offsets_always",)
# lane 0 of each warp reads clock64 around each window's wait, each tile's
# steps and each tile's stores
CLOCKS = {SRC: [
    ("namespace {\n\nusing mtm::finite_or_zero;",
     "__device__ unsigned long long g_k5_clk[4];\n\nnamespace {\n\nusing mtm::finite_or_zero;"),
    ("  int g = 0;\n  for (int it = 0; it < mine; ++it) {",
     "  long long ck_w = 0, ck_t = 0, ck_f = 0, ck_n = 0;\n  int g = 0;\n  for (int it = 0; it < mine; ++it) {\n"
     "    const long long ct = clock64();"),
    ("        ring.enter(g);\n", "        const long long c0 = clock64();\n        ring.enter(g);\n        ck_w += clock64() - c0;\n"),
    (FINISH, "    const long long cf = clock64();\n    ck_t += cf - ct;\n" + FINISH),
    (TILE_END + "  }\n}\n",
     TILE_END + "    ck_f += clock64() - cf;\n"
     "    ++ck_n;\n  }\n  if ((threadIdx.x & 31) == 0) {\n"
     "    atomicAdd(&g_k5_clk[0], (unsigned long long)ck_w);\n    atomicAdd(&g_k5_clk[1], (unsigned long long)ck_t);\n"
     "    atomicAdd(&g_k5_clk[2], (unsigned long long)ck_f);\n    atomicAdd(&g_k5_clk[3], (unsigned long long)ck_n);\n"
     "  }\n}\n"),
    ("// The largest d and l the kernel takes.\n",
     "extern \"C\" int mtm_k5_clocks(unsigned long long* out, int reset) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, g_k5_clk, sizeof(unsigned long long) * 4);\n"
     "  if (e == cudaSuccess && reset) {\n    unsigned long long z[4] = {0};\n"
     "    e = cudaMemcpyToSymbol(g_k5_clk, z, sizeof(z));\n  }\n  return (int)e;\n}\n\n"
     "// The largest d and l the kernel takes.\n"),
]}
T = 128
LENGTHS = (64, 100, 128)


def device_ms(torch, fn, reps=10):
    """Device ms a call (every kernel in the trace), over the calls the
    trace recorded (the least frequent kernel's count), and the executions
    it recorded."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, rec, calls = 0.0, 0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            us, rec, calls = us + t, rec + e.count, min(calls, e.count) if calls else e.count
    return {"ms": round(us / 1e3 / calls, 4) if calls else None, "kernels_recorded": rec, "calls": reps}


def timing(torch, fn, reps):
    return {"events_ms": round(event_ms(fn, reps), 4), "device": device_ms(torch, fn)}


def batch(torch, dev, n, d, l, dtype, seed):
    """(z_t, x_t, lens) on the card: N(0, 3²) values, a length of 64, 100 or
    128 an instance, NaN past it."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lens = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)[torch.randint(0, 3, (n,), generator=g, device=dev)]
    past = torch.arange(T, device=dev)[:, None] >= lens[None, :]
    z = torch.randn((T, d, n), generator=g, device=dev, dtype=torch.float64) * 3.0
    x = torch.randn((T, l, n), generator=g, device=dev, dtype=torch.float64) * 3.0
    z.masked_fill_(past[:, None, :], float("nan"))
    x.masked_fill_(past[:, None, :], float("nan"))
    return z.reshape(T * d, n).to(dtype), x.reshape(T * l, n).to(dtype), lens


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="root of the tree whose K5 to time beside this one")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--clocks", action="store_true", help="SM cycles a tile for the wait, the steps and the stores")
    ap.add_argument("--cases", help="comma-separated case labels to run (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k5_phase_split: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(json.dumps({"build_seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    csrc = ROOT / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
    clk_sig = {**SIG, "mtm_k5_clocks": [_P, _I]}
    jobs = {"staged": (csrc, None, SIG), **{k: (csrc, e, SIG) for k, e in EDITS.items()}}
    if args.clocks:
        jobs["clocks"] = (csrc, CLOCKS, clk_sig)
    if args.old:
        jobs["old"] = (args.old / "multimodal_trajectory_modeling_tpu_torch" / "csrc", None, OLD_SIG)
    scratch = ROOT / "chip_scratch"
    scratch.mkdir(exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {name: pool.submit(build, src, [SRC], scratch, edits, sig) for name, (src, edits, sig) in jobs.items()}
        built = {name: f.result() for name, f in futures.items()}
    libs = {name: lib for name, (lib, _log) in built.items()}
    for name in ("staged", "q3", "fused_mask"):
        for ln in built[name][1].splitlines():
            if "features_longT_staged" in ln or "Used" in ln or "spill" in ln:
                print(json.dumps({"ptxas": ln.strip()[:160], "variant": name}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    kinds = {torch.float32: 0, torch.float64: 1}

    def config(lib, kind, d, l, nt, q, W, ns):
        out = (ctypes.c_int * 6)()
        rc = lib.mtm_markov_features_longT_staged_config(kind, d, l, nt, q, W, ns, out)
        return list(out) if rc == 0 else None

    def staged(lib, zt, xt, lens, d, l, nt, q, W, ns):
        """A call of the staged body on this plan, or None where it does
        not fit; its grid the runtime's blocks an SM times the SMs."""
        kind = kinds[zt.dtype]
        cfg = config(lib, kind, d, l, nt, q, W, ns)
        if cfg is None:
            return None, None
        n = zt.shape[1]
        grid = min(-(-n // nt), cfg[2] * cfg[3])
        F_pad = mk._canonical_rows(d, l)
        phi = torch.empty((F_pad, n), dtype=zt.dtype, device=dev)

        def call():
            rc = lib.mtm_markov_features_longT_staged(0, kind, zt.data_ptr(), xt.data_ptr(), lens.data_ptr(),
                                                      phi.data_ptr(), n, T, d, l, F_pad, nt, q, W, ns, grid, stream)
            assert rc == 0, rc
            return phi

        return call, {"nt": nt, "q": q, "steps": W, "stages": ns, "grid": grid, "smem": cfg[0], "threads": cfg[1],
                      "blocks_per_sm": cfg[2], "registers": cfg[4], "local_bytes": cfg[5]}

    def global_body(lib, zt, xt, lens, d, l):
        n = zt.shape[1]
        F_pad = mk._canonical_rows(d, l)
        phi = torch.empty((F_pad, n), dtype=zt.dtype, device=dev)

        def call():
            rc = lib.mtm_markov_features_longT(0, kinds[zt.dtype], zt.data_ptr(), xt.data_ptr(), lens.data_ptr(),
                                               phi.data_ptr(), n, T, d, l, F_pad, stream)
            assert rc == 0, rc
            return phi

        return call

    def same(p, q):
        it = torch.int32 if p.dtype == torch.float32 else torch.int64
        return p.dtype == q.dtype and bool(torch.equal(p.view(it), q.view(it)))

    def bound_ms(n, d, l, itemsize):
        nbytes = itemsize * (T * (d + l) * n + mk._canonical_rows(d, l) * n) + 4 * n
        return round(nbytes / cs.HBM_BYTES_PER_S * 1e3, 4)

    cases = [("bench", 5, 3, 250_000, torch.float32), ("bench-n37", 5, 3, 250_037, torch.float32),
             ("adni-shape", 2, 4, 250_000, torch.float32), ("generic", 4, 4, 250_000, torch.float32),
             ("bench-float64", 5, 3, 250_000, torch.float64)]
    if args.cases:
        cases = [c for c in cases if c[0] in args.cases.split(",")]
    for label, d, l, n, dtype in cases:
        zt, xt, lens = batch(torch, dev, n, d, l, dtype, seed=5)
        plan = mk._k5_config(0, d, l, dtype)
        pl = (plan.nt, plan.q, plan.steps, plan.stages)
        ref = mk.markov_materialize_features_longT_plain(zt, xt, lens, T=T, d=d, l=l)
        main_call, main_plan = staged(libs["staged"], zt, xt, lens, d, l, *pl)
        got = main_call().clone()
        glob = global_body(libs["staged"], zt, xt, lens, d, l)
        print(json.dumps({"case": label, "n": n, "d": d, "l": l, "dtype": str(dtype), "plan": main_plan,
                          "bound_ms": bound_ms(n, d, l, zt.element_size()), "staged_equals_plain": same(got, ref),
                          "staged_equals_global": same(got, glob().clone()), "two_calls_equal": same(main_call(), got)}),
              flush=True)
        variants = {"staged": main_call, "global": glob}
        if label in ("bench", "bench-n37"):
            for k in EDITS:
                if k in ALIGNED_ONLY and label != "bench":
                    continue
                vp = (64, 3, plan.steps, plan.stages) if k == "q3" else pl
                variants[k] = staged(libs[k], zt, xt, lens, d, l, *vp)[0]
        for W in (2, 4, 8, 16):
            for ns in (2, 3):
                if (W, ns) == (plan.steps, plan.stages):
                    continue
                fn, p = staged(libs["staged"], zt, xt, lens, d, l, plan.nt, plan.q, W, ns)
                if fn is not None:
                    variants[f"W{W}_ns{ns}"] = fn
                    print(json.dumps({"case": label, "variant": f"W{W}_ns{ns}", "plan": p}), flush=True)
        for name, fn in variants.items():
            out = fn()
            eq = None if name in PARTS else same(out, ref)
            print(json.dumps({"case": label, "variant": name, **timing(torch, fn, args.reps), "bit_equal_to_plain": eq}),
                  flush=True)
        if args.clocks and label in ("bench", "bench-n37"):
            for name in ("clocks",):
                clk = (ctypes.c_ulonglong * 4)()
                fn = staged(libs[name], zt, xt, lens, d, l, *pl)[0]
                fn()
                torch.cuda.synchronize()
                libs[name].mtm_k5_clocks(clk, 1)
                fn()
                torch.cuda.synchronize()
                libs[name].mtm_k5_clocks(clk, 1)
                tiles = max(clk[3], 1)
                print(json.dumps({"case": label, "variant": name, "cycles_per_tile_per_warp": {
                    "wait": round(clk[0] / tiles, 1), "steps_without_wait": round((clk[1] - clk[0]) / tiles, 1),
                    "stores": round(clk[2] / tiles, 1)}}), flush=True)
        if args.old:
            old = global_body(libs["old"], zt, xt, lens, d, l)
            turns = {"old": [], "staged": []}
            for who in ("old", "staged", "staged", "old"):
                turns[who].append(timing(torch, {"old": old, "staged": main_call}[who], args.reps))
            print(json.dumps({"case": label, "old_equals_staged": same(old(), got), "old_equals_plain": same(old(), ref),
                              "turns": turns}), flush=True)
        del zt, xt, lens, ref, got, variants, main_call, glob
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

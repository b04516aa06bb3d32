#!/usr/bin/env python3
"""Where K2's time goes on the card (``markov_materialize_features``: Φ
from the packed batch, once per fit), and what the fit's whole Φ build
(K2, then ``quantize_phi``) costs.

Cases: ``chip_smoke.py`` phase 3's bench batch (T = 10, (d, l) = (5, 3),
n = 1e6 and 1e6 + 37), ADNI's (d, l) = (2, 4) and (3, 2) (no compile-time
table) at n = 1e6 (normal values, a length in 1..T an instance, NaN past
it), float32; and the bench batch in float64 (the row-at-a-time body).

This tree's ``csrc/markov_features.cu`` is built from edited copies
(``tools/variant_build.py``) and called through its C interface; each
variant is timed by CUDA events over ``--reps`` calls after a warm-up and
by ``torch.profiler`` (device time a call):

- ``staged``: the source as it is, the wrapper's plan (``mk.k2_plan``,
  the runtime's blocks an SM); ``general``: the same body building every
  row with ``acc_row_tile`` (the shapes without a table); ``rows``: the
  row-at-a-time body (float64, and the float32 body before this one);
- at the bench shape, n = 1e6 and 1e6 + 37, parts left out:
  ``copies_only`` (the ring filled, no build, no stores), ``no_stores``
  (copies and build, each row kept live in a register, nothing stored),
  ``stores_only`` (no copies, no build: every row of Φ stored as zeros);
  and design choices, each held to ``rows`` bit for bit:
  ``plain_stores`` (Φ stored without the streaming hint), ``regs64``
  (the registers capped at 64 a thread, two blocks of 512 threads an SM);
- in every case, the plans the wrapper did not pick (tiles of 128, 64
  and 32 instances, rings of one and two slots), each held to ``rows``
  bit for bit;
- ``quantize_phi`` on the staged Φ, and the fit's Φ build (K2 then
  ``quantize_phi``, as ``em._markov_features`` runs them).

Every staged output is held to the ``rows`` body's bit for bit, and two
calls to each other.  With ``--clocks`` lane 0 of each warp reads
``clock64`` around each tile's wait (the copies and the barrier) and its
build (with its stores, and again without them): the mean SM cycles a
tile per warp for the wait, the build and the stores (their difference).

With ``--old DIR`` (the root of an older tree, e.g. a ``git archive`` of
the parent commit) that tree's ``csrc/markov_features.cu`` is built alone
and timed in turns with this tree's body (old, new, rows, rows, new,
old), its Φ held to this tree's bit for bit in both types; and that
tree's float32 K4a sources (``csrc/markov_em_packed*.cu``) are built
alone and called through the port's wrapper in the place of this tree's
on phase 6's bench batch and weights: the outputs bit for bit, the
kernel's device time in turns.

Usage, on a machine with the card and ``nvcc``::

    mkdir -p chip_scratch/parent
    git archive <old commit> multimodal_trajectory_modeling_tpu_torch | tar -x -C chip_scratch/parent
    python3 tools/k2_phase_split.py [--old chip_scratch/parent] [--clocks] [--reps 20]

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
ROWS_SIG = {"mtm_markov_features": [_I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]}
SIG = {
    **ROWS_SIG,
    "mtm_markov_features_staged": [_I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mtm_markov_features_staged_config": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
SRC = "markov_features.cu"
BUILD_CALL = "    build_tile(tile * NT, ring > 1 ? it & 1 : 0);\n"
STORE = "auto sink = [=](int f, float v) { __stcs(col + (int64_t)f * n, v); };"
EDITS = {
    "copies_only": [(BUILD_CALL, "")],
    "no_stores": [(STORE, 'auto sink = [=](int, float v) { asm volatile("" ::"f"(v)); };')],
    "stores_only": [
        (BUILD_CALL, "    if (tile * NT + j < n)\n      for (int f = part; f < Fcp; f += q) __stcs(phi + (int64_t)f * n + tile * NT + j, 0.f);\n"),
        ("if (blockIdx.x < ntiles) issue(blockIdx.x, 0);", ""),
        ("if (tile + G < ntiles) issue(tile + G, (it + 1) & 1);", ""),
        ("if (tile + G < ntiles) issue(tile + G, 0);", ""),
    ],
    "plain_stores": [(STORE, "auto sink = [=](int f, float v) { col[(int64_t)f * n] = v; };")],
    "regs64": [("__launch_bounds__(kMaxThreads, 1)", "__launch_bounds__(kMaxThreads, 2)")],
}
PARTS = ("copies_only", "no_stores", "stores_only")  # variants whose Φ is not built
# lane 0 of each warp reads clock64 around each tile's wait and build
CLOCKS = [
    ("namespace {\n\nusing mtm::Fixed;", "__device__ unsigned long long g_k2_clk[4];\n\nnamespace {\n\nusing mtm::Fixed;"),
    ("  int it = 0;\n  for (int64_t tile = blockIdx.x; tile < ntiles; tile += G, ++it) {\n    mtm::cp_async_wait(",
     "  long long ck_w = 0, ck_b = 0, ck_n = 0;\n  int it = 0;\n  for (int64_t tile = blockIdx.x; tile < ntiles; tile += G, ++it) {\n"
     "    const long long c0 = clock64();\n    mtm::cp_async_wait("),
    (BUILD_CALL, "    const long long c1 = clock64();\n    ck_w += c1 - c0;\n" + BUILD_CALL +
     "    ck_b += clock64() - c1;\n    ++ck_n;\n"),
    ("  mtm::cp_async_wait(0);\n}\n",
     "  mtm::cp_async_wait(0);\n  if ((threadIdx.x & 31) == 0) {\n    atomicAdd(&g_k2_clk[0], (unsigned long long)ck_w);\n"
     "    atomicAdd(&g_k2_clk[1], (unsigned long long)ck_b);\n    atomicAdd(&g_k2_clk[2], (unsigned long long)ck_n);\n  }\n}\n"),
]
CLOCKS_FN = ("extern \"C\" int mtm_k2_clocks(unsigned long long* out, int reset) {\n"
             "  cudaError_t e = cudaMemcpyFromSymbol(out, g_k2_clk, sizeof(unsigned long long) * 4);\n"
             "  if (e == cudaSuccess && reset) {\n    unsigned long long z[4] = {0};\n"
             "    e = cudaMemcpyToSymbol(g_k2_clk, z, sizeof(z));\n  }\n  return (int)e;\n}\n")
T = 10


def device_ms(torch, fn, reps=10):
    """Device ms a call (every kernel in the trace), over the calls the
    trace recorded (a trace can hold fewer kernel executions than were
    launched: the least frequent kernel's count), and the executions it
    recorded."""
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


def batch(cs, mk, torch, dev, n, d, l, seed):
    """(u, lens) on the card: the bench batch at (5, 3), else normal values
    with a length in 1..T an instance, NaN past it."""
    import numpy as np

    if (d, l) == (cs.D, cs.L):
        z, x, lens = cs.bench_batch(n, seed=seed)
    else:
        rng = np.random.default_rng(seed)
        z, x = rng.normal(size=(T, n, d)) * 3.0, rng.normal(size=(T, n, l)) * 3.0
        lens = rng.integers(1, T + 1, size=n).astype(np.int32)
        past = np.arange(T)[:, None] >= lens[None, :]
        z[past], x[past] = np.nan, np.nan
    z_t = torch.tensor(z.transpose(0, 2, 1).reshape(T * d, n), dtype=torch.float32, device=dev)
    x_t = torch.tensor(x.transpose(0, 2, 1).reshape(T * l, n), dtype=torch.float32, device=dev)
    return mk.pack_markov_u(z_t, x_t, T=T, d=d, l=l), torch.tensor(lens, device=dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="root of the tree whose K2 (and float32 K4a) to time beside this one")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--clocks", action="store_true", help="SM cycles a tile for the wait, the build and the stores")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_phase_split: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    from multimodal_trajectory_modeling_tpu_torch.ops import markov as mops
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(json.dumps({"build_seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    csrc = ROOT / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
    clk_sig = {**SIG, "mtm_k2_clocks": [_P, _I]}
    jobs = {"staged": (csrc, [SRC], None, SIG), **{k: (csrc, [SRC], {SRC: e}, SIG) for k, e in EDITS.items()}}
    if args.clocks:
        jobs["clocks"] = (csrc, [SRC], {SRC: CLOCKS}, clk_sig)
        jobs["clocks_no_stores"] = (csrc, [SRC], {SRC: CLOCKS + EDITS["no_stores"]}, clk_sig)
    packed_sigs = {k: v for k, v in _build._SIGNATURES.items() if k.startswith("mtm_markov_em_packed")}
    if args.old:
        old_csrc = args.old / "multimodal_trajectory_modeling_tpu_torch" / "csrc"
        jobs["old"] = (old_csrc, [SRC], None, ROWS_SIG)
        jobs["old_k4a"] = (old_csrc, sorted(p.name for p in old_csrc.glob("markov_em_packed*.cu")), None, packed_sigs)
    scratch = ROOT / "chip_scratch"
    scratch.mkdir(exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {}
        for name, (src, srcs, edits, sig) in jobs.items():
            if name.startswith("clocks"):
                # the clock reader appended to the file
                edits = {SRC: edits[SRC] + [("extern \"C\" int mtm_markov_features(", CLOCKS_FN +
                                             "extern \"C\" int mtm_markov_features(")]}
            futures[name] = pool.submit(build, src, srcs, scratch, edits, sig)
        built = {name: f.result() for name, f in futures.items()}
    libs = {name: lib for name, (lib, _log) in built.items()}
    for name in ("staged", "regs64"):
        for ln in built[name][1].splitlines():
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln:
                print(json.dumps({"ptxas": ln.strip(), "variant": name}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    def config(lib, T_, d, l, nt, ring, table, q=4):
        Fcp, uniq, _ = mk.markov_compact_spec(T_, d, l)
        out = (ctypes.c_int * 6)()
        rc = lib.mtm_markov_features_staged_config(d, l, int(uniq.shape[0]), Fcp, T_ * 8 * ((d + l + 7) // 8), nt,
                                                   q, ring, int(table), out)
        return list(out) if rc == 0 else None

    def staged(lib, u, lens, d, l, nt, ring, table=True, q=4):
        """A call of the staged body with this plan, or None where it does
        not fit; its grid the runtime's blocks an SM times the SMs."""
        Fcp, uniq, _ = mk.markov_compact_spec(T, d, l)
        cfg = config(lib, T, d, l, nt, ring, table, q)
        if cfg is None:
            return None, None
        n = u.shape[1]
        grid = min(-(-n // nt), cfg[2] * cfg[3])
        desc = mk._row_desc(T, d, l, dev)
        phi = torch.empty((Fcp, n), dtype=torch.float32, device=dev)

        def call():
            rc = lib.mtm_markov_features_staged(0, u.data_ptr(), lens.data_ptr(), desc.data_ptr(), phi.data_ptr(), n,
                                                T, d, l, int(uniq.shape[0]), Fcp, nt, q, ring, grid, int(table),
                                                stream)
            assert rc == 0, rc
            return phi

        return call, {"nt": nt, "ring": ring, "grid": grid, "smem": cfg[0], "threads": cfg[1],
                      "blocks_per_sm": cfg[2], "registers": cfg[4], "local_bytes": cfg[5]}

    def rows(lib, u, lens, d, l):
        Fcp, uniq, _ = mk.markov_compact_spec(T, d, l)
        n = u.shape[1]
        desc = mk._row_desc(T, d, l, dev)
        phi = torch.empty((Fcp, n), dtype=u.dtype, device=dev)
        kind = 0 if u.dtype == torch.float32 else 1

        def call():
            rc = lib.mtm_markov_features(0, kind, u.data_ptr(), lens.data_ptr(), desc.data_ptr(), phi.data_ptr(), n, T,
                                         8 * ((d + l + 7) // 8), int(uniq.shape[0]), Fcp, stream)
            assert rc == 0, rc
            return phi

        return call

    def same(p, q):
        return bool(torch.equal(p.view(torch.int32 if p.dtype == torch.float32 else torch.int64),
                                q.view(torch.int32 if q.dtype == torch.float32 else torch.int64)))

    def bound_ms(n, d, l, itemsize=4):
        Fcp = mk.markov_compact_spec(T, d, l)[0]
        return round((itemsize * (T * 8 * ((d + l + 7) // 8) + Fcp) * n + 4 * n) / cs.HBM_BYTES_PER_S * 1e3, 4)

    cases = [("bench", 5, 3, cs.N), ("bench-n37", 5, 3, cs.N + 37), ("adni-shape", 2, 4, cs.N),
             ("no-table", 3, 2, cs.N)]
    for label, d, l, n in cases:
        u, lens = batch(cs, mk, torch, dev, n, d, l, seed=1)
        plan = mk._k2_config(0, T, d, l, (d, l) in ((5, 3), (2, 4)))
        p_nt, p_ring = plan.nt, plan.ring
        ref = rows(libs["staged"], u, lens, d, l)().clone()
        main_call, main_plan = staged(libs["staged"], u, lens, d, l, p_nt, p_ring)
        got = main_call().clone()
        print(json.dumps({"case": label, "n": n, "d": d, "l": l, "plan": main_plan, "bound_ms": bound_ms(n, d, l),
                          "staged_equals_rows": same(got, ref), "two_calls_equal": same(main_call(), got)}),
              flush=True)
        variants = {"staged": main_call, "general": staged(libs["staged"], u, lens, d, l, p_nt, p_ring, False)[0],
                    "rows": rows(libs["staged"], u, lens, d, l)}
        if label in ("bench", "bench-n37"):
            variants.update({k: staged(libs[k], u, lens, d, l, p_nt, p_ring)[0] for k in EDITS})
        for nt in (128, 64, 32):
            for ring in (1, 2):
                fn, pl = staged(libs["staged"], u, lens, d, l, nt, ring)
                if fn is not None and (nt, ring) != (p_nt, p_ring):
                    variants[f"nt{nt}_ring{ring}"] = fn
                    print(json.dumps({"case": label, "variant": f"nt{nt}_ring{ring}", "plan": pl}), flush=True)
        for name, fn in variants.items():
            out = fn()
            eq = None if name in PARTS else same(out, ref)
            print(json.dumps({"case": label, "variant": name, **timing(torch, fn, args.reps), "bit_equal_to_rows": eq}),
                  flush=True)
        if label == "bench":
            phi = got
            print(json.dumps({"case": label, "quantize_phi": timing(torch, lambda: mk.quantize_phi(phi), args.reps),
                              "fit_phi_build": timing(torch, lambda: mk.quantize_phi(
                                  mk.markov_materialize_features(u, lens, T=T, d=d, l=l)), args.reps)}), flush=True)
            if args.clocks:
                cyc = {}
                for name in ("clocks", "clocks_no_stores"):
                    clk = (ctypes.c_ulonglong * 4)()
                    fn = staged(libs[name], u, lens, d, l, p_nt, p_ring)[0]
                    fn()
                    torch.cuda.synchronize()
                    libs[name].mtm_k2_clocks(clk, 1)
                    fn()
                    torch.cuda.synchronize()
                    libs[name].mtm_k2_clocks(clk, 1)
                    cyc[name] = (clk[0] / max(clk[2], 1), clk[1] / max(clk[2], 1))
                print(json.dumps({"case": label, "cycles_per_tile_per_warp": {
                    "wait": round(cyc["clocks"][0], 1), "build_and_stores": round(cyc["clocks"][1], 1),
                    "build": round(cyc["clocks_no_stores"][1], 1),
                    "stores": round(cyc["clocks"][1] - cyc["clocks_no_stores"][1], 1),
                    "wait_without_stores": round(cyc["clocks_no_stores"][0], 1)}}), flush=True)
        if args.old:
            old = rows(libs["old"], u, lens, d, l)
            turns = {"old": [], "staged": [], "rows": []}
            for who in ("old", "staged", "rows", "rows", "staged", "old"):
                turns[who].append(timing(torch, {"old": old, "staged": main_call, "rows": variants["rows"]}[who],
                                         args.reps))
            print(json.dumps({"case": label, "old_equals_rows": same(old(), ref), "turns": turns}), flush=True)
        if label == "bench":
            u64 = u.double()
            ref64 = rows(libs["staged"], u64, lens, d, l)().clone()
            wrapped = mk.markov_materialize_features(u64, lens, T=T, d=d, l=l)
            line = {"case": "bench-float64", "bound_ms": bound_ms(n, d, l, 8), "wrapper_equals_rows": same(wrapped, ref64),
                    "rows": timing(torch, rows(libs["staged"], u64, lens, d, l), args.reps)}
            if args.old:
                old64 = rows(libs["old"], u64, lens, d, l)
                line["old_equals_rows"] = same(old64(), ref64)
                line["old"] = timing(torch, old64, args.reps)
            print(json.dumps(line), flush=True)
            del u64, ref64, wrapped
        if args.old and label == "bench":
            k4a_turns(torch, cs, em, mops, mk, _build, libs["old_k4a"], u, lens, args.reps)
        del u, lens, ref, got, variants, main_call
        torch.cuda.empty_cache()
    return 0


def k4a_turns(torch, cs, em, mops, mk, _build, old_lib, u, lens, reps):
    """Float32 K4a on the bench batch with this tree's sources and the older
    tree's (its packed launch functions in the place of this tree's):
    outputs bit for bit, device time in turns."""
    import numpy as np

    dev = u.device
    C, D, L = cs.C, cs.D, cs.L
    rng = np.random.default_rng(6)
    params = em.mixture_params_from_numpy(
        (np.full(C, 1.0 / C), rng.normal(size=(C, D)), np.stack([np.eye(D)] * C), rng.normal(scale=0.4, size=(C, D, D)),
         np.stack([np.eye(D)] * C), rng.normal(size=(C, D, L)), np.stack([np.eye(L)] * C)), device=dev)
    Wg = mops.markov_em_weights(params.m, params.S, params.A, params.G, params.H, params.L)
    Wg[:, -1] += torch.log(params.pi)
    Wg = Wg.float()
    prev = torch.tensor(rng.integers(0, C, size=u.shape[1]).astype(np.int32), device=dev)
    prev[::1009] = -1
    real = _build.library

    class Swapped:  # the older tree's packed launch functions, the rest this tree's
        def __getattr__(self, name):
            return getattr(old_lib if name.startswith("mtm_markov_em_packed") else real(), name)

    def with_lib(lib):
        def call():
            _build.library = lib
            try:
                return mk.markov_em_fused_packed(u, lens, prev, Wg, T=T, d=D, l=L)
            finally:
                _build.library = real
        return call

    new, old = with_lib(real), with_lib(lambda: Swapped())
    same = all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b) for a, b in zip(new(), old()))
    turns = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        turns[who].append(timing(torch, {"old": old, "new": new}[who], reps))
    print(json.dumps({"case": "k4a-f32", "old_equals_new": same, "turns": turns}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

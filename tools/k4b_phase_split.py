#!/usr/bin/env python3
"""Where K4b's time goes on the card: the float32 body of an older tree
(``csrc/markov_em_multi.cuh`` with ``PACKED``) and this tree's
(``csrc/markov_em_packed_mma.cu``), each timed whole and with phases
left out, at ``chip_smoke.py`` phase 6's shape (n = 1e6, T = 10, d = 5,
l = 3, C = 16, R = 32, 11 slots forced).

Each variant is ``markov_em_packed.cu`` (with this tree also
``markov_em_packed_mma.cu``) compiled alone into a library of its own, a
copy of the sources with one call removed: the statistics (the old body's
``ordered_add``, the new body's ``sort_tile`` and ``seg_sums``).  ``assign_mode="prev"`` skips
the scores.  So, per body:

- ``full``: Φ build + scores + statistics;
- ``no_stats``: Φ build + scores;
- ``prev``: Φ build + statistics;
- ``prev_no_stats``: Φ build (and the tile loop's barriers and copies).

Usage, on a machine with the card and ``nvcc``::

    mkdir -p chip_scratch/parent && git archive <old commit> \\
        multimodal_trajectory_modeling_tpu_torch/csrc | tar -x -C chip_scratch/parent
    python3 tools/k4b_phase_split.py --old chip_scratch/parent/multimodal_trajectory_modeling_tpu_torch/csrc

Prints one JSON line per body with each variant's milliseconds (CUDA
events over 5 calls after a warm-up), the card's name and power limit
first.  Without ``--old`` it times this tree's body alone.  With
``--clocks`` it also builds this tree's body with ``clock64()`` read by
thread 0 of each block at the tile loop's phase boundaries and prints
the mean SM cycles a tile spends in each: waiting for its u tile and the
cluster, building Φ (with the cluster's barrier), scoring and assigning
(with the next tile's copies started), the statistics, the objective.
With ``--chase`` as well, the statistics are replaced by a chain of 256
dependent shared-memory loads by every thread, whose cycles over 256
give the cost of one dependent load (and its few index operations) in
this kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from variant_build import build, card_line, event_ms  # noqa: E402  (tools/, the script's own directory)

# the clock64() reads of --clocks: (anchor, text that replaces it)
_CLOCKS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_clk[6];\n"),
    ("    cp_async_wait_all();\n    cluster_sync();",
     "    const long long c0 = clock64();\n    cp_async_wait_all();\n    cluster_sync();"),
    ("    build(i0);       // s_phi; s_u is free\n",
     "    const long long c1 = clock64();\n    build(i0);\n    const long long c2 = clock64();\n"),
    ("    __syncthreads();  // s_na\n    sort_tile();\n    __syncthreads();  // s_perm, s_seg\n    seg_sums();\n",
     "    __syncthreads();\n    const long long c3 = clock64();\n    sort_tile();\n    __syncthreads();\n"
     "    seg_sums();\n    __syncthreads();\n    const long long c4 = clock64();\n"),
    ("      for (int e = tid; e < rg * kObjThreads; e += kPT) s_vobj[e] = 0.f;\n    }\n",
     "      for (int e = tid; e < rg * kObjThreads; e += kPT) s_vobj[e] = 0.f;\n    }\n"
     "    if (tid == 0) {\n      const long long c5 = clock64();\n"
     "      const long long d[6] = {c1 - c0, c2 - c1, c3 - c2, c4 - c3, c5 - c4, 1};\n"
     "      for (int q = 0; q < 6; ++q) atomicAdd(&g_clk[q], (unsigned long long)d[q]);\n    }\n"),
    ("}  // namespace\n",
     "}  // namespace\nextern \"C\" int mtm_clocks(unsigned long long* out, int zero) {\n"
     "  unsigned long long z[6] = {};\n"
     "  return zero ? (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z))\n"
     "              : (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(z));\n}\n"),
]

# --chase: the statistics phase (after the clocks' patch) replaced by 256
# dependent shared-memory loads a thread
_CHASE = [
    ("    const long long c3 = clock64();\n    sort_tile();\n    __syncthreads();\n    seg_sums();\n",
     "    const long long c3 = clock64();\n"
     "    { int idx = lane; float x = 0.f;\n"
     "      for (int it = 0; it < 256; ++it) {\n"
     "        const float v = s_phi[idx];\n        x += v;\n"
     "        idx = (idx * 33 + (__float_as_int(v) & 1) + 1) & 4095;\n      }\n"
     "      if (x == 12345.f) part_obj[0] = x; }\n"),
]

# the call each variant removes, per body
_STATS_CALL = {
    "old": "          ordered_add(s_acc + rr * FS, cs, s_na, nt, tile, tstride, Fcp);\n",
    "new": "    sort_tile();\n    __syncthreads();  // s_perm, s_seg\n    seg_sums();\n",
}


def build_variant(src_dir: Path, body: str, drop_stats: bool, out_dir: Path,
                  clocks: bool = False, chase: bool = False) -> ctypes.CDLL:
    """``markov_em_packed.cu`` of ``src_dir`` (and its tensor-core body,
    for the new tree) compiled alone, the statistics call removed if
    ``drop_stats``, the phase clocks read if ``clocks``; the library
    loaded."""
    target = "markov_em_multi.cuh" if body == "old" else "markov_em_packed_mma.cu"
    edits = ([(_STATS_CALL[body], "")] if drop_stats else []) + (
        (_CLOCKS + (_CHASE if chase else [])) if clocks else [])
    srcs = ["markov_em_packed.cu"] + (["markov_em_packed_mma.cu"] if body == "new" else [])
    return build(src_dir, srcs, out_dir, edits={target: edits})[0]


def main() -> int:
    import numpy as np
    import torch

    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="csrc directory of the tree with the old body")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--clocks", action="store_true", help="also read the new body's phase clocks")
    ap.add_argument("--cs", type=int, help="blocks a cluster for the new body (default: the plan's)")
    ap.add_argument("--chase", action="store_true", help="with --clocks: a dependent-load chain for the stats")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4b_phase_split: no CUDA card", file=sys.stderr)
        return 2
    smi = card_line()
    print(smi, flush=True)

    dev = torch.device("cuda")
    T, d, l, C, R, n = 10, 5, 3, 16, 32, args.n
    rng = np.random.default_rng(6)
    z = rng.normal(size=(T, n, d)).astype(np.float32)
    x = rng.normal(size=(T, n, l)).astype(np.float32)
    lens = rng.integers(T // 2, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past] = np.nan
    x[past] = np.nan
    zt = torch.tensor(z.transpose(0, 2, 1).reshape(T * d, n), device=dev)
    xt = torch.tensor(x.transpose(0, 2, 1).reshape(T * l, n), device=dev)
    del z, x
    u = mk.pack_markov_u(zt, xt, T=T, d=d, l=l)
    del zt, xt
    lens_d = torch.tensor(lens, device=dev)
    Fcp = mk.markov_compact_spec(T, d, l)[0]
    wc = torch.tensor(rng.normal(size=(R, C, Fcp)) * 1e-3, dtype=torch.float32, device=dev)
    prev = torch.tensor(rng.integers(0, C, size=(R, n)).astype(np.int32), device=dev)
    force = torch.tensor([int(r % 3 == 0) for r in range(R)], dtype=torch.int32, device=dev)
    Fc = int(mk.markov_compact_spec(T, d, l)[1].shape[0])
    desc = mk._row_desc(T, d, l, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(lib, body, argmax):
        fn = lib.mtm_markov_em_packed
        P, I = ctypes.c_void_p, ctypes.c_int
        plan = mk.packed_mma_plan(Fcp, T * 8, C, R, argmax=argmax)
        if args.cs is not None:
            plan = plan._replace(cs=args.cs)
        extra = [I, I, I] if body == "new" else []
        fn.argtypes = [I, I] + [P] * 15 + [ctypes.c_longlong] + [I] * 10 + extra + [P]
        fn.restype = I
        parts, outs = mk._multi_buffers(R, n, Fcp, C, quant=False, wdtype=torch.float32, device=dev)

        def call():
            rc = fn(0, 1, u.data_ptr(), lens_d.data_ptr(), desc.data_ptr(), prev.data_ptr(),
                    force.data_ptr(), wc.data_ptr(), outs[0].data_ptr(), *(p.data_ptr() for p in parts),
                    *(o.data_ptr() for o in outs[3:4] + outs[1:3] + outs[4:]), n, T, 8, Fc, Fcp, C, R,
                    mk._multi_chunk(R), mk._EM_CHUNK, int(argmax), 1,
                    *((plan.nt, plan.rg, plan.cs) if body == "new" else ()), stream)
            if rc != 0:
                raise SystemExit(f"launch failed: {rc}")
        return call

    bodies = [("new", ROOT / "multimodal_trajectory_modeling_tpu_torch" / "csrc")]
    if args.old is not None:
        bodies.append(("old", args.old))
    out_dir = ROOT / "chip_scratch" / "k4b_phase_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    for body, src in bodies:
        libs = {drop: build_variant(src, body, drop, out_dir) for drop in (False, True)}
        row = {}
        for name, drop, argmax in (("full", False, True), ("no_stats", True, True),
                                   ("prev", False, False), ("prev_no_stats", True, False)):
            row[name + "_ms"] = round(event_ms(launcher(libs[drop], body, argmax), 5), 4)
        row["build_ms"] = row["prev_no_stats_ms"]
        row["scores_ms"] = round(row["full_ms"] - row["prev_ms"], 4)
        row["stats_ms"] = round(row["full_ms"] - row["no_stats_ms"], 4)
        print(json.dumps({"body": body, "n": n, "R": R, "C": C, "Fcp": Fcp, "forced": int(force.sum()),
                          "cs": args.cs, "card": smi, **row}), flush=True)
    if args.clocks:
        lib = build_variant(bodies[0][1], "new", False, out_dir, clocks=True, chase=args.chase)
        lib.mtm_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        call = launcher(lib, "new", True)
        call()
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * 6)()
        assert lib.mtm_clocks(clk, 1) == 0
        call()
        torch.cuda.synchronize()
        assert lib.mtm_clocks(clk, 0) == 0
        tiles = clk[5]
        names = ("wait_u_and_cluster", "build", "scores_assign", "stats", "objective")
        sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
        print(json.dumps({"body": "new", "clocks": True, "chase": args.chase, "cs": args.cs, "tiles": tiles,
                          "sm_clock": sm,
                          **{f"{k}_cycles_per_tile": round(clk[q] / tiles, 1) for q, k in enumerate(names)}}),
              flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())

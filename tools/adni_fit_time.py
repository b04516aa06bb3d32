"""Time the port's ADNI published fit: the README's 3-cluster
``train_with_multiple_random_starts(n_starts=1000)`` with ``init="k-means"``
and ``alpha=1.0`` on standardized states, on the CPU or the card.

Each ``--root`` is a checkout of the repo (this one by default; another
commit unpacked with ``git archive``).  Every root runs in a process of its
own that imports the port from there, the roots taken in turns
(``--rounds`` times), so two versions are compared on the same host under
the same load.  The data are read once through this checkout's adapter and
handed to each process in a file, so a root without the adapter (a commit
before it) runs the same fit.  A process fits once for each ``--dtype`` and
prints one JSON line a fit: root, device, dtype, seconds, k-means seconds,
batches, winner, objective and the restarts' iterations summed.
``--sequential N`` also times the first N candidates trained one by one
through ``em.train_em`` (one line); ``--profile`` traces each fit once more
with ``torch.profiler`` and prints its ops with the most self time on the
host and on the card.

    python tools/adni_fit_time.py --root /path/to/parent --root . --rounds 2
    python tools/adni_fit_time.py --device cuda --dtype float64 --dtype float32 --sequential 33
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def worker(args) -> None:
    sys.path.insert(0, args.worker)
    import numpy as np
    import torch

    torch.set_num_threads(args.threads)
    from multimodal_trajectory_modeling_tpu_torch.models import MMLinGaussSS_marginalizable, em

    with np.load(args.data) as f:
        zs, x = f["zs"], f["x"]
    cuda = args.device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def model(dtype):
        np.random.seed(0)
        return MMLinGaussSS_marginalizable(
            n_clusters=3, states=zs, observations=x, init="k-means", alpha=1.0,
            device=args.device, dtype=dtype,
        )

    def fit(dtype):
        m = model(dtype)
        sync()
        t0 = time.perf_counter()
        out = m.train_with_multiple_random_starts(
            n_starts=args.n_starts, use_cache=False, return_objectives=True
        )
        sync()
        return out, time.perf_counter() - t0

    line = {"root": args.worker, "device": args.device, "threads": args.threads}
    for name in args.dtype:
        dtype = getattr(torch, name)
        fit(dtype)  # the first fit of a process warms the card's libraries
        (best, objs), seconds = fit(dtype)
        ms = best.last_multistart
        winner = int(np.argmax(objs))
        print(json.dumps({
            **line, "dtype": name, "seconds": seconds,
            "kmeans_seconds": ms["kmeans_seconds"], "batches": ms.get("batches"),
            "winner": winner, "objective": float(objs[winner]),
            "iterations": int(np.sum(ms["iterations"])),
        }), flush=True)
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                fit(dtype)
            ev = prof.key_averages()
            for key in ("self_cpu_time_total",) + (("self_device_time_total",) if cuda else ()):
                top = sorted(ev, key=lambda e: getattr(e, key, 0), reverse=True)[:12]
                print(json.dumps({
                    **line, "dtype": name, "profile": key,
                    "total_ms": sum(getattr(e, key, 0) for e in ev) / 1e3,
                    "top": [(e.key[:60], e.count, round(getattr(e, key, 0) / 1e3, 3)) for e in top],
                }), flush=True)
    if args.sequential:
        m = model(torch.float64)
        cands = [m._candidate(0, "kmeans")] + [m._candidate(100 + i) for i in range(args.sequential - 1)]
        _T0, z, xx, v, pat, pid = m._packed()
        data = (z, xx, v, pat, torch.as_tensor(pid, device=v.device))
        kw = dict(n_steps=100, reg_mode="ridge", alpha=1.0)
        for _round in range(2):  # the first warms the card's libraries
            sync()
            t0 = time.perf_counter()
            its = [em.train_em(c._stacked_params(), m._on_device(c.cluster_assignment, torch.int32), *data, **kw)[2]
                   for c in cands]
            sync()
        print(json.dumps({**line, "dtype": "float64", "sequential": args.sequential,
                          "seconds": time.perf_counter() - t0, "iterations": int(sum(its))}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", help="a checkout to import the port from (repeatable)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--dtype", action="append", choices=("float64", "float32"),
                    help="a fit in this type (repeatable; float64 by default)")
    ap.add_argument("--threads", type=int, default=1, help="torch threads of each process")
    ap.add_argument("--n-starts", type=int, default=1000)
    ap.add_argument("--sequential", type=int, default=0, metavar="N")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.dtype = args.dtype or ["float64"]
    if args.worker:
        worker(args)
        return

    sys.path.insert(0, str(HERE))
    import numpy as np

    from multimodal_trajectory_modeling_tpu_torch.utils import adni, state_space

    z, x, _d, _ids, _time = adni.get_trajectories()
    roots = [str(Path(r).resolve()) for r in (args.root or [str(HERE)])]
    passed = ["--device", args.device, "--threads", str(args.threads), "--n-starts", str(args.n_starts),
              "--sequential", str(args.sequential), *(f"--dtype={t}" for t in args.dtype)]
    passed += ["--profile"] if args.profile else []
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "adni.npz")
        np.savez(data, zs=state_space.standardize(z), x=x)
        for _ in range(args.rounds):
            for root in roots:
                subprocess.run([sys.executable, __file__, "--worker", root, "--data", data, *passed],
                               check=True, cwd=tmp)


if __name__ == "__main__":
    main()

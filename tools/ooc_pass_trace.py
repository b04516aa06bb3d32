"""Follow the in-core and the int16 out-of-core Markov fits pass by pass on
the card, from the start of ``chip_smoke.py`` phase 7's winner (phase 4's
batch, n=1e6; the candidate of seed 138, phase 25's start): each pass's
switches and smallest cluster, the out-of-core fit in one chunk (the
in-core scales: every pass's counts must equal the in-core fit's) and in
chunks of 262 144 (each chunk its own int16 scales), with both fits' final
cluster sizes.

Usage (from the repository root, on a machine with one CUDA card)::

    python3 tools/ooc_pass_trace.py
"""
import os, sys, time
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs


def main():
    from multimodal_trajectory_modeling_tpu_torch.models import em, MMLinGaussSS_marginalizable
    from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk
    from multimodal_trajectory_modeling_tpu_torch.ops import _build
    _build.library()
    z, x, _l = cs.bench_batch(cs.N, seed=0)
    np.random.seed(0)
    m = MMLinGaussSS_marginalizable(cs.C, z, x, device="cuda")
    cand = m._candidate(138)
    p0 = cand._params_numpy()
    a0 = cand.cluster_assignment.astype(np.int32)
    lens = m._suffix_instance_lens(m.states, m.observations)
    z32, x32 = m.states.astype(np.float32), m.observations.astype(np.float32)
    log = []
    real = mk.markov_em_from_features

    def rec(*a, **k):
        out = real(*a, **k)
        log.append((k.get("assign_mode"), int(out[2]), out[1].cpu().numpy().copy(), a[0].q.shape[1] if isinstance(a[0], mk.PhiQuant) else a[0].shape[1]))
        return out

    mk.markov_em_from_features = rec
    dev = torch.device("cuda")
    zd, xd = torch.tensor(z32, device=dev), torch.tensor(x32, device=dev)
    p, a_in, it, st = em.train_em_markov(em.mixture_params_from_numpy(p0, device="cuda"), torch.tensor(a0, device=dev),
                                         zd, xd, torch.tensor(lens, device=dev), n_steps=100)
    a_in = a_in.cpu().numpy()
    print("incore", it, st, np.bincount(a_in, minlength=17).tolist())
    inc = [(md, sw, c.tolist()) for md, sw, c, w in log]
    del zd, xd
    for chunk in (cs.N, 262144):
        log.clear()
        p2, a2, it2, st2 = em.train_em_markov_outofcore(em.mixture_params_from_numpy(p0, device="cuda"), a0, z32, x32,
                                                        lens, n_steps=100, chunk_cols=chunk)
        a2 = a2.numpy()
        print("ooc", chunk, it2, st2, "diffs", int((a2 != a_in).sum()), np.bincount(a2, minlength=17).tolist())
        nchunk = -(-cs.N // chunk)
        for j in range(0, len(log), nchunk):
            grp = log[j:j + nchunk]
            sw = sum(g[1] for g in grp)
            cnt = np.sum([g[2] for g in grp], axis=0)
            i = j // nchunk
            ref = inc[i] if i < len(inc) else None
            print(f"  pass {i} mode={grp[0][0]} sw={sw} min={cnt.min()} widths={[g[3] for g in grp]}"
                  f" | incore sw={ref[1] if ref else None} min={min(ref[2]) if ref else None} same_counts={ref is not None and ref[2] == cnt.tolist()}")


if __name__ == "__main__":
    main()

"""The ranks of ``test_torch_parallel.py``: run in spawned processes, so
this module imports torch and the port only (no JAX: a rank then starts
in seconds)."""

import contextlib
import os
import queue
import traceback

import numpy as np
import torch

C = 3
_TIMEOUT_S = 300


def _np(out):
    """Results as numpy: params fields, tensors, ints."""
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return tuple(t.cpu().numpy() for t in out)
    if isinstance(out, (tuple, list)):
        return [_np(o) for o in out]
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return out


def _rank_work(prob, world):
    """Every trainer once on this rank: ``{name: numpy results}``."""
    from multimodal_trajectory_modeling_tpu_torch.models import em
    from multimodal_trajectory_modeling_tpu_torch.models import (
        MMLinGaussSS_marginalizable as TorchMixture,
    )
    from multimodal_trajectory_modeling_tpu_torch.parallel import mesh as mesh_lib
    from multimodal_trajectory_modeling_tpu_torch.parallel import sharded_em as sh

    t = {k: torch.from_numpy(v) for k, v in prob.items() if isinstance(v, np.ndarray)}
    params0 = em.mixture_params_from_numpy(prob["params0"], device="cpu")
    dense = (params0, t["assign0"], t["z"], t["x"], t["v"], t["patterns"], t["pid"])
    out = {}
    if world == 4:
        mesh2d = mesh_lib.make_mesh(axis_names=("restart", "data"), shape=(2, 2))
        out["multistart_2d"] = _np(sh.train_em_multistart_2d(
            params0, t["assigns"][:2], *dense[2:], mesh=mesh2d, n_steps=100))
        return out
    mesh = mesh_lib.make_mesh()
    out["shardmap"] = _np(sh.train_em_shardmap(*dense, mesh=mesh, n_steps=100))
    out["data_parallel"] = _np(sh.train_em_data_parallel(*dense, mesh=mesh, n_steps=100))
    restarts = em.stack_params([em.mixture_params_from_numpy(p, device="cpu") for p in prob["restarts"]])
    start_mesh = mesh_lib.make_mesh(axis_names=("start",))
    out["multistart_sharded"] = _np(sh.train_em_multistart_sharded(
        restarts, t["assigns"][:4], *dense[2:], mesh=start_mesh, n_steps=30))
    markov = (params0, t["assign0"], t["z"], t["x"], t["lens"])
    out["markov"] = _np(sh.train_em_markov_shardmap(*markov, mesh=mesh, n_steps=50))
    os.environ["MTM_MARKOV_PRECOMP"] = "0"
    out["markov_k4a"] = _np(sh.train_em_markov_shardmap(*markov, mesh=mesh, n_steps=50))
    out["multi_k4b"] = _np(sh.train_em_markov_multi_shardmap(
        em.MixtureParams(*(a[:3] for a in restarts)), t["assigns"][:3], t["z"], t["x"], t["lens"], mesh=mesh, n_steps=30))
    del os.environ["MTM_MARKOV_PRECOMP"]
    os.environ["MTM_MARKOV_PHI"] = "i16"
    out["markov_i16"] = _np(sh.train_em_markov_shardmap(*markov, mesh=mesh, n_steps=50))
    blk3, blk1 = sh._local(mesh)
    _u, pq = sh._local_markov_route(blk3(t["z"]), blk3(t["x"]), blk1(t["lens"]), mesh=mesh,
                                     precompute=True, phi_store="i16")
    out["i16_block"] = (pq.q.numpy(), pq.scale.numpy())
    del os.environ["MTM_MARKOV_PHI"]
    out["markov_longT"] = _np(sh.train_em_markov_shardmap(
        em.mixture_params_from_numpy(prob["params_l"], device="cpu"), t["assign_l"], t["zl"], t["xl"],
        t["lensl"], mesh=mesh, n_steps=12))
    out["masked"] = _np(sh.train_em_masked_kalman_shardmap(
        params0, t["assign0"], t["zg"], t["xg"], mesh=mesh, n_steps=100))
    out["multi"] = _np(sh.train_em_markov_multi_shardmap(
        em.MixtureParams(*(a[:3] for a in restarts)), t["assigns"][:3], t["z"], t["x"], t["lens"], mesh=mesh, n_steps=30))
    n_pool = 799  # pad lanes on the second rank
    results, _stats = em.train_em_markov_pool(
        [em.mixture_params_from_numpy(p, device="cpu") for p in prob["restarts"] + [prob["params0"]]],
        list(prob["assigns"][:, :n_pool]), t["z"][:, :n_pool], t["x"][:, :n_pool], t["lens"][:n_pool],
        R=2, n_steps=20, sync_every=3, mesh=mesh,
    )
    out["pool"] = _np(results)
    os.environ["MTM_MULTICHIP"] = "1"
    for key, (z, x) in {"mixture_pool": ("z", "x"), "mixture_masked": ("zg", "xg")}.items():
        np.random.seed(0)
        model = TorchMixture(n_clusters=C, states=prob[z], observations=prob[x], device="cpu")
        best, objs = model.train_with_multiple_random_starts(
            n_starts=3, n_steps=30, fast=True, use_cache=False, return_objectives=True
        )
        out[key] = (best.cluster_assignment, np.asarray(best.transition_matrices), np.asarray(objs))
    del os.environ["MTM_MULTICHIP"]
    return out


def _rank_main(rank, world, store_path, prob, out_q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            out_q.put((rank, _rank_work(prob, world)))
        finally:
            dist.destroy_process_group()
    except Exception:
        out_q.put((rank, traceback.format_exc()))


def _start_group(world, store_path, prob, ctx, out_q):
    procs = [ctx.Process(target=_rank_main, args=(r, world, store_path, prob, out_q)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _collect(procs, out_q, n):
    got = {}
    try:
        for _ in range(n):
            rank_world, res = out_q.get(timeout=_TIMEOUT_S)
            got[rank_world] = res
    except queue.Empty:
        pass
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join()
    return got


@contextlib.contextmanager
def one_rank_group(store_dir):
    """A gloo group of this process alone (a ``FileStore`` in
    ``store_dir``), destroyed on exit: a one-rank mesh for tests that run
    in the test process."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(store_dir, "store"), 1), rank=0, world_size=1
    )
    try:
        yield
    finally:
        dist.destroy_process_group()

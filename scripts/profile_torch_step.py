#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one CUDA GPU.

    python3 scripts/profile_torch_step.py [--views 2] [--steps 3]
        [--optimizer sgd|adam|uadam] [--precond none|sobolev|h1]

Same configuration as chip_smoke.py's train phase (synthetic capture of
dog_mid90k at 1280x960, steps from dog_mid45k, HyperParams() weights,
float32; reference-parity sgd + none unless another optimizer or
preconditioner is named), with fewer capture views. Each oracle
query is timed on the host clock between two synchronizations and split
into its stages (prepare_inputs: shift, coefficients, AABBs and the
candidate prepass, whose one kernel launch, scores, sort and counts, is
also timed apart) and the closest-hit kernel; the rest of the step
is the differentiable trace, the losses, backward and the update. The
synchronizations cost a little overlap; the step is also timed without
them, and one conjugate-gradient solve of the Sobolev preconditioner
(64 trips on the mesh's neighbor table) is timed on its own. Finally
torch.profiler lists the device kernels by total time.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "adam", "uadam"])
    ap.add_argument("--precond", default="none",
                    choices=["none", "sobolev", "h1"])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a CUDA GPU")
    from drt_tpu_torch.config import HyperParams
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.api import Hits, get_intersect_fn
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import (LossWeights,
                                        default_silhouette_budget,
                                        make_train_step)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    hp = HyperParams()
    res = (960, 1280)
    mdir = os.path.join(HERE, "reports", "tuning_meshes")
    v90, f90 = load_ply(os.path.join(mdir, "dog_mid90k.ply"))
    cap = synthesize_capture(v90, f90, num_views=args.views, resy=res[0],
                             resx=res[1], ior=hp.ior, ext_ior=hp.ext_ior,
                             device=dev)
    v45, f45 = load_ply(os.path.join(mdir, "dog_mid45k.ply"))
    ms = build_mesh_state(v45, f45, device=dev)
    weights = LossWeights(ray_w=hp.ray_w, vh_w=hp.vh_w, sm_w=hp.sm_w,
                          ior=hp.ior, ext_ior=hp.ext_ior)
    budget = default_silhouette_budget(ms.num_edges)
    silh = [i % args.views for i in range(8)]
    step_kw = dict(optimizer=args.optimizer, precond=args.precond,
                   precond_lambda=hp.precond_lambda, cg_iters=hp.cg_iters)
    lr = hp.start_lr if args.optimizer == "sgd" else 0.01
    print(f"optimizer {args.optimizer}, precond {args.precond}, lr {lr}")

    acc = defaultdict(float)
    kind_now = [""]

    def synced(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[f"{kind_now[0]} {name} ms"] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    prepass_fn = CK.candidates

    def timed_oracle(origins, dirs, vertices, faces, face_valid=None, *,
                     coherent):
        kind = ("silhouette" if origins.shape[0] != res[0] * res[1]
                else "coherent" if coherent else "incoherent")
        kind_now[0] = kind
        CK.candidates = synced("prepare: prepass kernel", prepass_fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            inp = CK.prepare_inputs(origins.detach(), dirs.detach(),
                                    vertices.detach(), faces, face_valid,
                                    coherent=coherent)
        finally:
            CK.candidates = prepass_fn
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        t, ids = CK.closest_hit(inp)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        acc[f"{kind} prepare ms"] += (t1 - t0) * 1e3
        acc[f"{kind} kernel ms"] += (t2 - t1) * 1e3
        n = origins.shape[0]
        return Hits(t[:n], ids[:n])

    def run(fn, steps):
        init, step, _ = make_train_step(fn, weights, *res, budget,
                                        **step_kw)
        state = init(ms)
        times = []
        for it in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss, _ = step(state, lr, ms, cap.views,
                                  it % args.views, silh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    plain = run(get_intersect_fn("auto"), args.steps)
    acc.clear()
    split = run(timed_oracle, args.steps)
    n = args.steps
    print(f"step ms (no syncs): {statistics.median(plain[1:]):.1f}, "
          f"all {['%.1f' % t for t in plain]}")
    print(f"step ms (synced per query): {statistics.median(split[1:]):.1f}")
    oracle = 0.0
    for k in sorted(acc):
        print(f"  {k} per step: {acc[k] / n:.2f}")
        if "prepare:" not in k:
            oracle += acc[k] / n
    print(f"  oracle total per step: {oracle:.1f}; rest of the step: "
          f"{statistics.mean(split) - oracle:.1f}")

    from drt_tpu_torch.optimize.precondition import sobolev_solve
    rhs = torch.randn_like(ms.vertices)

    def solve():
        return sobolev_solve(rhs, ms.neighbors, ms.neighbor_valid,
                             hp.precond_lambda, maxiter=hp.cg_iters)
    solve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        solve()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        solve()
    end.record()
    torch.cuda.synchronize()
    print(f"one Sobolev CG solve ({hp.cg_iters} trips, "
          f"{ms.vertices.shape[0]} padded vertices): {host_ms:.2f} ms host "
          f"clock, {start.elapsed_time(end) / 5:.2f} ms CUDA events")

    from torch.profiler import ProfilerActivity, profile
    init, step, _ = make_train_step(get_intersect_fn("auto"), weights, *res,
                                    budget, **step_kw)
    state = init(ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _, _ = step(state, lr, ms, cap.views, 0, silh)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=20, max_name_column_width=60))


if __name__ == "__main__":
    main()

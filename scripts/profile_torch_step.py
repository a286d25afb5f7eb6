#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one CUDA GPU.

    python3 scripts/profile_torch_step.py [--views 2] [--steps 3]
        [--optimizer sgd|adam|uadam] [--precond none|sobolev|h1]
        [--record reports/torch_step_ab.json]

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
(64 trips at most on the mesh's neighbor table) is timed on its own: the
kernel (csrc/cg.cu, one launch, as the step runs it) and its plain
version (`cg_plain`, the torch loop) side by side, by CUDA events and on
the host clock, with the kernel's device operations (torch.profiler);
`--record PATH` writes those numbers into PATH under "profile_cg"
(scripts/ab_torch_step.py writes its runs beside them). Then
torch.profiler lists the device kernels by total time. Last, a joint host
and device trace (torch.profiler, CPU and CUDA activities) of one eager
step and of one replay of the step's CUDA graph (`GraphedTrainStep`, as
`optimize` runs it on the card; its eager warm-up step and the capture
before it): each is written as a Chrome trace into `--trace-dir`, and for
each the host time of the step, the device busy time and device span,
the device's idle share of the host time, the device operations, and for
the eager step the host time inside the oracle queries, `total_loss` (the
forward, queries included) and `torch.autograd.grad` (the backward), the
rest being the normals, the update and Python.
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
    ap.add_argument("--trace-dir", default=os.path.join(
        HERE, "build", "torch_step_traces"))
    ap.add_argument("--record", help="JSON file for the CG line's numbers")
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

    from torch.profiler import ProfilerActivity, profile
    from drt_tpu_torch.optimize.precondition import cg_cuda, cg_plain
    rhs = torch.randn_like(ms.vertices)
    cg_line = {"device": smi.stdout.strip(),
               "script": "scripts/profile_torch_step.py",
               "shape": list(rhs.shape),
               "neighbours": ms.neighbors.shape[1],
               "maxiter": hp.cg_iters, "tol": 1e-6}
    for name, fn, reps in (("kernel", cg_cuda, 20), ("plain", cg_plain, 3)):
        def solve():
            return fn(rhs, ms.neighbors, ms.neighbor_valid,
                      hp.precond_lambda, tol=1e-6, maxiter=hp.cg_iters)
        _, trips = solve()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            solve()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            solve()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve()
            torch.cuda.synchronize()
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
        cg_line[name] = {"trips": int(trips), "host_ms": host_ms,
                         "cuda_ms": start.elapsed_time(end) / reps,
                         "device_ops": len(ops),
                         "device_busy_ms": sum(e.time_range.end
                                               - e.time_range.start
                                               for e in ops) / 1e3}
    k, p = cg_line["kernel"], cg_line["plain"]
    print(f"one Sobolev CG solve ({k['trips']} trips, "
          f"{ms.vertices.shape[0]} padded vertices): kernel "
          f"{k['cuda_ms']:.3f} ms CUDA events, {k['host_ms']:.3f} ms host "
          f"clock, {k['device_ops']} device operation(s); plain version "
          f"{p['cuda_ms']:.2f} ms CUDA events, {p['host_ms']:.2f} ms host "
          f"clock, {p['device_ops']} device operations "
          f"({p['device_busy_ms']:.2f} ms busy)")
    if args.record:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from ab_torch_step import record
        record(args.record, "profile_cg",
               f"{args.optimizer} + {args.precond}", cg_line)

    init, step, _ = make_train_step(get_intersect_fn("auto"), weights, *res,
                                    budget, **step_kw)
    state = init(ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _, _ = step(state, lr, ms, cap.views, 0, silh)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=20, max_name_column_width=60))
    joint_trace(args, step_kw, lr, weights, res, budget, ms, cap, silh)


def joint_trace(args, step_kw, lr, weights, res, budget, ms, cap, silh):
    """One eager step and one replay under torch.profiler (CPU and CUDA),
    each written as a Chrome trace and summed up."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    import drt_tpu_torch.optimize.loop as loop
    from drt_tpu_torch.intersect.api import get_intersect_fn
    base = get_intersect_fn("auto")

    def oracle(*a, **k):
        with record_function("oracle query"):
            return base(*a, **k)
    real_loss, real_grad = loop.total_loss, torch.autograd.grad

    def forward(*a, **k):
        with record_function("total_loss"):
            return real_loss(*a, **k)

    def backward(*a, **k):
        with record_function("autograd.grad"):
            return real_grad(*a, **k)
    init, step, _ = loop.make_train_step(oracle, weights, *res, budget,
                                         **step_kw)
    dev = ms.vertices.device
    ray = [[i % args.views] for i in range(3)]
    run = loop.GraphedTrainStep(step, init(ms), lr, ms, cap.views,
                                torch.tensor(ray, device=dev),
                                torch.tensor([silh] * 3, device=dev))
    for _ in range(2):                      # the warm-up, the capture
        run()
    torch.cuda.synchronize()
    os.makedirs(args.trace_dir, exist_ok=True)
    cpu_t, dev_t = (torch.autograd.DeviceType.CPU,
                    torch.autograd.DeviceType.CUDA)
    state = init(ms)
    for kind in ("eager", "replay"):
        loop.total_loss, torch.autograd.grad = forward, backward
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(f"{kind} step"):
                    if kind == "eager":
                        step(state, lr, ms, cap.views, 0, silh)
                    else:
                        run()
                    torch.cuda.synchronize()
        finally:
            loop.total_loss, torch.autograd.grad = real_loss, real_grad
        path = os.path.join(args.trace_dir, f"torch_step_{kind}.json")
        prof.export_chrome_trace(path)
        events = prof.events()

        def host_ms(name):
            return sum(e.time_range.end - e.time_range.start for e in events
                       if e.name == name and e.device_type == cpu_t) / 1e3
        ops = [e for e in events if e.device_type == dev_t
               and not e.is_user_annotation]
        busy = sum(e.time_range.end - e.time_range.start for e in ops) / 1e3
        span = ((max(e.time_range.end for e in ops)
                 - min(e.time_range.start for e in ops)) / 1e3 if ops
                else 0.0)
        wall = host_ms(f"{kind} step")
        print(f"joint trace, {kind} step ({path}): host {wall:.2f} ms, "
              f"device busy {busy:.3f} ms in {len(ops)} device operations "
              f"over a span of {span:.3f} ms, device idle "
              f"{1 - busy / wall:.1%} of the host time"
              + (f"; host ms in the oracle queries "
                 f"{host_ms('oracle query'):.2f}, in total_loss "
                 f"{host_ms('total_loss'):.2f}, in autograd.grad "
                 f"{host_ms('autograd.grad'):.2f}" if kind == "eager"
                 else ""))
    run.close()


if __name__ == "__main__":
    main()

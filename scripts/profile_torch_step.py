#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one CUDA GPU.

    python3 scripts/profile_torch_step.py [--views 2] [--steps 3]
        [--optimizer sgd|adam|uadam] [--precond none|sobolev|h1]
        [--record reports/torch_step_ab.json]
        [--ranges reports/torch_step_ranges.json --label this]
        [--only-ranges]

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

Then the step's device time by range (`range_breakdown`), for an eager step
and for a replay of its CUDA graph, read from the program's own device
spans (drt_tpu_torch/spans.py, reduced by port_bench/spans.py; a profiler
that records switches them on in both): each operation under the
innermost span open at its start, a chain's backward segment as
"<chain> (backward)", the oracle's kernels as "oracle: <span>", the
markers apart. For the eager step also the share of the backward's device
time that the spans put in the same chain as the profiler's sequence
numbers do (`backward_agreement`), and the span, torch operation and
input shapes of each GEMM kernel (`launchers`). `--ranges PATH` writes
both tables into PATH under "runs", keyed by `--label` and the optimizer
pair; `--only-ranges` skips everything else.
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
    ap.add_argument("--ranges", help="JSON file for the table by range")
    ap.add_argument("--label", default="this",
                    help="the tree's name in --ranges (this, parent)")
    ap.add_argument("--only-ranges", action="store_true",
                    help="measure the table by range alone")
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
    if args.only_ranges:
        range_breakdown(args, step_kw, lr, weights, res, budget, ms, cap,
                        silh, smi.stdout.strip())
        return

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
    range_breakdown(args, step_kw, lr, weights, res, budget, ms, cap, silh,
                    smi.stdout.strip())


def device_rows(prof):
    """The profile's device operations in start order, as (name, start us,
    end us, correlation id), from kineto's own events (user annotations
    left out)."""
    import torch
    dev_t = torch.autograd.DeviceType.CUDA
    rows = sorted((k.start_ns() / 1e3, k.name(),
                   (k.start_ns() + k.duration_ns()) / 1e3,
                   k.correlation_id())
                  for k in prof.profiler.kineto_results.events()
                  if k.device_type() == dev_t and not k.is_user_annotation())
    return [(name, s, e, corr) for s, name, e, corr in rows]


CHAINS = ("normals", "ray", "silhouette", "smooth")


def span_label(open_spans, name):
    """A device operation's range from the spans open at its start: the
    innermost, " (backward)" added to a chain's backward segment,
    "oracle: " before the oracle's kernels."""
    from port_bench.spans import ORACLE
    from port_bench.tracing import kernel_of
    if not open_spans:
        return "outside the spans"
    label = open_spans[-1]
    if label in CHAINS and "backward" in open_spans:
        label += " (backward)"
    return ("oracle: " + label if kernel_of(name) in ORACLE else label)


def label_ops(prof):
    """(range, name, us) of each device operation of a profile, by the
    program's span markers (port_bench/spans.py); the markers themselves
    under "markers"."""
    from port_bench import spans as PS
    rows = device_rows(prof)
    ops, _ = PS.walk([(n, s, e) for n, s, e, _ in rows])
    out = [(span_label(open_, name), name, e - s) for open_, name, s, e in ops]
    out += [("markers", n, e - s) for n, s, e, _ in rows
            if PS.marker(n) is not None]
    return out


def backward_agreement(prof):
    """Of the device time inside `backward`, the share that the spans put
    in the same chain (or in none) as the profiler's sequence numbers do:
    a backward operation belongs to the chain whose forward span (on the
    host, between its markers' launches) held the forward operation that
    made its autograd node. By host time: the kernels' own launches
    (ctypes) run inside no torch operation. An operation that the engine
    launches between nodes (the sums into a node's input buffer) belongs
    to the node that ran last before it; cuBLAS launches through the
    driver API ("cu..." calls)."""
    import bisect
    import torch
    from port_bench import spans as PS
    from port_bench.tracing import kernel_of
    dev_t = torch.autograd.DeviceType.CUDA
    host = [k for k in prof.profiler.kineto_results.events()
            if k.device_type() != dev_t]
    launch_at = {k.correlation_id(): k.start_ns() for k in host
                 if k.name().startswith("cu")}
    rows = device_rows(prof)
    # the forward chains' and the backward's spans on the host, from their
    # markers' launches
    stack, fwd, bwd = [], [], []
    for name, _, _, corr in rows:
        kind = PS.marker(name)
        if kind is None or corr not in launch_at:
            continue
        if kind != PS.END:
            stack.append((kind, launch_at[corr]))
        elif stack:
            kind, t0 = stack.pop()
            if kind == "backward":
                bwd.append((t0, launch_at[corr]))
            elif kind in CHAINS and all(n != "backward" for n, _ in stack):
                fwd.append((t0, launch_at[corr], kind))
    fwd.sort()
    nodes = sorted((k.start_ns(), k.end_ns(), k.sequence_nr(), k.name())
                   for k in host if k.scope() == 1 and k.sequence_nr() >= 0)
    starts = ([f[0] for f in fwd], [n[0] for n in nodes])

    def innermost(spans, first, t):
        for span in reversed(spans[:bisect.bisect_right(first, t)]):
            if span[1] >= t:
                return span
        return None

    def node_of(t):
        """The autograd node running at host time t, else the last one
        that ended before it."""
        before = nodes[:bisect.bisect_right(starts[1], t)]
        for node in reversed(before):
            if node[1] >= t:
                return node
        return max(before, key=lambda n: n[1], default=None)
    # An operation records the sequence number the next autograd node will
    # take; the one that makes the node records it last, so the latest
    # forward operation of a number names the node's chain.
    seq_chain = {}
    for k in sorted(host, key=lambda k: k.start_ns()):
        t = k.start_ns()
        if (k.sequence_nr() >= 0 and k.scope() != 1
                and not any(a <= t <= b for a, b in bwd)):
            span = innermost(fwd, starts[0], t)
            seq_chain[k.sequence_nr()] = span[2] if span else None
    ops, _ = PS.walk([(n, s, e) for n, s, e, _ in rows])
    corr_of = {(n, s): c for n, s, _, c in rows}
    agree = total = 0.0
    apart = {}
    for open_, name, s, e in ops:
        if "backward" not in open_:
            continue
        t = launch_at.get(corr_of[(name, s)])
        node = None if t is None else node_of(t)
        by_seq = None if node is None else seq_chain.get(node[2], "unknown")
        by_span = open_[-1] if open_[-1] in CHAINS else None
        total += e - s
        if by_seq == by_span:
            agree += e - s
        else:
            key = (f"span {by_span}, sequence {by_seq}: {kernel_of(name)} "
                   f"in {node[3] if node else 'no node'}"
                   + ("" if t is not None else " (launch not seen)"))
            apart[key] = apart.get(key, 0.0) + (e - s) / 1e3
    return {"backward_device_ms": total / 1e3,
            "agreement": agree / total if total else None,
            "apart_ms": dict(sorted(apart.items(),
                                    key=lambda kv: -kv[1])[:12])}


def launchers(prof, patterns=("gemm", "Kernel2")):
    """Device ms and calls of the kernels whose names hold one of
    `patterns`, by the span each ran in and the torch operation that
    launched it with its input shapes (the profile records shapes)."""
    import torch
    from port_bench import spans as PS
    from port_bench.tracing import kernel_of
    dev_t = torch.autograd.DeviceType.CUDA
    ops, _ = PS.walk([(n, s, e) for n, s, e, _ in device_rows(prof)])
    label = {(name, s): span_label(open_, name) for open_, name, s, e in ops}
    frontend = {fe.id: fe for fe in prof.events()
                if fe.device_type != dev_t}
    out = {}
    for k in prof.profiler.kineto_results.events():
        if (k.device_type() != dev_t or k.is_user_annotation()
                or not any(p in k.name() for p in patterns)):
            continue
        fe = frontend.get(k.linked_correlation_id())
        op = "?" if fe is None else f"{fe.name} {fe.input_shapes}"
        where = label.get((k.name(), k.start_ns() / 1e3), "?")
        key = f"{kernel_of(k.name())[:40]} | {where} | {op}"
        row = out.setdefault(key, {"ms": 0.0, "calls": 0})
        row["ms"] += k.duration_ns() / 1e6
        row["calls"] += 1
    return out


def table(labelled):
    """{range: {"device_ms", "device_ops", "top"}} from (range, name, us)
    rows; "top" the range's 3 longest kernels by name (ms)."""
    t, by_name = {}, {}
    for label, name, us in labelled:
        row = t.setdefault(label, {"device_ms": 0.0, "device_ops": 0})
        row["device_ms"] += us / 1e3
        row["device_ops"] += 1
        names = by_name.setdefault(label, {})
        names[name] = names.get(name, 0.0) + us / 1e3
    for label, row in t.items():
        row["top"] = dict(sorted(by_name[label].items(),
                                 key=lambda kv: -kv[1])[:3])
    return dict(sorted(t.items(), key=lambda kv: -kv[1]["device_ms"]))


def range_breakdown(args, step_kw, lr, weights, res, budget, ms, cap, silh,
                    device):
    """The step's device time and operations by span, eager and replayed
    (see the module docstring), printed and written to --ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import drt_tpu_torch.optimize.loop as loop
    from drt_tpu_torch.intersect.api import get_intersect_fn
    dev = ms.vertices.device
    ray = [[i % args.views] for i in range(3)]
    init, step, _ = loop.make_train_step(get_intersect_fn("auto"), weights,
                                         *res, budget, **step_kw)
    state = init(ms)
    step(state, lr, ms, cap.views, 0, silh)              # warm-up
    run = loop.GraphedTrainStep(step, init(ms), lr, ms, cap.views,
                                torch.tensor(ray, device=dev),
                                torch.tensor([silh] * 3, device=dev))
    for _ in range(2):                      # the warm-up, the capture
        run()
    torch.cuda.synchronize()
    profiles = {}
    for kind in ("eager", "replay"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=kind == "eager") as prof:
            if kind == "eager":
                step(state, lr, ms, cap.views, 0, silh)
            else:
                run()
            torch.cuda.synchronize()
        profiles[kind] = prof
    run.close()
    out = {"device": device, "script": "scripts/profile_torch_step.py",
           "tree": args.label}
    for kind, prof in profiles.items():
        labelled = label_ops(prof)
        out[kind] = table(labelled)
        out[kind + "_device_ops"] = len(labelled)
        out[kind + "_device_busy_ms"] = sum(us for *_, us in labelled) / 1e3
    out["backward"] = backward_agreement(profiles["eager"])
    out["launchers"] = launchers(profiles["eager"])
    for kind in ("eager", "replay"):
        print(f"by span, {kind} step ({out[kind + '_device_ops']} device "
              f"operations, {out[kind + '_device_busy_ms']:.3f} ms busy):")
        for name, row in out[kind].items():
            print(f"  {name:40s} {row['device_ms']:8.3f} ms "
                  f"{row['device_ops']:5d} ops")
    print(f"backward: {out['backward']}")
    for key, row in out["launchers"].items():
        print(f"launcher: {key}: {row}")
    if args.ranges:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from ab_torch_step import record
        record(args.ranges, "runs",
               f"{args.label}: {args.optimizer} + {args.precond}", out)


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

#!/usr/bin/env python3
"""The port's train step on one CUDA GPU as `optimize` runs it, this tree
against another (a parent commit unpacked with `git archive`), in turns.

    python3 scripts/ab_torch_step.py --parent DIR [--steps 5] [--out PATH]
        [--optimizer sgd|adam|uadam] [--precond none|sobolev|h1]

Each turn is a process of its own that imports `drt_tpu_torch` from one
tree only (the trees share the package's name) and builds that tree's
kernels into the tree's own build/: parent, this, this, parent. A turn
synthesizes the capture of chip_smoke.py's phase 5 (8 views of dog_mid90k
at 1280x960, Pointgray) and runs steps of `--optimizer` and `--precond`
(reference-parity sgd + none by default; lr HyperParams().start_lr for
sgd, 0.01 otherwise, as chip_smoke.py) from dog_mid45k (HyperParams()
weights, float32, 1 ray view and 8 silhouette views) the
way that tree's `optimize` runs them: a tree with
`optimize.loop.GraphedTrainStep` replays one captured CUDA graph (its
eager warm-up step and the capture first, untimed: the seconds of each are
printed), an older tree calls the eager step (one warm-up step). Then
`--steps` steps on the host clock between synchronizations (a graphed
tree times as many of its eager steps first), and 3 more under
torch.profiler: each one's device busy time (the sum of its device
operations' durations: kernels, memsets, copies) and its device operation
count. Before them, one eager step runs under
`torch.cuda.set_sync_debug_mode("warn")` (inside the scatters' deferred
bounds scope where the tree has one): the synchronizing operations it
makes, by file:line of the Python frame that made them (a backward's are
reported at the `autograd.grad` call). Prints one JSON line a turn and a
summary a tree (median and spread of each), with the card's name and
power limit, and writes them to `--out` (default
reports/torch_step_ab.json) under "runs" by the pair's name, beside the
runs of other pairs already there. Claims nothing.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sync_census(fn, tree):
    """{file:line: count} of the synchronizing CUDA operations `fn` makes,
    from torch's sync debug mode (a prototype: it reports copies to or from
    pageable host memory, `.item()`, `nonzero` and the like)."""
    import warnings
    import torch
    found = {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for r in rec:
        if "synchroniz" in str(r.message):
            where = f"{os.path.relpath(r.filename, tree)}:{r.lineno}"
            found[where] = found.get(where, 0) + 1
    return found


def turn(tree, steps, optimizer, precond):
    """One turn in this process: the step of `tree`'s package."""
    sys.path.insert(0, tree)
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    import drt_tpu_torch
    import drt_tpu_torch.optimize.loop as loop
    from drt_tpu_torch.config import POINTGRAY_RES as RES, HyperParams
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.geometry import scatter
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import (LossWeights,
                                        default_silhouette_budget,
                                        make_train_step)
    if os.path.dirname(os.path.dirname(os.path.abspath(
            drt_tpu_torch.__file__))) != os.path.abspath(tree):
        sys.exit(f"ab_torch_step: imported {drt_tpu_torch.__file__}, not "
                 f"the package of {tree}")
    graphed = hasattr(loop, "GraphedTrainStep")
    dev = torch.device("cuda", 0)
    meshes = os.path.join(tree, "reports", "tuning_meshes")
    hp = HyperParams()
    v90, f90 = load_ply(os.path.join(meshes, "dog_mid90k.ply"))
    cap = synthesize_capture(v90, f90, name="dog", num_views=8, resy=RES[0],
                             resx=RES[1], ior=hp.ior, ext_ior=hp.ext_ior,
                             num_view_used=8, device=dev)
    mesh = build_mesh_state(*load_ply(os.path.join(meshes,
                                                   "dog_mid45k.ply")),
                            device=dev)
    weights = LossWeights(ray_w=hp.ray_w, vh_w=hp.vh_w, sm_w=hp.sm_w,
                          ior=hp.ior, ext_ior=hp.ext_ior)
    init, step, _ = make_train_step(
        get_intersect_fn("auto"), weights, *RES,
        default_silhouette_budget(mesh.num_edges), momentum=hp.momentum,
        optimizer=optimizer, precond=precond,
        precond_lambda=hp.precond_lambda, cg_iters=hp.cg_iters,
        grad_clamp=hp.grad_clamp)
    lr = hp.start_lr if optimizer == "sgd" else 0.01
    state = init(mesh)
    ray_gen = cap.ray_view_generator(seed=hp.seed)
    silh_gen = cap.silh_view_generator(seed=hp.seed + 1000)

    def views():
        return next(ray_gen), [next(silh_gen) for _ in range(8)]

    def eager():
        r, s = views()
        return step(state, lr, mesh, cap.views, r, s)
    eager()                                 # builds the kernels
    word = torch.zeros(1, dtype=torch.int32, device=dev)
    scope = (scatter.deferred_bounds_check(word) if graphed
             else contextlib.nullcontext())
    with scope:
        census = sync_census(eager, tree)
    setup = {}
    eager_wall = []
    if graphed:
        for _ in range(steps):              # this tree's eager step too
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager()
            torch.cuda.synchronize()
            eager_wall.append((time.perf_counter() - t0) * 1e3)
        n = 2 + steps + 3
        drawn = [views() for _ in range(n)]
        run = loop.GraphedTrainStep(
            step, state, lr, mesh, cap.views,
            torch.tensor([[r] for r, _ in drawn], device=dev),
            torch.tensor([s for _, s in drawn], device=dev))
        for _ in range(2):                  # the warm-up, the capture
            run()
        torch.cuda.synchronize()
        setup = dict(run.setup)

        def one():
            return run()
    else:
        def one():
            return eager()
        one()
    torch.cuda.synchronize()
    wall = []
    for _ in range(steps):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    busy, ops = [], []
    dev_t = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == dev_t
                  and not e.is_user_annotation]
        busy.append(sum(e.time_range.end - e.time_range.start
                        for e in device) / 1e3)
        ops.append(len(device))
    if graphed:
        run.close()
        if int(run.bounds_word):
            sys.exit("ab_torch_step: a scatter index was out of bounds")
    print(json.dumps({"tree": tree, "graphed": graphed, "step_ms": wall,
                      "device_busy_ms": busy, "device_ops": ops,
                      "eager_step_ms": eager_wall, "graph_setup": setup,
                      "syncs": census, "n_syncs": sum(census.values())}))


def spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the other tree (unpacked)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(HERE, "reports",
                                                  "torch_step_ab.json"))
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "adam", "uadam"])
    ap.add_argument("--precond", default="none",
                    choices=["none", "sobolev", "h1"])
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args.turn, args.steps, args.optimizer, args.precond)
        return
    if not args.parent:
        sys.exit("ab_torch_step: --parent DIR is needed")
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_torch_step: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    trees = {"parent": os.path.abspath(args.parent), "this": HERE}
    turns = []
    for side in ("parent", "this", "this", "parent"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", trees[side], "--steps",
                              str(args.steps), "--optimizer", args.optimizer,
                              "--precond", args.precond],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            sys.exit(f"ab_torch_step: the {side} turn failed:\n"
                     f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["side"] = side
        turns.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for side in ("parent", "this"):
        rows = [r for r in turns if r["side"] == side]
        summary[side] = {
            "step_ms_turn_medians": [statistics.median(r["step_ms"])
                                     for r in rows],
            "step_ms": spread([x for r in rows for x in r["step_ms"]]),
            "device_busy_ms": spread([x for r in rows
                                      for x in r["device_busy_ms"]]),
            "device_ops": spread([x for r in rows for x in r["device_ops"]]),
            "graphed": rows[0]["graphed"], "syncs": rows[0]["syncs"]}
        eager = [x for r in rows for x in r.get("eager_step_ms", [])]
        if eager:
            summary[side]["eager_step_ms"] = spread(eager)
        print(f"{side}: {json.dumps(summary[side])}", flush=True)
    pair = f"{args.optimizer} + {args.precond}"
    record(args.out, "runs", pair, {
        "device": smi, "script": "scripts/ab_torch_step.py",
        "turns_order": "parent, this, this, parent", "summary": summary,
        "turns": turns})
    print(f"wrote {pair} into {args.out}")


def record(path, section, key, value):
    """Write `value` at path[section][key] of the JSON file at `path`,
    keeping what else it holds (scripts/profile_torch_step.py --record
    writes there too)."""
    data = {}
    if os.path.exists(path):
        with open(path) as fh:
            data = json.load(fh)
    data.setdefault(section, {})[key] = value
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(data, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()

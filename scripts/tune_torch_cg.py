#!/usr/bin/env python3
"""Both routes of the CG kernel (drt_tpu_torch/csrc/cg.cu) at three mesh
sizes and at a size where a trip is its fixed cost alone, on one CUDA GPU,
and where a trip's time goes.

    python3 scripts/tune_torch_cg.py [--reps 20] [--out PATH]

For dog_mid{20k,45k,90k}: one float32 solve of a seeded right-hand side,
64 trips at most, tol 1e-6, lam HyperParams().precond_lambda, timed by CUDA
events over `--reps` launches on each route in turns (global, shared,
shared, global). Then the fixed cost of a trip: a ring of 1,024 vertices,
each joined to the 4 on either side (3,072 elements, fewer than the
cluster's threads, so each thread updates at most one), solved with tol 0
for 64 trips and for 0 on each route in turns, the difference over the
trips run. Every solve must give the plain version's bits and trip count.
Then the trace: the kernels built once more with -DCG_TRACE=1 (a library
of its own), CTA 0's thread 0 stamping clock64() at each phase of each
trip; on the ring and the three meshes, each route's median cycles a trip
in each phase over the trips of `--trace-reps` launches, with the SM clock
nvidia-smi reads beside them. Prints ptxas's registers and spills for
the CG kernels, the times and the phases, and writes them with the card's
name and power limit to `--out` (default reports/torch_cg_sizes.json).
Claims nothing.
"""

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
RING_VP, RING_SIDE = 1024, 4
ROUTES = ("global", "shared")
TURNS = ("global", "shared", "shared", "global")
# csrc/cg.cu's trace: CG_TRACE_STRIDE slots a trip after the solve's own;
# a trip's stamps, in order (the global route takes no stamp 1: its matvec
# and p.Ap are one loop)
TRACE_STRIDE = 16
TRIP_PHASES = ("matvec", "p.Ap", "reduce A", "barrier A", "x and r",
               "reduce B", "barrier B", "p", "barrier C")
SOLVE_PHASES = ("rows or table", "start barrier", "b, x0 and r",
                "reduce", "barrier")


def ptxas_lines(log):
    """ptxas's register and spill lines for the CG kernels' entries."""
    out, entry = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        if "cg_" in entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def same(x, trips, want, want_trips):
    import torch
    iv = torch.int64 if x.dtype == torch.float64 else torch.int32
    return (torch.equal(x.view(iv), want.view(iv))
            and int(trips) == int(want_trips))


def timed(solve, want, want_trips, reps, label):
    """CUDA-event ms of solve() over reps launches, after one launch checked
    against the plain version's (x, trips)."""
    import torch
    x, trips = solve()
    torch.cuda.synchronize()
    if not same(x, trips, want, want_trips):
        sys.exit(f"tune_torch_cg: {label}: the kernel differs from the "
                 "plain version")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        solve()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(case, reps, label):
    """{route: [ms of each turn]} over TURNS, each checked first."""
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, lam, tol, maxiter = case
    want, want_trips = PC.cg_plain(b, nbr, valid, lam, tol=tol,
                                   maxiter=maxiter)
    out = {r: [] for r in ROUTES}
    for route in TURNS:
        def solve(route=route):
            return PC.cg_cuda(b, nbr, valid, lam, tol=tol, maxiter=maxiter,
                              route=route)
        out[route].append(timed(solve, want, want_trips, reps,
                                f"{label}, {route}"))
    return out, int(want_trips)


def trace(cases, reps):
    """{case: {route: {"trips": n, "cycles_a_trip": ..., "phases": {name:
    median cycles a trip}, "solve": {name: cycles}}}} from the
    -DCG_TRACE=1 library, launched through cg_cuda."""
    import ctypes
    import numpy as np
    import torch
    from drt_tpu_torch import kernels
    from drt_tpu_torch.optimize import precondition as PC
    lib = kernels.bind(kernels.build(defines=("CG_TRACE=1",)))
    lib.cg_trace_read.argtypes = [ctypes.c_void_p]
    slots = lib.cg_trace_slots()
    stamps = np.zeros(slots, dtype=np.int64)
    real = kernels.load()
    kernels._lib = lib               # cg_cuda launches the traced library
    out = {}
    try:
        for name, (b, nbr, valid, lam, tol, maxiter) in cases.items():
            out[name] = {}
            for route in ROUTES:
                runs = []
                for _ in range(reps + 1):
                    lib.cg_trace_clear()
                    _, trips = PC.cg_cuda(b, nbr, valid, lam, tol=tol,
                                          maxiter=maxiter, route=route)
                    torch.cuda.synchronize()
                    lib.cg_trace_read(stamps.ctypes.data)
                    runs.append(stamps.copy())
                runs = np.stack(runs[1:])
                n = min(int(trips), slots // TRACE_STRIDE - 1)
                trips_st = runs[:, TRACE_STRIDE:TRACE_STRIDE * (n + 1)]
                trips_st = trips_st.reshape(len(runs), n, TRACE_STRIDE)
                own = runs[:, :TRACE_STRIDE]
                phases = {}
                for i, ph in enumerate(TRIP_PHASES):
                    lo, hi = trips_st[..., i], trips_st[..., i + 1]
                    if route == "global" and i == 0:
                        continue            # no stamp 1: see "p.Ap"
                    if route == "global" and i == 1:
                        lo = trips_st[..., 0]
                    phases[ph] = float(np.median(hi - lo))
                whole = np.diff(trips_st[..., 0], axis=1) if n > 1 else None
                solve = {ph: float(np.median(own[:, i + 1] - own[:, i]))
                         for i, ph in enumerate(SOLVE_PHASES)}
                out[name][route] = {
                    "trips": int(trips), "traced_trips": n,
                    "cycles_a_trip": (float(np.median(whole))
                                      if whole is not None else None),
                    "phases": phases, "solve": solve,
                    "cycles_whole": float(np.median(own[:, 6] - own[:, 0]))}
                print(f"trace: {name}, {route} route, {int(trips)} trips: "
                      f"{out[name][route]['cycles_a_trip']} cycles a trip; "
                      + ", ".join(f"{k} {v:.0f}" for k, v in phases.items())
                      + "; before the trips: "
                      + ", ".join(f"{k} {v:.0f}" for k, v in solve.items()),
                      flush=True)
    finally:
        kernels._lib = real
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace-reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(HERE, "reports",
                                                  "torch_cg_sizes.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("tune_torch_cg: needs a CUDA GPU")
    from drt_tpu_torch import kernels
    from drt_tpu_torch.config import HyperParams
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import precondition as PC
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    kernels.build(force=True)
    report = {"device": smi, "script": "scripts/tune_torch_cg.py",
              "reps": args.reps, "turns": list(TURNS),
              "ptxas": ptxas_lines(kernels.build_log), "meshes": {}}
    for line in report["ptxas"]:
        print(line)
    hp = HyperParams()
    lam = hp.precond_lambda
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for mesh in ("dog_mid20k", "dog_mid45k", "dog_mid90k"):
        ms = build_mesh_state(*load_ply(os.path.join(
            HERE, "reports", "tuning_meshes", f"{mesh}.ply")), device=dev)
        b = torch.randn(tuple(ms.vertices.shape), device=dev, generator=gen)
        case = (b, ms.neighbors, ms.neighbor_valid, lam, 1e-6, hp.cg_iters)
        cases[mesh] = case
        times, n_trips = in_turns(case, args.reps, mesh)
        vp, d = ms.vertices.shape[0], ms.neighbors.shape[1]
        report["meshes"][mesh] = {
            "vp": vp, "neighbours": d, "trips": n_trips,
            "default_route": PC.cg_route(vp, 3, d, b.dtype),
            "route": {r: {"ms": t, "us_a_trip": [x / n_trips * 1e3
                                                 for x in t]}
                      for r, t in times.items()}}
        print(f"{mesh} (Vp {vp}, {n_trips} trips, default "
              f"{report['meshes'][mesh]['default_route']}): "
              + "; ".join(f"{r} {[round(x, 4) for x in t]} ms, "
                          f"{[round(x / n_trips * 1e3, 2) for x in t]} us "
                          "a trip" for r, t in times.items()))
    # the fixed cost of a trip: a ring too small to keep any thread busy
    ids = torch.arange(RING_VP, device=dev)
    steps = [s for s in range(-RING_SIDE, RING_SIDE + 1) if s]
    nbr = torch.stack([(ids + s) % RING_VP for s in steps], dim=1)
    valid = torch.ones_like(nbr, dtype=torch.bool)
    b = torch.randn((RING_VP, 3), device=dev, generator=gen)
    ring = {"vp": RING_VP, "neighbours": len(steps), "tol": 0.0,
            "route": {}}
    by_iters = {}
    for maxiter in (0, hp.cg_iters):
        by_iters[maxiter], ring["trips"] = in_turns(
            (b, nbr, valid, lam, 0.0, maxiter), args.reps, f"ring, {maxiter}")
    for r in ROUTES:
        ms0, ms64 = by_iters[0][r], by_iters[hp.cg_iters][r]
        ring["route"][r] = {
            "ms_0_trips": ms0, f"ms_{hp.cg_iters}_trips": ms64,
            "us_a_trip": [(t - t0) / ring["trips"] * 1e3
                          for t, t0 in zip(ms64, ms0)]}
        print(f"ring (Vp {RING_VP}, {len(steps)} neighbours, "
              f"{ring['trips']} trips), {r} route: 0 trips "
              f"{[round(t, 4) for t in ms0]} ms, "
              f"{[round(t, 2) for t in ring['route'][r]['us_a_trip']]} us "
              "a trip")
    report["fixed_trip"] = ring
    cases["ring"] = (b, nbr, valid, lam, 0.0, hp.cg_iters)
    clock = subprocess.run(["nvidia-smi",
                            "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    report["trace"] = trace(cases, args.trace_reps)
    report["trace_sm_clock"] = clock
    print(f"trace: SM clock now, max: {clock}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
        fh.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

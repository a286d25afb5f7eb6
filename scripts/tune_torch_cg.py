#!/usr/bin/env python3
"""The CG kernel (drt_tpu_torch/csrc/cg.cu) at three mesh sizes and at a
size where a trip is its fixed cost alone, on one CUDA GPU.

    python3 scripts/tune_torch_cg.py [--reps 20] [--out PATH]

For dog_mid{20k,45k,90k}: one float32 solve of a seeded right-hand side,
64 trips at most, tol 1e-6, lam HyperParams().precond_lambda, timed by CUDA
events over `--reps` launches, twice. Then the fixed cost of a trip: a ring
of 1,024 vertices, each joined to the 4 on either side (3,072 elements,
fewer than the cluster's threads, so each thread updates at most one), solved
with tol 0 for 64 trips and for 0, the difference over the trips run. Every
solve must give the plain version's bits and trip count. Prints ptxas's
registers and spills for the kernel, the times and each trip's time, and
writes them with the card's name and power limit to `--out` (default
reports/torch_cg_sizes.json). Claims nothing.
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


def ptxas_lines(log):
    """ptxas's register and spill lines for the CG kernel's entries."""
    out, entry = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        if "cg_kernel" in entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def timed(solve, want, want_trips, reps, label):
    """CUDA-event ms of solve() over reps launches, after one launch checked
    against the plain version's (x, trips)."""
    import torch
    x, trips = solve()
    torch.cuda.synchronize()
    if (not torch.equal(x.view(torch.int32), want.view(torch.int32))
            or int(trips) != int(want_trips)):
        sys.exit(f"tune_torch_cg: {label}: the kernel differs from the "
                 "plain version")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        solve()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
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
              "reps": args.reps, "ptxas": ptxas_lines(kernels.build_log),
              "meshes": {}}
    for line in report["ptxas"]:
        print(line)
    hp = HyperParams()
    lam = hp.precond_lambda
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for mesh in ("dog_mid20k", "dog_mid45k", "dog_mid90k"):
        ms = build_mesh_state(*load_ply(os.path.join(
            HERE, "reports", "tuning_meshes", f"{mesh}.ply")), device=dev)
        b = torch.randn(tuple(ms.vertices.shape), device=dev, generator=gen)
        want, want_trips = PC.cg_plain(b, ms.neighbors, ms.neighbor_valid,
                                       lam, tol=1e-6, maxiter=hp.cg_iters)

        def solve():
            return PC.cg_cuda(b, ms.neighbors, ms.neighbor_valid, lam,
                              tol=1e-6, maxiter=hp.cg_iters)
        times = [timed(solve, want, want_trips, args.reps, mesh)
                 for _ in range(2)]
        n_trips = int(want_trips)
        report["meshes"][mesh] = {
            "vp": ms.vertices.shape[0], "neighbours": ms.neighbors.shape[1],
            "trips": n_trips, "ms": times,
            "us_a_trip": [t / n_trips * 1e3 for t in times]}
        print(f"{mesh} (Vp {ms.vertices.shape[0]}, {n_trips} trips): "
              f"{[round(t, 4) for t in times]} ms, "
              f"{[round(t / n_trips * 1e3, 2) for t in times]} us a trip")
    # the fixed cost of a trip: a ring too small to keep any thread busy
    ids = torch.arange(RING_VP, device=dev)
    steps = [s for s in range(-RING_SIDE, RING_SIDE + 1) if s]
    nbr = torch.stack([(ids + s) % RING_VP for s in steps], dim=1)
    valid = torch.ones_like(nbr, dtype=torch.bool)
    b = torch.randn((RING_VP, 3), device=dev, generator=gen)
    ring = {"vp": RING_VP, "neighbours": len(steps), "tol": 0.0}
    for maxiter in (0, hp.cg_iters):
        want, want_trips = PC.cg_plain(b, nbr, valid, lam, tol=0.0,
                                       maxiter=maxiter)

        def solve():
            return PC.cg_cuda(b, nbr, valid, lam, tol=0.0, maxiter=maxiter)
        ring[f"ms_{maxiter}_trips"] = [
            timed(solve, want, want_trips, args.reps, f"ring, {maxiter}")
            for _ in range(2)]
        ring["trips"] = int(want_trips)
    ring["us_a_trip"] = [(t - t0) / ring["trips"] * 1e3 for t, t0 in zip(
        ring[f"ms_{hp.cg_iters}_trips"], ring["ms_0_trips"])]
    report["fixed_trip"] = ring
    print(f"ring (Vp {RING_VP}, {len(steps)} neighbours, {ring['trips']} "
          f"trips): 0 trips {[round(t, 4) for t in ring['ms_0_trips']]} ms, "
          f"{[round(t, 2) for t in ring['us_a_trip']]} us a trip")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
        fh.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

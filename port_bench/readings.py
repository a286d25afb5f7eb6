"""The readings that the limits of `correct` are set from (see PERF.md):
for a workload, in one process, the numbers compared (bench.gaps) of

- the program against the reference, on each of --seeds;
- each control (bench.CONTROLS: the reference with TF32 on, and the
  reference with its ray path in bfloat16) in the program's place, on each
  of --control-seeds;
- each fault (bench.FAULTS: every second matting-valid lane of the ray
  view left out with the ray loss scaled by the share kept, and the
  parameters left unwritten while the momentum updates), planted in the
  reference put in the program's place, on each of --fault-seeds;

on the first seed, the share of the ray view's camera rays on which the
program's oracle and the reference's name another face; and, with
--look, for each step of each side the second moment of uniform Adam, the
largest gradient entry, its vertex and that vertex's gradient rows on
both sides.

    python3 port_bench/readings.py --workload NAME --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--look 1 2] \
        [--out PATH]

Runs on the card; writes one JSON object (to --out too).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(workload, seeds, control_seeds, fault_seeds, root=ROOT,
             device=None, runner=None, log=print, look=()):
    import torch
    from port_bench import bench, capture
    from port_bench import traffic as traffic_gen
    from port_bench.meshio import load_mesh
    _cell, cfg, mix, _limits, _layer = bench.resolve(workload, root)
    ref = bench.reference_of(cfg, root)
    device = torch.device(device or "cuda")
    gt = load_mesh(root, cfg["ground_truth"])
    init = load_mesh(root, cfg["init_mesh"])
    views = capture.load(*gt, cfg, device,
                         os.path.join(root, "port_bench", ".cache"))
    n = mix["check_steps"]
    out = {"workload": workload, "program": {}, "look": {},
           "control": {k: {} for k in bench.CONTROLS},
           "fault": {k: {} for k in bench.FAULTS}}
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        rays, silhs = traffic_gen.view_rows(mix, cfg["rig"]["num_views"],
                                            seed, n + 1)
        t0 = time.time()
        want = bench.reference_steps(cfg, ref, views, init, rays[:n],
                                     silhs[:n], device)
        row = {"reference_s": time.time() - t0, "loss": want["losses"]}
        if seed in seeds:
            prog = bench.Program(cfg, views, init, rays, silhs, device,
                                 runner)
            got = prog.first_steps(n, cfg["optimizer"], ref)
            if seed == seeds[0]:
                out["flip_share"] = flip_share(prog.mesh, views, rays[0][0],
                                               init, device)
            prog.close()
            del prog
            out["program"][seed] = {**bench.gaps(got, want, cfg, ref),
                                    **row, **variants(got, want)}
            if seed in look:
                out["look"][seed] = look_at(got, want, cfg, ref)
        for kind, chosen, runs in (("control", control_seeds,
                                    [{"control": k} for k in bench.CONTROLS]),
                                   ("fault", fault_seeds,
                                    [{"fault": k} for k in bench.FAULTS])):
            if seed in chosen:
                for kw in runs:
                    got = bench.reference_steps(cfg, ref, views, init,
                                                rays[:n], silhs[:n], device,
                                                **kw)
                    out[kind][kw[kind]][seed] = {**bench.gaps(got, want,
                                                              cfg, ref),
                                                 **variants(got, want)}
        log(json.dumps({"seed": seed, "program": out["program"].get(seed),
                        "look": out["look"].get(seed),
                        **{f"{kind}.{k}": v.get(seed)
                           for kind in ("control", "fault")
                           for k, v in out[kind].items()}}), flush=True)
    rows = list(out["program"].values())
    if rows:
        out["program_max"] = {k: max(r[k] for r in rows) for k in rows[0]
                              if k.endswith("_gap")}
    for kind in ("control", "fault"):
        for k, runs in out[kind].items():
            if runs:
                first = next(iter(runs.values()))
                out[f"{kind}_min.{k}"] = {g: min(r[g] for r in runs.values())
                                          for g in first}
    return out


def variants(got, want) -> dict:
    """bench.rows_gap of the first gradient and of the change at other
    quantiles, at the reference's scale ("rows") and at each side's own
    ("dir"): what the quantile of the numbers compared was chosen from."""
    from port_bench import bench
    out = {}
    for name, key in (("grad", "g1"), ("update", "delta")):
        for q in (0.5, 0.75, 0.9, 0.99):
            for kind, own in (("rows", False), ("dir", True)):
                out[f"{name}_{kind}_q{round(q * 100)}_gap"] = bench.rows_gap(
                    got[key], want[key], own, q)
    return out


def look_at(got, want, cfg, ref) -> list:
    """Per step, for the program ("p") and the reference ("r"): uniform
    Adam's second moment v, the largest entry of the step's limited
    gradient (read back from the momentum by the reference module ref),
    its vertex, and that vertex's gradient rows on both sides."""
    steps, prev = [], {"p": None, "r": None}
    for k, (sp, sr) in enumerate(zip(got["states"], want["states"])):
        g = {}
        for side, st in (("p", sp), ("r", sr)):
            m_old = (prev[side]["m"] if prev[side] is not None
                     else st["m"] * 0)
            g[side] = ref.grad_from_momentum(st["m"].double(),
                                             m_old.double(),
                                             cfg["optimizer"],
                                             cfg["momentum"])
            prev[side] = st
        row = {"step": k + 1}
        for side, st in (("p", sp), ("r", sr)):
            flat = int(g[side].abs().reshape(-1).argmax())
            vtx = flat // 3
            row[side] = {"v": st["v"], "max_abs_g": float(
                g[side].abs().reshape(-1)[flat]), "vertex": vtx,
                "g_row_p": g["p"][vtx].tolist(),
                "g_row_r": g["r"][vtx].tolist()}
        row["median_row_p"] = float(g["p"].norm(dim=1).median())
        row["median_row_r"] = float(g["r"].norm(dim=1).median())
        steps.append(row)
    return steps


def flip_share(mesh, views, i, init, device):
    """The share of view i's matting-valid camera rays whose first hit
    the program's oracle and the reference's give on different faces
    (the two meshes order their faces alike)."""
    import torch
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from port_bench.reference.mesh import ref_mesh
    from port_bench.reference.oracle import Scene, closest_hit
    lanes = torch.nonzero(views.valid[i])[:, 0]
    o = views.origin[i, 0].expand(lanes.shape[0], 3).contiguous()
    d = views.ray_dir[i][lanes].contiguous()
    hp = get_intersect_fn("auto")(o, d, mesh.vertices, mesh.faces,
                                  mesh.face_valid, coherent=True)
    m = ref_mesh(*init, device)
    _, ids = closest_hit(o, d, Scene(m.vertices, m.faces))
    return float((hp.tri_id.long() != ids).float().mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--look", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("readings: needs a CUDA card")
    out = readings(args.workload, args.seeds, args.control_seeds,
                   args.fault_seeds, look=args.look)
    out["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()

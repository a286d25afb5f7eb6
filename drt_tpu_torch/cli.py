"""Command-line interface (port of drt_tpu/cli.py).

The reference's only entry point is `python optim.py` with hyper-parameters
edited by hand in config.py (optim.py:221-226, README.md:26). This CLI keeps
the same workflow but takes flags, adds an evaluation command (the
reference's Hausdorff protocol is manual, README.md:13), a standalone remesh
command, and a synthetic-capture mode so the full pipeline runs without the
non-vendored .h5 captures.

The subcommands, flags, defaults, printed lines and output files are the
JAX package's, except:
  --backend   takes the port's oracle backends, auto|brute|culled|cuda
              (the JAX package's `pallas` is the port's `cuda`);
  --device    (reconstruct, render, carve; default cuda) the torch device
              the capture, the carve's occupancy, the mesh and the
              optimization live on. `--device cpu` runs on the CPU, where
              every kernel wrapper runs its plain PyTorch version. With
              `cuda` and no card the command exits non-zero before any work;
              it never carries on on the CPU.
There is no persistent compilation cache to enable (the JAX package's
utils/cache.py sets XLA's): the port's compiled artefacts are the nvcc and
g++ builds in build/drt_tpu_torch/, made at first use. `main(argv)` can be
called in-process.

Examples:
  python -m drt_tpu_torch.cli reconstruct --name hand --data synthetic --resy 128 --resx 128
  python -m drt_tpu_torch.cli reconstruct --name mouse --data /path/to/mouse.h5 --init carved
  python -m drt_tpu_torch.cli evaluate --mesh result/hand_recons.ply --gt hand_scan.ply
  python -m drt_tpu_torch.cli remesh --mesh in.ply --out out.ply --target-len 2.0
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from drt_tpu_torch.config import DEFAULT_DATA_PATH, HyperParams


def _device(args):
    """The torch device of --device; exits with a message where it names a
    card and torch sees none."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"drt_tpu_torch: --device {args.device}: torch sees "
                         "no CUDA device; pass --device cpu to run on the "
                         "CPU")
    return dev


def cmd_reconstruct(args):
    device = _device(args)
    from drt_tpu_torch.mesh import load_ply, save_ply
    from drt_tpu_torch.optimize import optimize

    hp = HyperParams(
        name=args.name, ior=args.ior, num_passes=args.passes,
        iters=args.iters, ray_w=args.ray_w, sm_w=args.sm_w, vh_w=args.vh_w,
        momentum=args.momentum, start_lr=args.start_lr,
        lr_decay=args.lr_decay, start_len=args.start_len,
        end_len=args.end_len, num_view=args.num_view, backend=args.backend,
        seed=args.seed, ray_views_per_iter=args.ray_views_per_iter,
        coarsen_policy=args.coarsen_policy,
        optimizer=args.optimizer, precond=args.precond,
        precond_lambda=args.precond_lambda, huber=args.huber,
        lr_schedule=args.lr_schedule, bilinear_mask=args.bilinear_mask,
        diff_ray_chunk=args.ray_chunk,
        silhouette_budget=args.silhouette_budget,
    )

    if args.data == "synthetic":
        from drt_tpu_torch.data import synthesize_capture
        gt_path = args.gt_mesh or f"{DEFAULT_DATA_PATH}{hp.name}_scan.ply"
        gt_v, gt_f = load_ply(gt_path)
        print(f"synthesizing capture from {gt_path} "
              f"({args.views} views at {args.resy}x{args.resx})...")
        cache = (f"result/capture_cache/{hp.name}_{args.views}v_"
                 f"{args.resy}x{args.resx}.npz")
        data = synthesize_capture(
            gt_v, gt_f, name=hp.name, num_views=args.views,
            resy=args.resy, resx=args.resx, ior=hp.ior,
            backend=hp.backend, num_view_used=min(hp.num_view, args.views),
            cache_path=cache, device=device)
    else:
        from drt_tpu_torch.data import load_h5_capture
        data = load_h5_capture(args.data, hp.name, num_view_used=hp.num_view,
                               device=device)

    if args.init_mesh:
        v_init, f_init = load_ply(args.init_mesh)
    elif args.init == "carved":
        # Self-consistent init: carve the hull from the capture's own masks
        # over the rig's working volume (no ground truth needed).
        from drt_tpu_torch.data.carve import (carved_visual_hull,
                                              rig_working_volume)
        lo, hi = rig_working_volume(data)
        print(f"carving hull at {args.carve_res}^3 over "
              f"[{lo.round(1)}, {hi.round(1)}]...")
        v_init, f_init = carved_visual_hull(data, lo, hi,
                                            resolution=args.carve_res,
                                            target_len=hp.start_len,
                                            device=device)
        print(f"carved hull: V={len(v_init)}, F={len(f_init)}")
    else:
        v_init, f_init = load_ply(f"{DEFAULT_DATA_PATH}{hp.name}_vh.ply")

    mesh = optimize(hp, data, v_init, f_init,
                    remesh_fn=None if args.no_remesh else "isotropic",
                    checkpoint_dir=args.checkpoint_dir,
                    metrics=args.metrics, resume=args.resume, device=device)

    os.makedirs(args.result_dir, exist_ok=True)
    out = os.path.join(args.result_dir, f"{hp.name}_recons.ply")
    v, f = mesh.host_arrays()
    save_ply(out, v, f)
    print(f"wrote {out} (V={len(v)}, F={len(f)})")

    gt_scan = f"{DEFAULT_DATA_PATH}{hp.name}_scan.ply"
    if os.path.exists(gt_scan):
        from drt_tpu_torch.remesh import hausdorff_distance
        gv, gf = load_ply(gt_scan)
        st = hausdorff_distance(v, f, gv, gf)
        print(f"Hausdorff vs scan GT: mean={st.mean:.4f} rms={st.rms:.4f} "
              f"max={st.max:.4f}")


def cmd_evaluate(args):
    from drt_tpu_torch.mesh import load_ply
    from drt_tpu_torch.remesh import hausdorff_distance

    v1, f1 = load_ply(args.mesh)
    v2, f2 = load_ply(args.gt)
    st = hausdorff_distance(v1, f1, v2, f2, symmetric=not args.one_sided)
    print(f"mean={st.mean:.6f} rms={st.rms:.6f} max={st.max:.6f}")


def cmd_render(args):
    """Render diagnostic images of a mesh (mask + refraction validity) from
    a synthetic ring camera — visual QA without a capture."""
    device = _device(args)
    import torch

    from drt_tpu_torch.data.synthetic import intrinsics, look_at_extrinsic
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.render import render_mask, render_transparent
    from drt_tpu_torch.render.camera import CameraM, generate_rays
    from drt_tpu_torch.utils.images import save_image

    v, f = load_ply(args.mesh)
    ms = build_mesh_state(v, f, device=device)
    fn = get_intersect_fn(args.backend)
    center = v.mean(axis=0)
    radius = float(np.linalg.norm(v - center, axis=1).max())
    th = np.deg2rad(args.angle)
    cam_pos = center + 3.5 * radius * np.array(
        [np.cos(th), np.sin(th), 0.17])
    R = look_at_extrinsic(cam_pos, center)
    K = intrinsics(args.res, args.res)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    cam = CameraM(f32(R), f32(K), f32(np.linalg.inv(R)),
                  f32(np.linalg.inv(K)))
    with torch.no_grad():
        origin, ray_dir = generate_rays(args.res, args.res, cam)
        mask = render_mask(origin, ray_dir, ms, fn)
        res = render_transparent(origin, ray_dir, ms, fn, args.ior)
    mask = mask.cpu().numpy()
    valid = res.valid.cpu().numpy()
    dirs = res.direction.cpu().numpy()
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.mesh))[0]
    save_image(os.path.join(args.out_dir, f"{base}_mask.png"),
               mask, args.res, args.res)
    save_image(os.path.join(args.out_dir, f"{base}_valid.png"),
               valid.astype(np.float32), args.res, args.res)
    save_image(os.path.join(args.out_dir, f"{base}_exitdir.png"),
               (dirs * 0.5 + 0.5) * valid[:, None], args.res, args.res)
    print(f"wrote {base}_mask/valid/exitdir.png to {args.out_dir}")


def cmd_carve(args):
    """Carve a visual-hull mesh from a capture's silhouette masks (the
    upstream step the reference assumes done: its *_vh.ply hulls were carved
    from the same masks that ship in the .h5, captured_data.py:12-20)."""
    device = _device(args)
    from drt_tpu_torch.data.carve import carved_visual_hull, rig_working_volume
    from drt_tpu_torch.mesh import load_ply, save_ply

    if args.data == "synthetic":
        from drt_tpu_torch.data import synthesize_capture
        gt_path = args.gt_mesh or f"{DEFAULT_DATA_PATH}{args.name}_scan.ply"
        gt_v, gt_f = load_ply(gt_path)
        data = synthesize_capture(gt_v, gt_f, name=args.name,
                                  num_views=args.views, resy=args.resy,
                                  resx=args.resx, ior=args.ior,
                                  num_view_used=args.views, device=device)
    else:
        from drt_tpu_torch.data import load_h5_capture
        data = load_h5_capture(args.data, args.name, device=device)

    lo, hi = rig_working_volume(data)
    print(f"carving at {args.carve_res}^3 over [{lo.round(1)}, {hi.round(1)}]")
    v, f = carved_visual_hull(data, lo, hi, resolution=args.carve_res,
                              target_len=args.target_len, device=device)
    save_ply(args.out, v, f)
    print(f"wrote {args.out} (V={len(v)}, F={len(f)})")


def cmd_remesh(args):
    from drt_tpu_torch.mesh import load_ply, save_ply
    from drt_tpu_torch.remesh import isotropic_remesh

    v, f = load_ply(args.mesh)
    v2, f2 = isotropic_remesh(v, f, target_len=args.target_len,
                              iterations=args.iterations)
    save_ply(args.out, v2, f2)
    print(f"{args.mesh}: V={len(v)}/F={len(f)} -> V={len(v2)}/F={len(f2)} "
          f"-> {args.out}")


def _add_device(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default; exits if torch "
                             "sees no card) or cpu")


def main(argv=None):
    p = argparse.ArgumentParser(prog="drt_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    hp = HyperParams()
    r = sub.add_parser("reconstruct", help="run the LOD optimization")
    r.add_argument("--name", default=hp.name)
    r.add_argument("--data", default="synthetic",
                   help="'synthetic' or a path to the object's .h5 capture")
    r.add_argument("--init-mesh", default=None,
                   help="explicit init mesh path (overrides --init)")
    r.add_argument("--init", choices=["upstream", "carved"],
                   default="upstream",
                   help="upstream: bundled {name}_vh.ply (reference "
                        "parity); carved: space-carve the hull from the "
                        "capture's own masks (self-consistent, recommended)")
    r.add_argument("--carve-res", type=int, default=160)
    r.add_argument("--gt-mesh", default=None,
                   help="ground-truth mesh for synthetic capture")
    r.add_argument("--views", type=int, default=72)
    r.add_argument("--resy", type=int, default=256)
    r.add_argument("--resx", type=int, default=256)
    r.add_argument("--ior", type=float, default=hp.ior)
    r.add_argument("--passes", type=int, default=hp.num_passes)
    r.add_argument("--iters", type=int, default=hp.iters)
    r.add_argument("--ray-w", type=float, default=hp.ray_w)
    r.add_argument("--sm-w", type=float, default=hp.sm_w)
    r.add_argument("--vh-w", type=float, default=hp.vh_w)
    r.add_argument("--momentum", type=float, default=hp.momentum)
    r.add_argument("--start-lr", type=float, default=hp.start_lr)
    r.add_argument("--lr-decay", type=float, default=hp.lr_decay)
    r.add_argument("--start-len", type=float, default=hp.start_len)
    r.add_argument("--end-len", type=float, default=hp.end_len)
    r.add_argument("--num-view", type=int, default=hp.num_view)
    r.add_argument("--ray-views-per-iter", type=int,
                   default=hp.ray_views_per_iter)
    r.add_argument("--backend", default="auto",
                   choices=["auto", "brute", "culled", "cuda"])
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--optimizer", default=hp.optimizer,
                   choices=["sgd", "adam", "uadam"],
                   help="sgd = reference-parity Nesterov (optim.py:169)")
    r.add_argument("--precond", default=hp.precond,
                   choices=["none", "sobolev", "h1"],
                   help="vertex-update preconditioner "
                        "(optimize/precondition.py); none = parity")
    r.add_argument("--precond-lambda", type=float, default=hp.precond_lambda)
    r.add_argument("--huber", type=float, default=hp.huber,
                   help="Huber delta on per-ray residuals (0 = parity L2)")
    r.add_argument("--lr-schedule", default=hp.lr_schedule,
                   choices=["reciprocal", "len"],
                   help="reciprocal = reference parity (optim.py:147-153)")
    r.add_argument("--bilinear-mask", action="store_true",
                   help="bilinear soft-mask sampling in the silhouette loss "
                        "(reference truncates, DiffRender.py:245)")
    r.add_argument("--ray-chunk", type=int, default=hp.diff_ray_chunk,
                   help="differentiable-trace ray chunk size "
                        "(-1 auto, 0 never chunk; render/chunked.py)")
    r.add_argument("--silhouette-budget", type=int, default=None,
                   help="static silhouette-edge sampling budget "
                        "(default: auto from the mesh's edge count)")
    r.add_argument("--coarsen-policy", default="auto",
                   choices=["auto", "schedule", "clamp", "skip"],
                   help="early-pass coarsening policy (config.py docs; "
                        "auto = measured-best by capture resolution, "
                        "schedule = reference parity)")
    r.add_argument("--no-remesh", action="store_true")
    r.add_argument("--resume", action="store_true",
                   help="continue from the latest per-pass checkpoint")
    r.add_argument("--metrics", default=None,
                   help="write JSON-line per-iteration metrics to this file")
    r.add_argument("--checkpoint-dir", default="result/checkpoints")
    r.add_argument("--result-dir", default="result")
    _add_device(r)
    r.set_defaults(fn=cmd_reconstruct)

    e = sub.add_parser("evaluate", help="Hausdorff distance between meshes")
    e.add_argument("--mesh", required=True)
    e.add_argument("--gt", required=True)
    e.add_argument("--one-sided", action="store_true")
    e.set_defaults(fn=cmd_evaluate)

    rr = sub.add_parser("render", help="diagnostic renders of a mesh")
    rr.add_argument("--mesh", required=True)
    rr.add_argument("--out-dir", default="result/renders")
    rr.add_argument("--res", type=int, default=512)
    rr.add_argument("--angle", type=float, default=30.0)
    rr.add_argument("--ior", type=float, default=1.4723)
    rr.add_argument("--backend", default="auto")
    _add_device(rr)
    rr.set_defaults(fn=cmd_render)

    c = sub.add_parser("carve", help="space-carve a visual hull from a "
                                     "capture's silhouette masks")
    c.add_argument("--name", default=hp.name)
    c.add_argument("--data", default="synthetic",
                   help="'synthetic' or a path to a reference .h5 capture")
    c.add_argument("--gt-mesh", default=None,
                   help="scan mesh to synthesize the capture from")
    c.add_argument("--views", type=int, default=72)
    c.add_argument("--resy", type=int, default=256)
    c.add_argument("--resx", type=int, default=256)
    c.add_argument("--ior", type=float, default=hp.ior)
    c.add_argument("--carve-res", type=int, default=160)
    c.add_argument("--target-len", type=float, default=10.0)
    c.add_argument("--out", required=True)
    _add_device(c)
    c.set_defaults(fn=cmd_carve)

    m = sub.add_parser("remesh", help="isotropic explicit remeshing")
    m.add_argument("--mesh", required=True)
    m.add_argument("--out", required=True)
    m.add_argument("--target-len", type=float, required=True)
    m.add_argument("--iterations", type=int, default=3)
    m.set_defaults(fn=cmd_remesh)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

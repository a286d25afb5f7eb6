#!/usr/bin/env python3
"""Measurements behind the constants of the port's oracle, on one CUDA GPU.

    python3 scripts/tune_torch_oracle.py [--what tiles blocks gate]

Six queries, the ones chip_smoke.py checks: the camera rays and the
bounce-2 rays of one 1280x960 view of dog_mid90k, and the four queries of
one train step on dog_mid45k (bounce 1, bounce 2, exit, one silhouette
view), recorded from the loss functions themselves.

tiles   RAY_TILE_COHERENT and RAY_TILE_INCOHERENT set to 256, 128, 64, 32
        (closest-hit blocks as large as the tile): closest-hit kernel,
        the stages before it (of which, for incoherent queries, the prepass
        kernel with its sort), and whole query, in ms (CUDA events).
blocks  the tiles as the package sets them, BLOCK_RAYS set to 256, 128, 64,
        32: kernel and whole query.
gate    the per-ray gate of the kernel against the tile-wide gate of the
        JAX package's `_kernel` (the plain version with its gate widened to
        "any ray of the tile enters"): rays whose tri_id or t differ.
Every variant's hits are also compared with the first variant's: they do
not depend on tile or block size.
"""

import argparse
import inspect
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def recorded_queries(dev):
    """[(name, origins, dirs, geom, coherent)] of the six queries."""
    import numpy as np
    import torch
    import chip_smoke as S
    from drt_tpu_torch.config import POINTGRAY_RES as RES, HyperParams
    from drt_tpu_torch.data.synthetic import (intrinsics, ring_cameras,
                                              synthesize_capture)
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import default_silhouette_budget
    from drt_tpu_torch.optimize.losses import ray_loss, silhouette_loss
    from drt_tpu_torch.render.camera import CameraM, generate_rays
    from drt_tpu_torch.render.trace import _bounce

    hp = HyperParams()
    v90, f90 = load_ply(os.path.join(S.MESH_DIR, "dog_mid90k.ply"))
    ms90 = build_mesh_state(v90, f90, device=dev)
    R, _, _ = ring_cameras(v90, 8)[0]
    K = intrinsics(*RES)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    cam = CameraM(f32(R), f32(K), f32(np.linalg.inv(R)),
                  f32(np.linalg.inv(K)))
    o1, d1 = generate_rays(*RES, cam)
    with torch.no_grad():
        o2, d2, _, _ = _bounce(
            o1, d1, torch.ones(o1.shape[0], dtype=torch.bool, device=dev),
            ms90, get_intersect_fn("cuda"), hp.ior, hp.ext_ior, 1e-5,
            coherent=True)
    geom90 = (ms90.vertices, ms90.faces, ms90.face_valid)
    queries = [("dog_mid90k camera", o1, d1, geom90, True),
               ("dog_mid90k bounce2", o2, d2, geom90, False)]

    cap = synthesize_capture(v90, f90, name="dog", num_views=2, resy=RES[0],
                             resx=RES[1], ior=hp.ior, ext_ior=hp.ext_ior,
                             num_view_used=2, device=dev)
    v45, f45 = load_ply(os.path.join(S.MESH_DIR, "dog_mid45k.ply"))
    ms45 = build_mesh_state(v45, f45, device=dev)
    rec = S.QueryRecorder()
    with torch.no_grad():
        ray_loss(ms45, cap.views.take(0), rec, hp.ior, hp.ext_ior)
        silhouette_loss(ms45, cap.views.take(0), rec,
                        default_silhouette_budget(ms45.num_edges), *RES)
    geom45 = (ms45.vertices, ms45.faces, ms45.face_valid)
    for qn, (o, d, coh) in zip(("bounce1", "bounce2", "exit", "silhouette"),
                               rec.queries):
        queries.append((f"dog_mid45k {qn}", o, d, geom45, coh))
    return queries


def sweep(queries, names, values):
    """Time every query with the module constants `names` set to each of
    `values`; two rounds, so the spread shows."""
    import torch
    import chip_smoke as S
    from drt_tpu_torch.intersect import cuda_kernel as CK
    saved = {n: getattr(CK, n) for n in names}
    ref = {}
    try:
        for rnd in range(2):
            for name, o, d, geom, coh in queries:
                for val in values:
                    for n in names:
                        setattr(CK, n, val)
                    inp = CK.prepare_inputs(o, d, *geom, coherent=coh)
                    N = o.shape[0]
                    t, ids = (x[:N] for x in CK.closest_hit_cuda(inp))
                    ref.setdefault(name, (t.clone(), ids.clone()))
                    same = bool(torch.equal(ref[name][0], t)
                                and torch.equal(ref[name][1], ids))
                    ms_k = S.cuda_ms(lambda: CK.closest_hit_cuda(inp), 20)
                    ms_p = S.cuda_ms(lambda: CK.prepare_inputs(
                        o, d, *geom, coherent=coh), 10)
                    ms_q = S.cuda_ms(lambda: CK.intersect_cuda(
                        o, d, *geom, coherent=coh), 10)
                    T = inp.count.shape[0]
                    cnt = inp.count.float()
                    pre = ""
                    if not coh:
                        cv = CK._chunk_aabbs(*geom, o.float().mean(dim=0),
                                             CK.TRI_CHUNK)[2]
                        ms_c = S.cuda_ms(lambda: CK._sorted_candidates(
                            CK.candidate_scores_cuda(
                                inp.phi[6:9], inp.inv, inp.lo, inp.hi, cv,
                                T)), 10)
                        pre = f" of which prepass kernel and sort {ms_c:.3f},"
                    print(f"round {rnd} {name} {'/'.join(names)}={val} "
                          f"(tile {inp.phi.shape[1] // T}): kernel "
                          f"{ms_k:.3f} ms, stages before it {ms_p:.3f} ms,"
                          f"{pre} query {ms_q:.3f} ms; listed chunks "
                          f"{int(inp.count.sum())}, per tile mean "
                          f"{float(cnt.mean()):.1f} max {int(cnt.max())}; "
                          f"hits equal the first variant's: {same}",
                          flush=True)
    finally:
        for n, v in saved.items():
            setattr(CK, n, v)


def gate(queries):
    """Rays on which the kernel's per-ray gate and a tile-wide gate give
    different hits."""
    from drt_tpu_torch.intersect import cuda_kernel as CK
    src = inspect.getsource(CK.closest_hit_plain)
    per_ray = "& active[:, None])"
    if src.count(per_ray) != 1:
        sys.exit("tune_torch_oracle: closest_hit_plain's gate has moved")
    src = src.replace(per_ray, per_ray + ".any(dim=1, keepdim=True)")
    ns = dict(vars(CK))
    exec(src.replace("def closest_hit_plain", "def tile_gated"), ns)
    for name, o, d, geom, coh in queries:
        inp = CK.prepare_inputs(o, d, *geom, coherent=coh)
        N = o.shape[0]
        t, ids = (x[:N] for x in CK.closest_hit_cuda(inp))
        tg, idg = (x[:N] for x in ns["tile_gated"](inp))
        diff = ids != idg
        n_hit = int(((ids >= 0) | (idg >= 0)).sum())
        only_tile = int(((idg >= 0) & (ids < 0)).sum())
        dt = (t - tg)[~diff & (ids >= 0)].abs()
        print(f"{name} (tiles of {inp.phi.shape[1] // inp.count.shape[0]}): "
              f"per-ray gate vs tile gate: {int(diff.sum())} of {N} rays "
              f"differ in tri_id ({n_hit} hit), {only_tile} hits that only "
              f"the tile gate finds, t differs on {int((dt > 0).sum())} "
              f"rays with the same id", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", nargs="+", default=["tiles", "blocks", "gate"],
                    choices=["tiles", "blocks", "gate"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("tune_torch_oracle: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    queries = recorded_queries(torch.device("cuda", 0))
    if "tiles" in args.what:
        # blocks as large as the tile: BLOCK_RAYS = 256 divides none smaller
        from drt_tpu_torch.intersect import cuda_kernel as CK
        saved, CK.BLOCK_RAYS = CK.BLOCK_RAYS, CK.MAX_RAY_TILE
        try:
            sweep(queries, ("RAY_TILE_COHERENT", "RAY_TILE_INCOHERENT"),
                  (256, 128, 64, 32))
        finally:
            CK.BLOCK_RAYS = saved
    if "blocks" in args.what:
        sweep(queries, ("BLOCK_RAYS",), (256, 128, 64, 32))
    if "gate" in args.what:
        gate(queries)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the closest-hit kernel and the brute-force oracle disagree on the
queries of an LOD run, and why.

    python3 scripts/diag_torch_exit_ties.py [REPEATS]

Runs `chip_smoke.py` phase 9's LOD run (the 8-view dog capture at 1280x960,
3 passes x 10 steps from dog_mid20k) REPEATS times (default 2; the card's
scatter-adds make each run's meshes differ a little), and on each pass's
checkpoint records the ray loss's three queries of view 0. For every ray the
kernel hits, and a sample of 200,000 it misses, it compares the kernel with
the brute-force oracle and prints each disagreement: both sides' triangle
and t, both sides' float32 conditioning (`chip_smoke.t_conditioning`), the
ray origin's distance from the kernel's shift, and, in float64 for the
triangle each side names, t, the barycentric coordinates, the crossing's
signed distance to the nearest edge and the cosine to the normal. Needs a
CUDA GPU.
"""

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def float64_hit(o, d, geom, ids):
    """(t, w, u, v, signed distance of the crossing to the nearest edge
    line, |cos| to the normal) of each ray against triangle ids, float64."""
    import torch
    vertices, faces, _ = geom
    tri = vertices[faces[ids.clamp(min=0).long()]].double()
    o, d = o.double(), d.double()
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    p = torch.linalg.cross(d, e2)
    det = (e1 * p).sum(-1)
    tv = o - v0
    u = (tv * p).sum(-1) / det
    q = torch.linalg.cross(tv, e1)
    v = (d * q).sum(-1) / det
    t = (e2 * q).sum(-1) / det
    cross = o + t[:, None] * d
    dist = []
    for a, b, w in ((v0, v1, v), (v1, v2, 1 - u - v), (v2, v0, u)):
        ab = b - a
        dd = torch.linalg.cross(cross - a, ab).norm(dim=-1) / ab.norm(dim=-1)
        dist.append(torch.where(w >= 0, dd, -dd))
    n = torch.linalg.cross(e1, e2)
    cos = ((d * n).sum(-1) / (n.norm(dim=-1) * d.norm(dim=-1))).abs()
    return t, 1 - u - v, u, v, torch.stack(dist, 1).min(1).values, cos


def main():
    import torch
    import chip_smoke as CS
    from drt_tpu_torch.config import POINTGRAY_RES as RES, HyperParams
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.brute import intersect_brute
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import optimize
    from drt_tpu_torch.optimize.losses import ray_loss

    if not torch.cuda.is_available():
        sys.exit("diag_torch_exit_ties: needs a CUDA GPU")
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dev = torch.device("cuda", 0)
    v90, f90 = load_ply(os.path.join(CS.MESH_DIR, "dog_mid90k.ply"))
    v20, f20 = load_ply(os.path.join(CS.MESH_DIR, "dog_mid20k.ply"))
    cap = synthesize_capture(v90, f90, name="dog", num_views=8, resy=RES[0],
                             resx=RES[1], num_view_used=8, device=dev)
    hp = HyperParams(name="dog", num_passes=3, iters=10, start_len=2.5,
                     end_len=1.5, num_view=8)
    gen = torch.Generator(device=dev).manual_seed(0)
    for rep in range(repeats):
        with tempfile.TemporaryDirectory() as ck:
            optimize(hp, cap, v20, f20, remesh_fn="isotropic",
                     checkpoint_dir=ck, log_fn=lambda s: None, device=dev)
            for name in sorted(os.listdir(ck)):
                ms = build_mesh_state(*load_ply(os.path.join(ck, name)),
                                      device=dev)
                rec = CS.QueryRecorder()
                with torch.no_grad():
                    ray_loss(ms, cap.views.take(0), rec, hp.ior, hp.ext_ior)
                geom = (ms.vertices, ms.faces, ms.face_valid)
                for qname, (o, d, coh) in zip(("bounce1", "bounce2", "exit"),
                                              rec.queries):
                    h = CK.intersect_cuda(o, d, *geom, coherent=coh)
                    hits = torch.nonzero(h.tri_id >= 0)[:, 0]
                    miss = torch.nonzero(h.tri_id < 0)[:, 0]
                    miss = miss[torch.randperm(miss.numel(), device=dev,
                                               generator=gen)[:200000]]
                    idx = torch.cat([hits, miss])
                    b = intersect_brute(o[idx], d[idx], *geom)
                    kt, kid = h.t[idx], h.tri_id[idx]
                    diff = torch.nonzero(b.tri_id != kid)[:, 0]
                    print(f"rep {rep} {name} {qname}: kernel hits "
                          f"{hits.numel()}, misses sampled {miss.numel()}, "
                          f"differ {diff.numel()}", flush=True)
                    shift = o.float().mean(0)
                    cond_k = CS.t_conditioning(o[idx], d[idx], geom, kid)
                    cond_b = CS.t_conditioning(o[idx], d[idx], geom, b.tri_id)
                    for j in diff.tolist():
                        i = idx[j]
                        line = (f"   ray {int(i)}: kernel id {int(kid[j])} t "
                                f"{float(kt[j]):.6g} | brute id "
                                f"{int(b.tri_id[j])} t {float(b.t[j]):.6g} | "
                                f"cond k {float(cond_k[j]):.3g} b "
                                f"{float(cond_b[j]):.3g} | |o-shift| "
                                f"{float((o[i] - shift).norm()):.4g}")
                        for side, tid in (("k", kid[j:j + 1]),
                                          ("b", b.tri_id[j:j + 1])):
                            if int(tid) >= 0:
                                t64, w, u, v, edge, cos = (
                                    x.item() for x in float64_hit(
                                        o[i:i + 1], d[i:i + 1], geom, tid))
                                line += (f" | {side}: t64 {t64:.6g} bary "
                                         f"({w:.2e},{u:.2e},{v:.2e}) edge "
                                         f"{edge:.3g} cos {cos:.3g}")
                        print(line, flush=True)


if __name__ == "__main__":
    main()

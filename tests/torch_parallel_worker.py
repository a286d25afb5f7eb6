"""One rank of the port's two-process gloo run (tests/test_torch_parallel.py
starts one instance per rank).

    python tests/torch_parallel_worker.py RANK WORLD WORKDIR

It joins the process group through `init_multihost` (a file:// address in
WORKDIR, gloo on the CPU), reads WORKDIR/inputs.npz and config.json, which
the test wrote, runs every case through drt_tpu_torch.parallel and writes
WORKDIR/rank<RANK>.npz for the test to compare. It imports only numpy, torch
and drt_tpu_torch.
"""

import json
import os
import sys

import numpy as np
import torch


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    from drt_tpu_torch.convert import (mesh_state_from_arrays,
                                       view_batch_from_arrays)
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.optimize import LossWeights
    from drt_tpu_torch.parallel import (make_ray_mesh,
                                        make_sharded_train_step,
                                        pad_views_to_multiple, replicate,
                                        shard_views)
    from drt_tpu_torch.parallel.multihost import (init_multihost,
                                                  shard_rays_for_host)
    from drt_tpu_torch.parallel.sharding import shard_mapped_intersect

    init_multihost("file://" + os.path.join(work, "pg"), world, rank,
                   device="cpu")
    mesh = make_ray_mesh(device="cpu")
    with open(os.path.join(work, "config.json")) as fh:
        cfg = json.load(fh)
    arrs = np.load(os.path.join(work, "inputs.npz"))

    def fields(prefix):
        return {k[len(prefix):]: arrs[k] for k in arrs.files
                if k.startswith(prefix)}

    ms0 = mesh_state_from_arrays(fields("M_"), "cpu")
    views_a = view_batch_from_arrays(fields("A_"), "cpu")
    views_b = view_batch_from_arrays(fields("B_"), "cpu")
    weights = LossWeights(**cfg["weights"])
    out = {}

    def run(name, views, res, ray_views, backend="auto", **kw):
        """Steps of make_sharded_train_step, one for each ray view."""
        (init, step, final), ms, vs = make_sharded_train_step(
            dict(intersect_fn=get_intersect_fn(backend), weights=weights,
                 resy=res[0], resx=res[1],
                 silhouette_budget=cfg["budget"], **kw),
            mesh, ms0, views)
        st = init(ms)
        losses, calls = [], []
        for i in ray_views:
            CK.counters.reset()
            st, loss, aux = step(st, cfg["lr"], ms, vs, i, cfg["silh"])
            calls.append(CK.counters.calls)
            losses.append(float(loss))
        out.update({f"{name}_losses": np.array(losses),
                    f"{name}_calls": np.array(calls),
                    f"{name}_verts": final(st, ms).numpy(),
                    f"{name}_params": st["params"].numpy()})
        for k, v in aux.items():
            out[f"{name}_aux_{k}"] = v.numpy()

    run("train", views_a, cfg["res_a"], cfg["ray_views"])
    padded = pad_views_to_multiple(views_b, world)
    out["padded_n"] = np.array(padded.ray_dir.shape[1])
    run("padded", padded, cfg["res_b"], cfg["ray_views"], backend="brute")
    run("h1", views_a, cfg["res_a"], cfg["ray_views"][:1],
        optimizer="uadam", precond="h1", **cfg["h1"])

    # the oracle over global rays, each rank answering its slice
    o = views_a.origin[0].expand(views_a.ray_dir[0].shape)
    d = views_a.ray_dir[0]
    for backend in ("brute", "culled"):
        h = shard_mapped_intersect(get_intersect_fn(backend), mesh)(
            o, d, ms0.vertices, ms0.faces, ms0.face_valid, coherent=True)
        out[f"{backend}_t"], out[f"{backend}_tri_id"] = (h.t.numpy(),
                                                         h.tri_id.numpy())
    h = shard_mapped_intersect(
        get_intersect_fn("cuda", incoherent="resort"), mesh)(
        torch.from_numpy(arrs["scene_o"]), torch.from_numpy(arrs["scene_d"]),
        ms0.vertices, ms0.faces, ms0.face_valid, coherent=False)
    out["resort_t"], out["resort_tri_id"] = h.t.numpy(), h.tri_id.numpy()

    shard = shard_views(mesh, views_a)
    for k in ("screen_pixel", "valid", "mask", "origin", "ray_dir", "K"):
        out[f"shape_{k}"] = np.array(getattr(shard, k).shape)
    out["shard_ray_dir"] = shard.ray_dir.numpy()
    sl = shard_rays_for_host(views_a.ray_dir.shape[1])
    out["host_slice"] = np.array([sl.start, sl.stop])

    # every rank ends with rank 0's bits, whatever it held before
    mine = ms0.vertices + 1.0 if rank else ms0.vertices
    placed = replicate(mesh, {"mesh": ms0.with_vertices(mine), "v": mine})
    out["replicated"] = placed["mesh"].vertices.numpy()
    out["replicated_v"] = placed["v"].numpy()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Measurements behind the constants of the port's oracle, on one CUDA GPU.

    python3 scripts/tune_torch_oracle.py [--what tiles blocks gate prepass
                                          resort group pack scatter
                                          scatter-routes scatter-trace
                                          silhouette defaults]

Six queries, the ones chip_smoke.py checks: the camera rays and the
bounce-2 rays of one 1280x960 view of dog_mid90k, and the four queries of
one train step on dog_mid45k (bounce 1, bounce 2, exit, one silhouette
view), recorded from the loss functions themselves.

tiles   RAY_TILE_COHERENT and RAY_TILE_INCOHERENT set to 256, 128, 64, 32
        (closest-hit blocks as large as the tile): closest-hit kernel,
        the stages before it (of which the prepass kernel), and whole
        query, in ms (CUDA events).
blocks  the tiles as the package sets them, BLOCK_RAYS set to 256, 128, 64,
        32: kernel and whole query.
gate    the per-ray gate of the kernel against the tile-wide gate of the
        JAX package's `_kernel` (the plain version with its gate widened to
        "any ray of the tile enters"): rays whose tri_id or t differ.
prepass the prepass kernel (csrc/candidates.cu) built with blocks of 128
        and of 256 threads a tile (-DPREPASS_BLOCK), in turns (128, 256,
        256, 128; CUDA events), on each query in its own mode, the lists
        equal to the plain version's at both sizes. Writes
        reports/torch_prepass_blocks.json (or --prepass-out PATH); the
        source's PREPASS_BLOCK is the winner over the six.
resort  the two routes of an incoherent query, "ray" (the exact per-ray
        prepass kernel) against "resort" (Morton sort of the rays, tile
        prepass, scatter back), on the bounce-2 and exit queries of a
        1280x960 view of dog_mid{20k,45k,90k} (`incoherent_queries`): hits
        equal bit for bit, ms a query of both in turns (ray, resort, resort,
        ray; CUDA events), the group each route's query took, and the parts
        of the resorted route. Writes the winner for each mesh size into
        reports/torch_resort_ab.json (or --table PATH), the table that
        `get_intersect_fn(incoherent="auto")` reads. Not in the default
        set: it rewrites a file of the repository.
group   candidate groups of 1, 4 and 16 chunks (`intersect_cuda(group=)`)
        on the incoherent queries (ray mode) of dog_mid45k and dog_mid90k,
        bounce 2, exit and one silhouette view: hits against group 1
        (tri_id equal but for shared-edge ties), then the prepass kernel,
        the closest-hit kernel and the whole query in turns (1, g, g, 1;
        CUDA events), and one query's device operations, their busy time
        (torch.profiler) and its host time (the call's return, the device
        idle at its start). A group is faster on a mesh where both of its turns of
        a step's incoherent kernel time (prepass + closest hit of bounce 2,
        exit and 8 silhouette views) beat both of group 1's. Only where some
        group is faster on both meshes does a mesh take one: the least group
        faster on it; else every mesh takes 1. Writes
        reports/torch_group_ab.json (or --group-out PATH), the table that
        `intersect_cuda(group=None)` reads for incoherent queries. Not in
        the default set either: it rewrites a file of the repository.
pack    the packing kernel (csrc/pack.cu) against its plain version (the
        torch stages `pack_plain`, which the script swaps in for `pack`
        itself) on the four kinds of query of a train step (camera, bounce
        2, exit, one silhouette view) on dog_mid{20k,45k,90k}, each under a
        capture of another mesh: hits equal bit for bit, the whole query in
        turns (plain, kernel, kernel, plain; CUDA events), and a query's
        device operations, their busy time and its host time; then the
        reference-parity step (sgd + none, HyperParams() weights, 1 ray view
        and 8 silhouette views of 1280x960) on dog_mid45k the same way
        (host clock around synchronized steps, the median of 5 after a
        warm-up, in turns), with its device operations in and out of the
        oracle (torch.profiler). Writes reports/torch_pack_ab.json (or
        --pack-out PATH). Claims nothing: both sides give the same hits.
scatter the row scatter-add kernel (csrc/scatter.cu) against the parent's
        path, swapped in by the script: the step's vertex gathers as
        advanced indexing (IndexBackward0, `index_put_` with accumulate),
        `_GatherTri9`'s backward as one direct `index_add_`, the normals'
        `index_add`. The reference-parity step of `pack` on dog_mid45k in
        turns (parent, kernel, kernel, parent; 5 steps a turn after a
        warm-up, host clock, synchronized), each side's device operations,
        device busy time and peak memory, and whether two steps from one
        state give the same bits (default algorithms, no
        `torch.use_deterministic_algorithms`); then `_GatherTri9`'s two
        backward routes through the kernel (soup: [N,9] -> [F,9] -> [V,3]; direct:
        [3N,3] -> [V,3]) and the parent's direct `index_add_`, on both
        bounces' recorded cotangents of a 1280x960 view of dog_mid{20k,45k,
        90k} (Fp 32,768 / 65,536 / 131,072), each under a capture of
        another mesh, in turns (soup, direct, direct, soup; CUDA events).
        Writes reports/torch_scatter_ab.json (or --scatter-out PATH).
        Claims nothing.
scatter-routes  the scatter kernel's cluster and grid routes and
        `index_add_` on every scatter call of that step on dog_mid{20k,
        45k,90k} (recorded from the step), in turns under torch.profiler:
        device time, span and operations of each, both routes' calls with
        the wrapper, the route `scatter_route` takes and the call's bound.
        Writes reports/torch_scatter_routes.json (or --scatter-routes-out
        PATH).
scatter-trace  the cluster route built with -DSCATTER_TRACE=1 (a library
        of its own under build/): the SM cycles of each phase of one
        launch (CTA 0's clock64() stamps) on a silhouette-, a second-stage-
        and a normals-sized call, medians of 20 launches.
silhouette  the one-origin route (the silhouette sampler's queries,
        sorted along the screen by csrc/order.cu) on 8 silhouette views of
        dog_mid{20k,45k,90k} at their budgets, against the parent's route
        (the rays unsorted in rows, GROUP_TABLE's group, 32 rays a warp) in
        the shapes of SILHOUETTE_SHAPES: ray tiles of 32, 64 and 128 and
        groups of 1 and 4, rays a warp and warps a block, 8 key bits an
        axis against 5, and the parent's lanes with the route's warps. For
        each: the longest and mean candidate list, hit (bit for bit) and t
        against the parent's route, a query's device operations and device
        ms by kernel (torch.profiler), the query in turns (CUDA events),
        and csrc/order.cu's time at each key width (a library built with
        -DORDER_AXIS_BITS). The sorted shape with the least device time
        over all queries gives the route's constants in
        intersect/cuda_kernel.py. Writes reports/torch_silhouette_order.json
        (or --silhouette-out PATH).
defaults  with --parent DIR (an unpacked tree of another commit): the six
        queries and the incoherent ones of `group` through both trees'
        `intersect_cuda` at the defaults, hits equal bit for bit wherever
        both trees take one group, and both kernels of both trees timed in
        turns (parent, this, this, parent).
Every variant's hits are also compared with the first variant's: they do
not depend on tile or block size.
"""

import argparse
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time

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
                    args = S.prepass_args(o, geom, inp)
                    ms_c = S.cuda_ms(lambda: CK.candidates_cuda(
                        *args, tile=coh), 10)
                    pre = f" of which prepass kernel {ms_c:.3f},"
                    print(f"round {rnd} {name} {'/'.join(names)}={val} "
                          f"(tile {inp.phi.shape[1] // T}): kernel "
                          f"{ms_k:.3f} ms, stages before it {ms_p:.3f} ms,"
                          f"{pre} query {ms_q:.3f} ms; listed boxes "
                          f"{int(inp.count.sum())} (groups of {inp.group}), "
                          f"per tile mean "
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


def prepass_blocks(queries, card, out):
    """The prepass kernel built at 128 and 256 threads a tile, on each
    query; writes the times to `out`."""
    import torch
    import chip_smoke as S
    from drt_tpu_torch import kernels as KN
    from drt_tpu_torch.intersect import cuda_kernel as CK
    default = CK._load()
    libs = {b: KN.bind(KN.build(defines=(f"PREPASS_BLOCK={b}",)))
            for b in (128, 256)}
    for b, lib in libs.items():
        if lib.candidates_block() != b:
            sys.exit(f"tune_torch_oracle: the {b}-thread build launches "
                     f"{lib.candidates_block()} threads")
    rows, total = [], {128: 0.0, 256: 0.0}
    for name, o, d, geom, coh in queries:
        inp = CK.prepare_inputs(o, d, *geom, coherent=coh)
        T, NC = inp.cand.shape
        args = S.prepass_args(o, geom, inp)
        cv = args[4]
        want = CK.candidates_plain(*args, tile=coh)
        ms = {128: [], 256: []}
        try:
            for block in (128, 256, 256, 128):
                KN._lib = libs[block]
                got = CK.candidates_cuda(*args, tile=coh)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    sys.exit(f"tune_torch_oracle: {name}: the prepass kernel "
                             f"at {block} threads differs from its plain "
                             "version")
                ms[block].append(S.cuda_ms(lambda: CK.candidates_cuda(
                    *args, tile=coh), 20))
        finally:
            KN._lib = default
        bound, bound_by = S.prepass_bound(args[0].shape[1], T, NC,
                                          int(cv.sum()), coh, want[1])
        for b in ms:
            total[b] += sum(ms[b]) / 2
        rows.append({"query": name, "mode": "tile" if coh else "ray",
                     "tiles": T, "ray_tile": args[0].shape[1] // T,
                     "chunks": NC, "valid_chunks": int(cv.sum()),
                     "ms_128": ms[128], "ms_256": ms[256],
                     "bound_ms": bound, "bound_by": bound_by})
        print(f"{name} ({rows[-1]['mode']} mode, {T} tiles x {NC} chunks): "
              f"128 threads {ms[128][0]:.4f} / {ms[128][1]:.4f} ms, 256 "
              f"threads {ms[256][0]:.4f} / {ms[256][1]:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by})", flush=True)
    winner = min(total, key=total.get)
    print(f"all six queries: 128 threads {total[128]:.4f} ms, 256 threads "
          f"{total[256]:.4f} ms -> {winner} (the source's PREPASS_BLOCK is "
          f"{default.candidates_block()})")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"device": card, "script":
                   "scripts/tune_torch_oracle.py --what prepass",
                   "rows": rows, "total_ms": total, "winner": winner}, fh,
                  indent=1)
        fh.write("\n")
    print(f"wrote {out}")


# The capture each mesh's incoherent queries are made under: never the
# mesh's own, so the exit rays (which leave through the capture's surface)
# still hit the queried one.
CAPTURE_OF = {"dog_mid20k": "dog_mid90k", "dog_mid45k": "dog_mid90k",
              "dog_mid90k": "dog_mid45k"}


def incoherent_queries(dev, meshes, silhouette=False, coherent=False):
    """{mesh: (mesh state, geom, [(name, origins, dirs)])}: the bounce-2 and
    exit queries of one 1280x960 view (and, `silhouette`, one silhouette
    view's; `coherent`, the camera query's too, as (name, origins, dirs,
    coherent)), recorded from the loss functions on `mesh` under a capture
    synthesized from CAPTURE_OF[mesh]."""
    import torch
    import chip_smoke as S
    from drt_tpu_torch.config import POINTGRAY_RES as RES, HyperParams
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import default_silhouette_budget
    from drt_tpu_torch.optimize.losses import ray_loss, silhouette_loss

    hp = HyperParams()
    caps, out = {}, {}
    for mesh in meshes:
        src = CAPTURE_OF[mesh]
        if src not in caps:
            v, f = load_ply(os.path.join(S.MESH_DIR, f"{src}.ply"))
            caps[src] = synthesize_capture(
                v, f, name="dog", num_views=1, resy=RES[0], resx=RES[1],
                ior=hp.ior, ext_ior=hp.ext_ior, num_view_used=1, device=dev)
        ms = build_mesh_state(*load_ply(os.path.join(S.MESH_DIR,
                                                     f"{mesh}.ply")),
                              device=dev)
        rec = S.QueryRecorder()
        view = caps[src].views.take(0)
        with torch.no_grad():
            ray_loss(ms, view, rec, hp.ior, hp.ext_ior)
            if silhouette:
                silhouette_loss(ms, view, rec,
                                default_silhouette_budget(ms.num_edges),
                                *RES)
        out[mesh] = (ms, (ms.vertices, ms.faces, ms.face_valid),
                     [(qn, o, d, coh) if coherent else (qn, o, d)
                      for qn, (o, d, coh) in zip(S.QUERY_NAMES, rec.queries)
                      if coherent or not coh])
    return out


def resort_ab(dev, card, table=None):
    """The A/B of the two incoherent routes; writes the port's table (to
    `table`, or where `get_intersect_fn` reads it)."""
    import torch
    import chip_smoke as S
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.api import RESORT_TABLE, get_intersect_fn
    from drt_tpu_torch.intersect.resort import morton_keys

    fn_ray = get_intersect_fn("cuda", incoherent="ray")
    fn_res = get_intersect_fn("cuda", incoherent="resort")
    rows = []
    meshes = ("dog_mid20k", "dog_mid45k", "dog_mid90k")
    for mesh, (ms, geom, queries) in incoherent_queries(dev, meshes).items():
        total = {"ray": 0.0, "resort": 0.0}
        row = {"mesh": mesh, "capture": CAPTURE_OF[mesh],
               "faces": ms.num_faces, "faces_padded": int(ms.faces.shape[0]),
               "rays": int(queries[0][1].shape[0])}
        for qn, o, d in queries:
            h_ray = fn_ray(o, d, *geom, coherent=False)
            h_res = fn_res(o, d, *geom, coherent=False)
            same = bool(torch.equal(h_ray.tri_id, h_res.tri_id)
                        and torch.equal(h_ray.t, h_res.t))
            if not same:
                sys.exit(f"tune_torch_oracle: {mesh} {qn}: the two routes "
                         "give different hits")
            ms_q = {"ray": [], "resort": []}
            for route in ("ray", "resort", "resort", "ray"):
                fn = fn_ray if route == "ray" else fn_res
                ms_q[route].append(S.cuda_ms(
                    lambda: fn(o, d, *geom, coherent=False), 10))
            # the parts of the resorted route
            ms_sort = S.cuda_ms(lambda: torch.argsort(
                morton_keys(o, d), stable=True), 10)
            order = torch.argsort(morton_keys(o, d), stable=True)
            os_, ds_ = o[order], d[order]
            shift = o.float().mean(dim=0)
            ms_gather = S.cuda_ms(lambda: (o[order], d[order]), 10)
            ms_prep = S.cuda_ms(lambda: CK.prepare_inputs(
                os_, ds_, *geom, coherent=True, shift=shift), 10)
            inp_res = CK.prepare_inputs(os_, ds_, *geom, coherent=True,
                                        shift=shift)
            inp_ray = CK.prepare_inputs(o, d, *geom, coherent=False)
            ms_k_res = S.cuda_ms(lambda: CK.closest_hit_cuda(inp_res), 10)
            ms_k_ray = S.cuda_ms(lambda: CK.closest_hit_cuda(inp_ray), 10)
            ms_prep_ray = S.cuda_ms(lambda: CK.prepare_inputs(
                o, d, *geom, coherent=False), 10)
            r, s = (sum(ms_q[k]) / 2 for k in ("ray", "resort"))
            total["ray"] += r
            total["resort"] += s
            row[qn] = {"ray_ms": ms_q["ray"], "resort_ms": ms_q["resort"],
                       "hits": int(h_ray.hit.sum()),
                       "ray_group": inp_ray.group,
                       "resort_group": inp_res.group}
            print(f"{mesh} {qn}: hits equal bit for bit: {same} "
                  f"({int(h_ray.hit.sum())} hits; groups {inp_ray.group} "
                  f"/ {inp_res.group}); ray "
                  f"{ms_q['ray'][0]:.3f} / {ms_q['ray'][1]:.3f} ms, resort "
                  f"{ms_q['resort'][0]:.3f} / {ms_q['resort'][1]:.3f} ms a "
                  f"query. ray: stages {ms_prep_ray:.3f}, kernel "
                  f"{ms_k_ray:.3f} (listed boxes "
                  f"{int(inp_ray.count.sum())} over "
                  f"{inp_ray.count.shape[0]} tiles). resort: keys and sort "
                  f"{ms_sort:.3f}, two gathers {ms_gather:.3f}, stages with "
                  f"the tile prepass {ms_prep:.3f}, kernel {ms_k_res:.3f} "
                  f"(listed boxes {int(inp_res.count.sum())} over "
                  f"{inp_res.count.shape[0]} tiles)", flush=True)
        row["ray_ms"], row["resort_ms"] = total["ray"], total["resort"]
        row["winner"] = "resort" if total["resort"] < total["ray"] else "ray"
        print(f"{mesh} (capture of {CAPTURE_OF[mesh]}): both incoherent ray "
              f"queries: ray "
              f"{total['ray']:.3f} ms, resort {total['resort']:.3f} ms -> "
              f"{row['winner']}", flush=True)
        rows.append(row)
    table = table or RESORT_TABLE
    os.makedirs(os.path.dirname(os.path.abspath(table)), exist_ok=True)
    with open(table, "w") as fh:
        json.dump({"device": card, "script":
                   "scripts/tune_torch_oracle.py --what resort",
                   "rows": rows}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {table}")


GROUPS = (1, 4, 16)


def query_profile(fn, reps=5):
    """(device operations a call, their busy ms a call, host ms a call) of
    fn: the operations and the sum of their spans from torch.profiler, the
    host time by the clock from the call to its return, the device idle at
    its start and not waited for."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    host = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in ops)
    return len(ops) / reps, busy / reps / 1e3, host / reps * 1e3


def group_ab(dev, card, out):
    """Groups of 1, 4 and 16 chunks on the incoherent queries; writes the
    times and the verdict to `out`."""
    import chip_smoke as S
    from drt_tpu_torch.intersect import cuda_kernel as CK

    rows, verdict = [], {}
    data = incoherent_queries(dev, ("dog_mid45k", "dog_mid90k"),
                              silhouette=True)
    for mesh, (ms, geom, queries) in data.items():
        # a step's incoherent queries (a train step makes 8 silhouette
        # queries): each group's two turns and group 1's two turns beside
        # them
        sums = {g: {"group": [0.0, 0.0], "group_1": [0.0, 0.0]}
                for g in GROUPS[1:]}
        for qn, o, d in queries:
            ref = CK.intersect_cuda(o, d, *geom, coherent=False, group=1)
            row = {"mesh": mesh, "capture": CAPTURE_OF[mesh], "query": qn,
                   "rays": int(o.shape[0]), "faces": ms.num_faces,
                   "faces_padded": int(ms.faces.shape[0]),
                   "hits": int(ref.hit.sum()), "groups": {}}
            runs = {}
            for g in GROUPS:
                h = CK.intersect_cuda(o, d, *geom, coherent=False, group=g)
                S.compare_hits(f"{mesh} {qn} group {g} vs group 1", ref.t,
                               ref.tri_id, h.t, h.tri_id)
                inp = CK.prepare_inputs(o, d, *geom, coherent=False, group=g)
                args = S.prepass_args(o, geom, inp)
                boxes = args[2:5]
                runs[g] = (inp, args)
                n_ops, busy, host = query_profile(
                    lambda: CK.intersect_cuda(o, d, *geom, coherent=False,
                                              group=g))
                row["groups"][g] = {
                    "device_ops": n_ops, "device_busy_ms": busy,
                    "host_ms": host,
                    "boxes": int(boxes[0].shape[0]),
                    "valid_boxes": int(boxes[2].sum()),
                    "listed": int(inp.count.sum()),
                    "entries": int(inp.count.sum()) * g,
                    "tri_id_differ": int((h.tri_id != ref.tri_id).sum()),
                    "query_ms": [], "prepass_ms": [], "closest_hit_ms": []}
            for g in GROUPS[1:]:
                for k, turn in enumerate((1, g, g, 1)):
                    r = row["groups"][turn]
                    inp, args = runs[turn]
                    q = S.cuda_ms(lambda: CK.intersect_cuda(
                        o, d, *geom, coherent=False, group=turn), 10)
                    r["query_ms"].append(q)
                    pre = S.cuda_ms(
                        lambda: CK.candidates_cuda(*args, tile=False), 10)
                    hit = S.cuda_ms(lambda: CK.closest_hit_cuda(inp), 10)
                    r["prepass_ms"].append(pre)
                    r["closest_hit_ms"].append(hit)
                    side = "group_1" if turn == 1 else "group"
                    sums[g][side][0 if k in (0, 1) else 1] += (pre + hit) * (
                        8 if qn == "silhouette" else 1)
            for g in GROUPS:
                r = row["groups"][g]
                print(f"{mesh} {qn}: group {g}: {r['valid_boxes']} of "
                      f"{r['boxes']} boxes valid, {r['listed']} listed, "
                      f"{r['entries']} chunk entries walked, "
                      f"{r['tri_id_differ']} tri_ids differ from group 1; "
                      f"a query: {r['device_ops']:g} device operations busy "
                      f"{r['device_busy_ms']:.4f} ms, host "
                      f"{r['host_ms']:.4f} ms; "
                      f"query {_fmt(r['query_ms'])} ms, prepass "
                      f"{_fmt(r['prepass_ms'])} ms, closest hit "
                      f"{_fmt(r['closest_hit_ms'])} ms", flush=True)
            rows.append(row)
        faster = [g for g in GROUPS[1:]
                  if max(sums[g]["group"]) < min(sums[g]["group_1"])]
        verdict[mesh] = {"faces_padded": int(ms.faces.shape[0]),
                         "step_kernel_ms": sums, "faster": faster}
        print(f"{mesh}: a step's incoherent queries (bounce 2, exit, 8 "
              f"silhouette views), prepass + closest hit ms in turns: "
              f"{sums}; faster than group 1 beyond the spread: "
              f"{faster or 'none'}", flush=True)
    both = [g for g in GROUPS[1:]
            if all(g in v["faster"] for v in verdict.values())]
    for mesh, v in verdict.items():
        v["group"] = v["faster"][0] if both else 1
        print(f"{mesh}: group=None takes group {v['group']} for incoherent "
              "queries")
    print(f"groups faster than group 1 on both meshes: {both or 'none'}")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"device": card, "script":
                   "scripts/tune_torch_oracle.py --what group",
                   "rows": rows, "verdict": verdict,
                   "faster_on_both": both}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out}")


def parent_defaults(queries, incoherent, parent):
    """Hits at the defaults against the tree at `parent` (its kernels built
    from its own csrc/ into its own build/): bit for bit where both take
    the same group, else within the tie allowance; and both kernels of
    both trees in turns, the prepass on the boxes this tree scored."""
    import importlib.util
    import torch
    import chip_smoke as S
    from drt_tpu_torch.intersect import cuda_kernel as CK
    spec = importlib.util.spec_from_file_location(
        "parent_cuda_kernel",
        os.path.join(parent, "drt_tpu_torch", "intersect", "cuda_kernel.py"))
    P = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(P)          # builds its kernels at first use
    for name, o, d, geom, coh in queries + incoherent:
        new = CK.intersect_cuda(o, d, *geom, coherent=coh)
        old = P.intersect_cuda(o, d, *geom, coherent=coh)
        same = bool(torch.equal(new.t, old.t)
                    and torch.equal(new.tri_id, old.tri_id))
        inp_n = CK.prepare_inputs(o, d, *geom, coherent=coh)
        inp_o = P.prepare_inputs(o, d, *geom, coherent=coh)
        if inp_n.group == inp_o.group and not same:
            sys.exit(f"tune_torch_oracle: {name}: hits at the defaults differ "
                     "from the parent tree's")
        S.compare_hits(f"defaults: {name} (group {inp_n.group}) vs the "
                       "parent tree", old.t, old.tri_id, new.t, new.tri_id)
        o_args = (inp_o.phi[6:9], inp_o.inv,
                  *CK._chunk_aabbs(*geom, o.float().mean(dim=0),
                                   CK.TRI_CHUNK), inp_o.count.shape[0])
        n_args = S.prepass_args(o, geom, inp_n)
        ms = {"parent": {"closest_hit": [], "prepass": []},
              "this": {"closest_hit": [], "prepass": []}}
        for side in ("parent", "this", "this", "parent"):
            M, inp, args = ((P, inp_o, o_args) if side == "parent"
                            else (CK, inp_n, n_args))
            ms[side]["closest_hit"].append(S.cuda_ms(
                lambda: M.closest_hit_cuda(inp), 20))
            ms[side]["prepass"].append(S.cuda_ms(
                lambda: M.candidates_cuda(*args, tile=coh), 20))
        print(f"defaults: {name}: group {inp_n.group}, hits equal the "
              f"parent tree's bit for bit: {same} "
              f"({int(new.hit.sum())} hits); closest hit parent "
              f"{_fmt(ms['parent']['closest_hit'])} ms, this "
              f"{_fmt(ms['this']['closest_hit'])} ms; prepass parent "
              f"{_fmt(ms['parent']['prepass'])} ms, this "
              f"{_fmt(ms['this']['prepass'])} ms", flush=True)


def step_turns(step, state, lr, mesh, views, n=5):
    """ms of n steps (host clock, synchronized) after a warm-up, from
    `state` on the same views each time."""
    import torch
    step(state, lr, mesh, views, 0, list(range(8)))
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(state, lr, mesh, views, 0, list(range(8)))
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def step_profile(make_step, mesh, views, lr):
    """(device operations of one step, of them inside the oracle's ranges,
    their busy ms) under torch.profiler, each query in a range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from drt_tpu_torch.intersect.api import get_intersect_fn
    base = get_intersect_fn("auto")

    def traced(*args, **kwargs):
        with record_function("oracle query"):
            return base(*args, **kwargs)
    init, step = make_step(traced)
    state = init(mesh)
    step(state, lr, mesh, views, 0, list(range(8)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, lr, mesh, views, 0, list(range(8)))
        torch.cuda.synchronize()
    dev_t = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "oracle query" and e.device_type == dev_t]
    ops = [e for e in events
           if e.device_type == dev_t and e.name != "oracle query"]
    inside = sum(any(a <= k.time_range.start and k.time_range.end <= b
                     for a, b in spans) for k in ops)
    busy = sum(k.time_range.end - k.time_range.start for k in ops) / 1e3
    return len(ops), inside, busy


def pack_ab(dev, card, out):
    """The packing kernel against the plain stages it replaced, a query of
    each kind on three meshes and a train step, in turns; writes `out`."""
    import torch
    import chip_smoke as S
    from drt_tpu_torch.config import POINTGRAY_RES as RES, HyperParams
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import (LossWeights,
                                        default_silhouette_budget,
                                        make_train_step)
    kernel_pack = CK.pack

    def use(side):
        CK.pack = kernel_pack if side == "kernel" else CK.pack_plain

    rows = []
    meshes = ("dog_mid20k", "dog_mid45k", "dog_mid90k")
    try:
        data = incoherent_queries(dev, meshes, silhouette=True,
                                  coherent=True)
        for mesh, (ms, geom, queries) in data.items():
            for qn, o, d, coh in queries:
                hits = {}
                for side in ("plain", "kernel"):
                    use(side)
                    hits[side] = CK.intersect_cuda(o, d, *geom, coherent=coh)
                same = bool(torch.equal(hits["plain"].t, hits["kernel"].t)
                            and torch.equal(hits["plain"].tri_id,
                                            hits["kernel"].tri_id))
                if not same:
                    sys.exit(f"tune_torch_oracle: {mesh} {qn}: the packing "
                             "kernel's hits differ from the plain stages'")
                row = {"mesh": mesh, "capture": CAPTURE_OF[mesh],
                       "query": qn, "coherent": coh,
                       "rays": int(o.shape[0]), "faces": ms.num_faces,
                       "faces_padded": int(ms.faces.shape[0]),
                       "hits": int(hits["kernel"].hit.sum()),
                       "group": CK.prepare_inputs(
                           o, d, *geom, coherent=coh).group}
                for side in ("plain", "kernel"):
                    use(side)
                    n_ops, busy, host = query_profile(
                        lambda: CK.intersect_cuda(o, d, *geom, coherent=coh))
                    row[side] = {"device_ops": n_ops,
                                 "device_busy_ms": busy, "host_ms": host,
                                 "query_ms": []}
                for side in ("plain", "kernel", "kernel", "plain"):
                    use(side)
                    row[side]["query_ms"].append(S.cuda_ms(
                        lambda: CK.intersect_cuda(o, d, *geom,
                                                  coherent=coh), 10))
                rows.append(row)
                print(f"{mesh} {qn} (group {row['group']}): hits equal bit "
                      f"for bit ({row['hits']} hits); " + "; ".join(
                          f"{side}: query {_fmt(row[side]['query_ms'])} ms, "
                          f"{row[side]['device_ops']:g} device operations "
                          f"busy {row[side]['device_busy_ms']:.4f} ms, host "
                          f"{row[side]['host_ms']:.4f} ms"
                          for side in ("plain", "kernel")), flush=True)
        del data
        # the reference-parity step of chip_smoke.py phase 5
        hp = HyperParams()
        v90, f90 = load_ply(os.path.join(S.MESH_DIR, "dog_mid90k.ply"))
        cap = synthesize_capture(v90, f90, name="dog", num_views=8,
                                 resy=RES[0], resx=RES[1], ior=hp.ior,
                                 ext_ior=hp.ext_ior, num_view_used=8,
                                 device=dev)
        ms45 = build_mesh_state(*load_ply(os.path.join(
            S.MESH_DIR, "dog_mid45k.ply")), device=dev)
        weights = LossWeights(ray_w=hp.ray_w, vh_w=hp.vh_w, sm_w=hp.sm_w,
                              ior=hp.ior, ext_ior=hp.ext_ior)
        budget = default_silhouette_budget(ms45.num_edges)

        def make_step(fn):
            init, step, _ = make_train_step(fn, weights, *RES, budget,
                                            momentum=hp.momentum,
                                            grad_clamp=hp.grad_clamp)
            return init, step
        from drt_tpu_torch.intersect.api import get_intersect_fn
        init, step = make_step(get_intersect_fn("auto"))
        state = init(ms45)
        step_row = {"mesh": "dog_mid45k", "capture": "dog_mid90k, 8 views",
                    "rays": RES[0] * RES[1], "silhouette_views": 8,
                    "budget": budget}
        for side in ("plain", "kernel"):
            use(side)
            n_ops, inside, busy = step_profile(make_step, ms45, cap.views,
                                               hp.start_lr)
            step_row[side] = {"device_ops": n_ops, "oracle_ops": inside,
                              "device_busy_ms": busy, "step_ms": []}
        for side in ("plain", "kernel", "kernel", "plain"):
            use(side)
            step_row[side]["step_ms"].append(step_turns(
                step, state, hp.start_lr, ms45, cap.views))
        for side in ("plain", "kernel"):
            r = step_row[side]
            r["median_ms"] = [statistics.median(x) for x in r["step_ms"]]
            print(f"step ({side}): {r['device_ops']} device operations, "
                  f"{r['oracle_ops']} inside the oracle, busy "
                  f"{r['device_busy_ms']:.3f} ms; medians in turns "
                  f"{_fmt(r['median_ms'])} ms; all "
                  f"{[_fmt(x) for x in r['step_ms']]}", flush=True)
    finally:
        CK.pack = kernel_pack
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"device": card, "script":
                   "scripts/tune_torch_oracle.py --what pack",
                   "turns": "plain, kernel, kernel, plain",
                   "queries": rows, "step": step_row}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out}")


def scatter_ab(dev, card, out):
    """The scatter kernel against the parent's path: the step in turns, and
    `_GatherTri9`'s two forward and two backward routes on three meshes;
    writes `out`."""
    import torch
    import chip_smoke as S
    import drt_tpu_torch.render.trace as TR
    from drt_tpu_torch.config import POINTGRAY_RES as RES, HyperParams
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.geometry.scatter import scatter_rows
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import (LossWeights,
                                        default_silhouette_budget,
                                        make_train_step)
    from drt_tpu_torch.optimize.losses import ray_loss
    import drt_tpu_torch.geometry.metrics as M
    import drt_tpu_torch.geometry.normals as N
    import drt_tpu_torch.geometry.scatter as SC
    import drt_tpu_torch.optimize.losses as L
    import drt_tpu_torch.render.silhouette as SIL

    class ParentGatherTri9(torch.autograd.Function):
        """The parent's `_GatherTri9`: one direct `index_add_` of the [3N,3]
        cotangent rows (float atomics on the card)."""

        @staticmethod
        def forward(ctx, vertices, faces, safe_id):
            idx3 = faces[safe_id].reshape(-1)
            ctx.save_for_backward(idx3)
            ctx.num_vertices = vertices.shape[0]
            return vertices[idx3].reshape(-1, 9)

        @staticmethod
        def backward(ctx, g9):
            (idx3,) = ctx.saved_tensors
            return g9.new_zeros((ctx.num_vertices, 3)).index_add_(
                0, idx3, g9.reshape(-1, 3)), None, None

    def parent_scatter(rows, idx, num):
        return rows.new_zeros((num, rows.shape[1])).index_add(0, idx, rows)

    kernel_tri9 = TR._GatherTri9

    def use(side):
        """Point the step's gathers and scatters at the kernel (the modules
        as they are) or at the parent's torch path: advanced indexing and
        `index_add`."""
        kernel = side == "kernel"
        gather = SC.gather_rows if kernel else (lambda x, idx: x[idx])
        scatter = SC.scatter_rows if kernel else parent_scatter
        M.gather_rows = SIL.gather_rows = N.gather_rows = gather
        N.scatter_rows = L.scatter_rows = scatter
        TR._GatherTri9 = kernel_tri9 if kernel else ParentGatherTri9

    hp = HyperParams()
    caps = {}

    def capture(src, views):
        if (src, views) not in caps:
            v, f = load_ply(os.path.join(S.MESH_DIR, f"{src}.ply"))
            caps[(src, views)] = synthesize_capture(
                v, f, name="dog", num_views=views, resy=RES[0], resx=RES[1],
                ior=hp.ior, ext_ior=hp.ext_ior, num_view_used=views,
                device=dev)
        return caps[(src, views)]

    try:
        # the reference-parity step of chip_smoke.py phase 5
        cap = capture("dog_mid90k", 8)
        ms45 = build_mesh_state(*load_ply(os.path.join(
            S.MESH_DIR, "dog_mid45k.ply")), device=dev)
        weights = LossWeights(ray_w=hp.ray_w, vh_w=hp.vh_w, sm_w=hp.sm_w,
                              ior=hp.ior, ext_ior=hp.ext_ior)
        budget = default_silhouette_budget(ms45.num_edges)

        def make_step(fn):
            init, step, _ = make_train_step(fn, weights, *RES, budget,
                                            momentum=hp.momentum,
                                            grad_clamp=hp.grad_clamp)
            return init, step
        init, step = make_step(get_intersect_fn("auto"))
        state = init(ms45)
        step_row = {"mesh": "dog_mid45k", "capture": "dog_mid90k, 8 views",
                    "rays": RES[0] * RES[1], "silhouette_views": 8,
                    "budget": budget,
                    "faces_padded": int(ms45.faces.shape[0])}
        for side in ("parent", "kernel"):
            use(side)
            n_ops, inside, busy = step_profile(make_step, ms45, cap.views,
                                               hp.start_lr)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            CK.counters.reset()
            new, _, _ = step(state, hp.start_lr, ms45, cap.views, 0,
                             list(range(8)))
            torch.cuda.synchronize()
            step_row[side] = {
                "device_ops": n_ops, "oracle_ops": inside,
                "device_busy_ms": busy,
                "scatter_launches": CK.counters.scatter_launches,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "step_ms": []}
            twice, _, _ = step(state, hp.start_lr, ms45, cap.views, 0,
                               list(range(8)))
            step_row[side]["two_steps_same_bits"] = bool(
                torch.equal(new["m"], twice["m"])
                and torch.equal(new["params"], twice["params"]))
            step_row[side]["m"] = new["m"]
        dm = step_row["kernel"].pop("m") - step_row["parent"].pop("m")
        step_row["update_max_abs_diff"] = float(dm.abs().max())
        for side in ("parent", "kernel", "kernel", "parent"):
            use(side)
            step_row[side]["step_ms"].append(step_turns(
                step, state, hp.start_lr, ms45, cap.views))
        for side in ("parent", "kernel"):
            r = step_row[side]
            r["median_ms"] = [statistics.median(x) for x in r["step_ms"]]
            print(f"step ({side}): {r['device_ops']} device operations, "
                  f"busy {r['device_busy_ms']:.3f} ms, "
                  f"{r['scatter_launches']} scatter launches, two steps "
                  f"from one state give the same bits "
                  f"{r['two_steps_same_bits']}, peak "
                  f"{r['peak_gib']:.2f} GiB; medians in turns "
                  f"{_fmt(r['median_ms'])} ms; all "
                  f"{[_fmt(x) for x in r['step_ms']]}", flush=True)
        print(f"step: the momentum after one step differs by "
              f"{step_row['update_max_abs_diff']:g} at most between the "
              "two paths", flush=True)
        use("kernel")
        del state

        # _GatherTri9's routes on both bounces' inputs and cotangents
        routes = []
        base = kernel_tri9
        for mesh in ("dog_mid20k", "dog_mid45k", "dog_mid90k"):
            rec, fwd = [], []

            class Recording(base):
                @staticmethod
                def forward(ctx, vertices, faces, safe_id):
                    fwd.append(vertices.detach().clone())
                    return base.forward(ctx, vertices, faces, safe_id)

                @staticmethod
                def backward(ctx, g9):
                    faces, safe_id = ctx.saved_tensors
                    rec.append((g9.detach().clone(), faces, safe_id,
                                ctx.num_vertices))
                    return base.backward(ctx, g9)
            ms = build_mesh_state(*load_ply(os.path.join(
                S.MESH_DIR, f"{mesh}.ply")), device=dev)
            view = capture(CAPTURE_OF[mesh], 1).views.take(0)
            TR._GatherTri9 = Recording
            try:
                v = ms.vertices.clone().requires_grad_(True)
                loss, _ = ray_loss(ms.with_vertices(v), view,
                                   get_intersect_fn("auto"), hp.ior,
                                   hp.ext_ior)
                loss.backward()
            finally:
                TR._GatherTri9 = base
            for b, ((g9, faces, safe_id, V), verts) in enumerate(
                    zip(rec, reversed(fwd))):       # backward runs last first
                F = faces.shape[0]

                def fwd_soup():
                    return verts[faces.reshape(-1)].reshape(-1, 9)[safe_id]

                def fwd_direct():
                    return verts[faces[safe_id].reshape(-1)].reshape(-1, 9)

                def soup():
                    return scatter_rows(scatter_rows(g9, safe_id, F)
                                        .reshape(-1, 3), faces.reshape(-1), V)

                def direct():
                    return scatter_rows(g9.reshape(-1, 3),
                                        faces[safe_id].reshape(-1), V)

                def parent():
                    return g9.new_zeros((V, 3)).index_add_(
                        0, faces[safe_id].reshape(-1), g9.reshape(-1, 3))
                d_s, d_d = soup(), direct()
                row = {"mesh": mesh, "capture": CAPTURE_OF[mesh],
                       "backward": b, "rays": int(g9.shape[0]),
                       "faces_padded": int(F), "vertices_padded": int(V),
                       "live_rows": int((g9 != 0).any(dim=1).sum()),
                       "route_taken": "soup" if F <= TR._SOUP_BWD_MAX_FACES
                       else "direct",
                       "soup_direct_same_bits": bool(torch.equal(d_s, d_d)),
                       "soup_direct_max_abs_diff":
                           float((d_s - d_d).abs().max()),
                       "soup_ms": [], "direct_ms": [],
                       "parent_index_add_ms": S.cuda_ms(parent, 20),
                       "forward_route_taken": "soup" if g9.shape[0] >= F
                       else "direct",
                       "forward_same_bits": bool(torch.equal(
                           fwd_soup(), fwd_direct())),
                       "forward_soup_ms": [], "forward_direct_ms": []}
                for side in ("soup", "direct", "direct", "soup"):
                    row[f"{side}_ms"].append(S.cuda_ms(
                        soup if side == "soup" else direct, 20))
                    row[f"forward_{side}_ms"].append(S.cuda_ms(
                        fwd_soup if side == "soup" else fwd_direct, 20))
                routes.append(row)
                print(f"{mesh} backward {b} (Fp {F}, {row['live_rows']} of "
                      f"{row['rays']} cotangent rows not zero, takes "
                      f"{row['route_taken']}): soup "
                      f"{_fmt(row['soup_ms'])} ms, direct "
                      f"{_fmt(row['direct_ms'])} ms in turns, the parent's "
                      f"index_add_ {row['parent_index_add_ms']:.4f} ms; "
                      f"the routes' gradients same bits "
                      f"{row['soup_direct_same_bits']}, max |diff| "
                      f"{row['soup_direct_max_abs_diff']:g}; forward "
                      f"(takes {row['forward_route_taken']}) soup "
                      f"{_fmt(row['forward_soup_ms'])} ms, direct "
                      f"{_fmt(row['forward_direct_ms'])} ms in turns, same "
                      f"bits {row['forward_same_bits']}", flush=True)
            del ms, rec, fwd
    finally:
        use("kernel")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"device": card, "script":
                   "scripts/tune_torch_oracle.py --what scatter",
                   "turns": "parent, kernel, kernel, parent (step); soup, "
                            "direct, direct, soup (routes)",
                   "step": step_row, "routes": routes}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out}")


def scatter_routes(dev, card, out):
    """The scatter kernel's two routes on every scatter call of the
    reference-parity step (sgd + none, 1 ray view + 8 silhouette views of
    1280x960) on dog_mid{20k,45k,90k}, each mesh under an 8-view capture of
    another: the calls recorded from the step itself, then on each call
    both routes and `index_add_` (zeros and the add, the same function) in
    turns under torch.profiler (device time, span and device operations, 5
    runs each), both routes' calls with the wrapper (CUDA events), the
    route `scatter_route` takes, and the call's bound (bytes: rows and
    indices read once, output written once). The routes must give the same
    bits. Writes `out`."""
    import torch
    import chip_smoke as S
    from drt_tpu_torch.config import POINTGRAY_RES as RES, HyperParams
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import (LossWeights,
                                        default_silhouette_budget,
                                        make_train_step)
    import drt_tpu_torch.geometry.scatter as SC

    hp = HyperParams()
    weights = LossWeights(ray_w=hp.ray_w, vh_w=hp.vh_w, sm_w=hp.sm_w,
                          ior=hp.ior, ext_ior=hp.ext_ior)
    rows_out = []
    for mesh in ("dog_mid20k", "dog_mid45k", "dog_mid90k"):
        v, f = load_ply(os.path.join(S.MESH_DIR, f"{CAPTURE_OF[mesh]}.ply"))
        cap = synthesize_capture(v, f, name="dog", num_views=8, resy=RES[0],
                                 resx=RES[1], ior=hp.ior, ext_ior=hp.ext_ior,
                                 num_view_used=8, device=dev)
        ms = build_mesh_state(*load_ply(os.path.join(
            S.MESH_DIR, f"{mesh}.ply")), device=dev)
        budget = default_silhouette_budget(ms.num_edges)
        init, step, _ = make_train_step(get_intersect_fn("auto"), weights,
                                        *RES, budget, momentum=hp.momentum,
                                        grad_clamp=hp.grad_clamp)
        state = init(ms)
        step(state, hp.start_lr, ms, cap.views, 0, list(range(8)))
        recorded = []
        with S.scatter_spy(recorded):
            step(state, hp.start_lr, ms, cap.views, 1, list(range(8)))
            torch.cuda.synchronize()
        del cap, state
        for i, (rows, idx, num, _, _) in enumerate(recorded):
            R, C = rows.shape
            calls = {r: (lambda r=r: SC.scatter_rows_cuda(rows, idx, num,
                                                          route=r))
                     for r in SC.ROUTES}
            calls["index_add_"] = lambda: rows.new_zeros(num, C).index_add_(
                0, idx, rows)
            spans = S.device_spans(calls)
            outs = {r: calls[r]() for r in SC.ROUTES}
            same = S.same_bits(outs["cluster"], outs["grid"])
            if not same:
                sys.exit(f"scatter routes: {mesh} call {i} differs between "
                         "the routes")
            size = rows.element_size()
            live_idx = idx[(rows != 0).any(dim=1)]
            runs = torch.bincount(live_idx, minlength=1) if live_idx.numel() \
                else torch.zeros(1, dtype=torch.int64, device=dev)
            row = {"mesh": mesh, "call": i, "rows": R, "cols": C, "num": num,
                   "live": int(live_idx.numel()),
                   "longest_run": int(runs.max()),
                   "runs": int((runs > 0).sum()),
                   "route_taken": SC.scatter_route(R, C, num),
                   "bound_ms": (R * C * size + R * 8 + num * C * size)
                   / S.HBM_RATE * 1e3, "routes_same_bits": same,
                   "device": spans,
                   "call_ms": {r: S.cuda_ms(calls[r], 20)
                               for r in SC.ROUTES}}
            rows_out.append(row)
            print(f"{mesh} call {i}: {R} rows of {C} ({row['live']} live, "
                  f"{row['runs']} runs, the longest {row['longest_run']}) "
                  f"into {num}, takes {row['route_taken']}, bound "
                  f"{row['bound_ms']:.4f} ms; device ms (span, ops) "
                  + ", ".join(f"{k} {d['ms']:.4f} ({d['span_ms']:.4f}, "
                              f"{d['ops']})" for k, d in spans.items())
                  + "; grid route by operation "
                  + ", ".join(f"{k} {t:.4f}" for k, t in
                              spans["grid"]["by_op"].items())
                  + "; with the wrapper "
                  + ", ".join(f"{k} {t:.4f}"
                              for k, t in row["call_ms"].items()),
                  flush=True)
        del ms, recorded
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"device": card, "script":
                   "scripts/tune_torch_oracle.py --what scatter-routes",
                   "cluster_size": SC.cluster_size(),
                   "cluster_max_rows": SC.CLUSTER_MAX_ROWS,
                   "cluster_max_out": SC.CLUSTER_MAX_OUT,
                   "calls": rows_out}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out}")


# (rows, live share, destinations) of the scatter-trace cases: a
# silhouette view, a soup's second stage, the normals (dog_mid45k), and one
# run of 4,096 rows (the fold's cost a window of a long run)
TRACE_CASES = ((32768, 0.034, 32768), (196608, 0.06, 32768),
               (196608, 0.6, 32768), (4096, 1.0, 1))
TRACE_PHASES = ("zero and key", "syncthreads_or", "count", "warp prefix",
                "cluster.sync A", "cluster prefix", "place",
                "cluster.sync B")


def scatter_trace(dev, card, reps=20):
    """Where a launch of the scatter kernel's cluster route spends its
    time: a library built with -DSCATTER_TRACE=1 stamps clock64() at each
    phase boundary of CTA 0's thread 0; on TRACE_CASES (float32, 3
    columns, seeded), the median over `reps` launches of each phase's
    cycles, and the SM clock nvidia-smi reads beside them."""
    import ctypes
    import numpy as np
    import torch
    from drt_tpu_torch import kernels
    from drt_tpu_torch.geometry.scatter import ROUTES
    lib = kernels.bind(kernels.build(defines=("SCATTER_TRACE=1",)))
    entry = "?"
    for line in kernels.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        if "scatter" in entry and ("registers" in line or "stack" in line):
            print(f"ptxas {entry[:40]}: {line.strip()}")
    lib.scatter_trace_read.argtypes = [ctypes.c_void_p]
    stamps = np.zeros(64, dtype=np.int64)
    rng = np.random.default_rng(0)
    for n_rows, live, num in TRACE_CASES:
        rows = rng.standard_normal((n_rows, 3)).astype(np.float32)
        rows[rng.random(n_rows) >= live] = 0.0
        rows = torch.from_numpy(rows).to(dev)
        idx = torch.from_numpy(rng.integers(0, num, n_rows)).to(dev)
        out = torch.empty((num, 3), device=dev)
        code = ROUTES.index("cluster")
        scratch = torch.empty(lib.scatter_scratch_ints(n_rows, num, code),
                              dtype=torch.int32, device=dev)
        runs = []
        for _ in range(reps + 1):
            lib.scatter_trace_clear()
            err = lib.scatter_launch(rows.data_ptr(), 0, idx.data_ptr(),
                                     n_rows, 3, num, code, out.data_ptr(),
                                     scratch.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
            kernels.check(lib, err, "scatter (traced)")
            torch.cuda.synchronize()
            lib.scatter_trace_read(stamps.ctypes.data)
            runs.append(stamps.copy())
        runs = np.stack(runs[1:])
        last = int(np.flatnonzero(runs[0, :32])[-1])
        steps = np.diff(runs[:, :last + 1], axis=1)
        names = ["zero and key", "syncthreads_or"] + [
            f"pass {p} {n}" for p in range((last - 3) // 6)
            for n in TRACE_PHASES[2:]]
        names += ["fold"]
        med = np.median(steps, axis=0)
        fold = np.median(runs[:, 32:64], axis=0).reshape(8, 4)
        windows = [(int(f[1] - f[0]), int(f[2] - f[1]), int(f[3] - f[2]))
                   for f in fold if f[0] and f[3]]
        print(f"scatter-trace: {n_rows} rows ({live:.0%} live) into {num}: "
              f"{int(np.median(runs[:, last] - runs[:, 0]))} cycles; "
              + ", ".join(f"{n} {int(c)}" for n, c in zip(names, med))
              + f"; the fold's first windows in block 0 (load, sum, rest) "
              f"{windows}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"scatter-trace: {card}; SM clock now, max: {smi.stdout.strip()}")


# The one-origin route's shapes measured: (ray tile, group, rays a warp,
# warps a closest-hit block, sorted lanes, key bits an axis). Unsorted
# lanes take an identity order: the parent's lanes and group with the
# route's warps.
SILHOUETTE_SHAPES = (
    [(t, g, 4, 2, True, 5) for t in (32, 64, 128) for g in (1, 4)]
    + [(128, 1, lanes, warps, True, 5) for lanes, warps in
       ((8, 2), (32, 2), (4, 1))]
    + [(128, 1, 4, 2, True, 8), (128, 4, 4, 2, False, 5)])
ORDER_BITS = (5, 8)


def kernel_profile(fn, reps=10, tries=3):
    """(device operations a call, busy ms a call, {kernel: ms a call}) of
    fn under torch.profiler, after one call outside it. A profile whose
    operations are no whole number a call lost some; it is taken again,
    up to `tries` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {}
        n = 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            n += 1
            key = e.name.split("(")[0].split("<")[0].replace("void ", "")
            by[key] = by.get(key, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 1e3 / reps
        if n and n % reps == 0:
            break
    return n / reps, sum(by.values()), by


def order_kernel_ms(queries, bits_set, reps=50):
    """{bits: {name: ms}}: csrc/order.cu built with -DORDER_AXIS_BITS=bits
    (a library of its own under build/) on each query's directions, by
    CUDA events over `reps` launches."""
    import ctypes
    import torch
    from drt_tpu_torch import kernels as KN
    out = {}
    for bits in bits_set:
        lib = KN.bind(KN.build(defines=(f"ORDER_AXIS_BITS={bits}",)))
        out[bits] = {}
        for name, d in queries:
            n = d.shape[0]
            order = torch.empty(n, dtype=torch.int32, device=d.device)
            scratch = torch.empty(4 * n, dtype=torch.int32, device=d.device)

            def launch():
                KN.check(lib, lib.ray_order_launch(
                    d.data_ptr(), 0, n, n, order.data_ptr(),
                    scratch.data_ptr(),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)),
                    "ray_order")
            launch()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                launch()
            end.record()
            torch.cuda.synchronize()
            out[bits][name] = start.elapsed_time(end) / reps
    return out


def _shape_name(shape):
    t, g, lanes, warps, srt, bits = shape
    return (f"{'sorted' if srt else 'unsorted'} t{t} g{g} l{lanes} w{warps} "
            f"b{bits}")


def silhouette_order(dev, card, out):
    """The one-origin route on the silhouette queries of dog_mid{20k,45k,
    90k} at their budgets (chip_smoke.silhouette_queries: 8 views of the
    ring around dog_mid90k): for each query the parent's route ("before":
    the rays as separate rows, the group of GROUP_TABLE, ray tile
    RAY_TILE_INCOHERENT, 32 rays a warp) and the route in every launch
    shape of SILHOUETTE_SHAPES ("after"): the longest and mean candidate
    list in chunk entries (count * group), hits against the parent's
    route (hit bit for bit, t and tri_id counted where they differ), a
    query's device operations, busy ms and ms by kernel (torch.profiler),
    and the whole query by CUDA events in turns. The winner is the sorted
    shape with the least busy time over all the queries; the route's
    constants are set to it by hand. Writes
    reports/torch_silhouette_order.json (or --silhouette-out PATH)."""
    import torch
    import chip_smoke as S
    from drt_tpu_torch.config import POINTGRAY_RES as RES
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.mesh import build_mesh_state, load_ply

    meshes = {m: build_mesh_state(*load_ply(os.path.join(
        S.MESH_DIR, f"{m}.ply")), device=dev)
        for m in ("dog_mid20k", "dog_mid45k", "dog_mid90k")}
    data = S.silhouette_queries(meshes, RES)
    knobs = ("RAY_TILE_ONE_ORIGIN", "GROUP_ONE_ORIGIN", "RAY_LANES_ONE_ORIGIN",
             "BLOCK_RAYS_ONE_ORIGIN", "ORDER_AXIS_BITS")
    shipped = {k: getattr(CK, k) for k in knobs}
    real_order = CK.ray_order

    cached = {}

    def plain_order(d, n_pad):
        # made once a query and width, outside the profiles (each profile
        # calls its query once before it records)
        key = (d.data_ptr(), n_pad, CK.ORDER_AXIS_BITS)
        if key not in cached:
            cached[key] = CK.ray_order_plain(d, n_pad)
        return cached[key]

    def use(shape):
        t, g, lanes, warps, srt, bits = shape
        CK.RAY_TILE_ONE_ORIGIN, CK.GROUP_ONE_ORIGIN = t, g
        CK.RAY_LANES_ONE_ORIGIN, CK.BLOCK_RAYS_ONE_ORIGIN = lanes, lanes * warps
        CK.ORDER_AXIS_BITS = bits
        # another key width: the plain order on the card (the kernel's own
        # time at that width is `order_kernel_ms`'s)
        CK.ray_order = (real_order if bits == shipped["ORDER_AXIS_BITS"]
                        else plain_order) if srt else (
            lambda d, n_pad: torch.arange(n_pad, dtype=torch.int32,
                                          device=d.device))
    names = ["before"] + [_shape_name(v) for v in SILHOUETTE_SHAPES]
    rows, total = [], {k: 0.0 for k in names}
    per_mesh = {}
    try:
        for mesh, (ms, budget, queries) in data.items():
            geom = (ms.vertices, ms.faces, ms.face_valid)
            per_mesh[mesh] = {k: 0.0 for k in names}
            for view, o, d in queries:
                row = {"mesh": mesh, "view": view, "rays": int(o.shape[0]),
                       "faces": ms.num_faces, "budget": budget}

                def before():
                    # the parent's query: the mean, the rows' copy, 3 kernels
                    return CK.intersect_cuda(o.contiguous(), d, *geom,
                                             coherent=False,
                                             shift=o.float().mean(dim=0))

                def after(shape):
                    use(shape)
                    return CK.intersect_cuda(o, d, *geom, coherent=False)
                sides = {"before": before}
                sides.update({_shape_name(v): (lambda v=v: after(v))
                              for v in SILHOUETTE_SHAPES})
                ref = before()
                row["hits"] = int(ref.hit.sum())
                for name, fn in sides.items():
                    h = fn()
                    if not torch.equal(h.hit, ref.hit):
                        sys.exit(f"tune_torch_oracle: {mesh} view {view} "
                                 f"{name}: hit differs from the parent's "
                                 "route")
                    if name == "before":
                        inp = CK.prepare_inputs(o.contiguous(), d, *geom,
                                                coherent=False)
                    else:
                        inp = CK.prepare_inputs(o, d, *geom, coherent=False)
                    cnt = (inp.count * inp.group).float()
                    ops, busy, by = kernel_profile(fn)
                    row[name] = {
                        "ray_tile": inp.phi.shape[1] // inp.count.shape[0],
                        "group": inp.group, "longest": int(cnt.max()),
                        "mean": float(cnt.mean()),
                        "t_differ": int((h.t != ref.t).sum()),
                        "tri_id_differ": int((h.tri_id != ref.tri_id).sum()),
                        "device_ops": ops, "busy_ms": busy,
                        "kernel_ms": by, "query_ms": []}
                    total[name] += busy
                    per_mesh[mesh][name] += busy
                for name in names + names[::-1]:
                    row[name]["query_ms"].append(S.cuda_ms(sides[name], 10))
                b = row["before"]
                print(f"{mesh} view {view}: {row['rays']} rays, "
                      f"{row['hits']} hits. before (tile {b['ray_tile']}, "
                      f"group {b['group']}): lists {b['longest']} / "
                      f"{b['mean']:.1f}, {b['device_ops']:g} ops busy "
                      f"{b['busy_ms']:.4f} ms {_kms(b['kernel_ms'])}",
                      flush=True)
                for name in names[1:]:
                    a = row[name]
                    print(f"    {name}: lists {a['longest']} / "
                          f"{a['mean']:.1f}, {a['device_ops']:g} ops busy "
                          f"{a['busy_ms']:.4f} ms {_kms(a['kernel_ms'])}; "
                          f"t differs on {a['t_differ']}, tri_id on "
                          f"{a['tri_id_differ']}; query "
                          f"{_fmt(a['query_ms'])} ms (before "
                          f"{_fmt(b['query_ms'])})", flush=True)
                rows.append(row)
    finally:
        for k, v in shipped.items():
            setattr(CK, k, v)
        CK.ray_order = real_order
    # the order kernel at each key width, added to the shapes whose order
    # was made once outside their profiles
    order_ms = order_kernel_ms(
        [(f"{m} view {v}", d) for m, (_, _, qs) in data.items()
         for v, _, d in qs], ORDER_BITS)
    for v in SILHOUETTE_SHAPES:
        name = _shape_name(v)
        if v[4] and v[5] != shipped["ORDER_AXIS_BITS"]:
            for row in rows:
                r = row[name]
                kernel = order_ms[v[5]][f"{row['mesh']} view {row['view']}"]
                r["order_kernel_ms"] = kernel
                r["busy_ms"] += kernel
                total[name] += kernel
                per_mesh[row["mesh"]][name] += kernel
    print(f"silhouette: csrc/order.cu by key bits an axis, ms a query: "
          + ", ".join(f"{b}: {min(x.values()):.4f}-{max(x.values()):.4f}"
                      for b, x in order_ms.items()), flush=True)
    best = min((v for v in SILHOUETTE_SHAPES if v[4]),
               key=lambda v: total[_shape_name(v)])
    verdict = {"busy_ms_all_queries": total, "busy_ms_by_mesh": per_mesh,
               "order_kernel_ms": order_ms,
               "winner": dict(zip(knobs, (best[0], best[1], best[2],
                                          best[2] * best[3], best[5]))),
               "winner_by_mesh": {m: min(names[1:], key=p.get)
                                  for m, p in per_mesh.items()},
               "shipped": shipped}
    print(f"silhouette: busy ms over all {len(rows)} queries: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
              total.items(), key=lambda kv: kv[1]))
          + f"; winner {verdict['winner']}; by mesh "
          f"{verdict['winner_by_mesh']}; the source ships {shipped}",
          flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"device": card, "script":
                   "scripts/tune_torch_oracle.py --what silhouette",
                   "rows": rows, "verdict": verdict}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out}")


def _kms(by):
    return "(" + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
        by.items(), key=lambda kv: -kv[1])) + ")"


def _fmt(xs):
    return "/".join(f"{x:.4f}" for x in xs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", nargs="+", default=["tiles", "blocks", "gate"],
                    choices=["tiles", "blocks", "gate", "prepass", "resort",
                             "group", "pack", "scatter", "scatter-routes",
                             "scatter-trace", "silhouette", "defaults"])
    ap.add_argument("--parent", default=None,
                    help="--what defaults: the unpacked tree to compare with")
    ap.add_argument("--prepass-out",
                    default=os.path.join(HERE, "reports",
                                         "torch_prepass_blocks.json"),
                    help="where --what prepass writes its table")
    ap.add_argument("--group-out",
                    default=os.path.join(HERE, "reports",
                                         "torch_group_ab.json"),
                    help="where --what group writes its table")
    ap.add_argument("--pack-out",
                    default=os.path.join(HERE, "reports",
                                         "torch_pack_ab.json"),
                    help="where --what pack writes its times")
    ap.add_argument("--scatter-out",
                    default=os.path.join(HERE, "reports",
                                         "torch_scatter_ab.json"),
                    help="where --what scatter writes its times")
    ap.add_argument("--scatter-routes-out",
                    default=os.path.join(HERE, "reports",
                                         "torch_scatter_routes.json"),
                    help="where --what scatter-routes writes its times")
    ap.add_argument("--silhouette-out",
                    default=os.path.join(HERE, "reports",
                                         "torch_silhouette_order.json"),
                    help="where --what silhouette writes its table")
    ap.add_argument("--table", default=None,
                    help="where --what resort writes its table (default: "
                         "reports/torch_resort_ab.json)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("tune_torch_oracle: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    if "group" in args.what:
        group_ab(torch.device("cuda", 0), smi.stdout.strip(), args.group_out)
    if "resort" in args.what:
        resort_ab(torch.device("cuda", 0), smi.stdout.strip(), args.table)
    if "pack" in args.what:
        pack_ab(torch.device("cuda", 0), smi.stdout.strip(), args.pack_out)
    if "scatter" in args.what:
        scatter_ab(torch.device("cuda", 0), smi.stdout.strip(),
                   args.scatter_out)
    if "scatter-routes" in args.what:
        scatter_routes(torch.device("cuda", 0), smi.stdout.strip(),
                       args.scatter_routes_out)
    if "scatter-trace" in args.what:
        scatter_trace(torch.device("cuda", 0), smi.stdout.strip())
    if "silhouette" in args.what:
        silhouette_order(torch.device("cuda", 0), smi.stdout.strip(),
                         args.silhouette_out)
    if not set(args.what) - {"group", "resort", "pack", "scatter",
                             "scatter-routes", "scatter-trace",
                             "silhouette"}:
        return
    queries = recorded_queries(torch.device("cuda", 0))
    if "defaults" in args.what:
        if not args.parent:
            sys.exit("tune_torch_oracle: --what defaults needs --parent DIR")
        incoherent = [(f"{mesh} {qn}", o, d, geom, False) for mesh, (
            _, geom, qs) in incoherent_queries(
                torch.device("cuda", 0), ("dog_mid90k",)).items()
            for qn, o, d in qs]
        parent_defaults(queries, incoherent, args.parent)
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
    if "prepass" in args.what:
        prepass_blocks(queries, smi.stdout.strip(), args.prepass_out)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (drt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. build   the eight sources' kernels (closest hit; candidate prepass with
           its sort; the packing stages; the one-origin query's ray order;
           the row scatter-add of the step's
           vertex gathers, its cluster route's one kernel and its grid
           route's three; the Sobolev preconditioner's CG solve; a
           bounce's chain and the ray-loss tail, forward and backward; a
           silhouette view's chain around its query and its backward) from
           drt_tpu_torch/csrc with nvcc, one compile per source in
           parallel; prints each entry function's registers, shared
           memory and spills and fails on a spill to local memory or a
           kernel missing from the library; prints the scatter cluster
           route's cluster size (cudaOccupancyMaxActiveClusters) and fails
           unless the card schedules both CG routes' 16-CTA clusters and
           gives the shared route's CTAs the shared memory `cg_route` plans
           for (printed, with the bytes of the three meshes' solves);
2. kernel  the closest-hit kernel vs its plain PyTorch version on
           dog_mid90k (82,566 faces) at 1280x960: camera rays (coherent)
           and the bounce-2 rays of the same view (incoherent), plus a
           sample of each (65,536 rays and up to 8,192 of the rays that
           hit) against the brute-force oracle. tri_id may differ on at most
           2 per 1,024 rays that either side hits, and on 4 times as many
           where the two sides name different triangles at one t; t within
           rtol 1e-5 / atol 1e-4 plus the hit's float32 conditioning
           (t_conditioning: 4 roundings of the coordinates' size over the
           cosine between ray and normal, in the kernel's shifted frame and
           in the brute oracle's), except on at most 2 per 1,024 hits, which
           stay within 1e-2 of that. The conditioning matters where the
           shift (the mean ray origin, as in the JAX package) lies far from
           the mesh, as it does when most lanes are parked: an exit query's
           t is then off by up to 3e-3 on grazing hits. The kernel and its
           plain version round alike and must agree bit for bit. On each
           query the prepass kernel must give the whole candidate lists and
           counts of its plain version exactly: `_candidates` (ray mode) on
           an incoherent query, `_candidates_tile` (tile mode) on a
           coherent one; its time, its bound and the time of the torch
           stages it replaced are printed; and the packing kernel must give
           all eight outputs of `pack_plain` (coefficients, chunk boxes,
           the prepass's boxes and validity, ray features, inverse
           directions) bit for bit as int32 views, on the query's own
           shift, group and ray tile, and they must be what the query
           handed the other two kernels; the time of a call (its wrapper's
           host time included: the kernel takes less), its bound and the
           plain version's time;
3. small   the full loss and gradient on a small icosphere (float64), on
           the card against the CPU: valid rays within the tie tolerance
           with each device's own oracle, and, with the card's hits
           replayed on the CPU, loss within rtol 1e-7 and gradient within
           1e-6 of its largest entry;
4. capture synthesize 8 views of dog_mid90k at 1280x960 (Pointgray);
   queries the four kinds of query one train step makes on dog_mid45k,
           recorded from the main path's own loss functions on a capture
           view (bounce 1, bounce 2, exit, and one silhouette view's edge-
           offset rays, which are incoherent and not normalized): both
           kernels against their plain versions as in phase 2, and the
           silhouette query against the brute-force oracle on all its rays;
5. train   3 reference-parity steps (sgd, precond none, HyperParams()
           weights, float32) from dog_mid45k: one ray view and 8 silhouette
           views per step, 11 oracle queries per step, each through the
           packing, the prepass and the closest-hit kernel (the launch
           counters are reset just before and read just after); then one
           more step under torch.profiler, each query in a range: prints
           the device operations inside the oracle's ranges, a query and a
           step, and the packing kernel's device time in each query (its
           profiler span: the kernels line's `ms`), and fails if the oracle launched a sort, cross product,
           min/max reduction or concatenation kernel, or more than 8
           device operations a query. The scatter kernel: each step's
           launches against the reckoned count (`scatters_per_step`: the
           normals, each silhouette view's and the dihedral term's gather
           backward, `_gather_tri9`'s backward in both bounces, 2 each on
           its soup route), and both of its routes launched by the steps
           (the cluster route for the silhouette views, the grid route for
           the rest); one more step's scatters recorded (rows, indices,
           size, route) and each held against `scatter_rows_plain` run on
           the CPU bit for bit (int views), run again on its route and,
           where it took the cluster route, on the grid route too, for the
           same bits; then, on the same inputs under torch.profiler, the
           device time, span and operations of each route and of
           `index_add_`, each route's call with its wrapper (CUDA events),
           its bound, the plain version on the card and
           `index_put_(accumulate=True)`; in the profiled step, each
           scatter call's device time and device operations (failing
           above 2 on the cluster route or 6 on the grid route), the
           step's device time by kernel, and a failure if
           `indexing_backward_kernel` or an `index_add_` kernel ran;
6. steps   from dog_mid45k, 2 steps each of adam + none, uadam + h1 and
           sgd + sobolev: finite loss and vertices, and the launch counts
           reckoned from the weights (a zero weight skips its term, so h1's
           two evaluations of the loss, one with the ray weight alone and
           one with the regularizers alone, make the 11 queries of one) and
           the preconditioner (CG launches a step: 0 for none, 1 for h1, 2
           for sobolev, and 1 in sobolev's `final_vertices`), every one on
           the CG kernel's shared route; then one uadam + h1 step each on
           dog_mid20k and dog_mid90k (the shared route) and on dog_mid45k
           subdivided once (Vp 131,072, above the shared route's cap: the
           global route), each checked by the counters of its route;
7. chunked one sgd + none step with ray_chunk=2**18 against the unchunked
           step from the same state, twice. First as the step runs it, each
           query shifting the scene by its own mean ray origin: a chunk's
           rays then meet coefficients rounded about another point than the
           whole view's, some rays on a shared edge take the other triangle
           (counted and printed), and the bound is loss rtol 1e-5 and
           gradient 1e-2 of its largest entry, the allowance
           tests/test_chunked.py gives the JAX package. Then with one shift
           handed to every query, which leaves the chunking alone: no ray
           may change its triangle, and the gradient must hold to 1e-4 of
           its largest entry (float32 sums in another order; the float64 CPU
           tests hold the port to 1e-10). The checkpointed chunks rerun
           their oracle queries in the backward, and the counts say so;
           peak memory of both;
8. routes  the bounce-2 and exit queries of phase 4 through
           incoherent="resort" (Morton sort + the prepass kernel's tile
           mode) against "ray" (its ray mode): tri_id and t equal bit for
           bit, one launch of each kernel a query, ms of both; and the
           `culled` backend against the kernel on 65,536-ray samples
           within phase 2's tie allowance;
9. lod     `optimize`, the LOD loop, on the phase-4 capture from
           dog_mid20k: 3 passes of 10 steps, remeshed by the isotropic
           remesher from edge length 2.5 to 1.5, checkpoints into a
           temporary directory; 3 loadable watertight checkpoints whose
           face counts differ, no remesh failure, finite losses, 11
           launches of each kernel a step and no CG launch, by the
           remesher's
           native core; each pass's checkpoint, a remeshed mesh
           at that pass's chunk count (128, 256, 512) and silhouette budget,
           goes through the checks of phase 4's queries (the kernels
           against their plain versions, the brute-force oracle); then
           `resume=True` with one pass more runs exactly that pass;
10. cli    the command line, `drt_tpu_torch.cli.main`, in a temporary
           working directory: `reconstruct --data synthetic` of the dog
           (dog_mid90k, 8 views at 1280x960, cached to .npz) from the hull
           `--init carved` carves at 160^3, 2 passes x 10 steps from edge
           length 3.0 to 1.8 (the 8-view hull's surface is larger than the
           dog's: about 14k and 37k faces), with the launches of each
           kernel reckoned from the synthesis (4 each a view) and
           the steps (11 each), a watertight carved hull and result, no
           remesh failure, the native remesher; `carve_occupancy` of two of
           its views on the card against the CPU (voxels flipped across 0.5
           and the largest |dfield| printed and bounded), its device time a
           view and its peak memory; `render` of the result at 512x512 (4
           launches of each kernel, 3 PNGs, a mask that is not empty);
           `evaluate` against dog_mid90k and `remesh` as `python3 -m
           drt_tpu_torch.cli` subprocesses, run side by side; `carve` from 2
           views; the h5 path (`save_h5_capture`, then `reconstruct --data
           file.h5`) where h5py is installed, else a line that says it was
           checked on the CPU only; and the time of each part, host clock
           with synchronization.
11. parallel the sharded train step of drt_tpu_torch.parallel. (a) World
           size 1 over NCCL in this process (`init_multihost`, a file://
           address): `make_sharded_train_step` with phase 5's configuration
           (sgd + none, HyperParams(), float32, dog_mid45k, 8 silhouette
           views), 3 steps against 3 plain steps from the same state and
           views, then one uadam + h1 step against one plain step: params,
           m and the losses equal bit for bit (torch.equal), with 11
           launches of each kernel a step. The card's float
           atomics (index_add) sum in any order, so the bitwise runs are
           made under torch.use_deterministic_algorithms; two pairs of 3
           sgd steps without it, in turns (plain, sharded, sharded, plain),
           give the times and say whether they happened to match too. (b)
           World size 2 on the one card over gloo (NCCL refuses two ranks
           on one device): two ranks of this script, each with half of the
           1,228,800 rays and its 4 of the 8 silhouette views, started side
           by side with a deadline; one sgd + none step without the clamp
           (after a warm-up step) against the single step from the same
           state, first with each query's own shift (phase 7's allowance:
           loss rtol 1e-5, update within 1e-2 of the single step's largest
           entry; the rays that change triangle are counted and printed),
           then with one shift for every query (no ray may change its
           triangle, update within 1e-4); both ranks must hold the same
           update, and each rank makes 7 launches of each kernel a step.
12. groups the oracle's options, on dog_mid90k's camera, bounce-2, exit and
           silhouette queries under a capture of dog_mid45k (so that exit
           rays hit): at groups of 1, 4 and 16 chunks, both kernels against
           their plain versions (closest hit and packing bit for bit; the
           prepass's whole lists and counts over the group boxes, in both
           modes), the
           hits against group 1 within phase 2's tie allowance, a 4,096-ray
           sample (and up to 1,024 hits) against the brute-force oracle as
           in phase 2, and both kernels' times and bounds; the bounce-2
           query at t_min = the median t of its hits, against its plain
           version and the brute oracle with that t_min; and a camera query
           of 262,144 rays (the middle rows of phase 2's view) on
           dog_mid45k subdivided three times (2,493,568 faces, above the
           prepass kernel's MAX_CHUNKS = 16,384 chunks) through
           `intersect_cuda(group=None)`: the group it took (the least power
           of two that fits), one launch of each kernel, the same checks,
           its time and the phase's seconds.
13. graph  the train step as one CUDA graph (optimize/loop.py
           `GraphedTrainStep`, which `optimize` runs every pass on the card;
           phases 9 and 10 already went through it, their launch counts
           being each replay's recorded launches): (a) phase 5's eager
           step, once with device view indices and a 0-d lr as the graph
           takes them and once with ints, inside the scatters' deferred
           bounds scope under torch.cuda.set_sync_debug_mode("error"):
           any synchronizing operation fails the run; (b) for sgd + none,
           adam + none, uadam + h1 and sgd + sobolev, 3 eager steps and 3
           graphed steps (the warm-up, the capture, 2 replays) from one
           state on the same views: params, m, v and the loss equal bit
           for bit after every step, and the graphed run's launches of
           every kernel equal the eager run's (the CG's reckoned as in
           phase 6, all on the shared route); (c) phase 5's step, then
           uadam + h1 and sgd +
           sobolev, timed in turns (eager, graph, graph, eager), 5 steps a
           turn on the host clock between synchronizations, with the
           launches of each graph turn counted from 0 (11 of each oracle
           kernel, the reckoned scatters and CG solves a step, its warm-up
           and its replays); (d)
           one replay and one eager step under torch.profiler: device
           busy time and device operations; and the warm-up, capture and
           instantiate seconds and the graph's memory pool.
14. cg     the CG kernel (csrc/cg.cu) against its plain version on the
           card, on the solves recorded from one dog_mid45k uadam + h1 step
           (its gradient's solve), one sgd + sobolev step (the forward
           solve and the backward's) and its `final_vertices` (4 x
           cg_iters trips at most, tol 1e-8), and one uadam + h1 step on
           phase 6's subdivided mesh, each in float32 and in float64, on
           the default route (`cg_route`) and on each route forced: the
           same bits (integer views) and trip counts, and a second
           launch's bits; the shared route must refuse what `cg_route`
           does not give it; the h1 solve with valid entries given from
           the end (n - Vp), which both routes must take as torch's
           indexing does; the measured trip floor of each route (a
           1,024-vertex ring, tol 0, 64 trips against 0); the h1 solves
           and the final solve under torch.profiler (the default route's
           kernel alone), each route's time by CUDA events in turns,
           their bound (`cg_bound`: inputs read once and x written once
           against the trips' operations at the FP32 rate), the ring's
           floor for as many trips, the per-trip HBM figure (the global
           route's bytes a trip at the HBM rate) and the plain version's
           time. Phases 6 and 13 are the kernel's main
           path: their launches by route are each route's count in the
           kernels line.
15. chain  csrc/bounce.cu's four kernels against their plain versions on
           the main path's own inputs: the ray loss's trace of capture view
           0 (1280x960) through the step's oracle on dog_mid45k and
           dog_mid90k, float32 and float64, compat off and on; on both
           bounces every output (o_out, d_out, active, face ids) and every
           output of their backward (d_origin, d_direction, dg9; the new
           direction's cotangent alone, as the loss sends it, and both),
           and the tail's loss and gradient at Huber 0 and 0.1, bit for
           bit (integer views). Then, on bounce 2 and the tail of
           dog_mid45k in float32: each kernel's time by CUDA events (with
           its wrapper) and its device time and operations under
           torch.profiler, the plain versions' times, and the bounds
           (`bounce_bound`, `ray_tail_bound`: the bytes this run's masks
           make the kernel move, against its operations). The launches of
           both are counted on every earlier path against the reckoned
           counts (`note_chain`: 4 bounce and 2 tail launches a step, a
           checkpointed chunk 6 and 3; the synthesis and `render` 2 bounce
           launches a view): phases 5, 6, 7, 9, 10, 11 and 13, the kernels
           line's launches by path.
16. order  the one-origin route (the silhouette sampler's queries sorted
           along the screen: csrc/order.cu, the order read by csrc/pack.cu
           and written through by csrc/closest_hit.cu) on 8 silhouette
           views of dog_mid20k, dog_mid45k and dog_mid90k at their budgets
           (`silhouette_queries`: the rays of csrc/silhouette.cu's pre
           kernel, as the step queries them, from the ring of 72 around
           dog_mid90k at 1280x960): the order kernel against
           `ray_order_plain` on the CPU, the packing, prepass and
           closest-hit kernels on the route's inputs against their plain
           versions, bit for bit; the route's
           hit and t against the parent's route (the rays as separate rows)
           bit for bit, a tri_id differing only at one t, and each mesh's
           first view against the brute oracle; then 3 replays of the
           parity step (sgd + none) on dog_mid45k as one CUDA graph with the
           route and with the parent's route: loss and state bit for bit,
           and 8 one-origin queries a replay against 0.
17. silh   csrc/silhouette.cu's three kernels (a silhouette view's chain
           before its query, after it, and its backward) against their
           plain versions run on the card, bit for bit (integer views), on
           capture views 0, 3 and 6 of dog_mid20k, dog_mid45k and
           dog_mid90k at their budgets, float32 and float64, read by
           device view index, the mask read truncated and bilinear; then
           each kernel's time (CUDA events with its wrapper, and its
           profiled device time), its bound (`silhouette_bound`, bytes)
           and its plain version's time on view 0 of dog_mid45k and
           dog_mid90k, float32. The launches of the three are counted on
           every earlier path with the bounce chain's (`note_chain`: 8 of
           each a step, 4 on each rank of the 2-rank sharded step, none in
           `render`), the kernels line's launches by path.
Then it prints the timings, a JSON line of phase 10's times, a JSON line of
phase 11's, one of phase 12's, one of phase 13's, one of phase 16's, a JSON
line with the kernels' numbers (with their times at each group on phase
12's bounce-2 query), the card's name and power limit, and as its last
line {"ok": true, "device": {...}}.

The scatter kernel also runs in phases 3, 6, 7, 9, 10 and 11 (every
vertex gradient on the card); phase 9 prints its launches. The CG kernel
also runs in phase 11a's uadam + h1 step (its shared route).

It needs the repository around it (drt_tpu_torch/, native/remesh.cpp and
reports/tuning_meshes/), a CUDA GPU, nvcc, g++ and PIL (to decode phase 10's
PNGs); it imports nothing of JAX.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MESH_DIR = os.path.join(HERE, "reports", "tuning_meshes")
FP32_PEAK = 67e12                 # H100 SXM FP32 non-tensor FLOP/s
HBM_RATE = 3.35e12                # H100 SXM HBM3 bytes/s
TIE_PER_1024 = 2
# The entry functions of the eight sources: closest_hit.cu, candidates.cu,
# pack.cu, order.cu, scatter.cu (its cluster route's one kernel; its grid
# route's upfront, pass and reduce kernels), cg.cu (its global and shared
# routes' kernels), bounce.cu (a bounce's chain and the ray-loss tail,
# forward and backward) and silhouette.cu (a silhouette view's chain
# before and after its query, and its backward).
BUILT_KERNELS = ("closest_hit_kernel", "candidates_kernel", "pack_kernel",
                 "ray_order_kernel",
                 "scatter_cluster_kernel", "scatter_upfront_kernel",
                 "scatter_pass_kernel", "scatter_reduce_kernel", "cg_kernel",
                 "cg_shared_kernel", "bounce_fwd_kernel", "bounce_bwd_kernel",
                 "ray_tail_fwd_kernel", "ray_tail_bwd_kernel",
                 "silhouette_pre_kernel", "silhouette_post_kernel",
                 "silhouette_bwd_kernel")
# CG solves a step by preconditioner: h1 solves its gradient, sobolev its
# vertices in the forward and the cotangent in the backward.
CG_PER_STEP = {"none": 0, "h1": 1, "sobolev": 2}
BRUTE_SAMPLE = 65536


def counts():
    """The launch counters: (closest hit, prepass, packing)."""
    from drt_tpu_torch.intersect import cuda_kernel as CK
    c = CK.counters
    return (c.launches, c.candidates_launches, c.pack_launches)


# csrc/bounce.cu's and csrc/silhouette.cu's launches a step: a bounce's
# chain forward and backward for each of the 2 bounces, the ray loss's tail
# forward and backward (a checkpointed chunk reruns its forward in the
# backward); the silhouette chain's pre, post and backward kernels, once
# each for each of the 8 silhouette views.
CHAIN_PER_STEP = (4, 2, 8, 8, 8)
CHAIN_NAMES = ("bounce chain", "ray-loss tail", "silhouette pre",
               "silhouette post", "silhouette backward")
# The main path's launches of those, by path (`note_chain`).
CHAIN_LAUNCHES = {}


def chain_counts():
    """csrc/bounce.cu's and csrc/silhouette.cu's launch counters, in the
    order of CHAIN_NAMES."""
    from drt_tpu_torch.intersect import cuda_kernel as CK
    c = CK.counters
    return (c.bounce_launches, c.ray_tail_launches,
            c.silhouette_pre_launches, c.silhouette_post_launches,
            c.silhouette_backward_launches)


def note_chain(path, got, want):
    """Add `got` (chain_counts()) to the main path's launches on `path`;
    fail where it differs from `want`."""
    if tuple(got) != tuple(want):
        fail(f"{path}: csrc/bounce.cu and csrc/silhouette.cu launches "
             f"({', '.join(CHAIN_NAMES)}) {tuple(got)}, reckoned "
             f"{tuple(want)}")
    prev = CHAIN_LAUNCHES.get(path, (0,) * len(CHAIN_NAMES))
    CHAIN_LAUNCHES[path] = tuple(a + b for a, b in zip(prev, got))


def cg_counts():
    """The CG launch counters: (all, shared route, global route)."""
    from drt_tpu_torch.intersect import cuda_kernel as CK
    c = CK.counters
    return (c.cg_launches, c.cg_shared_launches, c.cg_global_launches)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Profiles taken for one measurement before a range that lacks its device
# span fails the run. Kineto builds a range's device span (its GPU user
# annotation) from CUPTI's correlation records, and on the H100 a profile
# now and then comes back with a range's span missing although the
# range's operations ran.
PROFILE_TRIES = 3


def profile_again(attempt, why):
    """After profile `attempt` (1-based) lacked a device span (`why`): True,
    with a note on stderr, while another profile may be taken."""
    if attempt >= PROFILE_TRIES:
        return False
    print(f"chip_smoke: profile {attempt} of {PROFILE_TRIES}: {why}; "
          f"profiling again", file=sys.stderr)
    return True


def device_spans(calls, reps=5):
    """Each of `calls` (name -> fn) run `reps` times in turns under
    torch.profiler, each run in a range of its own. Per name, the medians
    over its runs of: `ms`, the device time (the sum of the durations of
    the device operations inside the run's range: kernels, memsets,
    copies); `span_ms`, the range's device span, first start to last end;
    `ops`, its device operations (the largest count of any run); `by_op`,
    each operation's name (to its first parenthesis or template bracket)
    and its median time over the runs. Each call also runs once inside the
    profile before the ranges, and a profile in which a range has no
    device span is taken again (`profile_again`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    labels = {f"{name} run {r}": (name, r) for name in calls
              for r in range(reps)}
    dev_t = torch.autograd.DeviceType.CUDA
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in calls.values():
                fn()
            torch.cuda.synchronize()
            for r in range(reps):
                for name, fn in calls.items():
                    with record_function(f"{name} run {r}"):
                        fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == dev_t]
        ranges = {e.name: (e.time_range.start, e.time_range.end)
                  for e in events if e.name in labels}
        missing = [label for label in labels if label not in ranges]
        if not missing or not profile_again(
                attempt, f"no device span for {len(missing)} of "
                f"{len(labels)} ranges, the first {missing[0]!r}"):
            break
    ops = [e for e in events if e.name not in labels]
    runs = {name: [] for name in calls}
    by_op = {name: {} for name in calls}
    for label, (name, _) in labels.items():
        if label not in ranges:
            fail(f"profile: no device span for {label!r} in "
                 f"{PROFILE_TRIES} profiles")
        a, b = ranges[label]
        inside = [k for k in ops
                  if a <= k.time_range.start and k.time_range.end <= b]
        for k in inside:
            key = k.name.split("(")[0].split("<")[0][:40]
            by_op[name].setdefault(key, []).append(
                (k.time_range.end - k.time_range.start) / 1e3)
        runs[name].append((
            sum(k.time_range.end - k.time_range.start for k in inside) / 1e3,
            (b - a) / 1e3, len(inside)))
    return {name: dict(ms=statistics.median(x[0] for x in rs),
                       span_ms=statistics.median(x[1] for x in rs),
                       ops=max(x[2] for x in rs),
                       by_op={k: statistics.median(v)
                              for k, v in by_op[name].items()})
            for name, rs in runs.items()}


def t_conditioning(o, d, geom, ids):
    """How far float32 can carry t = (v0 - o).n / d.n of each ray's hit
    triangle `ids` [n] (0 where a ray has none): 4 roundings of the
    magnitudes that meet in the numerator, over the cosine between ray and
    normal, once in the kernel's frame (the scene shifted by the mean ray
    origin, which parked lanes pull far from the mesh) and once in the
    brute-force oracle's (world coordinates). A grazing hit of a ray that
    starts far from the shift is ill-conditioned in both."""
    import torch
    vertices, faces, _ = geom
    tri = vertices[faces[ids.clamp(min=0).long()]].double()      # [n,3,3]
    o, d = o.double(), d.double()
    shift = o.float().mean(dim=0).double()
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    d_len = d.norm(dim=-1)
    dn = (d * n).sum(-1)
    cos = (dn / (n.norm(dim=-1) * d_len)).abs().clamp(min=1e-12)
    reach = (((tri[:, 0] - o) * n).sum(-1) / dn).abs() * d_len
    size = ((o - shift).abs().amax(-1) + (tri - shift).abs().amax((-1, -2))
            + o.abs().amax(-1) + tri.abs().amax((-1, -2)) + 2 * reach)
    return (4 * 2.0 ** -24 * size / cos).float()


def compare_hits(name, ref_t, ref_id, t, ids, cond=None):
    """Tie tolerance on tri_id (counted against the rays either side hits,
    so dropped hits cannot hide among misses), rtol/atol on t; returns max
    |dt| on rays with the same id. `cond` [n] (t_conditioning of the
    triangle the side that hits names) widens each ray's tolerance on t by
    what float32 can resolve of that hit, and sets apart the rays float32
    cannot decide: the two sides name different triangles at one t within
    that tolerance, or one side hits at a t within it of 0 and the other
    misses (a ray that starts on the triangle, as an exit query's nudged
    origins do, whose t has the sign of its rounding). Up to 4 times the tie
    allowance of those."""
    import torch
    n = ref_id.numel()
    differ = ref_id != ids
    n_hit = int(((ref_id >= 0) | (ids >= 0)).sum())
    allowed = max(1, TIE_PER_1024 * n_hit // 1024)
    ties = 0
    if cond is not None:
        # two triangles at one t, as far as float32 tells: neither side is
        # wrong, and an exit query has about 2 such per 1,024 hits
        near = (differ & (ref_id >= 0) & (ids >= 0)
                & ((t - ref_t).abs() <= 1e-4 + 1e-5 * ref_t.abs() + cond))
        at_origin = (differ & ((ref_id >= 0) != (ids >= 0))
                     & (torch.where(ids >= 0, t, ref_t) <= 1e-4 + cond))
        ties = int((near | at_origin).sum())
        differ = differ & ~(near | at_origin)
    bad = int(differ.sum())
    if bad > allowed or ties > 4 * allowed:
        fail(f"{name}: {bad} tri_ids differ and {ties} more at one t or at "
             f"the origin, {n_hit} rays hit")
    same = (ref_id == ids) & (ids >= 0)
    dt = (t[same] - ref_t[same]).abs()
    tol = 1e-4 + 1e-5 * ref_t[same].abs()
    what, over = "rtol 1e-5 / atol 1e-4", dt
    if cond is not None and same.any():
        wide = dt > tol
        what += (f" + float32 conditioning ({int(wide.sum())} beyond "
                 "rtol/atol alone")
        if wide.any():
            what += (", the worst of them at "
                     f"{float((dt / cond[same])[wide].max()) * 4:.2f} of the "
                     "4 roundings allowed")
        what += ")"
        tol = tol + cond[same]
        over = dt - cond[same]
    loose = int((dt > tol).sum())
    err = float(dt.max()) if same.any() else 0.0
    worst = float(over.max()) if same.any() else 0.0
    if loose > max(1, TIE_PER_1024 * int(same.sum()) // 1024) or worst > 1e-2:
        fail(f"{name}: {loose} t beyond {what}, max |dt| {err:g}")
    print(f"{name}: {n} rays, {int(same.sum())} hits, {bad} tri_id "
          f"mismatches and {ties} more at one t or at the origin, {loose} t "
          f"beyond {what}, max |dt| {err:g}")
    return err


def slab_pairs(inp, t_hit):
    """(ray, chunk) pairs, over the chunks on the ray's tile list (a listed
    group's chunks, with groups: `chunk_lists`), whose
    AABB the ray's own slab test enters: all of them, and those it enters
    no later than its closest hit t_hit [Np] (inf on a miss). The second is
    the least work of the function: a chunk entered before the hit may hold
    a nearer one and must be tested, one entered after it cannot. Also the
    (tile, chunk) pairs in which some ray of the tile makes a pair of the
    second kind: the fewest chunks the tile's block must fetch."""
    import torch
    from drt_tpu_torch.intersect.cuda_kernel import chunk_lists
    cand, count = chunk_lists(inp)
    T, NC = cand.shape
    RT = inp.phi.shape[1] // T
    rank = torch.arange(NC, device=cand.device)
    listed = torch.zeros(T, NC, dtype=torch.bool, device=cand.device)
    listed.scatter_(1, cand.long(), count[:, None] > rank)
    o = inp.phi[6:9].reshape(3, T, RT)
    iv = inp.inv.reshape(3, T, RT)
    th = t_hit.reshape(T, RT, 1)
    g = max(1, 2 ** 25 // (RT * NC))
    n_all = n_cut = n_tile = 0
    for s in range(0, T, g):
        t_entry = t_exit = None
        for ax in range(3):
            oa, ia = o[ax, s:s + g, :, None], iv[ax, s:s + g, :, None]
            t1 = (inp.lo[:, ax] - oa) * ia                   # [G,RT,NC]
            t2 = (inp.hi[:, ax] - oa) * ia
            e, x = torch.minimum(t1, t2), torch.maximum(t1, t2)
            t_entry = e if t_entry is None else torch.maximum(t_entry, e)
            t_exit = x if t_exit is None else torch.minimum(t_exit, x)
        hit = ((t_entry <= t_exit) & (t_exit > inp.t_min)
               & listed[s:s + g, None])
        n_all += int(hit.sum())
        cut = hit & (t_entry <= th[s:s + g])
        n_cut += int(cut.sum())
        n_tile += int(cut.any(dim=1).sum())
    return n_all, n_cut, n_tile


def kernel_bound(inp, C, t_hit):
    """Least time for one launch: operations against bytes (each input the
    kernel needs read once, outputs written once). The operations are the
    Plücker products for each (ray, triangle) pair of each chunk the ray
    enters before its hit (slab_pairs): 19 multiplies and 15 adds, each
    rounded on its own as the kernel and its plain twin round them. An
    unfused multiply or add issues at the FMA rate, half the FP32 FLOP/s
    peak (which counts an FMA as two)."""
    import torch
    from drt_tpu_torch.intersect.cuda_kernel import chunk_lists
    count = inp.count.long()
    pairs_all, pairs, tile_pairs = slab_pairs(inp, t_hit)
    visits = pairs * C
    ops = visits * 34 * 2
    cand, n_chunks = chunk_lists(inp)
    used = n_chunks[:, None].long() > torch.arange(cand.shape[1],
                                                   device=count.device)
    distinct = int(cand[used].unique().numel())
    nbytes = (inp.phi.numel() * 4 + inp.inv.numel() * 4
              + distinct * (19 * C + 6) * 4 + int(count.sum()) * 4
              + count.numel() * 4 + inp.phi.shape[1] * 8)
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", visits, pairs_all * C, nbytes, t_ops, tile_pairs)


def prepass_bound(n_rays, n_tiles, n_chunks, n_valid, tile, count,
                  kept=None, n_tested=0):
    """Least time for one launch of the prepass kernel. Operations (unfused,
    at half the FP32 FLOP/s peak): ray mode, every ray against every box its
    tile scores, 20 a pair: 6 subtractions and 6 multiplies for the three
    planes the ray meets first and the three it meets last (its direction
    octant says which), 4 min/max for the entry and the exit, 2 compares and
    a select for the overlap test, 1 min for the running minimum; the boxes
    a tile scores are `kept` [T] (the kernel's, this run's), which its cull
    by the tile's frustum took from the valid ones at 12 min/max a ray and
    86 operations a (tile, valid box) on the `n_tested` tiles it tested
    (None: every valid box, no cull); tile mode, the tile's 12 interval ends
    (12 min/max a ray) and, per (tile, valid chunk), 12 subtractions, 24
    multiplies and 36 min/max for the interval products, then 10 min/max
    for the entry and the exit, 2 compares and a select for the test and 1
    max for the score; both, F log2 F compares to sort the F candidates of
    each tile (`count` [T], this run's). Bytes: origins, inverse directions
    and the boxes read once, the T x NC lists and T counts written."""
    import torch
    if tile:
        ops = n_rays * 12 + n_tiles * n_valid * 86
    elif kept is None:
        ops = n_rays * n_valid * 20
    else:
        ops = (n_rays * 12 + n_rays // n_tiles * int(kept.sum()) * 20
               + n_tested * n_valid * 86)
    f = count.double()
    ops += float((f * torch.log2(f.clamp(min=1))).sum())
    ops *= 2
    nbytes = n_rays * 6 * 4 + n_chunks * 25 + n_tiles * (n_chunks + 1) * 4
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def prepass_kept(args, t_min=0.0):
    """The ray mode's cull on one query's prepass inputs `args` (as
    `prepass_args` gives them): the kernel's `kept` [T], checked against
    `frustum_kept_plain`'s row sums (the run fails where they differ), and
    the tiles it tested (those not straddling every axis sign)."""
    import torch
    from drt_tpu_torch.intersect import cuda_kernel as CK
    org, inv, _, _, _, T = args
    kept = torch.empty(T, dtype=torch.int32, device=org.device)
    CK.candidates_cuda(*args, tile=False, t_min=t_min, kept=kept)
    want = CK.frustum_kept_plain(*args, t_min).sum(dim=1).int()
    if not torch.equal(kept, want):
        fail("the prepass kernel's kept differs from frustum_kept_plain on "
             f"{int((kept != want).sum())} of {T} tiles")
    return kept, T - int(CK.tile_straddles(inv, T).sum())


def pack_bound(n_rays, n_pad, faces, vertices, face_valid, pk, rbytes):
    """Least time for one launch of the packing kernel: bytes (rays, faces,
    vertices and validity read once; phi, inv, coefficients and boxes
    written once) against operations (unfused, at half the FP32 FLOP/s
    peak: a ray 21 (3 subtractions for the shift, 3 products and 3 fused
    products for o x d, 3 guards of 3 and 3 reciprocals), a face 70 (9
    subtractions for the shift, 6 for the edges, 24 for the four cross
    products, 6 for v0 . n, 12 min/max for its box and 13 more for the
    chunk's reduction)). Returns (ms, "bytes" or "operations", bytes)."""
    nbytes = (n_rays * 6 * rbytes + 12 + faces.numel() * faces.element_size()
              + vertices.numel() * vertices.element_size()
              + (face_valid.numel() if face_valid is not None else 0)
              + n_pad * 12 * 4 + pk.coef.numel() * 4 + pk.lo.numel() * 8
              + pk.box_valid.numel())
    if pk.box_lo is not pk.lo:
        nbytes += pk.box_lo.numel() * 8
    ops = (n_pad * 21 + faces.shape[0] * 70) * 2
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes
            else "bytes", nbytes)


def int_view(a):
    """a float tensor as the integers of its width (so -0 is not +0)."""
    import torch
    return a.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[a.element_size()])


def same_bits(a, b):
    """a and b hold the same bits (floats compared as integer views, so -0
    is not +0)."""
    import torch
    if a.is_floating_point():
        if a.dtype != b.dtype:
            return False
        a, b = int_view(a), int_view(b)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_diff(a, b):
    """The largest |a - b| over the elements whose bits differ (0 where
    every element is the same to the bit; inf where one side is not
    finite)."""
    import torch
    if a.dtype == torch.bool:
        return float((a != b).any())
    differ = int_view(a) != int_view(b)
    if not differ.any():
        return 0.0
    return float((a[differ].double() - b[differ].double()).abs()
                 .nan_to_num(nan=float("inf")).max())


def check_pack(name, o, d, geom, inp):
    """The packing kernel against `pack_plain` on one query's inputs (its
    shift, the mean ray origin; its group and ray tile): all eight outputs
    equal as int32 views, and the kernel's phi, inv, coefficients and chunk
    boxes those `prepare_inputs` handed the other kernels. Then the
    kernel's time, its bound and the plain version's time."""
    import torch
    from drt_tpu_torch.intersect import cuda_kernel as CK
    args = (*geom, o.float().mean(dim=0), o.contiguous(), d.contiguous())
    kw = dict(group=inp.group, ray_tile=inp.phi.shape[1] // inp.count.shape[0])
    got = CK.pack_cuda(*args, **kw)
    want = CK.pack_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = {f: max_abs_diff(getattr(got, f), getattr(want, f))
            for f in CK.Packed._fields}
    bits = {f: same_bits(getattr(got, f), getattr(want, f))
            for f in CK.Packed._fields}
    handed = all(same_bits(getattr(got, f), getattr(inp, f))
                 for f in ("phi", "inv", "coef", "lo", "hi"))
    err = max(errs.values())
    print(f"{name} packing kernel vs plain: all eight outputs equal as int32 "
          f"views: {all(bits.values())} (largest difference {err:g}); what "
          f"the query handed the other kernels: {handed}")
    if not all(bits.values()) or not handed:
        fail(f"{name}: the packing kernel differs from its plain version "
             f"({[f for f, b in bits.items() if not b]}) or from the query's "
             f"inputs ({handed})")
    vertices, faces, face_valid = geom
    bound, bound_by, nbytes = pack_bound(
        o.shape[0], inp.phi.shape[1], faces, vertices, face_valid, got,
        o.element_size())
    ms_c = cuda_ms(lambda: CK.pack_cuda(*args, **kw), 20)
    ms_p = cuda_ms(lambda: CK.pack_plain(*args, **kw), 5)
    print(f"{name} packing: {faces.shape[0]} faces, {got.coef.shape[0]} "
          f"chunks in {got.box_valid.numel()} groups of {inp.group}, "
          f"{inp.phi.shape[1]} rays: a call {ms_c:.4f} ms (CUDA events, the "
          f"wrapper's host time included), bound {bound:.4f} ms ({bound_by}, "
          f"{nbytes} bytes); plain version (the torch stages) {ms_p:.3f} ms")
    return dict(call_ms=ms_c, plain_ms=ms_p, bound_ms=bound,
                bound_by=bound_by, err=err)


def parent_stage_inputs(o, d, geom, inp):
    """KernelInputs of the query as the torch stages gave them before
    csrc/pack.cu (on the card, the same shift, group and t_min), their
    prepass run by csrc/candidates.cu: the path the packing kernel replaced,
    whose hits the query must give bit for bit."""
    import torch
    from drt_tpu_torch.intersect import cuda_kernel as CK
    vertices, faces, face_valid = geom
    RT = inp.phi.shape[1] // inp.count.shape[0]
    o32 = o.float()
    shift = o32.mean(dim=0)
    coef, _ = CK._coef_packed(vertices, faces, face_valid, shift, CK.TRI_CHUNK)
    lo, hi, cv = CK._chunk_aabbs(vertices, faces, face_valid, shift,
                                 CK.TRI_CHUNK)
    lo, hi, boxes = CK._grouped_boxes(lo, hi, cv, inp.group)
    oo = CK._pad_axis0(o32 - shift, RT)
    dd = CK._pad_axis0(d.float(), RT, 1.0)
    inv = CK._safe_inv(dd).t().contiguous()
    phi = torch.cat([dd, torch.linalg.cross(oo, dd, dim=-1), oo],
                    dim=1).t().contiguous()
    T = phi.shape[1] // RT
    cand, count = CK.candidates_cuda(phi[6:9], inv, *boxes, T,
                                     tile=RT == CK.RAY_TILE_COHERENT,
                                     t_min=inp.t_min)
    return CK.KernelInputs(phi, inv, CK._pad_axis0(coef, inp.group), lo, hi,
                           cand, count, inp.group, inp.t_min)


def prepass_args(o, geom, inp):
    """(org, inv, lo, hi, valid, T) of the prepass `prepare_inputs` ran for
    `inp`: its rays and the boxes it scored, the chunks' or, with groups,
    the groups' (the query's own shift, the mean ray origin)."""
    from drt_tpu_torch.intersect import cuda_kernel as CK
    lo, hi, cv = CK._chunk_aabbs(*geom, o.float().mean(dim=0), CK.TRI_CHUNK)
    _, _, boxes = CK._grouped_boxes(lo, hi, cv, inp.group)
    return (inp.phi[6:9], inp.inv, *boxes, inp.count.shape[0])


def check_prepass(name, o, geom, inp, coherent, mode=None, timed=True):
    """The prepass kernel against its plain version on one query's own
    inputs (`_candidates` in ray mode, an incoherent query's, and
    `_candidates_tile` in tile mode, a coherent one's; `mode` picks the
    other), over the boxes the query scored (groups of `inp.group` chunks)
    at its t_min: the whole [T,NG] lists and the counts equal, and in the
    query's own mode equal to what `prepare_inputs` got from the kernel.
    Then (`timed`) the kernel's time and its bound, and the times on the
    card of the torch stages it replaces: the stable sort and count over
    the plain scores (ray mode), the whole `_candidates_tile` (tile
    mode)."""
    import torch
    from drt_tpu_torch.intersect import cuda_kernel as CK
    tile = coherent if mode is None else mode == "tile"
    args = prepass_args(o, geom, inp)
    org, _, lo, hi, cv, T = args
    NC = lo.shape[0]
    RT = org.shape[1] // T
    cand_k, count_k = CK.candidates_cuda(*args, tile=tile, t_min=inp.t_min)
    torch.cuda.synchronize()
    ot = org.reshape(3, T, RT).permute(1, 0, 2)
    dt = inp.phi[0:3].reshape(3, T, RT).permute(1, 0, 2)
    plain = CK._candidates_tile if tile else CK._candidates
    t0 = time.time()
    cand_p, count_p = plain(ot, dt, lo, hi, cv, inp.t_min)
    torch.cuda.synchronize()
    ms_p = (time.time() - t0) * 1e3
    same = bool(torch.equal(count_k, count_p) and torch.equal(cand_k, cand_p)
                and (tile != coherent or (torch.equal(cand_k, inp.cand)
                                          and torch.equal(count_k,
                                                          inp.count))))
    # chunk indices and counts are integers: the largest difference
    err = float(max((cand_k.long() - cand_p.long()).abs().max(),
                    (count_k.long() - count_p.long()).abs().max()))
    mode = "tile" if tile else "ray"
    print(f"{name} prepass kernel ({mode} mode) vs plain: whole lists and "
          f"counts equal: {same} (largest difference {err:g})")
    if not same:
        fail(f"{name}: the prepass kernel differs from its plain version")
    n_valid = int(cv.sum())
    kept, n_tested = (None, 0) if tile else prepass_kept(args, inp.t_min)
    bound, bound_by = prepass_bound(org.shape[1], T, NC, n_valid, tile,
                                    count_k, kept, n_tested)
    kept_share = None if tile else float(kept.sum()) / (T * n_valid)
    if not timed:
        return dict(plain_ms=ms_p, bound_ms=bound, bound_by=bound_by,
                    err=err, mode=mode)
    ms_k = cuda_ms(lambda: CK.candidates_cuda(*args, tile=tile,
                                              t_min=inp.t_min), 20)
    if tile:
        ms_r = cuda_ms(lambda: plain(ot, dt, lo, hi, cv, inp.t_min), 5)
        replaced = "_candidates_tile in torch"
    else:
        score_p = CK.candidate_scores_plain(*args, inp.t_min)
        ms_r = cuda_ms(lambda: CK._sorted_candidates(score_p), 5)
        replaced = "sort and count of the plain scores"
    p2 = 1 << max(NC - 1, 0).bit_length()
    smem = 2 * RT * 16 + p2 * 8 + NC * 4
    print(f"{name} prepass: {T} tiles of {RT} x {NC} boxes ({n_valid} "
          f"valid), {mode} mode, kernel {ms_k:.4f} ms (dynamic shared "
          f"memory {smem} B a block), bound {bound:.4f} ms "
          f"({bound_by}, {bound / ms_k:.0%} of it); replaced torch stages "
          f"({replaced}) {ms_r:.4f} ms; plain version {ms_p:.3f} ms; "
          f"candidates/tile mean {float(count_k.float().mean()):.1f}"
          + ("" if tile else f"; the cull kept {kept_share:.1%} of the "
             f"tiles' valid boxes ({n_tested} of {T} tiles tested)"))
    return dict(ms=ms_k, plain_ms=ms_p, bound_ms=bound, bound_by=bound_by,
                err=err, replaced_ms=ms_r, mode=mode, kept_share=kept_share)


def check_query(name, o, d, geom, coherent, gen, plain_reps=0,
                brute_all=False, group=None, t_min=0.0,
                brute_sample=BRUTE_SAMPLE, hit_sample=8192, both_modes=False):
    """One oracle query (`group` and `t_min` as `intersect_cuda` takes
    them): the closest-hit kernel against its plain version on the card
    (bit for bit) and against the brute-force oracle with the same t_min (a
    sample of `brute_sample` rays and up to `hit_sample` of the rays that
    hit, or all rays), then the kernel's, the plain version's and the whole
    query's times and the bound; then the prepass kernel against its plain
    version, in the query's own mode (and, `both_modes`, the other), and the
    packing kernel against its plain version.
    plain_reps=0 times the plain version by its one checking run. Returns
    the times, and the hits as `hits` (t, tri_id)."""
    import torch
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.brute import intersect_brute
    inp = CK.prepare_inputs(o, d, *geom, coherent=coherent, group=group,
                            t_min=t_min)
    N = o.shape[0]
    t_k, id_k = (x[:N] for x in CK.closest_hit_cuda(inp))
    torch.cuda.synchronize()
    t0 = time.time()
    t_full, id_p = CK.closest_hit_plain(inp)
    torch.cuda.synchronize()
    ms_p = (time.time() - t0) * 1e3
    t_p, id_p = t_full[:N], id_p[:N]
    err = compare_hits(f"{name} kernel vs plain", t_p, id_p, t_k, id_k)
    same_bits = bool(torch.equal(id_k, id_p) and torch.equal(t_k, t_p))
    print(f"{name} kernel vs plain bit for bit: {same_bits}")
    if not same_bits:
        fail(f"{name}: kernel and plain version differ")
    t_s, id_s = (x[:N] for x in CK.closest_hit_cuda(
        parent_stage_inputs(o, d, geom, inp)))
    same_stages = bool(torch.equal(id_k, id_s) and torch.equal(t_k, t_s))
    print(f"{name} hits against the torch stages the packing kernel "
          f"replaced, bit for bit: {same_stages}")
    if not same_stages:
        fail(f"{name}: the hits differ from those of the torch stages")
    if t_min and bool((t_k[id_k >= 0] <= t_min).any()):
        fail(f"{name}: a hit at or before t_min {t_min}")
    if brute_all or N <= brute_sample:
        idx, what = torch.arange(N, device=o.device), "all rays"
    else:
        # a uniform sample, and some of the rays the kernel hits: an exit
        # query hits with one ray in a thousand
        idx = torch.randperm(N, generator=gen)[:brute_sample].to(o.device)
        hit_idx = torch.nonzero(id_k >= 0)[:, 0]
        pick = torch.randperm(hit_idx.numel(), generator=gen)[:hit_sample]
        idx = torch.cat([idx, hit_idx[pick.to(o.device)]]).unique()
        what = f"{brute_sample} sample and {pick.numel()} of the hits"
    hb = intersect_brute(o[idx], d[idx], *geom, t_min=t_min,
                         tri_chunk=max(512, geom[1].shape[0] // 512))
    hit_id = torch.where(id_k[idx] >= 0, id_k[idx], hb.tri_id)
    compare_hits(f"{name} kernel vs brute ({what})", hb.t, hb.tri_id,
                 t_k[idx], id_k[idx],
                 cond=t_conditioning(o[idx], d[idx], geom, hit_id))
    ms_k = cuda_ms(lambda: CK.closest_hit_cuda(inp), 20)
    if plain_reps:
        ms_p = cuda_ms(lambda: CK.closest_hit_plain(inp), plain_reps)
    ms_q = cuda_ms(lambda: CK.intersect_cuda(o, d, *geom, coherent=coherent,
                                             group=group, t_min=t_min), 5)
    bound, bound_by, visits, visits_uncut, nbytes, t_ops, tile_pairs = \
        kernel_bound(inp, CK.TRI_CHUNK, t_full)
    cnt = inp.count.float()
    T = inp.count.shape[0]
    chunk_bytes = CK.N_COEF * CK.TRI_CHUNK * 4
    listed = int(inp.count.sum()) * inp.group
    per_tile = inp.phi.shape[1] // T // CK.BLOCK_RAYS
    print(f"{name}: coefficient traffic of {T} tiles of "
          f"{inp.phi.shape[1] // T} rays, {per_tile} blocks each: at least "
          f"{tile_pairs} (tile, chunk) visits x {chunk_bytes} B = "
          f"{tile_pairs * chunk_bytes / 1e6:.1f} MB, at most {listed} listed"
          f" x {per_tile} blocks = "
          f"{listed * per_tile * chunk_bytes / 1e6:.1f} MB, beside an "
          f"operations bound of {t_ops:.3f} ms")
    print(f"{name}: {N} rays, candidates/tile mean {float(cnt.mean()):.1f} "
          f"max {int(cnt.max())}, kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms,"
          f" query (packing + prepass + kernel) {ms_q:.3f} ms, bound "
          f"{bound:.3f} ms "
          f"({bound_by}: {visits} ray-triangle pairs entered before the hit,"
          f" {visits_uncut} entered at all, {nbytes} bytes), "
          f"{N / ms_k * 1e3 / 1e6:.1f} Mrays/s kernel, "
          f"{N / ms_q * 1e3 / 1e6:.1f} Mrays/s query")
    res = dict(ms=ms_k, plain_ms=ms_p, bound_ms=bound, bound_by=bound_by,
               err=err, query_ms=ms_q, group=inp.group, hits=(t_k, id_k))
    res["prepass"] = check_prepass(name, o, geom, inp, coherent)
    res["pack"] = check_pack(name, o, d, geom, inp)
    if both_modes:
        check_prepass(name, o, geom, inp, coherent,
                      mode="ray" if coherent else "tile", timed=False)
    return res


class QueryRecorder:
    """An oracle for the loss functions that records each query's inputs
    and hits and answers it through `fn` (the "cuda" backend if None);
    keep_rays=False records the hits alone."""

    def __init__(self, fn=None, keep_rays=True):
        from drt_tpu_torch.intersect.api import get_intersect_fn
        self.fn = fn or get_intersect_fn("cuda")
        self.keep_rays = keep_rays
        self.queries = []
        self.hits = []

    def __call__(self, origins, dirs, vertices, faces, face_valid=None, *,
                 coherent):
        if self.keep_rays:
            self.queries.append((origins.detach().clone(),
                                 dirs.detach().clone(), coherent))
        hits = self.fn(origins, dirs, vertices, faces, face_valid,
                       coherent=coherent)
        self.hits.append(hits)
        return hits


def one_shift_oracle(shift):
    """The "cuda" backend with every query's scene shifted by the same
    `shift` [3] instead of by the query's own mean ray origin, so a ray meets
    the same rounded coefficients whatever batch it arrives in."""
    from drt_tpu_torch.intersect.cuda_kernel import intersect_cuda

    def fn(origins, dirs, vertices, faces, face_valid=None, *, coherent):
        return intersect_cuda(origins.detach(), dirs.detach(),
                              vertices.detach(), faces, face_valid,
                              coherent=coherent, shift=shift)
    return fn


QUERY_NAMES = ("bounce1", "bounce2", "exit", "silhouette")


def check_step_queries(label, mesh, view, budget, res, hp, gen):
    """The four kinds of query a train step makes on `mesh` (the ray loss's
    three and one silhouette view's at `budget` samples), each through
    check_query: both kernels against their plain versions at this mesh's
    own chunk count. Returns ({name: result}, the recorded queries)."""
    import torch
    from drt_tpu_torch.optimize.losses import ray_loss, silhouette_loss
    rec = QueryRecorder()
    with torch.no_grad():
        ray_loss(mesh, view, rec, hp.ior, hp.ext_ior)
        silhouette_loss(mesh, view, rec, budget, *res)
    if [q[2] for q in rec.queries] != [True, False, False, False]:
        fail(f"{label}: unexpected queries {[q[2] for q in rec.queries]}")
    geom = (mesh.vertices, mesh.faces, mesh.face_valid)
    out = {}
    for qname, (o, d, coherent) in zip(QUERY_NAMES, rec.queries):
        out[f"{label} {qname}"] = check_query(
            f"{label} {qname}", o, d, geom, coherent, gen,
            brute_all=qname == "silhouette")
    return out, rec.queries


def replay(recorded, device):
    """An oracle that answers the i-th query with the i-th recorded hits."""
    from drt_tpu_torch.intersect.api import Hits
    queue = list(recorded)

    def fn(origins, dirs, vertices, faces, face_valid=None, *, coherent):
        h = queue.pop(0)
        if h.t.shape[0] != origins.shape[0]:
            fail(f"replay: recorded {h.t.shape[0]} rays, asked for "
                 f"{origins.shape[0]}")
        return Hits(h.t.to(device), h.tri_id.to(device))
    return fn


def queries_per_step(weights, n_silh=8, ray_chunks=1):
    """(closest-hit, prepass, packing launches) of one train step, from
    which terms a zero weight skips: the ray loss makes 3 queries (bounce 1
    coherent, bounce 2 and exit incoherent) for each chunk of rays, and a
    chunked loss reruns them in the backward; each silhouette view makes one
    incoherent query. Every query launches each kernel once. h1's two loss
    evaluations split these between them."""
    rerun = 2 if ray_chunks > 1 else 1
    ray = 3 * ray_chunks * rerun if weights.ray_w else 0
    silh = n_silh if weights.vh_w else 0
    return (ray + silh,) * 3


def scatters_per_step(weights, faces_padded, n_silh=8):
    """Launches of the scatter kernel in one step without h1 (the normals
    of `with_vertices`, then the backward of each silhouette view's
    endpoint gather, of the dihedral gather, and of `_gather_tri9` in both
    bounces: 2 each on its soup route, at most 2^16 padded faces, 1
    above); a zero weight skips its term."""
    from drt_tpu_torch.render.trace import _SOUP_BWD_MAX_FACES
    tri9 = 2 if faces_padded <= _SOUP_BWD_MAX_FACES else 1
    return (1 + (n_silh if weights.vh_w else 0) + (1 if weights.sm_w else 0)
            + (2 * tri9 if weights.ray_w else 0))


@contextlib.contextmanager
def scatter_spy(calls, label=None, keep=True):
    """For the duration, each call of the scatter kernel's wrapper appends
    to `calls` its (rows, idx, num, out, route), cloned (keep), or its (R,
    C, num, route), `route` the one the call took; with `label`, each runs
    in a torch.profiler range of that name."""
    from torch.profiler import record_function
    from drt_tpu_torch.geometry import scatter as SC
    real = SC.scatter_rows_cuda

    def spy(rows, idx, num, route=None):
        taken = route or SC.scatter_route(rows.shape[0], rows.shape[1], num)
        with record_function(label) if label else contextlib.nullcontext():
            out = real(rows, idx, num, route=route)
        calls.append((rows.clone(), idx.clone(), num, out.clone(), taken)
                     if keep else (rows.shape[0], rows.shape[1], num, taken))
        return out
    SC.scatter_rows_cuda = spy
    try:
        yield
    finally:
        SC.scatter_rows_cuda = real


def scatter_kinds(shapes, mesh, budget, n_rays):
    """The kind of each of a step's scatter calls, from its (rows, cols,
    destinations) and the mesh's padded sizes: "normals" (the first [3F,3]
    call, in the forward), "silhouette" ([2 budget,3]), "dihedral"
    ([6E,3]), "soup" (a bounce's [N,9] into [F,9]), "second stage" (the
    soup's [3F,3] into [V,3], in the backward), "direct" (a bounce's
    [3N,3] into [V,3] above 2^16 faces)."""
    F, E = mesh.faces.shape[0], mesh.edges.shape[0]
    kinds, seen_3f = [], False
    for R, C, _ in shapes:
        if C == 9:
            kinds.append("soup")
        elif R == 2 * budget:
            kinds.append("silhouette")
        elif R == 6 * E:
            kinds.append("dihedral")
        elif R == 3 * F:
            kinds.append("second stage" if seen_3f else "normals")
            seen_3f = True
        elif R == 3 * n_rays:
            kinds.append("direct")
        else:
            kinds.append("other")
    return kinds


def check_scatters(calls, kinds):
    """Each recorded scatter (rows, idx, num, out, route) against
    scatter_rows_plain run on the CPU bit for bit (int views), and the
    kernel run again on the same inputs on the route the call took for the
    same bits; where it took the cluster route, the grid route too, for the
    same bits. Then on the same inputs, in turns under torch.profiler
    (`device_spans`), the device time, span and operations of each route
    run and of `index_add_` (zeros and the add: the same function); each
    route's call with its wrapper (CUDA events, the flag's wait included);
    its bound (bytes: rows and indices read once, the output written once);
    the plain version's time on the card and `index_put_(accumulate=True)`
    (IndexBackward0's path before the kernel). Returns one dict a call."""
    import torch
    from drt_tpu_torch.geometry import scatter as SC
    out_rows = []
    for i, ((rows, idx, num, out, route), kind) in enumerate(zip(calls,
                                                                  kinds)):
        want = SC.scatter_rows_plain(rows.cpu(), idx.cpu(), num)
        routes = ("cluster", "grid") if route == "cluster" else ("grid",)
        again = {r: SC.scatter_rows_cuda(rows, idx, num, route=r)
                 for r in routes}
        torch.cuda.synchronize()
        bits = same_bits(out.cpu(), want)
        det = all(same_bits(o, out) for o in again.values())
        err = float((out.cpu().double() - want.double()).abs().max()) \
            if out.numel() else 0.0
        R, C = rows.shape
        live = int((rows != 0).any(dim=1).sum())
        size = rows.element_size()
        nbytes = R * C * size + R * 8 + num * C * size
        bound = nbytes / HBM_RATE * 1e3
        timed = {r: (lambda r=r: SC.scatter_rows_cuda(rows, idx, num,
                                                      route=r))
                 for r in routes}
        dev = device_spans({**timed, "index_add_": lambda: rows.new_zeros(
            num, C).index_add_(0, idx, rows)})
        call_ms = {r: cuda_ms(fn, 20) for r, fn in timed.items()}
        plain = cuda_ms(lambda: SC.scatter_rows_plain(rows, idx, num), 20)
        zeros = rows.new_zeros(num, C)
        put = cuda_ms(lambda: zeros.index_put_((idx,), rows,
                                               accumulate=True), 20)
        print(f"scatter {i} ({kind}): {R} rows of {C} "
              f"{str(rows.dtype)[6:]} ({live} not all zero) into {num}, "
              f"route {route}: the CPU plain version's bits {bits}, the "
              f"reruns' (routes {', '.join(routes)}) {det}; device ms "
              f"(span, operations) "
              + ", ".join(f"{k} {d['ms']:.4f} ({d['span_ms']:.4f}, "
                          f"{d['ops']})" for k, d in dev.items())
              + f"; bound {bound:.4f} ms (bytes); with the wrapper "
              + ", ".join(f"{k} {t:.4f}" for k, t in call_ms.items())
              + f" ms; plain on the card {plain:.4f} ms, index_put_ "
              f"accumulate {put:.4f} ms")
        if not (bits and det):
            fail(f"scatter {i}: the kernel differs from scatter_rows_plain "
                 f"on the CPU ({bits}, largest difference {err:g}) or from "
                 f"its reruns on routes {routes} ({det})")
        out_rows.append(dict(
            kind=kind, rows=R, cols=C, num=num, live=live, route=route,
            ms=dev[route]["ms"], span_ms=dev[route]["span_ms"],
            ops=dev[route]["ops"], call_ms=call_ms[route],
            grid_ms=dev["grid"]["ms"], grid_span_ms=dev["grid"]["span_ms"],
            grid_call_ms=call_ms["grid"], plain_ms=plain,
            index_add_ms=dev["index_add_"]["ms"],
            index_add_span_ms=dev["index_add_"]["span_ms"],
            index_add_ops=dev["index_add_"]["ops"], index_put_ms=put,
            bound_ms=bound, err=err))
    return out_rows


# Device operations a scatter call may make, by route: the cluster route's
# one kernel and the flag's read; the grid route's clear, upfront kernel, 2
# passes (up to 65,536 destinations), reduce and the flag's read.
MAX_SCATTER_OPS = {"cluster": 2, "grid": 6}


def scatter_entry(checked, prof, launches, per_step, lod_launches,
                  route_launches):
    """The kernels line's entry of the scatter kernel: its numbers on the
    largest scatter of phase 5's step (a bounce's [N,9] soup rows into
    [F,9], the grid route), its device time the profiled step's of that
    call, `index_add_`'s device time on the same input; then each route,
    the cluster size, and per call kind its numbers (the median over the
    step's calls of that kind)."""
    from drt_tpu_torch.geometry import scatter as SC
    i = max(range(len(checked)), key=lambda j: (checked[j]["cols"] == 9,
                                                 checked[j]["rows"]))
    big = checked[i]
    by_kind = {}
    for j, c in enumerate(checked):
        by_kind.setdefault(c["kind"], []).append((c, prof["ms"][j],
                                                  prof["ops"][j]))
    kinds = []
    for kind, cs in by_kind.items():
        def med(key):
            return statistics.median(c[key] for c, _, _ in cs)
        kinds.append({
            "kind": kind, "calls": len(cs), "rows": cs[0][0]["rows"],
            "cols": cs[0][0]["cols"], "num": cs[0][0]["num"],
            "route": cs[0][0]["route"],
            "step_ms": statistics.median(m for _, m, _ in cs),
            "step_ops": max(o for _, _, o in cs),
            "ms": med("ms"), "span_ms": med("span_ms"),
            "call_ms": med("call_ms"), "grid_ms": med("grid_ms"),
            "bound_ms": med("bound_ms"), "index_add_ms": med("index_add_ms"),
            "index_add_span_ms": med("index_add_span_ms"),
            "plain_ms": med("plain_ms")})
    return {
        "name": "scatter_kernel",
        "route": "cuda",
        "source": "drt_tpu_torch/csrc/scatter.cu",
        "replaces": "drt_tpu/render/trace.py:164",
        "replaces_also": ["drt_tpu/geometry/normals.py:31",
                          "drt_tpu/render/silhouette.py:158",
                          "drt_tpu/geometry/metrics.py:56"],
        "launches": launches,
        "launches_per_step": per_step,
        "launches_lod": lod_launches,
        "routes": {"cluster": {"kernel": "scatter_cluster_kernel",
                               "launches": route_launches[0],
                               "max_rows": SC.CLUSTER_MAX_ROWS,
                               "max_out": SC.CLUSTER_MAX_OUT},
                   "grid": {"kernels": ["scatter_upfront_kernel",
                                        "scatter_pass_kernel",
                                        "scatter_reduce_kernel"],
                            "launches": route_launches[1]}},
        "cluster_size": SC.cluster_size(),
        "shape": f"{big['rows']} rows of {big['cols']} into {big['num']} "
                 "(a bounce's _gather_tri9 soup backward, dog_mid45k at "
                 "1280x960, the grid route)",
        "max_abs_err": max(c["err"] for c in checked),
        "ms": prof["ms"][i],
        "ms_from": "torch.profiler: the device time of that call's "
                   "operations in phase 5's profiled step",
        "call_ms": big["call_ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": big["index_add_ms"],
        "library": "torch.Tensor.index_add_ on zeros (its device time, "
                   "torch.profiler, on the same input)",
        "library_index_put_ms": big["index_put_ms"],
        "step_ms": sum(prof["ms"]),
        "step_ops": sum(prof["ops"]),
        "step_bound_ms": sum(c["bound_ms"] for c in checked),
        "step_index_add_ms": sum(c["index_add_ms"] for c in checked),
        "step_index_put_ms": sum(c["index_put_ms"] for c in checked),
        "step_device_busy_ms": prof["busy_ms"],
        "step_device_ops": prof["kernels"],
        "kinds": kinds,
        "calls": checked,
    }


# Kernels of torch's scatter-adds, which the step's vertex gathers ran
# before csrc/scatter.cu (IndexBackward0's `index_put_` with accumulate,
# `index_add_`; lowercased): none may run in a step.
PARENT_SCATTER_KERNELS = ("indexing_backward_kernel", "indexfunclargeindex",
                          "indexfuncsmallindex")


# Device operations of the packing stages before csrc/pack.cu took them
# (lowercased substrings of their kernels' names): none may run inside an
# oracle range.
PACKED_STAGE_KERNELS = ("cross", "minnan", "maxnan", "minops", "maxops",
                        "catarray")
MAX_ORACLE_OPS = 8                # a query: mean, pack, prepass, closest hit
# A step's device operations inside the oracle's ranges while the torch
# stages packed each query (groups of 4 for the incoherent ones).
TORCH_STAGES_ORACLE_OPS = 707


def oracle_kernel_profile(weights, res, budget, hp, mesh, cap, n_queries):
    """One more sgd + none step under torch.profiler, each oracle query in a
    `record_function` range: the device kernels launched inside the ranges
    (the oracle's) and outside them, by name, and a query's count; fails if
    the oracle launched a sort kernel (its prepass sorts inside
    csrc/candidates.cu), a kernel of the packing stages (a cross product, a
    min/max reduction, a concatenation: csrc/pack.cu does them), more than
    MAX_ORACLE_OPS device operations in a query, or if the step's
    `n_queries` queries did not each give a range with a device-side span,
    since then the check could not see the oracle's kernels (a profile
    that lacks a range's span is taken again, `profile_again`). Each call of
    the scatter kernel runs in a range too: its device span, the step's
    device time by kernel, and a failure if torch's scatter-add kernels
    (PARENT_SCATTER_KERNELS) ran anywhere in the step. Returns the step's
    device operations inside the oracle's ranges, each query's packing
    kernel device ms (its profiler span) and the scatter calls' shapes and
    device ms with the step's device busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.optimize import make_train_step
    base = get_intersect_fn("auto")

    def traced(*args, **kwargs):
        with record_function("oracle query"):
            return base(*args, **kwargs)
    init, step, _ = make_train_step(traced, weights, *res, budget,
                                    momentum=hp.momentum,
                                    grad_clamp=hp.grad_clamp)
    state = init(mesh)
    cpu_t, dev_t = (torch.autograd.DeviceType.CPU,
                    torch.autograd.DeviceType.CUDA)
    for attempt in range(1, PROFILE_TRIES + 1):
        scatter_calls = []
        with scatter_spy(scatter_calls, "scatter rows", keep=False), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            step(state, hp.start_lr, mesh, cap.views, 0, list(range(8)))
            torch.cuda.synchronize()
        events = prof.events()
        n_ranges = sum(e.name == "oracle query" and e.device_type == cpu_t
                       for e in events)
        # each range's device-side span (kineto's GPU user annotation): the
        # kernels that ran inside one are the oracle's
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == "oracle query" and e.device_type == dev_t]
        sc_spans = [(e.time_range.start, e.time_range.end) for e in events
                    if e.name == "scatter rows" and e.device_type == dev_t]
        if (len(spans) == n_ranges and len(sc_spans) == len(scatter_calls)
                or not profile_again(
                    attempt, f"{len(spans)} device spans for {n_ranges} "
                    f"oracle ranges, {len(sc_spans)} for "
                    f"{len(scatter_calls)} scatter ranges")):
            break
    kernels = [e for e in events if e.device_type == dev_t
               and e.name not in ("oracle query", "scatter rows")]
    per_query = [[k for k in kernels
                  if a <= k.time_range.start and k.time_range.end <= b]
                 for a, b in spans]
    pack_ms = [sum(k.time_range.end - k.time_range.start for k in q
                   if k.name.split("(")[0] == "pack_kernel") / 1e3
               for q in per_query]
    per_query = [[k.name for k in q] for q in per_query]
    oracle = [n for q in per_query for n in q]
    sorts = sorted({n for n in oracle if "sort" in n.lower()})
    stages = sorted({n[:80] for n in oracle
                     if any(k in n.lower() for k in PACKED_STAGE_KERNELS)})
    names = {}
    for n in oracle:
        key = n.split("(")[0][:60]
        names[key] = names.get(key, 0) + 1
    print(f"profile: one step, {n_ranges} oracle queries, {len(spans)} "
          f"device spans, {len(oracle)} of the step's {len(kernels)} device "
          f"kernels inside them; by name "
          f"{sorted(names.items(), key=lambda kv: -kv[1])}; sort kernels in "
          f"the oracle: {sorts or 'none'}; sort kernels elsewhere in the "
          f"step: {sum('sort' in k.name.lower() for k in kernels)}")
    print(f"profile: device operations inside the oracle's ranges: "
          f"{len(oracle)} a step ({TORCH_STAGES_ORACLE_OPS} with the torch "
          f"stages), "
          f"{[len(q) for q in per_query]} a query; kernels of the packing "
          f"stages among them: {stages or 'none'}; pack_kernel's device ms a "
          f"query {[round(x, 4) for x in pack_ms]}")
    if not n_ranges == len(spans) == n_queries:
        fail(f"profile: {n_ranges} oracle ranges and {len(spans)} device "
             f"spans for the step's {n_queries} queries: the oracle's "
             "kernels cannot be told apart")
    if sorts:
        fail(f"profile: the oracle launched sort kernels {sorts}")
    if stages:
        fail(f"profile: the oracle launched the packing stages' kernels "
             f"{stages}")
    if max(len(q) for q in per_query) > MAX_ORACLE_OPS:
        fail(f"profile: a query made {max(len(q) for q in per_query)} device "
             f"operations, more than {MAX_ORACLE_OPS}")
    # the scatter kernel: each call's device span, and no torch scatter-add
    if len(sc_spans) != len(scatter_calls):
        fail(f"profile: {len(sc_spans)} device spans for the step's "
             f"{len(scatter_calls)} scatter calls")
    sc_in = [[k for k in kernels
              if a <= k.time_range.start and k.time_range.end <= b]
             for a, b in sc_spans]
    sc_ms = [sum(k.time_range.end - k.time_range.start for k in ks) / 1e3
             for ks in sc_in]
    sc_ops = [len(ks) for ks in sc_in]
    over = [(call, n) for call, n in zip(scatter_calls, sc_ops)
            if n > MAX_SCATTER_OPS[call[3]]]
    parent = sorted({k.name[:80] for k in kernels
                     if any(p in k.name.lower()
                            for p in PARENT_SCATTER_KERNELS)})
    ops = sorted({e.name for e in events if e.device_type == cpu_t and (
        e.name in ("IndexBackward0", "IndexPutBackward0")
        or e.name.startswith(("aten::index_put", "aten::index_add",
                              "aten::_index_put")))})
    by_name = {}
    for k in kernels:
        key = k.name.split("(")[0].split("<")[0][:50]
        by_name[key] = (by_name.get(key, 0.0)
                        + (k.time_range.end - k.time_range.start) / 1e3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"profile: the step's device busy time {busy:.3f} ms in "
          f"{len(kernels)} kernels; by name (ms) "
          f"{[(n, round(t, 3)) for n, t in top]}")
    print(f"profile: {len(sc_spans)} scatter calls (rows, columns, "
          f"destinations, route) {scatter_calls}, device ms each "
          f"{[round(x, 4) for x in sc_ms]}, {sum(sc_ms):.4f} ms in all; "
          f"device operations each {sc_ops}, {sum(sc_ops)} in all (at most "
          f"{MAX_SCATTER_OPS} a call by route); torch scatter-add kernels "
          f"in the step: {parent or 'none'}; their ops on the host: "
          f"{ops or 'none'}")
    if parent:
        fail(f"profile: the step launched torch's scatter-add kernels "
             f"{parent} (host ops {ops})")
    if over:
        fail(f"profile: scatter calls (rows, columns, destinations, route) "
             f"with more device operations than their route allows: {over}")
    return len(oracle), pack_ms, dict(
        calls=scatter_calls, ms=sc_ms, ops=sc_ops, busy_ms=busy,
        kernels=len(kernels))


def run_steps(name, step, state, lr, mesh, cap, seed, n, expect,
              cg_expect=None, cg_seen=None, cg_route=None,
              chain=("steps", CHAIN_PER_STEP)):
    """n steps through `step`; the launch counts of each against `expect`
    (closest-hit, prepass, packing) and, where given, its CG launches
    against `cg_expect`, every one on route `cg_route` (the counts of each
    step appended to the list `cg_seen` as `cg_counts()`); its bounce,
    tail and silhouette launches against chain[1], noted on path chain[0].
    Returns
    (state, losses, ms of the last step)."""
    import torch
    from drt_tpu_torch.intersect import cuda_kernel as CK
    ray_gen = cap.ray_view_generator(seed=seed)
    silh_gen = cap.silh_view_generator(seed=seed + 1000)
    losses, ms = [], 0.0
    for it in range(n):
        CK.counters.reset()
        ray_idx = next(ray_gen)
        silh_idx = [next(silh_gen) for _ in range(8)]
        torch.cuda.synchronize()
        t0 = time.time()
        state, loss, aux = step(state, lr, mesh, cap.views, ray_idx,
                                silh_idx)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        losses.append(float(loss))
        got = counts()
        cg_got, cg_shared, cg_global = cg_counts()
        chain_got = chain_counts()
        print(f"{name} step {it}: {ms:.1f} ms, loss {losses[-1]:.6g}, max "
              f"grad {float(aux['max_grad']):.3g}, launches {got[0]} "
              f"closest-hit, {got[1]} prepass, {got[2]} packing, {cg_got} "
              f"CG ({cg_shared} shared route, {cg_global} global route), "
              f"{chain_got[0]} bounce chain, {chain_got[1]} ray-loss tail, "
              f"{chain_got[2]} silhouette pre, {chain_got[3]} post, "
              f"{chain_got[4]} backward")
        note_chain(chain[0], chain_got, chain[1])
        if got != tuple(expect):
            fail(f"{name} step {it}: launches {got}, expected {expect}")
        if cg_expect is not None and cg_got != cg_expect:
            fail(f"{name} step {it}: {cg_got} CG launches, reckoned "
                 f"{cg_expect}")
        if cg_route is not None and cg_got != {
                "shared": cg_shared, "global": cg_global}[cg_route]:
            fail(f"{name} step {it}: {cg_shared} CG launches on the shared "
                 f"route and {cg_global} on the global, every one reckoned "
                 f"on the {cg_route} route")
        if cg_seen is not None:
            cg_seen.append((cg_got, cg_shared, cg_global))
        if not math.isfinite(losses[-1]):
            fail(f"{name} step {it}: loss is not finite")
    return state, losses, ms


def small_reference_check(dev):
    """Loss and gradient of the whole path on a small icosphere (float64,
    compat chain), on the card against the CPU. The CPU run with its own
    oracle (the kernel's plain twin) must see the same valid rays but for
    the tie tolerance; the CPU run fed the card's recorded hits must give
    the card's loss within rtol 1e-7 and its gradient within 1e-6 of the
    gradient's largest entry (float64 sums in another order)."""
    import numpy as np
    import torch
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.data.views import ViewBatch
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.mesh import build_mesh_state
    from drt_tpu_torch.optimize import (LossWeights,
                                        default_silhouette_budget, total_loss)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_meshes", os.path.join(HERE, "tests", "meshes.py"))
    meshes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(meshes)
    make_icosphere = meshes.make_icosphere

    res = (48, 64)
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=20.0)
    cap = synthesize_capture(gt_v, gt_f, num_views=4, resy=res[0],
                             resx=res[1], device="cpu")
    rng = np.random.default_rng(1)
    v0, f0 = make_icosphere(subdivisions=2, radius=20.0)
    v0 = v0 * np.clip(1 + 0.06 * rng.standard_normal(len(v0))[:, None],
                      0.9, 1.1)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    v0 = v0 @ q.T
    w = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.4723,
                    compat=True)

    def run(device, fn):
        ms = build_mesh_state(v0, f0, dtype=torch.float64, device=device)
        views = ViewBatch(*[x.to(device=device, dtype=torch.float64)
                            if x.is_floating_point() else x.to(device)
                            for x in cap.views])
        v = ms.vertices.clone().requires_grad_(True)
        loss, aux = total_loss(ms.with_vertices(v), views, 1, [0, 1, 2, 3],
                               fn, w, *res,
                               default_silhouette_budget(ms.num_edges))
        (g,) = torch.autograd.grad(loss, v)
        return float(loss.detach()), g.cpu(), int(aux["valid_rays"])

    rec = QueryRecorder()
    l_g, g_g, n_g = run(dev, rec)
    _, _, n_c = run("cpu", get_intersect_fn("auto"))
    l_r, g_r, n_r = run("cpu", replay(rec.hits, "cpu"))
    dg = float((g_g - g_r).abs().max())
    g_max = float(g_r.abs().max())
    print(f"small: icosphere valid rays card {n_g}, cpu {n_c}; with the "
          f"card's hits on the cpu: loss card {l_g:.15g} cpu {l_r:.15g}, "
          f"max |dgrad| {dg:.3g} (max |grad| {g_max:.3g})")
    if not (math.isfinite(l_g) and torch.isfinite(g_g).all()):
        fail("small: loss or gradient not finite on the card")
    if abs(n_g - n_c) > max(1, TIE_PER_1024 * n_c // 1024) or n_r != n_g:
        fail("small: valid rays differ between the card and the CPU")
    if abs(l_g - l_r) > 1e-7 * abs(l_r) or dg > 1e-6 * g_max:
        fail("small: loss or gradient differs between the card and the CPU")


@contextlib.contextmanager
def timed(module, name, log, wrap=None):
    """Replace module.name, for the duration, by a wrapper that appends
    (seconds, result) of each call to `log`, the card synchronized on both
    sides; wrap(args, kwargs) may adjust the arguments first."""
    import torch
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        if wrap is not None:
            args, kwargs = wrap(args, kwargs)
        torch.cuda.synchronize()
        t0 = time.time()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((time.time() - t0, out))
        return out
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


def cli_phase(dev, RES, gt_mesh, views=8, carve_res=160, render_res=512,
              lens=(3.0, 1.8)):
    """Phase 10: the command line on `dev` (see the module docstring).
    Returns (closest-hit, prepass, packing launches, timings)."""
    import numpy as np
    import torch
    import drt_tpu_torch.data as D
    import drt_tpu_torch.data.carve as CV
    import drt_tpu_torch.optimize as OPT
    from drt_tpu_torch.cli import main as cli
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.mesh import load_ply
    from drt_tpu_torch.mesh.topology import build_topology

    def watertight(label, v, f):
        if (not np.isfinite(v).all() or len(f) == 0
                or not build_topology(np.asarray(f), len(v)).is_watertight):
            fail(f"cli: {label} is not a finite watertight mesh")

    dog90 = gt_mesh
    passes, iters = 2, 10
    dev_args = ["--device", str(dev)]
    tm = {}
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            # -- reconstruct ------------------------------------------------
            synth, saves, occ, hull, opt, info = [], [], [], [], [], {}

            def with_info(args, kwargs):
                kwargs["run_info"] = info
                return args, kwargs
            argv = ["reconstruct", "--name", "dog", "--data", "synthetic",
                    "--gt-mesh", dog90, "--views", str(views),
                    "--num-view", str(views), "--resy", str(RES[0]),
                    "--resx", str(RES[1]), "--init", "carved",
                    "--carve-res", str(carve_res), "--passes", str(passes),
                    "--iters", str(iters), "--start-len", str(lens[0]),
                    "--end-len", str(lens[1]), *dev_args]
            torch.cuda.synchronize()
            CK.counters.reset()                  # main path starts here
            t0 = time.time()
            with timed(D, "synthesize_capture", synth), \
                    timed(np, "savez_compressed", saves), \
                    timed(CV, "carve_occupancy", occ), \
                    timed(CV, "carved_visual_hull", hull), \
                    timed(OPT, "optimize", opt, with_info):
                cli(argv)
            torch.cuda.synchronize()
            tm["reconstruct_s"] = time.time() - t0
            launches = counts()                  # main path ends here
            # the synthesis renders each view (2 bounces, no loss)
            note_chain("cli", chain_counts(),
                       (views * 2 + passes * iters * CHAIN_PER_STEP[0],)
                       + tuple(passes * iters * k
                               for k in CHAIN_PER_STEP[1:]))
            cap = synth[0][1]
            tm["cache_write_s"] = saves[0][0]
            tm["synthesis_s"] = synth[0][0] - saves[0][0]
            tm["carve_occupancy_s"] = occ[0][0]
            tm["carve_occupancy_ms_per_view"] = occ[0][0] / views * 1e3
            tm["carve_host_s"] = hull[0][0] - occ[0][0]
            tm["optimize_s"] = opt[0][0]
            tm["passes"] = [{k: p[k] for k in ("faces", "budget", "remesh_s",
                                               "steps_s")}
                            for p in info["passes"]]
            hv, hf = hull[0][1]
            watertight("the carved hull", hv, hf)
            if info["remesh_failures"] or info["remesher"] != "native":
                fail(f"cli: remesh health {info}")
            expect = (views * 4 + passes * iters * 11,) * 3
            print(f"cli: reconstruct: {launches} closest-hit, prepass and "
                  f"packing launches, expected {expect[0]} each ({views} "
                  f"views x 4 in the synthesis, {passes * iters} steps x "
                  "11)")
            if launches != expect:
                fail(f"cli: reconstruct launches {launches}, "
                     f"expected {expect}")
            recons = os.path.join("result", "dog_recons.ply")
            rv, rf = load_ply(recons)
            watertight("dog_recons.ply", rv, rf)
            if len(rf) != info["passes"][-1]["faces"]:
                fail("cli: dog_recons.ply is not the last pass's mesh")
            print(f"cli: carved hull {len(hv)} vertices / {len(hf)} faces; "
                  f"passes {tm['passes']}; result {len(rf)} faces")

            # -- carve_occupancy of two views, card against CPU -------------
            lo, hi = CV.rig_working_volume(cap)
            v2 = cap.views
            args2 = (v2.mask[:2], v2.R[:2], v2.K[:2], lo, hi, carve_res)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            fk, sk, _, _ = CV.carve_occupancy(*args2, device=dev)
            torch.cuda.synchronize()
            tm["carve_occupancy_2v_card_s"] = time.time() - t0
            tm["carve_occupancy_peak_gib"] = (
                torch.cuda.max_memory_allocated() - base) / 2 ** 30
            # a view's device time: the kernels' sum over a call of all
            # views (the call's host clock is mostly the host's grid)
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                CV.carve_occupancy(v2.mask, v2.R, v2.K, lo, hi, carve_res,
                                   device=dev)
            dev_us = sum(getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                         for e in prof.key_averages())
            tm["carve_occupancy_view_ms"] = (dev_us / 1e3 / views if dev_us
                                             else "not measured")
            t0 = time.time()
            fc, sc, _, _ = CV.carve_occupancy(
                *(a.cpu() for a in args2[:3]), *args2[3:], device="cpu")
            tm["carve_occupancy_2v_cpu_s"] = time.time() - t0
            flipped = (fk > 0.5) != (fc > 0.5)
            n_flip, dfield = int(flipped.sum()), float(np.abs(fk - fc).max())
            band = (float(np.abs(fc[flipped] - 0.5).max()) if n_flip
                    else 0.0)
            print(f"cli: carve_occupancy card against CPU, 2 views at "
                  f"{carve_res}^3: {n_flip} of {fk.size} voxels flipped "
                  "across 0.5 "
                  f"(farthest {band:g} from it), max |dfield| {dfield:g}, "
                  f"seen differs on {int((sk != sc).sum())}; "
                  f"{tm['carve_occupancy_2v_card_s']:.3f} s card, "
                  f"{tm['carve_occupancy_2v_cpu_s']:.3f} s CPU, device "
                  f"time {tm['carve_occupancy_view_ms']} ms a view "
                  "(torch.profiler), "
                  f"peak memory {tm['carve_occupancy_peak_gib']:.3f} GiB "
                  "above what was allocated before")
            if (dfield > 1e-6 or n_flip > 1e-4 * fk.size or band > 1e-5
                    or (sk != sc).any()):
                fail("cli: carve_occupancy differs between card and CPU")
            tm["carve_flipped"], tm["carve_max_dfield"] = n_flip, dfield

            # -- render ------------------------------------------------------
            CK.counters.reset()
            torch.cuda.synchronize()
            t0 = time.time()
            cli(["render", "--mesh", recons, "--out-dir", "renders",
                 "--res", str(render_res), *dev_args])
            torch.cuda.synchronize()
            tm["render_s"] = time.time() - t0
            r_launch = counts()
            note_chain("cli", chain_counts(), (2, 0, 0, 0, 0))
            pngs = sorted(os.listdir("renders"))
            if pngs != ["dog_recons_exitdir.png", "dog_recons_mask.png",
                        "dog_recons_valid.png"] or r_launch != (4, 4, 4):
                fail(f"cli: render wrote {pngs} with {r_launch} launches")
            # decoded by PIL, a decoder of its own (the port writes its PNGs
            # with zlib and struct)
            from PIL import Image
            mask = np.asarray(Image.open(
                os.path.join("renders", "dog_recons_mask.png")))
            exitdir = np.asarray(Image.open(
                os.path.join("renders", "dog_recons_exitdir.png")))
            if (mask.shape != (render_res,) * 2
                    or exitdir.shape != (render_res, render_res, 3)):
                fail(f"cli: render shapes {mask.shape}, {exitdir.shape}")
            covered = int((mask == 255).sum())
            if not 0 < covered < mask.size:
                fail(f"cli: render mask covers {covered} pixels")
            print(f"cli: render {render_res}x{render_res}: {r_launch} "
                  f"closest-hit, prepass and packing launches, "
                  f"mask covers {covered} pixels, {tm['render_s']:.2f} s")

            # -- evaluate and remesh through `python3 -m`, side by side ------
            env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            t0 = time.time()
            procs = {label: subprocess.Popen(
                [sys.executable, "-m", "drt_tpu_torch.cli", *sub], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for label, sub in (
                    ("evaluate", ["evaluate", "--mesh", recons, "--gt",
                                  dog90]),
                    ("remesh", ["remesh", "--mesh", recons, "--out",
                                "remeshed.ply", "--target-len", "2.0"]))}
            try:
                outs = {label: p.communicate(timeout=300)
                        for label, p in procs.items()}
            finally:
                for p in procs.values():
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            tm["evaluate_remesh_subprocesses_s"] = time.time() - t0
            for label, (out, err) in outs.items():
                if (procs[label].returncode != 0
                        or ("mean=" if label == "evaluate" else " -> ")
                        not in out):
                    fail(f"cli: {label} exited {procs[label].returncode}: "
                         f"{out[-500:]} {err[-2000:]}")
                print(f"cli: python3 -m drt_tpu_torch.cli {label}: "
                      f"{out.strip()}")
            print(f"cli: both interpreters, run side by side, "
                  f"{tm['evaluate_remesh_subprocesses_s']:.1f} s")
            watertight("remeshed.ply", *load_ply("remeshed.ply"))

            # -- carve from 2 views ------------------------------------------
            t0 = time.time()
            cli(["carve", "--name", "dog", "--data", "synthetic",
                 "--gt-mesh", dog90, "--views", "2", "--resy", str(RES[0]),
                 "--resx", str(RES[1]), "--carve-res", str(carve_res),
                 "--out", "carved2.ply", *dev_args])
            tm["carve_2v_s"] = time.time() - t0
            watertight("carved2.ply", *load_ply("carved2.ply"))

            # -- the h5 path -------------------------------------------------
            import importlib.util
            have = {m: importlib.util.find_spec(m) is not None
                    for m in ("h5py", "imageio", "PIL")}
            print(f"cli: python {sys.version.split()[0]}, torch "
                  f"{torch.__version__} (CUDA {torch.version.cuda}); "
                  f"installed: {have}")
            tm["installed"] = have
            try:
                import h5py  # noqa: F401
            except ImportError:
                print("cli: h5py is not installed here: the h5 path "
                      "(load_h5_capture, save_h5_capture, reconstruct --data "
                      "file.h5) was checked on the CPU only "
                      "(tests/test_torch_captured.py, "
                      "tests/test_torch_cli.py)")
                tm["h5"] = "not installed"
            else:
                from drt_tpu_torch.data.captured import save_h5_capture
                from drt_tpu_torch.data.views import CaptureData, ViewBatch
                two = CaptureData(name="dog", resy=cap.resy, resx=cap.resx,
                                  num_views=2,
                                  views=ViewBatch(*(x[:2] for x in v2)),
                                  num_view_used=2)
                save_h5_capture(two, "dog.h5")
                t0 = time.time()
                cli(["reconstruct", "--name", "dog", "--data", "dog.h5",
                     "--init", "carved", "--carve-res", str(carve_res),
                     "--passes", "1", "--iters", "2", "--start-len",
                     str(lens[0]), "--result-dir", "h5", *dev_args])
                tm["h5"] = time.time() - t0
                watertight("the h5 result",
                           *load_ply(os.path.join("h5", "dog_recons.ply")))
        finally:
            os.chdir(old_cwd)
    passes_txt = [(round(p["remesh_s"], 2), round(p["steps_s"], 2))
                  for p in tm["passes"]]
    print(f"cli: synthesis {tm['synthesis_s']:.2f} s, cache write "
          f"{tm['cache_write_s']:.2f} s, carve_occupancy "
          f"{tm['carve_occupancy_ms_per_view']:.1f} ms a view "
          f"({tm['carve_occupancy_s']:.2f} s for {views}), host carve "
          f"{tm['carve_host_s']:.2f} s, passes (remesh s, steps s) "
          f"{passes_txt}, "
          f"render {tm['render_s']:.2f} s, reconstruct "
          f"{tm['reconstruct_s']:.2f} s")
    return launches, tm


PARALLEL_RANK = "--parallel-rank"     # argv[1] of the ranks of phase 11b
RANK_DEADLINE_S = 600


def parallel_phase(res, hp, weights, budget, mesh, cap):
    """Phase 11a: the sharded step at world size 1 over NCCL against the
    plain step. Returns (closest-hit, prepass, packing launches) of its
    sharded steps and its times."""
    import torch
    import torch.distributed as dist
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.optimize import make_train_step
    from drt_tpu_torch.parallel import make_ray_mesh, make_sharded_train_step
    from drt_tpu_torch.parallel.multihost import init_multihost
    per_step = queries_per_step(weights)
    launches = [0, 0, 0]

    def pair(rmesh, optimizer, precond, n, lr, sharded_first=False):
        """n plain and n sharded steps from one state on the same views, in
        that order or the other; (bitwise equal, max |dparams|, plain ms,
        sharded ms of the last)."""
        kw = dict(intersect_fn=get_intersect_fn("auto"), weights=weights,
                  resy=res[0], resx=res[1], silhouette_budget=budget,
                  momentum=hp.momentum, optimizer=optimizer, precond=precond,
                  precond_lambda=hp.precond_lambda, cg_iters=hp.cg_iters,
                  grad_clamp=hp.grad_clamp)
        name = f"{optimizer} + {precond}"

        def plain():
            init, step, _ = make_train_step(**kw)
            return run_steps(f"parallel: plain {name}", step, init(mesh),
                             lr, mesh, cap, hp.seed, n, per_step)

        def sharded():
            (init, step, _), mesh_s, views_s = make_sharded_train_step(
                kw, rmesh, mesh, cap.views)
            return run_steps(
                f"parallel: sharded {name}", step, init(mesh_s), lr, mesh_s,
                dataclasses.replace(cap, views=views_s), hp.seed, n,
                per_step, chain=("parallel", CHAIN_PER_STEP))
        if sharded_first:
            (st_s, l_s, ms_s), (st_p, l_p, ms_p) = sharded(), plain()
        else:
            (st_p, l_p, ms_p), (st_s, l_s, ms_s) = plain(), sharded()
        for k in range(3):
            launches[k] += n * per_step[k]
        same = (l_p == l_s and torch.equal(st_p["params"], st_s["params"])
                and torch.equal(st_p["m"], st_s["m"]))
        return (same, float((st_p["params"] - st_s["params"]).abs().max()),
                ms_p, ms_s)

    with tempfile.TemporaryDirectory() as work:
        init_multihost("file://" + os.path.join(work, "pg"), 1, 0,
                       device="cuda")
        rmesh = make_ray_mesh()
        if (dist.get_backend(), rmesh.size, rmesh.device.type) != (
                "nccl", 1, "cuda"):
            fail(f"parallel: backend {dist.get_backend()}, mesh {rmesh}")
        # in turns (plain, sharded, sharded, plain): the host drifts
        same0, d0, ms_p0, ms_s0 = pair(rmesh, "sgd", "none", 3, hp.start_lr)
        _, _, ms_p1, ms_s1 = pair(rmesh, "sgd", "none", 3, hp.start_lr,
                                  sharded_first=True)
        ms_plain, ms_sharded = [ms_p0, ms_p1], [ms_s0, ms_s1]
        print(f"parallel: world size 1 (NCCL), default algorithms: sharded "
              f"step {ms_s0:.1f}, {ms_s1:.1f} ms against plain {ms_p0:.1f}, "
              f"{ms_p1:.1f} ms (third steps, in turns plain, sharded, "
              f"sharded, plain); bit for bit: {same0} (max |dparams| "
              f"{d0:.3g})")
        torch.use_deterministic_algorithms(True, warn_only=True)
        same1, d1, _, _ = pair(rmesh, "sgd", "none", 3, hp.start_lr)
        same2, d2, ms_h1_p, ms_h1_s = pair(rmesh, "uadam", "h1", 1, 0.01)
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    print(f"parallel: world size 1 (NCCL), deterministic algorithms: "
          f"sgd + none x3 bit for bit: {same1} (max |dparams| {d1:.3g}); "
          f"uadam + h1 x1 bit for bit: {same2} (max |dparams| {d2:.3g}), "
          f"step {ms_h1_s:.1f} ms against {ms_h1_p:.1f} ms")
    if not (same1 and same2):
        fail("parallel: the sharded step at world size 1 differs from the "
             "plain step")
    return launches, {"w1_sharded_ms": ms_sharded, "w1_plain_ms": ms_plain,
                      "w1_bitwise_default_algorithms": same0,
                      "w1_h1_sharded_ms": ms_h1_s, "w1_h1_plain_ms": ms_h1_p}


def parallel_rank(rank, work):
    """One of the two ranks of phase 11b (run as `chip_smoke.py
    --parallel-rank RANK DIR`): gloo over a file:// address in DIR, this
    rank's half of the rays on the card, one sgd + none step without the
    clamp for each oracle of DIR/inputs.pt (after a warm-up step); writes
    DIR/rank<RANK>.pt."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.parallel import make_ray_mesh, make_sharded_train_step
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(1)          # the work is on the card
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        work, "pg"), rank=rank, world_size=2)
    rmesh = make_ray_mesh(device=dev)
    inp = torch.load(os.path.join(work, "inputs.pt"), map_location=dev,
                     weights_only=False)
    out = {}
    for name, oracle in (("own", get_intersect_fn("auto")),
                         ("one", one_shift_oracle(inp["shift"]))):
        rec = QueryRecorder(oracle, keep_rays=False)
        (init, step, _), mesh, views = make_sharded_train_step(
            dict(inp["kwargs"], intersect_fn=rec), rmesh, inp["mesh"],
            inp["views"])
        # the same step twice from rest: the first warms the process up,
        # the second is timed, counted and recorded
        step(init(mesh), inp["lr"], mesh, views, inp["ray_idx"],
             inp["silh_idx"])
        rec.hits.clear()
        torch.cuda.synchronize()
        CK.counters.reset()
        t0 = time.time()
        st, loss, aux = step(init(mesh), inp["lr"], mesh, views,
                             inp["ray_idx"], inp["silh_idx"])
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        out[name] = dict(loss=float(loss), m=st["m"].cpu(), ms=ms,
                         ids=[h.tri_id.cpu() for h in rec.hits],
                         launches=counts(), chain=chain_counts(),
                         valid_rays=int(aux["valid_rays"]))
        print(f"parallel rank {rank}: {name} shift: {ms:.1f} ms, loss "
              f"{float(loss):.8g}, {views.ray_dir.shape[1]} rays a view, "
              f"launches {out[name]['launches']}", flush=True)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


GROUPS = (1, 4, 16)
BIG_SUBDIVISIONS = 3      # dog_mid45k's 38,962 faces -> 2,493,568
BIG_RAYS = 262144


def midpoint_subdivide(v, f):
    """One 1-to-4 midpoint subdivision of the triangles f [F,3] of v [V,3]:
    each edge gets its midpoint once, and a face's four children follow one
    another, so chunks of consecutive faces stay as tight as the parent's
    (a Morton-ordered mesh stays Morton-ordered)."""
    import torch
    V, F = v.shape[0], f.shape[0]
    e = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]).sort(dim=1)[0]
    key, inv = torch.unique(e[:, 0] * V + e[:, 1], return_inverse=True)
    mid = (v[key // V] + v[key % V]) / 2
    ab, bc, ca = (inv.reshape(3, F) + V).unbind(0)
    a, b, c = f.unbind(1)
    kids = torch.stack([a, ab, ca, ab, b, bc, ca, bc, c, ab, bc, ca], dim=1)
    return torch.cat([v, mid]), kids.reshape(-1, 3)


def groups_phase(dev, res, hp, mesh45, o_cam, d_cam, gen):
    """Phase 12: candidate groups, t_min and a mesh above the prepass
    kernel's box limit. Returns ({group: check_query result} of the
    dog_mid90k bounce-2 query, the phase's numbers)."""
    import torch
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.mesh import build_mesh_state, load_ply
    from drt_tpu_torch.optimize import default_silhouette_budget
    from drt_tpu_torch.optimize.losses import ray_loss, silhouette_loss
    t_phase = time.time()
    # dog_mid90k's queries under a capture of dog_mid45k, so that the exit
    # rays, which leave through the capture's surface, hit the queried one
    v45, f45 = load_ply(os.path.join(MESH_DIR, "dog_mid45k.ply"))
    cap = synthesize_capture(v45, f45, name="dog", num_views=1, resy=res[0],
                             resx=res[1], ior=hp.ior, ext_ior=hp.ext_ior,
                             num_view_used=1, device=dev)
    ms90 = build_mesh_state(*load_ply(os.path.join(MESH_DIR,
                                                   "dog_mid90k.ply")),
                            device=dev)
    geom = (ms90.vertices, ms90.faces, ms90.face_valid)
    rec = QueryRecorder()
    with torch.no_grad():
        ray_loss(ms90, cap.views.take(0), rec, hp.ior, hp.ext_ior)
        silhouette_loss(ms90, cap.views.take(0), rec,
                        default_silhouette_budget(ms90.num_edges), *res)
    names = ("camera", "bounce2", "exit", "silhouette")
    by_group, out = {}, {}
    for qname, (o, d, coherent) in zip(names, rec.queries):
        ref = None
        for g in GROUPS:
            label = f"groups: dog_mid90k {qname} group {g}"
            r = check_query(label, o, d, geom, coherent, gen, group=g,
                            brute_sample=4096, hit_sample=1024,
                            brute_all=qname == "silhouette",
                            both_modes=True)
            if r["group"] != g:
                fail(f"{label}: the query took group {r['group']}")
            t, ids = r.pop("hits")
            if ref is None:
                ref = (t, ids)
            else:
                compare_hits(f"{label} vs group 1", *ref, t, ids)
            if qname == "bounce2":
                by_group[g] = r
        del ref
    # t_min: half of the bounce-2 hits lie beyond the median t of them all
    o, d, _ = rec.queries[1]
    h = CK.intersect_cuda(o, d, *geom, coherent=False)
    t_min = float(h.t[h.tri_id >= 0].median())
    r = check_query(f"groups: dog_mid90k bounce2 t_min {t_min:.4g}", o, d,
                    geom, False, gen, t_min=t_min, brute_sample=4096,
                    hit_sample=1024)
    n_cut = int((r["hits"][1] >= 0).sum())
    print(f"groups: t_min {t_min:.6g}: {n_cut} hits beyond it, "
          f"{int((h.tri_id >= 0).sum())} at t_min 0")
    del rec, h, ms90, cap
    # above the cap: dog_mid45k subdivided three times
    t0 = time.time()
    v = mesh45.vertices[:mesh45.num_vertices]
    f = mesh45.faces[:mesh45.num_faces]
    for _ in range(BIG_SUBDIVISIONS):
        v, f = midpoint_subdivide(v, f)
    big = (v, f, torch.ones(f.shape[0], dtype=torch.bool, device=dev))
    nc = -(-f.shape[0] // CK.TRI_CHUNK)
    if nc <= CK.MAX_CHUNKS:
        fail(f"groups: the subdivided mesh has {nc} chunks, not above "
             f"MAX_CHUNKS = {CK.MAX_CHUNKS}")
    n = BIG_RAYS
    s0 = (o_cam.shape[0] - n) // 2       # the middle rows of the view
    ob, db = o_cam[s0:s0 + n].contiguous(), d_cam[s0:s0 + n].contiguous()
    CK.counters.reset()
    hb = CK.intersect_cuda(ob, db, *big, coherent=True)
    seen = counts()
    if seen != (1, 1, 1):
        fail(f"groups: above the cap, launches {seen}, expected (1, 1, 1)")
    r_big = check_query(f"groups: dog_mid45k subdivided {BIG_SUBDIVISIONS} "
                        f"times ({f.shape[0]} faces, {nc} chunks) camera "
                        f"{n} rays",
                        ob, db, big, True, gen, brute_sample=4096,
                        hit_sample=1024, both_modes=True)
    t_big, id_big = r_big.pop("hits")
    if not (torch.equal(t_big, hb.t) and torch.equal(id_big, hb.tri_id)):
        fail("groups: above the cap, intersect_cuda differs from the "
             "checked query")
    want = CK._auto_group(nc, CK.MAX_CHUNKS)
    if r_big["group"] != want or want < 2:
        fail(f"groups: above the cap group=None took {r_big['group']}, "
             f"expected {want}")
    out.update(big_faces=int(f.shape[0]), big_chunks=nc,
               big_group=r_big["group"], big_query_ms=r_big["query_ms"],
               big_kernel_ms=r_big["ms"],
               big_prepass_ms=r_big["prepass"]["ms"],
               big_pack_call_ms=r_big["pack"]["call_ms"],
               big_pack_bound_ms=r_big["pack"]["bound_ms"],
               big_hits=int((id_big >= 0).sum()),
               big_s=time.time() - t0, t_min=t_min, t_min_hits=n_cut)
    print(f"groups: above the cap: {f.shape[0]} faces, {nc} chunks, "
          f"group=None took group {r_big['group']}; query "
          f"{r_big['query_ms']:.3f} ms (closest hit {r_big['ms']:.3f} ms, "
          f"prepass {r_big['prepass']['ms']:.4f} ms, packing call "
          f"{r_big['pack']['call_ms']:.4f} ms), {out['big_hits']} hits "
          f"of {n} rays; {out['big_s']:.1f} s with the subdivision")
    out["phase_s"] = time.time() - t_phase
    print(f"groups: phase {out['phase_s']:.1f} s")
    return by_group, out


def parallel_ranks_phase(res, hp, weights, budget, mesh, cap, shift):
    """Phase 11b: two gloo ranks on the one card against the single step.
    Returns (closest-hit, prepass, packing launches) of the ranks' steps and
    its times."""
    import torch
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.optimize import make_train_step
    kwargs = dict(weights=weights, resy=res[0], resx=res[1],
                  silhouette_budget=budget, momentum=hp.momentum,
                  grad_clamp=0.0)
    ray_idx, silh_idx = 0, list(range(8))
    single = {}
    for name, oracle in (("own", get_intersect_fn("auto")),
                         ("one", one_shift_oracle(shift))):
        rec = QueryRecorder(oracle, keep_rays=False)
        init, step, _ = make_train_step(intersect_fn=rec, **kwargs)
        st, loss, aux = step(init(mesh), hp.start_lr, mesh, cap.views,
                             ray_idx, silh_idx)
        single[name] = dict(loss=float(loss), m=st["m"].cpu(),
                            ids=[h.tri_id.cpu() for h in rec.hits])
    with tempfile.TemporaryDirectory() as work:
        torch.save(dict(mesh=mesh, views=cap.views, shift=shift,
                        kwargs=kwargs, lr=hp.start_lr, ray_idx=ray_idx,
                        silh_idx=silh_idx),
                   os.path.join(work, "inputs.pt"))
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), PARALLEL_RANK,
             str(r), work], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                left = max(1.0, RANK_DEADLINE_S - (time.time() - t0))
                outs.append(p.communicate(timeout=left)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            fail(f"parallel: a rank did not finish in {RANK_DEADLINE_S} s")
        for r, (p, o) in enumerate(zip(procs, outs)):
            for ln in o.strip().splitlines():
                print(f"  rank {r}: {ln}")
            if p.returncode != 0:
                fail(f"parallel: rank {r} exited with {p.returncode}")
        ranks_s = time.time() - t0
        got = [torch.load(os.path.join(work, f"rank{r}.pt"),
                          weights_only=False) for r in range(2)]
    kinds = ("bounce1", "bounce2", "exit")
    times = {"w2_ranks_s": ranks_s}
    for name, bound in (("own", 1e-2), ("one", 1e-4)):
        a, b = (g[name] for g in got)
        ref = single[name]
        if a["loss"] != b["loss"] or not torch.equal(a["m"], b["m"]):
            fail(f"parallel: {name} shift: the two ranks hold different "
                 "updates")
        for r, g in enumerate(got):
            if tuple(g[name]["launches"]) != (3 + 4,) * 3:
                fail(f"parallel: rank {r} launched {g[name]['launches']}, "
                     "expected 7 of each kernel")
            # each rank takes 4 of the 8 silhouette views
            note_chain("parallel", g[name]["chain"], CHAIN_PER_STEP[:2]
                       + tuple(k // 2 for k in CHAIN_PER_STEP[2:]))
        # the ranks' ray queries in ray order; silhouette view k is rank
        # k % 2's query 3 + k // 2
        flips = {k: int((torch.cat([a["ids"][q], b["ids"][q]])
                         != ref["ids"][q]).sum())
                 for q, k in enumerate(kinds)}
        flips["silhouette"] = sum(
            int((got[k % 2][name]["ids"][3 + k // 2]
                 != ref["ids"][3 + k]).sum()) for k in range(8))
        dm, m_max = (float((a["m"] - ref["m"]).abs().max()),
                     float(ref["m"].abs().max()))
        print(f"parallel: world size 2 (gloo, one card), {name} shift: loss "
              f"{a['loss']:.8g} against {ref['loss']:.8g} single, max "
              f"|dupdate| {dm:.3g} (max |update| {m_max:.3g}), valid rays "
              f"{a['valid_rays']}, rays whose tri_id differs {flips}, step "
              f"{a['ms']:.1f} / {b['ms']:.1f} ms (rank 0 / 1)")
        if abs(a["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]) \
                or dm > bound * m_max:
            fail(f"parallel: {name} shift: loss or update differs from the "
                 "single step")
        if name == "one" and any(flips.values()):
            fail("parallel: with one shift a rank's rays hit other "
                 "triangles than the single step's")
        times[f"w2_{name}_rank_ms"] = [a["ms"], b["ms"]]
        times[f"w2_{name}_flips"] = flips
    return [sum(g[name]["launches"][k] for g in got for name in ("own", "one"))
            for k in range(3)], times


# The optimizer and preconditioner pairs phase 13 holds graphed against
# eager: phase 5's and phase 6's, each with its lr.
GRAPH_PAIRS = (("sgd", "none"), ("adam", "none"), ("uadam", "h1"),
               ("sgd", "sobolev"))
# The pairs phase 13 times in turns: phase 5's step and the two that solve.
TIMED_PAIRS = (("sgd", "none"), ("uadam", "h1"), ("sgd", "sobolev"))


def graph_phase(res, hp, weights, budget, mesh, cap, per_step,
                scatter_step):
    """Phase 13: the train step as one CUDA graph (GraphedTrainStep, as
    `optimize` runs each pass on the card). Returns (the phase's launches
    of the three oracle kernels, its scatter launches, the CG launches of
    its timed graph turns as `cg_counts()`, its numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from drt_tpu_torch.geometry.scatter import deferred_bounds_check
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.optimize import make_train_step
    from drt_tpu_torch.optimize.loop import GraphedTrainStep
    dev = mesh.vertices.device
    t_phase = time.time()
    out = {}

    def make(optimizer="sgd", precond="none"):
        return make_train_step(
            get_intersect_fn("auto"), weights, *res, budget,
            momentum=hp.momentum, optimizer=optimizer, precond=precond,
            precond_lambda=hp.precond_lambda, cg_iters=hp.cg_iters,
            grad_clamp=hp.grad_clamp)

    def drawn(n, seed):
        ray_gen = cap.ray_view_generator(seed=seed)
        silh_gen = cap.silh_view_generator(seed=seed + 1000)
        return ([[next(ray_gen)] for _ in range(n)],
                [[next(silh_gen) for _ in range(8)] for _ in range(n)])

    def graphed(step, state, lr, ray, silh):
        return GraphedTrainStep(step, state, lr, mesh, cap.views,
                                torch.tensor(ray, device=dev),
                                torch.tensor(silh, device=dev))

    # (a) the census: phase 5's eager step inside the scatters' deferred
    # bounds scope under sync debug mode "error", once with the graph's
    # device indices and a 0-d lr and once with ints and a float
    init, step, _ = make()
    state = init(mesh)
    word = torch.zeros(1, dtype=torch.int32, device=dev)
    lr_t = torch.full((), hp.start_lr, dtype=state["params"].dtype,
                      device=dev)
    ray, silh = drawn(1, hp.seed)
    ray_t, silh_t = (torch.tensor(ray[0], device=dev),
                     torch.tensor(silh[0], device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with deferred_bounds_check(word):
            step(state, lr_t, mesh, cap.views, ray_t, silh_t)
            step(state, hp.start_lr, mesh, cap.views, ray[0][0], silh[0])
    except RuntimeError as e:
        fail(f"graph: the eager step made a synchronizing operation inside "
             f"the deferred bounds scope: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if int(word):
        fail("graph: the census steps flagged an index out of bounds")
    print("graph: census: phase 5's eager step, with device and with host "
          "view indices, made 0 synchronizing operations inside the "
          "deferred bounds scope (sync debug mode \"error\")")

    # (b) 3 eager and 3 graphed steps (the warm-up, the capture, 2 replays)
    # from one state: the same bits after every step; the graphed run's
    # launches those of the eager run
    out["bitwise"] = {}
    for optimizer, precond in GRAPH_PAIRS:
        name = f"{optimizer} + {precond}"
        lr = hp.start_lr if optimizer == "sgd" else 0.01
        init_o, step_o, _ = make(optimizer, precond)
        state0 = init_o(mesh)
        ray, silh = drawn(3, hp.seed + 7)
        eager, st = [], state0
        CK.counters.reset()
        for r, s in zip(ray, silh):
            st, loss, _ = step_o(st, lr, mesh, cap.views, r[0], s)
            eager.append((loss.clone(), {k: v.clone() for k, v in
                                         st.items()}))
        want = CK.counters.snapshot()
        CK.counters.reset()
        run = graphed(step_o, state0, lr, ray, silh)
        for it, (loss_e, st_e) in enumerate(eager):
            loss, _ = run()
            diff = [k for k in ("params", "m", "v", "v_per", "count",
                                "silh_max")
                    if not torch.equal(run.state[k], st_e[k])]
            if diff or not torch.equal(loss, loss_e):
                fail(f"graph: {name} step {it}: the graphed step differs "
                     f"from the eager step in {diff or ['loss']}")
        got = CK.counters.snapshot()
        run.close()
        if got != want or got["launches"] != 3 * per_step \
                or got["cg_launches"] != 3 * CG_PER_STEP[precond] \
                or got["cg_shared_launches"] != got["cg_launches"]:
            fail(f"graph: {name}: launches {got} in 3 graphed steps, "
                 f"{want} in 3 eager steps ({3 * CG_PER_STEP[precond]} CG "
                 "solves reckoned, all on the shared route)")
        if int(run.bounds_word):
            fail(f"graph: {name}: a scatter index was out of bounds")
        out["bitwise"][name] = {"steps": 3, "equal": True,
                                "setup": run.setup,
                                "scatter_launches": got["scatter_launches"],
                                "cg_launches": got["cg_launches"]}
        print(f"graph: {name}: 3 graphed steps (warm-up, capture, 2 "
              f"replays) equal 3 eager steps bit for bit (params, m, v, "
              f"loss); launches {got['launches']} closest-hit, "
              f"{got['scatter_launches']} scatter, {got['cg_launches']} CG "
              f"in both; capture "
              f"{run.setup['capture_s']:.3f} s, instantiate "
              f"{run.setup['instantiate_s']:.3f} s, pool "
              f"{run.setup['pool_bytes'] / 2**20:.0f} MiB")
        del run, eager, st, state0

    # (c) the step's time in turns: eager, graph, graph, eager; 5 timed
    # steps a turn after its warm-up (and, in a graph turn, the capture);
    # phase 5's step, then the two preconditioned steps
    n = 5
    graph_launches, graph_scatters, graph_cg = (0, 0, 0), 0, (0, 0, 0)
    out["pairs"] = {}
    for optimizer, precond in TIMED_PAIRS:
        name = f"{optimizer} + {precond}"
        lr = hp.start_lr if optimizer == "sgd" else 0.01
        init_t, step_t, _ = make(optimizer, precond)
        turns = []
        for kind in ("eager", "graph", "graph", "eager"):
            ray, silh = drawn(2 + n, hp.seed + len(turns))
            st = init_t(mesh)
            ms_ = []
            if kind == "eager":
                for it in range(1 + n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st, _, _ = step_t(st, lr, mesh, cap.views, ray[it][0],
                                      silh[it])
                    torch.cuda.synchronize()
                    if it:
                        ms_.append((time.perf_counter() - t0) * 1e3)
            else:
                run = graphed(step_t, st, lr, ray, silh)
                CK.counters.reset()          # the graph's path starts here
                for it in range(2 + n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    if it >= 2:
                        ms_.append((time.perf_counter() - t0) * 1e3)
                launched = counts()          # and ends here
                note_chain("graph", chain_counts(),
                           tuple((2 + n) * k for k in CHAIN_PER_STEP))
                sc = CK.counters.scatter_launches
                cg_by = cg_counts()
                cg_n = cg_by[0]
                graph_launches = tuple(a + b for a, b in zip(graph_launches,
                                                             launched))
                graph_scatters += sc
                graph_cg = tuple(a + b for a, b in zip(graph_cg, cg_by))
                # h1 evaluates the loss twice, the ray term alone (with
                # its vertex evidence, one scatter more) and the
                # regularizers alone, each with its normals
                f_pad = mesh.faces.shape[0]
                want_sc = (scatter_step if precond != "h1" else
                           scatters_per_step(weights._replace(
                               vh_w=0.0, sm_w=0.0), f_pad) + 1
                           + scatters_per_step(weights._replace(ray_w=0.0),
                                               f_pad))
                if launched != (per_step * (2 + n),) * 3 \
                        or sc != want_sc * (2 + n) \
                        or cg_n != CG_PER_STEP[precond] * (2 + n) \
                        or cg_by[1] != cg_n:
                    fail(f"graph: {name}: {2 + n} graphed steps launched "
                         f"{launched} oracle kernels, {sc} scatters and "
                         f"{cg_by} CG solves (all, shared, global), reckoned "
                         f"{per_step * (2 + n)}, {want_sc * (2 + n)} and "
                         f"{CG_PER_STEP[precond] * (2 + n)} on the shared "
                         "route")
                setup = dict(run.setup)
                run.close()
            turns.append({"kind": kind, "step_ms": ms_})
            print(f"graph: {name}: turn {len(turns)} ({kind}): step ms "
                  f"{[round(x, 2) for x in ms_]}")
        timed = {"turns": turns, "setup": setup}
        for kind in ("eager", "graph"):
            xs = [x for t in turns if t["kind"] == kind
                  for x in t["step_ms"]]
            timed[f"{kind}_step_ms"] = {
                "median": statistics.median(xs), "min": min(xs),
                "max": max(xs),
                "turn_medians": [statistics.median(t["step_ms"])
                                 for t in turns if t["kind"] == kind]}
        if precond == "none":
            out.update(timed)
        else:
            out["pairs"][name] = timed
            g, e = timed["graph_step_ms"], timed["eager_step_ms"]
            print(f"graph: {name} in turns (eager, graph, graph, eager), {n} "
                  f"steps a turn: eager {e['median']:.2f} ms ({e['min']:.2f}"
                  f"-{e['max']:.2f}), graph {g['median']:.2f} ms "
                  f"({g['min']:.2f}-{g['max']:.2f}, turn medians "
                  f"{[round(x, 2) for x in g['turn_medians']]})")
        del run, st
    if min(graph_launches) < 1 or graph_scatters < 1 or graph_cg[1] < 1:
        fail(f"graph: the graphed steps launched {graph_launches} oracle "
             f"kernels, {graph_scatters} scatters and {graph_cg} CG solves "
             "(all, shared route, global route)")
    setup = out["setup"]

    # (d) one replay and one eager step under torch.profiler: device busy
    # time and device operations
    dev_t = torch.autograd.DeviceType.CUDA
    ray, silh = drawn(3, hp.seed + 20)
    run = graphed(step, init(mesh), hp.start_lr, ray, silh)
    for _ in range(2):                       # the warm-up, the capture
        run()
    prof_out = {}
    for kind in ("graph", "eager"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if kind == "graph":
                run()
            else:
                step(state, hp.start_lr, mesh, cap.views, ray[0][0], silh[0])
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == dev_t
               and not e.is_user_annotation]
        prof_out[kind] = {
            "device_busy_ms": sum(e.time_range.end - e.time_range.start
                                  for e in ops) / 1e3,
            "device_ops": len(ops)}
    run.close()
    out["profile"] = prof_out
    if prof_out["graph"]["device_ops"] < 1:
        fail("graph: torch.profiler saw no device operation in a replay")
    g, e = out["graph_step_ms"], out["eager_step_ms"]
    print(f"graph: phase 5's step in turns (eager, graph, graph, eager), "
          f"{n} steps a turn: eager {e['median']:.2f} ms ({e['min']:.2f}-"
          f"{e['max']:.2f}, turn medians "
          f"{[round(x, 2) for x in e['turn_medians']]}), graph "
          f"{g['median']:.2f} ms ({g['min']:.2f}-{g['max']:.2f}, turn "
          f"medians {[round(x, 2) for x in g['turn_medians']]}); a replay "
          f"{prof_out['graph']['device_busy_ms']:.3f} ms device busy in "
          f"{prof_out['graph']['device_ops']} device operations, an eager "
          f"step {prof_out['eager']['device_busy_ms']:.3f} ms in "
          f"{prof_out['eager']['device_ops']}; warm-up "
          f"{setup['warmup_s']:.3f} s (1 step), capture "
          f"{setup['capture_s']:.3f} s, instantiate "
          f"{setup['instantiate_s']:.3f} s, pool "
          f"{setup['pool_bytes'] / 2**20:.1f} MiB; launches {graph_launches}"
          f", scatter launches {graph_scatters}, CG launches {graph_cg[0]} "
          f"({graph_cg[1]} on the shared route)")
    out["phase_s"] = time.time() - t_phase
    return graph_launches, graph_scatters, graph_cg, out



@contextlib.contextmanager
def cg_spy(calls):
    """For the duration, each launch of csrc/cg.cu through `cg_cuda`
    appends its inputs (b, neighbors, neighbor_valid, lam, tol, maxiter,
    x0; b and x0 copied) to `calls`, then launches as before."""
    from drt_tpu_torch.optimize import precondition as PC
    real = PC.cg_cuda

    def spy(b, neighbors, neighbor_valid, lam, tol=1e-5, maxiter=64,
            x0=None, route=None):
        calls.append((b.clone(), neighbors, neighbor_valid, lam, tol,
                      maxiter, None if x0 is None else x0.clone()))
        return real(b, neighbors, neighbor_valid, lam, tol=tol,
                    maxiter=maxiter, x0=x0, route=route)
    PC.cg_cuda = spy
    try:
        yield calls
    finally:
        PC.cg_cuda = real


def cg_bound(b, neighbor_valid, trips, x0=False):
    """(ms, "bytes" or "operations"): the least time of a solve of b [Vp,C]
    that ran `trips` trips, counted as every bound in this script is
    counted: each input read once (b, the int64 table and its mask, x0 where
    given) and x written once, at the HBM rate, against the operations this
    run does at the FP32 rate: b.b and r.r (4 an element); A x0 and b - A
    x0 where x0 is given (5 an element and one add a valid neighbour's
    element); and each trip's 14 an element (the matvec's 4, p.Ap, the x
    and r updates, r.r and the p update, 2 each) and one add a valid
    neighbour's element (csrc/cg.cu's code)."""
    vp, c = b.shape
    d = neighbor_valid.shape[1]
    n, size = vp * c, b.element_size()
    gathers = int(neighbor_valid.sum()) * c
    bytes_ms = ((2 + int(x0)) * n * size + vp * d * 9) / HBM_RATE * 1e3
    ops = 4 * n + (5 * n + gathers if x0 else 0) + trips * (14 * n + gathers)
    ops_ms = ops / FP32_PEAK * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


def cg_trip_hbm_ms(b, neighbor_valid, trips):
    """The per-trip HBM figure, the CG kernel's bound before `cg_bound`
    counted inputs once: b, the int64 table and mask read and x written
    once, and each trip's int32 table, degrees and x, r and p read and
    written once, at the HBM rate (what the global route moves through L2
    a trip, priced at HBM's rate)."""
    vp, c = b.shape
    d = neighbor_valid.shape[1]
    n, size = vp * c, b.element_size()
    once = 2 * n * size + vp * d * 9
    trip = vp * d * 4 + vp * size + 6 * n * size
    return (once + trips * trip) / HBM_RATE * 1e3


def cg_ring_floor(lam, reps=20, vp=1024, side=4):
    """{route: {"ms_0_trips", "ms_64_trips", "us_a_trip"}}: the measured
    trip floor, a ring of `vp` vertices each joined to the `side` on
    either side (fewer elements than the cluster's threads), solved with
    tol 0 for 64 trips and for 0 on each route in turns (global, shared,
    shared, global), CUDA events, bits checked."""
    import torch
    from drt_tpu_torch.optimize import precondition as PC
    dev = torch.device("cuda", 0)
    ids = torch.arange(vp, device=dev)
    steps = [k for k in range(-side, side + 1) if k]
    nbr = torch.stack([(ids + k) % vp for k in steps], dim=1)
    valid = torch.ones_like(nbr, dtype=torch.bool)
    b = torch.randn((vp, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    out = {r: {"ms_0_trips": [], "ms_64_trips": []} for r in PC.CG_ROUTES}
    for maxiter in (0, 64):
        want, want_trips = PC.cg_plain(b, nbr, valid, lam, tol=0.0,
                                       maxiter=maxiter)
        for route in ("global", "shared", "shared", "global"):
            x, trips = PC.cg_cuda(b, nbr, valid, lam, tol=0.0,
                                  maxiter=maxiter, route=route)
            if not same_bits(x, want) or int(trips) != int(want_trips):
                fail(f"cg: the ring's {maxiter}-trip solve on the {route} "
                     "route differs from its plain version")
            out[route][f"ms_{maxiter}_trips"].append(cuda_ms(
                lambda: PC.cg_cuda(b, nbr, valid, lam, tol=0.0,
                                   maxiter=maxiter, route=route), reps))
    for r in out.values():
        r["us_a_trip"] = (statistics.mean(r["ms_64_trips"])
                          - statistics.mean(r["ms_0_trips"])) / 64 * 1e3
    return out


# Spin kernels (torch.cuda._sleep) launched at the start of a profile
# before the operations it counts.
SENTINELS = 32
# csrc/cg.cu's kernel by route
CG_KERNEL = {"global": "cg_kernel", "shared": "cg_shared_kernel"}


def cg_phase(res, hp, weights, budget, mesh, cap, mesh_fine, budget_fine):
    """Phase 14: csrc/cg.cu against its plain version on the solves of a
    dog_mid45k uadam + h1 step and an sgd + sobolev step (the forward
    solve, the backward solve, and `final_vertices` at 4 cg_iters trips and
    tol 1e-8) and of a uadam + h1 step on `mesh_fine` (above the shared
    route's cap), in float32 and float64, on the default route and on each
    route forced (the shared route must refuse what `cg_route` does not
    give it): the bits, the trips, the bits of a second launch; negative
    table entries on both routes; one solve of each route under
    torch.profiler (its kernel alone); each route's time on the h1 solves
    and `final_vertices` in turns (CUDA events) against their bounds, the
    ring's trip floor and the plain version's time. Returns its numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.optimize import make_train_step
    from drt_tpu_torch.optimize import precondition as PC
    t_phase = time.time()
    ray_gen = cap.ray_view_generator(seed=hp.seed + 30)
    silh_gen = cap.silh_view_generator(seed=hp.seed + 1030)
    recorded = {}
    for optimizer, precond, ms, bud, names in (
            ("uadam", "h1", mesh, budget, ["h1"]),
            ("sgd", "sobolev", mesh, budget,
             ["sobolev forward", "sobolev backward"]),
            ("uadam", "h1", mesh_fine, budget_fine, ["h1 above the cap"])):
        init, step, final = make_train_step(
            get_intersect_fn("auto"), weights, *res, bud,
            momentum=hp.momentum, optimizer=optimizer, precond=precond,
            precond_lambda=hp.precond_lambda, cg_iters=hp.cg_iters,
            grad_clamp=hp.grad_clamp)
        calls = []
        with cg_spy(calls):
            st, _, _ = step(init(ms), 0.01, ms, cap.views,
                            next(ray_gen), [next(silh_gen) for _ in range(8)])
            torch.cuda.synchronize()
        if len(calls) != CG_PER_STEP[precond]:
            fail(f"cg: a {precond} step made {len(calls)} solves, reckoned "
                 f"{CG_PER_STEP[precond]}")
        recorded.update(zip(names, calls))
        if precond == "sobolev":
            calls = []
            with cg_spy(calls):
                final(st, ms)
                torch.cuda.synchronize()
            if len(calls) != 1:
                fail(f"cg: final_vertices made {len(calls)} solves")
            recorded["final_vertices"] = calls[0]
    out = {"solves": {}}
    err = 0.0
    for name, (b, nbr, valid, lam, tol, maxiter, x0) in recorded.items():
        for dtype in (torch.float32, torch.float64):
            bd = b.to(dtype)
            x0d = None if x0 is None else x0.to(dtype)
            key = f"{name} {str(dtype).split('.')[-1]}"
            default = PC.cg_route(bd.shape[0], bd.shape[1], nbr.shape[1],
                                  dtype)
            xp, tp = PC.cg_plain(bd, nbr, valid, lam, tol=tol,
                                 maxiter=maxiter, x0=x0d)
            row = {"default_route": default, "maxiter": maxiter, "tol": tol,
                   "trips": int(tp)}
            for route in (None, "global", "shared"):
                label = route or "default"
                if route == "shared" and default != "shared":
                    try:
                        PC.cg_cuda(bd, nbr, valid, lam, tol=tol,
                                   maxiter=maxiter, x0=x0d, route=route)
                    except ValueError:
                        row[label] = "refused"
                        continue
                    fail(f"cg: {key}: the shared route took a solve "
                         "cg_route does not give it")
                xk, tk = PC.cg_cuda(bd, nbr, valid, lam, tol=tol,
                                    maxiter=maxiter, x0=x0d, route=route)
                xk2, tk2 = PC.cg_cuda(bd, nbr, valid, lam, tol=tol,
                                      maxiter=maxiter, x0=x0d, route=route)
                torch.cuda.synchronize()
                trips = (int(tk), int(tk2), int(tp))
                bits, again = same_bits(xk, xp), same_bits(xk, xk2)
                e = max_abs_diff(xk, xp)
                err = max(err, e)
                row[label] = {"bits": bits, "again": again, "err": e}
                if not (bits and again and len(set(trips)) == 1
                        and torch.isfinite(xk).all()):
                    fail(f"cg: {key}, {label} route: the kernel differs from "
                         f"its plain version or from itself (trips {trips})")
            out["solves"][key] = row
            print(f"cg: {key} ([{b.shape[0]},{b.shape[1]}], {maxiter} trips "
                  f"at most, tol {tol:g}): {int(tp)} trips; the default "
                  f"route ({default}), the global route and the shared "
                  f"route ({'refused' if row['shared'] == 'refused' else 'taken'}) "
                  "each bit for bit with the plain version, with its trips, "
                  "and a second launch bit for bit")
    out["max_abs_err"] = err
    # a table with valid entries given from the end (n - Vp) on even rows:
    # torch's indexing takes them as n, and so must both routes
    b, nbr, valid, lam, tol, maxiter, x0 = recorded["h1"]
    even = torch.arange(nbr.shape[0], device=nbr.device)[:, None] % 2 == 0
    neg = torch.where(valid & even, nbr - nbr.shape[0], nbr)
    xp, tp = PC.cg_plain(b, neg, valid, lam, tol=tol, maxiter=maxiter, x0=x0)
    for route in PC.CG_ROUTES:
        xn, tn = PC.cg_cuda(b, neg, valid, lam, tol=tol, maxiter=maxiter,
                            x0=x0, route=route)
        xw, tw = PC.cg_cuda(b, nbr, valid, lam, tol=tol, maxiter=maxiter,
                            x0=x0, route=route)
        torch.cuda.synchronize()
        if not (same_bits(xn, xw) and same_bits(xn, xp)
                and int(tn) == int(tw) == int(tp)):
            fail(f"cg: the {route} route takes negative neighbour entries "
                 "otherwise than torch's indexing")
    print("cg: the h1 solve with its even rows' entries given from the end: "
          "each route's bits equal the table as given and the plain "
          "version's")
    # the trip floor, then the device operations of a solve and the times
    out["ring"] = cg_ring_floor(hp.precond_lambda)
    for route, r in out["ring"].items():
        print(f"cg: the measured trip floor ({route} route): a 1,024-vertex "
              f"ring, {r['us_a_trip']:.3f} us a trip, "
              f"{statistics.mean(r['ms_0_trips']):.4f} ms for a launch of no "
              "trip")
    dev_t = torch.autograd.DeviceType.CUDA
    for name in ("h1", "final_vertices", "h1 above the cap"):
        b, nbr, valid, lam, tol, maxiter, x0 = recorded[name]
        default = PC.cg_route(b.shape[0], b.shape[1], nbr.shape[1], b.dtype)
        routes = (PC.CG_ROUTES if default == "shared" else ("global",))

        def kernel(route=default):
            return PC.cg_cuda(b, nbr, valid, lam, tol=tol, maxiter=maxiter,
                              x0=x0, route=route)
        kernel()
        torch.cuda.synchronize()
        attempt = 0
        while True:
            attempt += 1
            # In this process a profile loses its first device operations
            # (phase 13's profiled replays count 10-12 fewer than
            # scripts/ab_torch_step.py's), so spin kernels go first, and
            # only the solve's operations are counted.
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(SENTINELS):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                _, trips = kernel()
                torch.cuda.synchronize()
            ops = [e for e in prof.events() if e.device_type == dev_t
                   and not e.is_user_annotation
                   and "spin_kernel" not in e.name]
            if ops or not profile_again(attempt, f"the {name} solve's "
                                        "profile holds no device operation"):
                break
        if len(ops) != 1 or CG_KERNEL[default] not in ops[0].name:
            fail(f"cg: the {name} solve made {len(ops)} device operations "
                 f"({[e.name for e in ops]}), expected {CG_KERNEL[default]} "
                 "alone")
        trips = int(trips)
        by_route = {r: [] for r in routes}
        for route in ("global", "shared", "shared", "global"):
            if route in by_route:
                by_route[route].append(cuda_ms(
                    lambda route=route: kernel(route), 20))
        plain_ms = cuda_ms(lambda: PC.cg_plain(b, nbr, valid, lam, tol=tol,
                                               maxiter=maxiter, x0=x0), 3)
        bound_ms, bound_by = cg_bound(b, valid, trips, x0 is not None)
        floor = {r: statistics.mean(out["ring"][r]["ms_0_trips"])
                 + trips * out["ring"][r]["us_a_trip"] / 1e3 for r in routes}
        out[name] = {"shape": [b.shape[0], b.shape[1]],
                     "neighbours": nbr.shape[1], "trips": trips,
                     "default_route": default,
                     "device_ops": len(ops), "device_op": ops[0].name,
                     "profiled_ms": (ops[0].time_range.end
                                     - ops[0].time_range.start) / 1e3,
                     "ms_by_route": by_route,
                     "ms": statistics.mean(by_route[default]),
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "trip_hbm_ms": cg_trip_hbm_ms(b, valid, trips),
                     "ring_floor_ms": floor}
        print(f"cg: the {name} solve ([{b.shape[0]},{b.shape[1]}] float32, "
              f"{nbr.shape[1]} neighbours, {trips} trips, default route "
              f"{default}): 1 device operation ({ops[0].name}, "
              f"{out[name]['profiled_ms']:.4f} ms profiled); by route in "
              "turns (CUDA events) "
              + ", ".join(f"{r} {[round(x, 4) for x in t]} ms"
                          for r, t in by_route.items())
              + f"; its bound {bound_ms:.4f} ms ({bound_by}); the measured "
              "trip floor (ring) "
              + ", ".join(f"{r} {x:.4f} ms" for r, x in floor.items())
              + f"; the per-trip HBM figure "
              f"{out[name]['trip_hbm_ms']:.4f} ms; the plain version's "
              f"{plain_ms:.2f} ms")
    out["phase_s"] = time.time() - t_phase
    print(f"cg: phase {out['phase_s']:.1f} s")
    return out


def cg_entries(cg, cg_steps, graph_cg):
    """The kernels line's entries of csrc/cg.cu, a route each: the shared
    route on the uadam + h1 step's solve of dog_mid45k, the global route on
    the same step's solve above the shared route's cap. Their launches are
    the main path's: phase 6's steps and phase 13's graph turns."""
    steps = [sum(x) for x in zip(*cg_steps)]
    entries = []
    for route, kernel, solve in (("shared", "cg_shared_kernel", "h1"),
                                 ("global", "cg_kernel",
                                  "h1 above the cap")):
        i = 1 if route == "shared" else 2
        r = cg[solve]
        entries.append({
            "name": kernel,
            "route": "cuda",
            "cg_route": route,
            "source": "drt_tpu_torch/csrc/cg.cu",
            "replaces": "drt_tpu/optimize/precondition.py:65",
            "launches": steps[i] + graph_cg[i],
            "launches_steps": steps[i],
            "launches_graph": graph_cg[i],
            "launches_per_step": CG_PER_STEP,
            "shape": f"the uadam + h1 step's solve: b [{r['shape'][0]},"
                     f"{r['shape'][1]}] float32, {r['neighbours']} "
                     f"neighbours, {r['trips']} trips",
            "max_abs_err": cg["max_abs_err"],
            "ms": statistics.mean(r["ms_by_route"][route]),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call solves the system (a "
                       "torch.sparse product computes only the matvec)",
            "ring_floor_ms": r["ring_floor_ms"][route],
            "trip_hbm_ms": r["trip_hbm_ms"],
            "ms_by_route": r["ms_by_route"],
            "device_op": r["device_op"],
            "profiled_ms": r["profiled_ms"],
            "final_vertices": cg["final_vertices"],
            "ring": cg["ring"],
            "solves": cg["solves"],
        })
    return entries


# Rounded arithmetic operations (products, quotients, sums, square roots;
# not compares or selects) a lane of csrc/bounce.cu does, counted from the
# source: a bounce's forward on a live lane (95 in `lane_forward`, 12 for
# the new origin), its backward (the 95 again and 88 of cotangents; 90
# more with the origin's cotangent: the t path), the tail's forward and
# backward on a lane the loss counts (Huber's 3 left out).
BOUNCE_OPS = {"fwd": 107, "bwd": 183, "bwd_origin": 273}
RAY_TAIL_OPS = {"fwd": 21, "bwd": 24}


def bounce_bound(args, out, backward=None):
    """The least time (ms) and what bounds it for one launch of
    csrc/bounce.cu's bounce forward (backward=None) or backward
    (backward="d" for the new direction's cotangent alone, "both"),
    from this run's inputs: every byte the launch must move, each read
    once (a lane's rays, triangle and face id only where it is active and
    hit, as the kernel reads them) and each output written once, at the
    HBM rate, against its operations at the FP32 (or FP64: half) rate."""
    origin, direction, g9, hit, active, safe_id, park = args[:7]
    o_out, d_out, alive, tri = out
    n, s = origin.shape[0], origin.element_size()
    live = int((hit & active).sum())
    n_alive = int(alive.sum())
    if backward is None:
        nbytes = (n + int(active.sum()) + live * 15 * s + n_alive * 8
                  + 3 * s + n * (6 * s + 1 + 8))
        ops = live * BOUNCE_OPS["fwd"]
    else:
        both = backward == "both"
        nbytes = (n + n_alive * (15 * s + (6 if both else 3) * s)
                  + n * (12 if not both else 15) * s)
        ops = n_alive * BOUNCE_OPS["bwd_origin" if both else "bwd"]
    peak = FP32_PEAK if s == 4 else FP32_PEAK / 2
    by_bytes, by_ops = nbytes / HBM_RATE * 1e3, ops / peak * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def ray_tail_bound(args, backward=False):
    """The same for the ray-loss tail's forward or backward: the three masks
    as the kernel reads them (active where lane_valid, exit_hit where both),
    a counted lane's origin, direction and screen point, the loss (or the
    cotangent and the [N,3] gradient)."""
    origin, direction, sp, lane_valid, active, exit_hit = args
    n, s = origin.shape[0], origin.element_size()
    both = lane_valid & active
    counted = int((both & ~exit_hit).sum())
    nbytes = (n + int(lane_valid.sum()) + int(both.sum()) + counted * 9 * s
              + (s + n * 3 * s if backward else s))
    ops = counted * RAY_TAIL_OPS["bwd" if backward else "fwd"]
    peak = FP32_PEAK if s == 4 else FP32_PEAK / 2
    by_bytes, by_ops = nbytes / HBM_RATE * 1e3, ops / peak * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


# The silhouette views the one-origin route's checks take: 8 of the ring of
# 72 around dog_mid90k (the benchmark's rig), one every 9.
ORDER_VIEWS = tuple(range(0, 72, 9))


def silhouette_queries(meshes, res, views=ORDER_VIEWS):
    """{name: (mesh state, budget, [(view, origins, dirs)])} for `meshes`
    {name: mesh state}: each view's silhouette query as the step makes it
    (csrc/silhouette.cu's pre kernel's rays, its origin expanded over them,
    so the oracle takes its one-origin route), from the ring of 72 cameras
    around dog_mid90k at `res`, at the step's budget for the mesh."""
    import numpy as np
    import torch
    from drt_tpu_torch.data.synthetic import intrinsics, ring_cameras
    from drt_tpu_torch.intersect.api import Hits
    from drt_tpu_torch.mesh import load_ply
    from drt_tpu_torch.optimize import default_silhouette_budget
    from drt_tpu_torch.render.camera import CameraM
    from drt_tpu_torch.render.silhouette_kernels import (one_camera,
                                                         silhouette_view_loss)
    ring = ring_cameras(load_ply(os.path.join(MESH_DIR, "dog_mid90k.ply"))[0],
                        72)
    K = intrinsics(*res)
    out = {}
    for name, ms in meshes.items():
        dev = ms.vertices.device
        budget = default_silhouette_budget(ms.num_edges)
        queries = []
        for view in views:
            R = ring[view][0]
            cam = CameraM(*(torch.as_tensor(a, dtype=torch.float32,
                                            device=dev)
                            for a in (R, K, np.linalg.inv(R),
                                      np.linalg.inv(K))))
            asked = []

            def record(o, d, *_, coherent):
                asked.append((o.detach(), d.detach()))
                n = o.shape[0]
                return Hits(torch.full((n,), float("inf"), device=dev),
                            torch.full((n,), -1, dtype=torch.int32,
                                       device=dev))
            with torch.no_grad():
                silhouette_view_loss(
                    ms, one_camera(cam, cam.R_inv[:3, 3].contiguous(),
                                   torch.zeros(res, device=dev)),
                    record, budget, *res)
            queries.append((view, *asked[0]))
        out[name] = (ms, budget, queries)
    return out


def parent_route_oracle():
    """The "cuda" backend as the parent ran the silhouette queries: a
    one-origin query's rays as separate rows (so no order), with the shift
    of its one-origin tensor; every other query as it is."""
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.api import get_intersect_fn, one_origin
    base = get_intersect_fn("cuda")

    def fn(origins, dirs, vertices, faces, face_valid=None, *, coherent):
        if coherent or not one_origin(origins):
            return base(origins, dirs, vertices, faces, face_valid,
                        coherent=coherent)
        o = origins.detach()
        return CK.intersect_cuda(o.contiguous(), dirs.detach(),
                                 vertices.detach(), faces, face_valid,
                                 coherent=False, shift=o.float().mean(dim=0))
    return fn


def order_phase(res, hp, weights, budget, mesh45, cap, meshes):
    """Phase 16: the one-origin route (csrc/order.cu, and the order read by
    csrc/pack.cu and written through by csrc/closest_hit.cu) on the
    silhouette queries of `meshes` {name: mesh state} at their budgets
    (`silhouette_queries`): the order kernel against `ray_order_plain` on
    the CPU, the packing, prepass and closest-hit kernels against their
    plain versions on the route's inputs (bit for bit), the route's hits
    against the parent's route (`hit` and t bit for bit, tri_id differing
    only at one t) and, on each mesh's first view, against the brute
    oracle; then a parity step (sgd + none) on dog_mid45k as one CUDA graph,
    3 replays with the route against 3 with the parent's route: loss and
    state bit for bit, and `one_origin_queries` 8 a replay against 0.
    Returns the phase's numbers."""
    import torch
    from drt_tpu_torch.intersect import cuda_kernel as CK
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.intersect.brute import intersect_brute
    from drt_tpu_torch.optimize import make_train_step
    from drt_tpu_torch.optimize.loop import GraphedTrainStep
    t_phase = time.time()
    out = {"meshes": {}}
    for name, (ms, bud, queries) in silhouette_queries(meshes, res).items():
        geom = (ms.vertices, ms.faces, ms.face_valid)
        row = {"budget": bud, "views": [], "tri_id_differ": 0,
               "t_differ": 0}
        for k, (view, o, d) in enumerate(queries):
            label = f"order: {name} view {view}"
            inp = CK.prepare_inputs(o, d, *geom, coherent=False)
            N, Np = o.shape[0], inp.phi.shape[1]
            want = CK.ray_order_plain(d.cpu(), Np)
            if not torch.equal(inp.order.cpu(), want):
                fail(f"{label}: the order kernel differs from "
                     "ray_order_plain")
            shift = o.float().mean(dim=0)
            kw = dict(group=inp.group, ray_tile=CK.RAY_TILE_ONE_ORIGIN,
                      order=inp.order)
            got = CK.pack_cuda(*geom, shift, o, d, **kw)
            plain = CK.pack_plain(*geom, shift, o, d, **kw)
            bad = [f for f in CK.Packed._fields
                   if not same_bits(getattr(got, f), getattr(plain, f))
                   or (f in ("phi", "inv")
                       and not same_bits(getattr(got, f), getattr(inp, f)))]
            if bad:
                fail(f"{label}: the packing kernel differs from pack_plain "
                     f"or from the query's inputs in {bad}")
            check_prepass(label, o, geom, inp, False, timed=False)
            t_k, id_k = CK.closest_hit_cuda(inp)
            t_p, id_p = CK.closest_hit_plain(inp)
            if not (same_bits(t_k, t_p) and torch.equal(id_k, id_p)):
                fail(f"{label}: the closest-hit kernel differs from its "
                     "plain version through the order")
            h = CK.intersect_cuda(o, d, *geom, coherent=False)
            ref = CK.intersect_cuda(o.contiguous(), d, *geom, coherent=False,
                                    shift=shift)
            if not torch.equal(h.hit, ref.hit):
                fail(f"{label}: the route's hit differs from the parent "
                     "route's")
            differ = h.tri_id != ref.tri_id
            t_differ = int((h.t != ref.t).sum())
            if t_differ or bool((differ & (h.t != ref.t)).any()):
                fail(f"{label}: t differs from the parent route's on "
                     f"{t_differ} rays")
            if k == 0:
                hb = intersect_brute(o, d, *geom, tri_chunk=max(
                    512, geom[1].shape[0] // 512))
                hit_id = torch.where(h.tri_id >= 0, h.tri_id, hb.tri_id)
                compare_hits(f"{label} vs brute (all rays)", hb.t, hb.tri_id,
                             h.t, h.tri_id,
                             cond=t_conditioning(o, d, geom, hit_id))
            cnt = (inp.count * inp.group).float()
            row["tri_id_differ"] += int(differ.sum())
            row["views"].append({
                "view": view, "rays": N, "hits": int(h.hit.sum()),
                "tri_id_differ": int(differ.sum()),
                "longest": int(cnt.max()), "mean": float(cnt.mean())})
            print(f"{label}: {N} rays, {int(h.hit.sum())} hits; order, "
                  "packing, prepass and closest hit equal their plain "
                  "versions; hit and t equal the parent route's bit for "
                  f"bit, {int(differ.sum())} tri_ids differ at one t; "
                  f"longest list {int(cnt.max())}, mean {float(cnt.mean()):.1f}"
                  " chunk entries", flush=True)
        out["meshes"][name] = row

    # a parity step as one CUDA graph: the route against the parent's
    lr = hp.start_lr
    ray_gen = cap.ray_view_generator(seed=hp.seed + 61)
    silh_gen = cap.silh_view_generator(seed=hp.seed + 1061)
    ray = [[next(ray_gen)] for _ in range(3)]
    silh = [[next(silh_gen) for _ in range(8)] for _ in range(3)]
    dev = mesh45.vertices.device
    runs = {}
    for side, oracle in (("route", get_intersect_fn("cuda")),
                         ("parent", parent_route_oracle())):
        init, step, _ = make_train_step(oracle, weights, *res, budget,
                                        momentum=hp.momentum,
                                        grad_clamp=hp.grad_clamp)
        run = GraphedTrainStep(step, init(mesh45), lr, mesh45, cap.views,
                               torch.tensor(ray, device=dev),
                               torch.tensor(silh, device=dev))
        got = []
        for _ in ray:
            before = CK.counters.one_origin_queries
            loss, _ = run()
            torch.cuda.synchronize()
            got.append((loss.clone(), {k: v.clone()
                                       for k, v in run.state.items()},
                        CK.counters.one_origin_queries - before))
        run.close()
        runs[side] = got
    for it, ((la, sa, na), (lb, sb, nb)) in enumerate(zip(runs["route"],
                                                          runs["parent"])):
        diff = [k for k in sa if not same_bits(sa[k], sb[k])]
        if diff or not same_bits(la, lb):
            fail(f"order: graphed step {it}: the route differs from the "
                 f"parent's route in {diff or ['loss']}")
        if (na, nb) != (8, 0):
            fail(f"order: graphed step {it}: {na} and {nb} one-origin "
                 "queries (route, parent), reckoned 8 and 0")
    out["graphed_steps_equal"] = 3
    out["phase_s"] = time.time() - t_phase
    print(f"order: 3 graphed parity steps on dog_mid45k equal the parent "
          f"route's bit for bit (loss, params, m); 8 one-origin queries a "
          f"replay; phase {out['phase_s']:.1f} s", flush=True)
    return out


def chain_phase(res, hp, cap, meshes):
    """Phase 15: csrc/bounce.cu's four kernels against their plain versions
    on the main path's own inputs. For each mesh of `meshes` (name ->
    (vertices, faces)), float32 and float64, compat off and on: the ray
    loss's trace of capture view 0 (1280x960) through the step's oracle,
    with each bounce's chain inputs recorded; every output of both bounces
    (o_out, d_out, active, face ids) and of their backward (d_origin,
    d_direction, dg9; the new direction's cotangent alone, as the loss
    sends it, and both cotangents), and the tail's loss and gradient at
    Huber 0 and 0.1, bit for bit (integer views) with the plain version on
    the card. Then on dog_mid45k float32: each kernel's time by CUDA events
    and its profiled device time, the plain versions' times and the bounds
    (`bounce_bound`, `ray_tail_bound`). Returns the phase's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.mesh import build_mesh_state
    from drt_tpu_torch.render import bounce as TB
    from drt_tpu_torch.render.trace import trace_exit
    t_phase = time.time()
    dev = cap.views.origin.device
    fn = get_intersect_fn("auto")
    sp0, valid, _m, o0, d0, _c = cap.views.take(0)
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {"checked": [], "max_abs_err": 0.0}

    def hold(what, got, want):
        for k, (a, b) in enumerate(zip(got, want)):
            if (a is None) != (b is None):
                fail(f"chain: {what}: output {k} is None on one side")
            if a is None:
                continue
            if not same_bits(a, b):
                n_diff = (int((int_view(a) != int_view(b)).sum())
                          if a.is_floating_point() else int((a != b).sum()))
                fail(f"chain: {what}: output {k} differs from the plain "
                     f"version on {n_diff} of {a.numel()} elements (max "
                     f"|diff| {max_abs_diff(a, b):.3g})")
        out["checked"].append(what)

    timed = None
    for label, (v, f) in meshes.items():
        for dtype in (torch.float32, torch.float64):
            ms = build_mesh_state(v, f, dtype=dtype, device=dev)
            sp, o, d = (x.to(dtype) for x in (sp0, o0, d0))
            for compat in (False, True):
                rec = []
                real = TB.bounce_cuda

                def spy(*a, **k):
                    got = real(*a, **k)
                    rec.append((a, k, got))
                    return got
                TB.bounce_cuda = spy
                try:
                    with torch.no_grad():
                        oe, de, act, exit_hit, _, _ = trace_exit(
                            o, d, ms, fn, hp.ior, hp.ext_ior,
                            lane_mask=valid, compat=compat)
                finally:
                    TB.bounce_cuda = real
                name = (f"{label} {str(dtype)[6:]} compat "
                        f"{'on' if compat else 'off'}")
                if len(rec) != 2:
                    fail(f"chain: {name}: {len(rec)} bounce launches in the "
                         "trace, expected 2")
                for b, (a, k, got) in enumerate(rec):
                    what = f"{name} bounce {b + 1}"
                    hold(what, got, TB.bounce_plain(*a, **k))
                    n = a[0].shape[0]
                    gd = torch.randn(n, 3, generator=gen, device=dev,
                                     dtype=dtype)
                    go = torch.randn(n, 3, generator=gen, device=dev,
                                     dtype=dtype)
                    for cots in ((None, gd), (go, gd)):
                        bw = (*a[:3], got[2], *cots, *a[7:])
                        hold(f"{what} backward"
                             f"{'' if cots[0] is None else ' (both)'}",
                             TB.bounce_cuda_backward(*bw),
                             TB.bounce_plain_backward(*bw))
                    if (label, dtype, compat, b) == (
                            "dog_mid45k", torch.float32, False, 1):
                        timed = (a, got, gd, go)
                targs = (oe, de, sp, valid, act, exit_hit)
                g = torch.rand((), generator=gen, device=dev, dtype=dtype)
                for huber in (0.0, 0.1):
                    what = f"{name} ray tail, Huber {huber}"
                    hold(what, (TB.ray_tail_cuda(*targs, huber),
                                TB.ray_tail_cuda_backward(*targs, huber, g)),
                         (TB.ray_tail_plain(*targs, huber),
                          TB.ray_tail_plain_backward(*targs, huber, g)))
                if (label, dtype, compat) == ("dog_mid45k", torch.float32,
                                              False):
                    tail_args = targs
                print(f"chain: {name}: both bounces (active after "
                      f"{[int(r[2][2].sum()) for r in rec]} of "
                      f"{o.shape[0]}), their backward and the tail bit for "
                      "bit with the plain versions")
            del ms
    torch.cuda.synchronize()
    # times on the bounce-2 chain and the tail of dog_mid45k, float32
    a, got, gd, go = timed
    bw = (*a[:3], got[2], None, gd, *a[7:])
    calls = {
        "bounce": lambda: TB.bounce_cuda(*a),
        "bounce_backward": lambda: TB.bounce_cuda_backward(*bw),
        "ray_tail": lambda: TB.ray_tail_cuda(*tail_args, 0.0),
        "ray_tail_backward": lambda: TB.ray_tail_cuda_backward(
            *tail_args, 0.0, torch.ones((), device=dev)),
    }
    plain = {
        "bounce": lambda: TB.bounce_plain(*a),
        "bounce_backward": lambda: TB.bounce_plain_backward(*bw),
        "ray_tail": lambda: TB.ray_tail_plain(*tail_args, 0.0),
        "ray_tail_backward": lambda: TB.ray_tail_plain_backward(
            *tail_args, 0.0, torch.ones((), device=dev)),
    }
    before = chain_counts()
    ms_ = {k: cuda_ms(f, 20) for k, f in calls.items()}
    plain_ms = {k: cuda_ms(f, 5) for k, f in plain.items()}
    if chain_counts() == before:
        fail("chain: the timed calls launched no kernel")
    # each call's device operations under torch.profiler, a profile a call
    # (no ranges: the kernels launch from ctypes, inside no torch
    # operation); in this process a profile loses its first device
    # operations, so spin kernels go first and are not counted (phase 14)
    dev_t = torch.autograd.DeviceType.CUDA
    spans, kernel_ms, reps = {}, {}, 5
    for k, f in calls.items():
        f()
        torch.cuda.synchronize()
        kernel = (k.replace("_backward", "")
                  + ("_bwd_kernel" if "backward" in k else "_fwd_kernel"))
        attempt = 0
        while True:
            attempt += 1
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(SENTINELS):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                for _ in range(reps):
                    f()
                torch.cuda.synchronize()
            ops = [e for e in prof.events()
                   if e.device_type == dev_t and not e.is_user_annotation
                   and "spin_kernel" not in e.name]
            by_op = {}
            for e in ops:
                key = e.name.split("(")[0].split("<")[0].replace("void ", "")
                by_op.setdefault(key, []).append(
                    (e.time_range.end - e.time_range.start) / 1e3)
            if len(by_op.get(kernel, ())) == reps or not profile_again(
                    attempt, f"the profile of {k} holds "
                    f"{len(by_op.get(kernel, ()))} of {reps} {kernel}"):
                break
        if len(by_op.get(kernel, ())) != reps:
            fail(f"chain: the profile of {k} holds no {reps} {kernel}: "
                 f"{by_op}")
        kernel_ms[kernel] = statistics.median(by_op[kernel])
        spans[k] = {"ms": sum(sum(v) for v in by_op.values()) / reps,
                    "ops": len(ops) / reps,
                    "by_op": {n: statistics.median(v)
                              for n, v in by_op.items()}}
    bounds = {"bounce": bounce_bound(a, got),
              "bounce_backward": bounce_bound(a, got, backward="d"),
              "ray_tail": ray_tail_bound(tail_args),
              "ray_tail_backward": ray_tail_bound(tail_args, backward=True)}
    out.update(ms=ms_, plain_ms=plain_ms, profiled=spans,
               kernel_ms=kernel_ms,
               bound_ms={k: b[0] for k, b in bounds.items()},
               bound_by={k: b[1] for k, b in bounds.items()},
               lanes=a[0].shape[0], alive=int(got[2].sum()),
               counted=int((tail_args[3] & tail_args[4]
                            & ~tail_args[5]).sum()))
    for k in calls:
        print(f"chain: {k} (dog_mid45k bounce 2, float32, "
              f"{a[0].shape[0]} lanes): {ms_[k]:.4f} ms (CUDA events, with "
              f"its wrapper), device {spans[k]['ms']:.4f} ms in "
              f"{spans[k]['ops']:g} operation(s) {spans[k]['by_op']}, bound "
              f"{bounds[k][0]:.4f} ms ({bounds[k][1]}), plain version "
              f"{plain_ms[k]:.3f} ms")
    out["phase_s"] = time.time() - t_phase
    print(f"chain: {len(out['checked'])} checks bit for bit, phase "
          f"{out['phase_s']:.1f} s")
    return out


def chain_entries(chain):
    """The kernels line's entries of csrc/bounce.cu: the bounce chain
    (forward and backward launches) and the ray-loss tail; launches by
    path from the main path's runs (CHAIN_LAUNCHES), times from phase 15."""
    entries = []
    for i, (name, replaces) in enumerate((
            ("bounce", "drt_tpu/render/trace.py:207"),
            ("ray_tail", "drt_tpu/optimize/losses.py:77"))):
        fwd, bwd = name, f"{name}_backward"
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "drt_tpu_torch/csrc/bounce.cu",
            "replaces": replaces,
            "kernels": [f"{name}_fwd_kernel", f"{name}_bwd_kernel"],
            "launches": sum(c[i] for c in CHAIN_LAUNCHES.values()),
            "launches_by_path": {p: c[i] for p, c in CHAIN_LAUNCHES.items()},
            "launches_per_step": CHAIN_PER_STEP[i],
            "shape": ("bounce 2 of the ray view, 1280x960 on dog_mid45k, "
                      f"float32 ({chain['alive']} of {chain['lanes']} lanes "
                      "active after it)" if name == "bounce" else
                      "the ray view's tail, 1280x960 on dog_mid45k, float32 "
                      f"({chain['counted']} lanes counted)"),
            "max_abs_err": chain["max_abs_err"],
            "ms": chain["ms"][fwd] + chain["ms"][bwd],
            "ms_from": "CUDA events around the forward and the backward "
                       "launch (each with its wrapper), summed",
            "fwd_ms": chain["ms"][fwd],
            "bwd_ms": chain["ms"][bwd],
            "profiled_ms": chain["profiled"][fwd]["ms"]
            + chain["profiled"][bwd]["ms"],
            "profiled_ops": chain["profiled"][fwd]["ops"]
            + chain["profiled"][bwd]["ops"],
            "kernel_ms": {k: t for k, t in chain["kernel_ms"].items()
                          if k.startswith(name + "_")},
            "plain_ms": chain["plain_ms"][fwd] + chain["plain_ms"][bwd],
            "bound_ms": chain["bound_ms"][fwd] + chain["bound_ms"][bwd],
            "bound_by": chain["bound_by"][fwd],
            "fwd_bound_ms": chain["bound_ms"][fwd],
            "bwd_bound_ms": chain["bound_ms"][bwd],
            "library_ms": None,
            "library": "none: no PyTorch call computes it",
            "checked": len(chain["checked"]),
        })
    return entries


# Bytes of float32 rows that csrc/silhouette.cu moves to or from HBM, each
# once: the pre kernel reads a vertex row once (the vertex array stays in
# L2 for the faces' and the slots' gathers), a face row's 3 int64
# indices, an edge row's valid byte and a valid edge's 2 int64 face ids,
# and a slot's edge's 2 int64 endpoints; it writes a slot's edge id, 2 vertex ids, 2 projected rows,
# midpoint, normal and 2 rays (its edge id read back comes from L2). A slot
# of the post kernel: 2 int32 face ids, the midpoint, the mask read as a
# 32-byte sector (or two for bilinear), the coefficient. A row of the
# backward: half a normal and a coefficient, the projected row, the
# gradient row.
SIL_VERTEX_BYTES = 12
SIL_FACE_BYTES = 24
SIL_EDGE_BYTES = 1
SIL_VALID_EDGE_BYTES = 16
SIL_PRE_SLOT_BYTES = 16 + 8 + 16 + 24 + 8 + 8 + 24
SIL_POST_SLOT_BYTES = 8 + 8 + 32 + 4
SIL_BWD_ROW_BYTES = 4 + 2 + 12 + 12


def silhouette_bound(name, mesh, budget, bilinear=False):
    """csrc/silhouette.cu's kernel `name` at HBM rate on mesh state `mesh`:
    (ms, "bytes")."""
    if name == "pre":
        nbytes = (mesh.num_vertices * SIL_VERTEX_BYTES
                  + mesh.faces.shape[0] * SIL_FACE_BYTES
                  + mesh.edges.shape[0] * SIL_EDGE_BYTES
                  + mesh.num_edges * SIL_VALID_EDGE_BYTES
                  + budget * SIL_PRE_SLOT_BYTES)
    elif name == "post":
        nbytes = budget * (SIL_POST_SLOT_BYTES + (32 if bilinear else 0))
    else:
        nbytes = 2 * budget * SIL_BWD_ROW_BYTES
    return nbytes / HBM_RATE * 1e3, "bytes"


def silhouette_phase(res, cap, meshes, views=(0, 3, 6)):
    """Phase 17: csrc/silhouette.cu's three kernels against their plain
    versions (run on the card) on the step's own inputs: for each mesh of
    `meshes` (name -> (vertices, faces)), float32 and float64, capture
    views `views` read by device index at the step's budget: the pre
    kernel's eight outputs, the post kernel's loss and coefficients (mask
    read truncated and bilinear) on the step oracle's hits, and the
    backward's rows, bit for bit (integer views). Then on dog_mid45k and
    dog_mid90k float32, view 0: each kernel's time by CUDA events (with its
    wrapper) and its profiled device time, the plain versions' times and
    the bounds (`silhouette_bound`). Returns the phase's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.mesh import build_mesh_state
    from drt_tpu_torch.optimize import default_silhouette_budget
    from drt_tpu_torch.render import silhouette_kernels as SK
    t_phase = time.time()
    dev = cap.views.origin.device
    fn = get_intersect_fn("auto")
    out = {"checked": [], "timed": {}}

    def hold(what, got, want):
        for k, (a, b) in enumerate(zip(got, want)):
            if not same_bits(a, b):
                n_diff = (int((int_view(a) != int_view(b)).sum())
                          if a.is_floating_point() else int((a != b).sum()))
                fail(f"silhouette: {what}: output {k} differs from the "
                     f"plain version on {n_diff} of {a.numel()} elements "
                     f"(max |diff| {max_abs_diff(a, b):.3g})")
        out["checked"].append(what)

    for label, (v, f) in meshes.items():
        for dtype in (torch.float32, torch.float64):
            ms = build_mesh_state(v, f, dtype=dtype, device=dev)
            budget = default_silhouette_budget(ms.num_edges)
            vb = type(cap.views)(*(None if a is None else
                                   a.to(dtype) if a.is_floating_point()
                                   else a for a in cap.views))
            counts = []
            for view in views:
                cam = SK.view_camera(vb, torch.tensor([view], device=dev))
                args = (ms.vertices, ms.faces, ms.edge_faces, ms.edge_valid,
                        ms.edges, cam, budget)
                what = f"{label} {str(dtype)[6:]} view {view}"
                pre = SK.silhouette_pre_cuda(*args)
                hold(f"{what} pre", pre, SK.silhouette_pre_plain(*args))
                hits = fn(pre.origin.expand(pre.ray_dir.shape), pre.ray_dir,
                          ms.vertices, ms.faces, ms.face_valid,
                          coherent=False)
                g = torch.rand((), device=dev, dtype=dtype)
                for bilinear in (False, True):
                    post = (hits.tri_id, pre.sample, pre.count, cam, *res,
                            bilinear)
                    loss, coef = SK.silhouette_post_cuda(*post)
                    hold(f"{what} post (bilinear {bilinear})", (loss, coef),
                         SK.silhouette_post_plain(*post))
                    bwd = (pre.normal, coef, pre.pix, cam, g)
                    hold(f"{what} backward (bilinear {bilinear})",
                         (SK.silhouette_backward_cuda(*bwd),),
                         (SK.silhouette_backward_plain(*bwd),))
                    if (dtype, bilinear, view) == (torch.float32, False,
                                                   views[0]) \
                            and label in ("dog_mid45k", "dog_mid90k"):
                        out["timed"][label] = (args, post, bwd, ms, budget)
                counts.append(int(pre.count))
            print(f"silhouette: {label} {str(dtype)[6:]} (budget {budget}, "
                  f"silhouette edges {counts}): pre, post and backward bit "
                  "for bit with the plain versions")
            del ms
    torch.cuda.synchronize()
    dev_t = torch.autograd.DeviceType.CUDA
    for label, (args, post, bwd, ms, budget) in out["timed"].items():
        calls = {"pre": lambda: SK.silhouette_pre_cuda(*args),
                 "post": lambda: SK.silhouette_post_cuda(*post),
                 "backward": lambda: SK.silhouette_backward_cuda(*bwd)}
        plain = {"pre": lambda: SK.silhouette_pre_plain(*args),
                 "post": lambda: SK.silhouette_post_plain(*post),
                 "backward": lambda: SK.silhouette_backward_plain(*bwd)}
        row = {"ms": {k: cuda_ms(c, 20) for k, c in calls.items()},
               "plain_ms": {k: cuda_ms(c, 5) for k, c in plain.items()},
               "bound_ms": {k: silhouette_bound(k, ms, budget)[0]
                            for k in calls},
               "vertices": ms.num_vertices, "faces": ms.faces.shape[0],
               "edges": ms.edges.shape[0], "budget": budget,
               "kernel_ms": {}}
        for k, c in calls.items():
            kernel = {"backward": "silhouette_bwd_kernel"}.get(
                k, f"silhouette_{k}_kernel")
            c()
            torch.cuda.synchronize()
            attempt, reps = 0, 5
            while True:
                attempt += 1
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(SENTINELS):
                        torch.cuda._sleep(1000)
                    torch.cuda.synchronize()
                    for _ in range(reps):
                        c()
                    torch.cuda.synchronize()
                found = [(e.time_range.end - e.time_range.start) / 1e3
                         for e in prof.events()
                         if e.device_type == dev_t and kernel in e.name]
                if len(found) == reps or not profile_again(
                        attempt, f"the profile of {k} holds {len(found)} "
                        f"of {reps} {kernel}"):
                    break
            if len(found) != reps:
                fail(f"silhouette: the profile of {k} holds no {reps} "
                     f"{kernel}")
            row["kernel_ms"][kernel] = statistics.median(found)
        out["timed"][label] = row
        for k in calls:
            kernel = {"backward": "silhouette_bwd_kernel"}.get(
                k, f"silhouette_{k}_kernel")
            print(f"silhouette: {k} ({label} view {views[0]}, float32, "
                  f"budget {budget}): {row['ms'][k]:.4f} ms (CUDA events, "
                  f"with its wrapper), device {row['kernel_ms'][kernel]:.4f}"
                  f" ms, bound {row['bound_ms'][k]:.4f} ms (bytes), plain "
                  f"version {row['plain_ms'][k]:.3f} ms")
    out["phase_s"] = time.time() - t_phase
    print(f"silhouette: {len(out['checked'])} checks bit for bit, phase "
          f"{out['phase_s']:.1f} s")
    return out


def silhouette_entries(sil):
    """The kernels line's entries of csrc/silhouette.cu: launches by path
    from the main path's runs (CHAIN_LAUNCHES), times from phase 17."""
    entries = []
    for i, (k, kernel, replaces) in enumerate((
            ("pre", "silhouette_pre_kernel",
             "drt_tpu/render/silhouette.py:29"),
            ("post", "silhouette_post_kernel",
             "drt_tpu/optimize/losses.py:109"),
            ("backward", "silhouette_bwd_kernel",
             "drt_tpu/render/silhouette.py:130")), start=2):
        entries.append({
            "name": f"silhouette_{k}",
            "route": "cuda",
            "source": "drt_tpu_torch/csrc/silhouette.cu",
            "replaces": replaces,
            "kernels": [kernel],
            "launches": sum(c[i] for c in CHAIN_LAUNCHES.values()),
            "launches_by_path": {p: c[i] for p, c in CHAIN_LAUNCHES.items()},
            "launches_per_step": CHAIN_PER_STEP[i],
            "shape": {label: f"view 0 at 1280x960, float32, "
                             f"{r['vertices']} vertices, {r['faces']} "
                             f"faces, {r['edges']} edges, budget "
                             f"{r['budget']}"
                      for label, r in sil["timed"].items()},
            "ms": {label: r["ms"][k] for label, r in sil["timed"].items()},
            "ms_from": "CUDA events around the launch, with its wrapper",
            "kernel_ms": {label: r["kernel_ms"][kernel]
                          for label, r in sil["timed"].items()},
            "plain_ms": {label: r["plain_ms"][k]
                         for label, r in sil["timed"].items()},
            "bound_ms": {label: r["bound_ms"][k]
                         for label, r in sil["timed"].items()},
            "bound_by": "bytes",
            "library_ms": None,
            "library": "none: no PyTorch call computes it",
            "checked": len(sil["checked"]),
        })
    return entries


def main():
    # cuBLAS's fixed workspace, which torch.use_deterministic_algorithms
    # (phase 11a) asks for; it is read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        import drt_tpu_torch  # noqa: F401
        from drt_tpu_torch import kernels as KN
        from drt_tpu_torch.config import POINTGRAY_RES as RES, HyperParams
        from drt_tpu_torch.data.synthetic import (intrinsics, ring_cameras,
                                                  synthesize_capture)
        from drt_tpu_torch.geometry import scatter as SC
        from drt_tpu_torch.intersect import cuda_kernel as CK
        from drt_tpu_torch.intersect.api import get_intersect_fn
        from drt_tpu_torch.mesh import build_mesh_state, load_ply
        from drt_tpu_torch.optimize import (LossWeights,
                                            default_silhouette_budget,
                                            make_train_step, optimize)
        from drt_tpu_torch.optimize import precondition as PC
        from drt_tpu_torch.remesh import hausdorff_distance
        from drt_tpu_torch.utils.metrics import MetricsLogger
        from drt_tpu_torch.render.camera import CameraM, generate_rays
        from drt_tpu_torch.render.trace import _bounce
    except ImportError as e:
        fail(f"the drt_tpu_torch package is not beside chip_smoke.py ({e})")
    for m in ("dog_mid20k.ply", "dog_mid45k.ply", "dog_mid90k.ply"):
        if not os.path.exists(os.path.join(MESH_DIR, m)):
            fail(f"missing {os.path.join(MESH_DIR, m)}")
    dev = torch.device("cuda", 0)
    hp = HyperParams()
    C = CK.TRI_CHUNK

    # -- 1. build -----------------------------------------------------------
    t0 = time.time()
    KN.build(force=True)
    KN.library("pack")
    print(f"build: {time.time() - t0:.2f} s (nvcc {' '.join(KN.NVCC_FLAGS)})")
    entry, n_entries = "?", 0
    for line in KN.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, n_entries = m.group(1), n_entries + 1
        if "registers" in line or "spill" in line:
            print(f"ptxas {entry}: {line.strip()}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (int(m.group(1)) or int(m.group(2))):
            fail(f"{entry} spills to local memory: {line.strip()}")
    # an entry function's Itanium name starts _Z<length><name>, so a
    # kernel's name matches only itself (hist_kernel not live_hist_kernel)
    entries = re.findall(r"Compiling entry function '(\w+)'", KN.build_log)
    missing = [k for k in BUILT_KERNELS
               if not any(e.startswith(f"_Z{len(k)}{k}") for e in entries)]
    if missing:
        fail(f"ptxas reported no entry function for {missing} among "
             f"{n_entries}:\n{KN.build_log}")
    print(f"scatter: the cluster route's cluster holds {SC.cluster_size()} "
          f"CTAs (cudaOccupancyMaxActiveClusters); it takes up to "
          f"{SC.CLUSTER_MAX_ROWS} rows into {SC.CLUSTER_MAX_OUT} output "
          "elements, the grid route the rest")
    try:
        cg_lib = KN.library("cg")
    except RuntimeError as e:
        fail(f"cg: {e}")
    print(f"cg: one cluster of {PC.CG_CTAS} CTAs of {PC.CG_BLOCK} threads a "
          "solve (cudaOccupancyMaxActiveClusters); the shared route's CTAs "
          f"may take {cg_lib.cg_shared_budget()} bytes of shared memory "
          f"(cg_route plans for {PC.CG_SHARED_BUDGET}); a float32 solve at "
          "C = 3, 8 neighbours takes "
          + ", ".join(f"{cg_lib.cg_shared_bytes(vp, 3, 8, 0)} at Vp {vp}"
                      for vp in (16384, 32768, 65536))
          + " (dog_mid20k, 45k, 90k)")
    print(f"ray tiles: coherent {CK.RAY_TILE_COHERENT}, incoherent "
          f"{CK.RAY_TILE_INCOHERENT}; closest-hit blocks of "
          f"{CK.BLOCK_RAYS} rays")

    # -- 2. kernel vs plain twin on dog_mid90k at 1280x960 ------------------
    v90, f90 = load_ply(os.path.join(MESH_DIR, "dog_mid90k.ply"))
    ms90 = build_mesh_state(v90, f90, device=dev)
    R, _, _ = ring_cameras(v90, 8)[0]
    K = intrinsics(*RES)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    import numpy as np
    cam = CameraM(f32(R), f32(K), f32(np.linalg.inv(R)),
                  f32(np.linalg.inv(K)))
    o1, d1 = generate_rays(*RES, cam)
    fn = get_intersect_fn("cuda")
    with torch.no_grad():
        o2, d2, active, _ = _bounce(
            o1, d1, torch.ones(o1.shape[0], dtype=torch.bool, device=dev),
            ms90, fn, hp.ior, hp.ext_ior, 1e-5, coherent=True)
    geom = (ms90.vertices, ms90.faces, ms90.face_valid)
    gen = torch.Generator(device="cpu").manual_seed(0)
    results = {
        "camera": check_query("camera", o1, d1, geom, True, gen,
                              plain_reps=1),
        "bounce2": check_query(f"bounce2 ({int(active.sum())} active)", o2,
                               d2, geom, False, gen)}
    del o2, d2, active

    # -- 3. small input: loss and gradient on the card vs the CPU (f64) ----
    small_reference_check(dev)

    # -- 4. synthesize a capture -------------------------------------------
    t0 = time.time()
    cap = synthesize_capture(v90, f90, name="dog", num_views=8, resy=RES[0],
                             resx=RES[1], ior=hp.ior, ext_ior=hp.ext_ior,
                             num_view_used=8, device=dev)
    torch.cuda.synchronize()
    valid_per_view = cap.views.valid.sum(dim=1).tolist()
    print(f"capture: 8 views {RES[1]}x{RES[0]} of dog_mid90k in "
          f"{time.time() - t0:.2f} s, valid rays per view {valid_per_view}")
    if min(valid_per_view) < 1000:
        fail("synthetic capture has views with almost no valid rays")
    del ms90

    # -- 4b. the main path's own queries on dog_mid45k ----------------------
    v45, f45 = load_ply(os.path.join(MESH_DIR, "dog_mid45k.ply"))
    ms45 = build_mesh_state(v45, f45, device=dev)
    weights = LossWeights(ray_w=hp.ray_w, vh_w=hp.vh_w, sm_w=hp.sm_w,
                          ior=hp.ior, ext_ior=hp.ext_ior)
    budget = default_silhouette_budget(ms45.num_edges)
    geom45 = (ms45.vertices, ms45.faces, ms45.face_valid)
    checked, queries45 = check_step_queries("dog_mid45k", ms45,
                                            cap.views.take(0), budget, RES,
                                            hp, gen)
    results.update(checked)

    # -- 5. train from dog_mid45k -------------------------------------------
    init, step, final = make_train_step(get_intersect_fn("auto"), weights,
                                        *RES, budget, momentum=hp.momentum,
                                        grad_clamp=hp.grad_clamp)
    state = init(ms45)
    ray_gen = cap.ray_view_generator(seed=hp.seed)
    silh_gen = cap.silh_view_generator(seed=hp.seed + 1000)
    per_step = 3 + 8                  # each kernel once a query of either kind
    scatter_step = scatters_per_step(weights, ms45.faces.shape[0])
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    CK.counters.reset()                        # main path starts here
    for it in range(3):
        calls0, seen0 = CK.counters.calls, counts()
        sc0, chain0 = CK.counters.scatter_launches, chain_counts()
        ray_idx = next(ray_gen)
        silh_idx = [next(silh_gen) for _ in range(8)]
        torch.cuda.synchronize()
        t0 = time.time()
        state, loss, aux = step(state, hp.start_lr, ms45, cap.views,
                                ray_idx, silh_idx)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        losses.append(float(loss))
        d_calls = CK.counters.calls - calls0
        d_seen = tuple(b - a for a, b in zip(seen0, counts()))
        d_scatter = CK.counters.scatter_launches - sc0
        d_chain = tuple(b - a for a, b in zip(chain0, chain_counts()))
        note_chain("train", d_chain, CHAIN_PER_STEP)
        print(f"step {it}: {times[-1]:.1f} ms, loss {losses[-1]:.6g} "
              f"(ray {float(aux['ray']):.6g} vh {float(aux['vh']):.6g} "
              f"sm {float(aux['sm']):.6g}), valid rays "
              f"{int(aux['valid_rays'])}, max grad "
              f"{float(aux['max_grad']):.3g}, queries {d_calls}, "
              f"closest-hit, prepass and packing launches {d_seen}, scatter "
              f"launches {d_scatter}, bounce chain and ray-loss tail "
              f"launches {d_chain}")
        if d_calls != per_step or d_seen != (per_step,) * 3:
            fail(f"step {it}: {d_calls} queries, launches {d_seen}, expected "
                 f"{per_step} of each")
        if d_scatter != scatter_step:
            fail(f"step {it}: {d_scatter} scatter launches, reckoned "
                 f"{scatter_step}")
        if not math.isfinite(losses[-1]):
            fail(f"step {it}: loss is not finite")
    launches = counts()                          # main path ends here
    scatter_launches = CK.counters.scatter_launches
    scatter_route_launches = (CK.counters.scatter_cluster_launches,
                              CK.counters.scatter_grid_launches)
    if min(scatter_route_launches) < 1:
        fail(f"the steps launched the scatter kernel's cluster and grid "
             f"routes {scatter_route_launches} times: both must run")
    verts = final(state, ms45)
    moved = float((verts - ms45.vertices).abs().max())
    if not torch.isfinite(verts).all() or moved <= 0:
        fail(f"vertices did not move or are not finite (max move {moved})")
    step_ms = statistics.median(times[1:])
    n_rays = RES[0] * RES[1]
    print(f"train: dog_mid45k ({ms45.num_faces} faces), silhouette budget "
          f"{budget}, step {step_ms:.1f} ms (median of steps 1-2 after a "
          f"warm-up), {n_rays / step_ms * 1e3 / 1e6:.2f} Mrays/s "
          f"(ray view), max vertex move {moved:.4g}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"closest-hit, prepass and packing launches {launches}")
    # one more step's scatters, each against the CPU plain version
    recorded = []
    with scatter_spy(recorded):
        step(state, hp.start_lr, ms45, cap.views, next(ray_gen),
             [next(silh_gen) for _ in range(8)])
        torch.cuda.synchronize()
    if len(recorded) != scatter_step:
        fail(f"recorded {len(recorded)} scatters, reckoned {scatter_step}")
    kinds = scatter_kinds([(r.shape[0], r.shape[1], num)
                           for r, _, num, _, _ in recorded], ms45, budget,
                          RES[0] * RES[1])
    print(f"scatter: cluster size {SC.cluster_size()} CTAs; the steps' "
          f"launches by route (cluster, grid) {scatter_route_launches}; "
          f"a step's calls {list(zip(kinds, (c[4] for c in recorded)))}")
    scatter_checked = check_scatters(recorded, kinds)
    del recorded
    oracle_ops, pack_step_ms, scatter_prof = oracle_kernel_profile(
        weights, RES, budget, hp, ms45, cap, per_step)
    if len(scatter_prof["calls"]) != scatter_step:
        fail(f"profile: {len(scatter_prof['calls'])} scatter calls, "
             f"reckoned {scatter_step}")

    # -- 6. the other optimizers and preconditioners -------------------------
    per_step_all = queries_per_step(weights)
    if per_step_all != (per_step,) * 3:
        fail(f"reckoned {per_step_all} launches a step, phase 5 saw "
             f"{per_step} of each kernel")
    step_ms_by = {}
    # phase 6's CG launches, step by step: (all, shared route, global)
    cg_steps = []
    route45 = PC.cg_route(ms45.vertices.shape[0], 3, ms45.neighbors.shape[1],
                          ms45.vertices.dtype)
    if route45 != "shared":
        fail(f"cg: dog_mid45k's solves would take the {route45} route")
    for optimizer, precond in (("adam", "none"), ("uadam", "h1"),
                               ("sgd", "sobolev")):
        init_o, step_o, final_o = make_train_step(
            get_intersect_fn("auto"), weights, *RES, budget,
            momentum=hp.momentum, optimizer=optimizer, precond=precond,
            precond_lambda=hp.precond_lambda, cg_iters=hp.cg_iters,
            grad_clamp=hp.grad_clamp)
        name = f"{optimizer} + {precond}"
        st, _, ms = run_steps(name, step_o, init_o(ms45), 0.01, ms45, cap,
                              hp.seed, 2, per_step_all,
                              cg_expect=CG_PER_STEP[precond],
                              cg_seen=cg_steps, cg_route="shared")
        CK.counters.reset()
        verts_o = final_o(st, ms45)
        cg_final = cg_counts()
        cg_steps.append(cg_final)
        if cg_final[:2] != (int(precond == "sobolev"),) * 2:
            fail(f"{name}: final_vertices made {cg_final} CG launches (all, "
                 f"shared route, global route), reckoned "
                 f"{int(precond == 'sobolev')} on the shared route")
        moved_o = float((verts_o - ms45.vertices).abs().max())
        if not torch.isfinite(verts_o).all() or moved_o <= 0:
            fail(f"{name}: vertices did not move or are not finite "
                 f"(max move {moved_o})")
        step_ms_by[name] = ms
        print(f"steps: {name}: second step {ms:.1f} ms, max vertex move "
              f"{moved_o:.4g}")
        del st, verts_o
    # one uadam + h1 step on dog_mid20k and dog_mid90k (the shared route)
    # and on dog_mid45k subdivided once (Vp 131,072, above the shared
    # route's cap: the global route)
    vs, fs = midpoint_subdivide(torch.from_numpy(v45), torch.from_numpy(f45))
    ms_fine = build_mesh_state(vs.numpy(), fs.numpy(), device=dev)
    for label, ms_o, route in (
            ("dog_mid20k", build_mesh_state(*load_ply(os.path.join(
                MESH_DIR, "dog_mid20k.ply")), device=dev), "shared"),
            ("dog_mid90k", build_mesh_state(v90, f90, device=dev),
             "shared"),
            ("dog_mid45k subdivided once", ms_fine, "global")):
        vp_o, d_o = ms_o.vertices.shape[0], ms_o.neighbors.shape[1]
        if PC.cg_route(vp_o, 3, d_o, ms_o.vertices.dtype) != route:
            fail(f"cg: {label}'s solves would not take the {route} route")
        init_o, step_o, _ = make_train_step(
            get_intersect_fn("auto"), weights, *RES,
            default_silhouette_budget(ms_o.num_edges),
            momentum=hp.momentum, optimizer="uadam", precond="h1",
            precond_lambda=hp.precond_lambda, cg_iters=hp.cg_iters,
            grad_clamp=hp.grad_clamp)
        name = (f"uadam + h1 on {label} ({ms_o.num_faces} faces, Vp "
                f"{vp_o})")
        _, _, step_ms_by[name] = run_steps(
            name, step_o, init_o(ms_o), 0.01, ms_o, cap, hp.seed, 1,
            per_step_all, cg_expect=CG_PER_STEP["h1"], cg_seen=cg_steps,
            cg_route=route)
    budget_fine = default_silhouette_budget(ms_fine.num_edges)

    # -- 7. a chunked step against the unchunked one --------------------------
    chunk = 2 ** 18
    n_chunks = -(-n_rays // chunk)
    expect_c = queries_per_step(weights, ray_chunks=n_chunks)
    one_shift = ms45.vertices[:ms45.num_vertices].float().mean(dim=0)

    def one_step(label, rc, oracle, expect):
        """One sgd + none step from rest, without the clamp, so the state's
        momentum after it is the raw gradient. It runs twice from the same
        state, since the first call of torch.utils.checkpoint in a process
        takes seconds: the first run records the hits, the second is the
        one timed. Returns (loss, gradient, ms, peak GiB, tri_id [N] of the
        ray loss's three forward queries, the chunks' joined in ray order)."""
        rec = QueryRecorder(oracle, keep_rays=False)
        for fn_c in (rec, oracle):
            init_c, step_c, _ = make_train_step(
                fn_c, weights, *RES, budget, momentum=hp.momentum,
                grad_clamp=0.0, ray_chunk=rc)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # a checkpointed chunk runs its forward again in the backward
            st, ls, ms = run_steps(
                label, step_c, init_c(ms45), hp.start_lr, ms45, cap,
                hp.seed, 1, expect, chain=("chunked", (
                    (6 * n_chunks, 3 * n_chunks) + CHAIN_PER_STEP[2:]
                    if rc else CHAIN_PER_STEP)))
        k = n_chunks if rc else 1
        ids = [torch.cat([rec.hits[3 * i + q].tri_id for i in range(k)])
               [:n_rays] for q in range(3)]
        return (ls[0], st["m"], ms,
                torch.cuda.max_memory_allocated() / 2 ** 30, ids)

    def flipped(ids_a, ids_b):
        return [int((a != b).sum()) for a, b in zip(ids_a, ids_b)]

    # As the step runs it: each query shifts the scene by its own mean ray
    # origin, so a chunk's rays meet coefficients rounded about another
    # point than the whole view's, and a ray on a shared edge may take the
    # other triangle.
    auto_fn = get_intersect_fn("auto")
    l_u, g_u, ms_u, mem_u, ids_u = one_step("unchunked", 0, auto_fn,
                                            per_step_all)
    l_c, g_c, ms_c, mem_c, ids_c = one_step("chunked", chunk, auto_fn,
                                            expect_c)
    dg, g_max = float((g_c - g_u).abs().max()), float(g_u.abs().max())
    flips = flipped(ids_u, ids_c)
    print(f"chunked: {n_chunks} chunks of {chunk} rays: loss {l_c:.8g} "
          f"against {l_u:.8g} unchunked, max |dgrad| {dg:.3g} (max |grad| "
          f"{g_max:.3g}), step {ms_c:.1f} ms against {ms_u:.1f} ms, peak "
          f"memory {mem_c:.2f} GiB against {mem_u:.2f} GiB; rays whose "
          f"tri_id differs (bounce1, bounce2, exit): {flips} of {n_rays}")
    if abs(l_c - l_u) > 1e-5 * abs(l_u) or dg > 1e-2 * g_max:
        fail("chunked: loss or gradient differs from the unchunked step")
    # The chunking alone: with one shift for every query each ray gets the
    # same hit in both steps, and what is left is float32 sums in another
    # order.
    shift_fn = one_shift_oracle(one_shift)
    l_u1, g_u1, _, _, ids_u1 = one_step("unchunked, one shift", 0, shift_fn,
                                        per_step_all)
    l_c1, g_c1, _, _, ids_c1 = one_step("chunked, one shift", chunk,
                                        shift_fn, expect_c)
    dg1, g_max1 = float((g_c1 - g_u1).abs().max()), float(g_u1.abs().max())
    flips1 = flipped(ids_u1, ids_c1)
    print(f"chunked, one shift for every query: loss {l_c1:.8g} against "
          f"{l_u1:.8g} unchunked, max |dgrad| {dg1:.3g} (max |grad| "
          f"{g_max1:.3g}), rays whose tri_id differs {flips1}; the shift "
          f"alone, unchunked: max |dgrad| "
          f"{float((g_u1 - g_u).abs().max()):.3g}, rays whose tri_id "
          f"differs {flipped(ids_u, ids_u1)}")
    if any(flips1):
        fail("chunked: with one shift a chunk's rays hit other triangles "
             "than the whole view's")
    if abs(l_c1 - l_u1) > 1e-5 * abs(l_u1) or dg1 > 1e-4 * g_max1:
        fail("chunked: with one shift, loss or gradient differs from the "
             "unchunked step")
    del g_u, g_c, g_u1, g_c1, ids_u, ids_c, ids_u1, ids_c1

    # -- 8. the other oracle routes --------------------------------------------
    fn_ray = get_intersect_fn("cuda", incoherent="ray")
    fn_resort = get_intersect_fn("cuda", incoherent="resort")
    fn_culled = get_intersect_fn("culled")
    route_ms = {}
    for qname, (o, d, coherent) in zip(("bounce1", "bounce2", "exit"),
                                       queries45):
        if coherent:
            continue
        CK.counters.reset()
        h_ray = fn_ray(o, d, *geom45, coherent=False)
        seen_ray = counts()
        h_res = fn_resort(o, d, *geom45, coherent=False)
        seen = counts()
        same = bool(torch.equal(h_ray.tri_id, h_res.tri_id)
                    and torch.equal(h_ray.t, h_res.t))
        ms_ray = cuda_ms(lambda: fn_ray(o, d, *geom45, coherent=False), 10)
        ms_res = cuda_ms(lambda: fn_resort(o, d, *geom45, coherent=False),
                         10)
        route_ms[qname] = (ms_ray, ms_res)
        print(f"routes: dog_mid45k {qname}: resort against ray bit for "
              f"bit: {same} ({int(h_ray.hit.sum())} hits); ray {ms_ray:.3f} "
              f"ms, resort {ms_res:.3f} ms a query")
        if not same:
            fail(f"routes: {qname}: the resorted route differs from the "
                 "per-ray route")
        if seen_ray != (1, 1, 1) or seen != (2, 2, 2):
            fail(f"routes: {qname}: launches {seen_ray} then {seen}, "
                 "expected (1, 1, 1) then (2, 2, 2)")
    for qname, (o, d, coherent) in zip(("bounce1", "bounce2"), queries45):
        idx = torch.randperm(o.shape[0], generator=gen)[:BRUTE_SAMPLE].to(
            dev)
        os_, ds_ = o[idx].contiguous(), d[idx].contiguous()
        h_k = fn_ray(os_, ds_, *geom45, coherent=coherent)
        t0 = time.time()
        h_c = fn_culled(os_, ds_, *geom45, coherent=coherent)
        torch.cuda.synchronize()
        compare_hits(f"routes: dog_mid45k {qname} culled vs kernel "
                     f"({BRUTE_SAMPLE} sample, {time.time() - t0:.2f} s)",
                     h_k.t, h_k.tri_id, h_c.t, h_c.tri_id)
    del queries45

    # -- 9. a whole LOD run through `optimize` ---------------------------------
    v20, f20 = load_ply(os.path.join(MESH_DIR, "dog_mid20k.ply"))
    hp_lod = HyperParams(name="dog", num_passes=3, iters=10, start_len=2.5,
                         end_len=1.5, num_view=8)
    t0 = time.time()
    h_init = hausdorff_distance(v20, f20, v90, f90)
    hausdorff_s = time.time() - t0
    with tempfile.TemporaryDirectory() as ck_dir:
        info, lines, logger = {}, [], MetricsLogger()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        CK.counters.reset()                    # main path starts here
        t0 = time.time()
        out = optimize(hp_lod, cap, v20, f20, remesh_fn="isotropic",
                       checkpoint_dir=ck_dir, log_fn=lines.append,
                       log_every=5, metrics=logger, run_info=info,
                       device=dev)
        torch.cuda.synchronize()
        lod_s = time.time() - t0
        lod_launches = counts()                # main path ends here
        lod_scatters = CK.counters.scatter_launches
        n_steps = hp_lod.num_passes * hp_lod.iters
        note_chain("lod", chain_counts(),
                   tuple(n_steps * k for k in CHAIN_PER_STEP))
        if CK.counters.cg_launches != 0:
            fail(f"lod: {CK.counters.cg_launches} CG launches in sgd + "
                 "none steps, reckoned 0")
        lod_peak = torch.cuda.max_memory_allocated()
        for ln in lines:
            print(f"lod: {ln}")
        cks = sorted(os.listdir(ck_dir))
        if cks != [f"dog_pass{i:02d}.ply" for i in range(3)]:
            fail(f"lod: checkpoints {cks}")
        faces_by_pass = []
        for i, name in enumerate(cks):
            ms_ck = build_mesh_state(*load_ply(os.path.join(ck_dir, name)),
                                     device=dev)      # raises if not closed
            faces_by_pass.append(ms_ck.num_faces)
            p = info["passes"][i]
            print(f"lod: pass {i}: {ms_ck.num_faces} faces (padded "
                  f"{ms_ck.faces.shape[0]}, {ms_ck.faces.shape[0] // C} "
                  f"chunks), silhouette budget "
                  f"{p['budget']}, remesh {p['remesh_s']:.2f} s, "
                  f"{hp_lod.iters} steps {p['steps_s']:.2f} s, graph: "
                  f"warm-up {p['graph']['warmup_s']:.3f} s, capture "
                  f"{p['graph']['capture_s']:.3f} s, instantiate "
                  f"{p['graph']['instantiate_s']:.3f} s, pool "
                  f"{p['graph']['pool_bytes'] / 2**20:.0f} MiB")
            if p["faces"] != ms_ck.num_faces:
                fail(f"lod: pass {i} ran on {p['faces']} faces, its "
                     f"checkpoint has {ms_ck.num_faces}")
            # both kernels against their plain versions at this pass's own
            # chunk count and silhouette budget, on the remeshed mesh
            checked, _ = check_step_queries(
                f"lod pass {i} ({ms_ck.faces.shape[0] // C} chunks)", ms_ck,
                cap.views.take(0), p["budget"], RES, hp_lod, gen)
            results.update(checked)
            del ms_ck
        if len(set(faces_by_pass)) != len(faces_by_pass):
            fail(f"lod: face counts {faces_by_pass} do not differ")
        if info["remesh_failures"] or info["remesh_attempts"] != 3:
            fail(f"lod: remesh health {info}")
        if info["remesher"] != "native":
            fail(f"lod: the {info['remesher']} remesher ran, not the native "
                 "core (is g++ there?)")
        logged = [r for r in logger.history if "iter" in r]
        if len(logged) != 6 or not all(math.isfinite(r["loss"])
                                       for r in logged):
            fail(f"lod: logged losses {[r.get('loss') for r in logged]}")
        n_steps = hp_lod.num_passes * hp_lod.iters
        if lod_launches != (n_steps * per_step,) * 3:
            fail(f"lod: launches {lod_launches} in {n_steps} steps, "
                 f"expected {n_steps * per_step} of each kernel")
        v_out, f_out = out.host_arrays()
        if not np.isfinite(v_out).all() or len(f_out) != faces_by_pass[-1]:
            fail("lod: the final mesh is not finite or not the last pass's")
        h_out = hausdorff_distance(v_out, f_out, v90, f90)
        print(f"lod: {hp_lod.num_passes} passes x {hp_lod.iters} steps in "
              f"{lod_s:.2f} s ({info['remesher']} remesher), remesh "
              f"{sum(p['remesh_s'] for p in info['passes']):.2f} s, steps "
              f"{sum(p['steps_s'] for p in info['passes']):.2f} s, peak "
              f"memory {lod_peak / 2**30:.2f} GiB, "
              f"closest-hit, prepass and packing launches {lod_launches}, "
              f"scatter launches {lod_scatters}; Hausdorff mean against "
              f"dog_mid90k: init {h_init.mean:.4f}, result {h_out.mean:.4f} (max {h_init.max:.3f} -> "
              f"{h_out.max:.3f}; one evaluation {hausdorff_s:.1f} s)")
        # resume: one pass more, and only that pass
        info2 = {}
        t0 = time.time()
        out2 = optimize(hp_lod.replace(num_passes=4), cap, v20, f20,
                        remesh_fn="isotropic", checkpoint_dir=ck_dir,
                        log_fn=lambda s: None, resume=True, run_info=info2,
                        device=dev)
        torch.cuda.synchronize()
        if ([p["pass"] for p in info2["passes"]] != [3]
                or "dog_pass03.ply" not in os.listdir(ck_dir)
                or not torch.isfinite(out2.vertices).all()):
            fail(f"lod: resume ran passes {info2['passes']}")
        print(f"lod: resume ran pass 3 alone: {out2.num_faces} faces, "
              f"{time.time() - t0:.2f} s")
    # -- 10. the command line -------------------------------------------------
    t0 = time.time()
    cli_launches, cli_times = cli_phase(
        dev, RES, os.path.join(MESH_DIR, "dog_mid90k.ply"))
    cli_times["phase_s"] = time.time() - t0

    # -- 11. the sharded train step -------------------------------------------
    t0 = time.time()
    par_a, par_times = parallel_phase(RES, hp, weights, budget, ms45, cap)
    par_b, times_b = parallel_ranks_phase(RES, hp, weights, budget, ms45,
                                          cap, one_shift)
    par_times.update(times_b, phase_s=time.time() - t0)
    par_launches = tuple(a + b for a, b in zip(par_a, par_b))

    # -- 12. candidate groups, t_min, a mesh above the cap -------------------
    by_group, group_times = groups_phase(dev, RES, hp, ms45, o1, d1, gen)

    # -- 13. the train step as one CUDA graph -------------------------------
    graph_launches, graph_scatters, graph_cg, graph_out = graph_phase(
        RES, hp, weights, budget, ms45, cap, per_step, scatter_step)

    # -- 14. the CG solve's kernel against its plain version ---------------
    cg_out = cg_phase(RES, hp, weights, budget, ms45, cap, ms_fine,
                      budget_fine)
    cg_main = [sum(x) for x in zip(*cg_steps, graph_cg)]
    if min(cg_main[1:]) < 1:
        fail(f"cg: the main path's steps launched the CG kernel {cg_main} "
             "times (all, shared route, global route; phases 6 and 13)")

    # -- 15. the bounce chain and the ray-loss tail ------------------------
    missing = [p for p in ("train", "steps", "chunked", "lod", "cli",
                           "parallel", "graph") if p not in CHAIN_LAUNCHES]
    if missing:
        fail(f"chain: no bounce or tail launch counted on {missing}")
    chain_out = chain_phase(RES, hp, cap, {"dog_mid45k": (v45, f45),
                                           "dog_mid90k": (v90, f90)})

    # -- 16. the one-origin route -------------------------------------------
    order_out = order_phase(RES, hp, weights, budget, ms45, cap, {
        "dog_mid20k": build_mesh_state(*load_ply(os.path.join(
            MESH_DIR, "dog_mid20k.ply")), device=dev),
        "dog_mid45k": ms45,
        "dog_mid90k": build_mesh_state(v90, f90, device=dev)})

    # -- 17. the silhouette views' chain ------------------------------------
    sil_out = silhouette_phase(RES, cap, {
        "dog_mid20k": load_ply(os.path.join(MESH_DIR, "dog_mid20k.ply")),
        "dog_mid45k": (v45, f45), "dog_mid90k": (v90, f90)})

    total = [sum(x) for x in zip(launches, lod_launches, cli_launches,
                                 par_launches, graph_launches)]

    cam_r = results["camera"]
    pre = {k: r["prepass"] for k, r in results.items()}
    pre_r = pre["dog_mid45k bounce2"]
    pre_t = pre["camera"]
    pack_r = results["dog_mid45k bounce2"]["pack"]
    kernels = [{
        "name": "closest_hit",
        "route": "cuda",
        "source": "drt_tpu_torch/csrc/closest_hit.cu",
        "replaces": "drt_tpu/intersect/pallas_kernel.py:118",
        "launches": total[0],
        "launches_train": launches[0],
        "launches_lod": lod_launches[0],
        "launches_cli": cli_launches[0],
        "launches_parallel": par_launches[0],
        "launches_graph": graph_launches[0],
        "launches_per_step": per_step,
        "shape": "camera rays 1280x960 on dog_mid90k",
        "max_abs_err": max(r["err"] for r in [*results.values(),
                                               *by_group.values()]),
        "ms": cam_r["ms"],
        "plain_ms": cam_r["plain_ms"],
        "bound_ms": cam_r["bound_ms"],
        "bound_by": cam_r["bound_by"],
        "library_ms": None,
        "group_shape": "bounce-2 rays 1280x960 on dog_mid90k (phase 12)",
        "group_ms": {g: r["ms"] for g, r in by_group.items()},
        "group_bound_ms": {g: r["bound_ms"] for g, r in by_group.items()},
        "group_query_ms": {g: r["query_ms"] for g, r in by_group.items()},
    }, {
        "name": "candidates",
        "route": "cuda",
        "source": "drt_tpu_torch/csrc/candidates.cu",
        "replaces": "drt_tpu/intersect/pallas_kernel.py:359",
        "launches": total[1],
        "launches_train": launches[1],
        "launches_lod": lod_launches[1],
        "launches_cli": cli_launches[1],
        "launches_parallel": par_launches[1],
        "launches_graph": graph_launches[1],
        "launches_per_step": per_step,
        "shape": "ray mode: bounce-2 rays 1280x960 on dog_mid45k, groups "
                 f"of {results['dog_mid45k bounce2']['group']} (the default)",
        "max_abs_err": max(r["err"] for r in [
            *pre.values(), *(r["prepass"] for r in by_group.values())]),
        "ms": pre_r["ms"],
        "plain_ms": pre_r["plain_ms"],
        "bound_ms": pre_r["bound_ms"],
        "bound_by": pre_r["bound_by"],
        "replaced_ms": pre_r["replaced_ms"],
        "tile_shape": "tile mode: camera rays 1280x960 on dog_mid90k",
        "tile_ms": pre_t["ms"],
        "tile_plain_ms": pre_t["plain_ms"],
        "tile_bound_ms": pre_t["bound_ms"],
        "tile_bound_by": pre_t["bound_by"],
        "tile_replaced_ms": pre_t["replaced_ms"],
        "library_ms": None,
        "group_shape": "ray mode: bounce-2 rays 1280x960 on dog_mid90k "
                       "(phase 12), group boxes",
        "group_ms": {g: r["prepass"]["ms"] for g, r in by_group.items()},
        "group_bound_ms": {g: r["prepass"]["bound_ms"]
                           for g, r in by_group.items()},
    }, {
        "name": "pack",
        "route": "cuda",
        "source": "drt_tpu_torch/csrc/pack.cu",
        "replaces": "drt_tpu/intersect/pallas_kernel.py:291",
        "replaces_also": ["drt_tpu/intersect/culled.py:54",
                          "drt_tpu/intersect/culled.py:78",
                          "drt_tpu/intersect/pallas_kernel.py:449",
                          "drt_tpu/intersect/pallas_kernel.py:473"],
        "launches": total[2],
        "launches_train": launches[2],
        "launches_lod": lod_launches[2],
        "launches_cli": cli_launches[2],
        "launches_parallel": par_launches[2],
        "launches_graph": graph_launches[2],
        "launches_per_step": per_step,
        "shape": "bounce-2 rays 1280x960 on dog_mid45k, groups of "
                 f"{results['dog_mid45k bounce2']['group']} (the default)",
        "max_abs_err": max(r["pack"]["err"] for r in [*results.values(),
                                                       *by_group.values()]),
        "ms": pack_step_ms[1],
        "ms_from": "torch.profiler's device span in phase 5's profiled "
                   "step (its bounce-2 query)",
        "step_ms": pack_step_ms,
        "call_ms": pack_r["call_ms"],
        "plain_ms": pack_r["plain_ms"],
        "bound_ms": pack_r["bound_ms"],
        "bound_by": pack_r["bound_by"],
        "library_ms": None,
        "camera_shape": "camera rays 1280x960 on dog_mid90k",
        "camera_call_ms": results["camera"]["pack"]["call_ms"],
        "camera_plain_ms": results["camera"]["pack"]["plain_ms"],
        "camera_bound_ms": results["camera"]["pack"]["bound_ms"],
        "group_shape": "bounce-2 rays 1280x960 on dog_mid90k (phase 12)",
        "group_call_ms": {g: r["pack"]["call_ms"]
                          for g, r in by_group.items()},
        "group_bound_ms": {g: r["pack"]["bound_ms"]
                           for g, r in by_group.items()},
        "oracle_ops_per_step": oracle_ops,
    }, scatter_entry(scatter_checked, scatter_prof, scatter_launches,
                     scatter_step, lod_scatters, scatter_route_launches)]
    kernels[-1]["launches_graph"] = graph_scatters
    kernels.extend(cg_entries(cg_out, cg_steps, graph_cg))
    kernels.extend(chain_entries(chain_out))
    kernels.extend(silhouette_entries(sil_out))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"cli": cli_times}))
    print(json.dumps({"graph": graph_out}))
    print(json.dumps({"parallel": par_times}))
    print(json.dumps({"groups": group_times}))
    print(json.dumps({"order": order_out}))
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [PARALLEL_RANK]:
        parallel_rank(int(sys.argv[2]), sys.argv[3])
    else:
        main()

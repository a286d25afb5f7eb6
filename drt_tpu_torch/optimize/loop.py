"""The train step and the LOD optimization loop (port of
drt_tpu/optimize/loop.py).

Capability of the reference's `optimize` (optim.py:145-219): `num_passes`
passes of [remesh to the scheduled edge length, re-init a zero displacement
parameter, run `iters` steps on the weighted loss], with reciprocal
schedules for remesh length and learning rate, and the gradient limit hook
(NaN -> 0, clamp +-1, optim.py:155-162).

One step: vertices from the parameters, vertex normals
(MeshState.with_vertices), total_loss, backward to the [V,3] gradient, the
preconditioner, the limit hook and the optimizer update. The state is a
dict of device tensors. On the card `optimize` runs each pass's steps as
one CUDA graph (`GraphedTrainStep`), captured once a pass and replayed
every iteration, the counterpart of the JAX package's jitted step: no step
reads anything back to the host, and `optimize` reads once a pass (the
running silhouette-edge maximum and the scatters' out-of-range word, in
one read) and on logged iterations. On the CPU it runs the eager step of
`make_train_step`, whose scatters check their indices at every call.
Per-pass state is checkpointed as a PLY mesh, which gives the
restart-from-pass capability the reference lacks. Remeshing is an injectable
callable (the in-process isotropic remesher of drt_tpu_torch.remesh stands
in for the reference's meshlabserver subprocess).
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from drt_tpu_torch import kernels, spans
from drt_tpu_torch.config import HyperParams
from drt_tpu_torch.data.views import CaptureData
from drt_tpu_torch.geometry.scatter import (deferred_bounds_check,
                                            raise_if_out_of_bounds)
from drt_tpu_torch.intersect.api import get_intersect_fn
from drt_tpu_torch.mesh.ply import load_ply, save_ply
from drt_tpu_torch.mesh.state import MeshState, build_mesh_state
from drt_tpu_torch.mesh.topology import build_topology, morton_order_faces
from drt_tpu_torch.optimize.losses import LossWeights, total_loss
from drt_tpu_torch.optimize.precondition import sobolev_apply, sobolev_solve
from drt_tpu_torch.optimize.schedules import interp_reciprocal
from drt_tpu_torch.render.trace import debug_enabled


def limit_grad(g: torch.Tensor, max_abs: float = 1.0) -> torch.Tensor:
    """The reference's limit_hook: NaN -> 0, clamp to +-max_abs."""
    g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
    if max_abs:
        g = torch.clamp(g, -max_abs, max_abs)
    return g


def default_silhouette_budget(num_edges: int) -> int:
    """~1/4 of all edges rounded up to a power of two (at least 512)."""
    b = 512
    while b < num_edges // 4:
        b *= 2
    return b


def _reduce_over_ranks(ray_mesh, aux, *tensors):
    """Sum `tensors` and aux's floating parts over the ranks of `ray_mesh`
    with one all_reduce of one flat buffer (in the first tensor's dtype),
    aux's integer counters with one more, and take the largest
    silh_edge_max with a third. aux is updated in place; returns the summed
    tensors, each in its own dtype and shape."""
    group = ray_mesh.group
    floats = [k for k, v in aux.items()
              if k != "silh_edge_max" and v.is_floating_point()]
    ints = [k for k, v in aux.items()
            if k != "silh_edge_max" and not v.is_floating_point()]
    parts = list(tensors) + [aux[k] for k in floats]
    buf = torch.cat([x.reshape(-1).to(tensors[0].dtype) for x in parts])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    out, i = [], 0
    for x in parts:
        out.append(buf[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    aux.update(zip(floats, out[len(tensors):]))
    if ints:
        counts = torch.stack([aux[k].to(torch.int64) for k in ints])
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
        aux.update(zip(ints, counts.unbind()))
    silh = aux["silh_edge_max"].to(torch.int64).reshape(1)
    dist.all_reduce(silh, op=dist.ReduceOp.MAX, group=group)
    aux["silh_edge_max"] = silh[0]
    return out[:len(tensors)]


def make_train_step(intersect_fn: Callable, weights: LossWeights,
                    resy: int, resx: int, silhouette_budget: int,
                    momentum: float = 0.95, optimizer: str = "sgd",
                    precond: str = "none", precond_lambda: float = 29.0,
                    cg_iters: int = 64, grad_clamp: float = 1.0,
                    ray_chunk: int = -1, ray_mesh=None):
    """Build (init_state, step, final_vertices) for one LOD pass.

    step(state, lr, mesh, views, ray_view_idx, silh_view_idx)
    -> (new_state, loss, aux). The state is a dict of tensors; step returns
    a new dict and leaves its argument unchanged. `lr` is a float or a 0-d
    tensor.

    optimizer: 'sgd' is Nesterov-momentum SGD, the reference's exact
      dynamics (optim.py:169) with the limit hook; 'adam' is Adam; 'uadam'
      is Adam with a uniform (scalar, max-over-coordinates) second moment,
      the variant of Nicolet et al. 2021 that avoids per-coordinate step
      distortion.
    precond: 'none' optimizes a per-vertex displacement p, vertices =
      init + p (reference parity); 'sobolev' optimizes u with vertices =
      (I + lam L)^{-1} u (optimize/precondition.py); 'h1' is an evidence-
      equalized H1 gradient flow: the ray-loss gradient is divided by each
      vertex's ray-evidence count, combined with the regularizer gradient,
      then smoothed by (I + lam L)^{-1} so low-frequency shape modes move
      at full scale.

    The reference's +-1 clamp (grad_clamp) is applied in the parity
    configuration (sgd + none) and, after equalization and smoothing, in
    'h1' under every optimizer: there it is a trust region on an already
    well-scaled direction (one near-degenerate-triangle ray can spike the
    gradient by ~1e7, and uadam's max-based second moment never forgets
    it). Under the Sobolev reparameterization the u-space gradient scale is
    different and clamping would bring back the saturation the
    preconditioner removes.

    ray_mesh: a `RayMesh` (drt_tpu_torch.parallel) when `views` holds this
      rank's shard of the rays (parallel.shard_views) and the mesh and the
      state are the same on every rank (parallel.replicate). Each rank then
      traces its own rays, takes the silhouette views
      silh_view_idx[rank::size] and, on rank 0 alone, the smoothness term,
      so that each term is counted once. One all_reduce sums the gradient,
      the loss and its parts (and h1's per-vertex evidence, before c_bar is
      taken from it), one more the trace counters, and one takes the largest
      silhouette-edge count; every rank then applies the same update. Every
      rank must pass the same lr, ray_view_idx and silh_view_idx. None (the
      default) is the single-process step.
    """
    if optimizer not in ("sgd", "adam", "uadam"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if precond not in ("none", "sobolev", "h1"):
        raise ValueError(f"unknown precond {precond!r}")
    if precond == "h1" and not weights.ray_w:
        raise ValueError("precond='h1' requires a nonzero ray_w")

    clamp = grad_clamp if (precond == "h1" or (optimizer == "sgd"
                                               and precond == "none")) else 0.0

    def init_state(mesh: MeshState):
        init_v = mesh.vertices.detach()
        if precond == "sobolev":
            params = sobolev_apply(init_v, mesh.neighbors,
                                   mesh.neighbor_valid, precond_lambda)
        else:
            params = torch.zeros_like(init_v)
        zeros = torch.zeros_like(init_v)
        dev = init_v.device
        return {"params": params, "m": zeros,
                "v": torch.zeros((), dtype=init_v.dtype, device=dev),
                "v_per": zeros,
                "count": torch.zeros((), dtype=torch.int32, device=dev),
                "init_v": init_v,
                # Running max of per-view silhouette-edge counts over every
                # iteration, so `optimize`'s budget guard sees all of them
                # with one host read a pass.
                "silh_max": torch.zeros((), dtype=torch.int64, device=dev)}

    def loss_and_grad(state, mesh, views, ray_view_idx, silh_view_idx, w,
                      collect_evidence=False):
        """total_loss under weights w and its gradient in the parameters
        (this rank's share of them under a ray mesh); aux comes back
        detached so it does not keep the graph alive."""
        if ray_mesh is not None:
            silh_view_idx = list(silh_view_idx)[ray_mesh.rank::ray_mesh.size]
            w = w._replace(vh_w=w.vh_w if silh_view_idx else 0.0,
                           sm_w=0.0 if ray_mesh.rank else w.sm_w)
        p = state["params"].detach().requires_grad_(True)
        with spans.span("normals", p):
            if precond == "sobolev":
                vert = sobolev_solve(p, mesh.neighbors, mesh.neighbor_valid,
                                     precond_lambda, maxiter=cg_iters)
            else:
                vert = state["init_v"] + p
            mesh_v = mesh.with_vertices(vert)
        loss, aux = total_loss(mesh_v, views, ray_view_idx, silh_view_idx,
                               intersect_fn, w, resy, resx,
                               silhouette_budget,
                               collect_evidence=collect_evidence,
                               ray_chunk=ray_chunk)
        if loss.requires_grad:
            with spans.span("backward", p):
                (g,) = torch.autograd.grad(loss, p)
        else:                      # every weight of w is zero
            g = torch.zeros_like(p)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, g

    def step(state, lr, mesh: MeshState, views, ray_view_idx,
             silh_view_idx):
        with spans.step_span(state["params"]):
            if precond == "h1":
                # Split gradients: the ray term (evidence-preconditioned)
                # against the regularizers (vh + sm). A zero weight skips
                # its term, so the two passes make the oracle queries of
                # one.
                grads = (
                    loss_and_grad(state, mesh, views, ray_view_idx,
                                  silh_view_idx,
                                  weights._replace(vh_w=0.0, sm_w=0.0),
                                  collect_evidence=True),
                    loss_and_grad(state, mesh, views, ray_view_idx,
                                  silh_view_idx,
                                  weights._replace(ray_w=0.0)))
            else:
                grads = (loss_and_grad(state, mesh, views, ray_view_idx,
                                       silh_view_idx, weights),)
            with spans.span("update", state["params"]):
                return update(state, lr, mesh, grads)

    def update(state, lr, mesh, grads):
        """The step after its gradient: the preconditioner, the limit hook
        and the optimizer; `grads` holds loss_and_grad's results."""
        if precond == "h1":
            (l_ray, aux, g_ray), (l_reg, aux_reg, g_reg) = grads
            ev = aux.pop("vertex_evidence")     # float32 counts
            aux.update({k: aux_reg[k] for k in ("vh", "sm", "silh_edge_max")})
            if ray_mesh is not None:
                l_ray, l_reg, g_ray, g_reg, ev = _reduce_over_ranks(
                    ray_mesh, aux, l_ray, l_reg, g_ray, g_reg, ev)
            # Equalize: vertices with little refraction evidence get the
            # same step scale as high-evidence ones; c_bar keeps the global
            # ray/regularizer balance of the reference's weighted sum. The
            # scale stays in float32 whatever the gradient's dtype, as in
            # the JAX package.
            c_bar = ev.sum() / torch.clamp((ev > 0).sum().to(ev.dtype),
                                           min=1.0)
            # no evidence at all (every ray lost) -> drop the ray term
            scale = torch.where(
                c_bar > 0.0,
                c_bar / (ev + 0.25 * torch.clamp(c_bar, min=1e-9)),
                torch.zeros_like(ev))
            g = g_ray * scale[:, None] + g_reg
            # H1 smoothing: descent direction in the Sobolev metric.
            g = sobolev_solve(g, mesh.neighbors, mesh.neighbor_valid,
                              precond_lambda, maxiter=cg_iters)
            loss = l_ray + l_reg
            aux["evidence_mean"] = c_bar
        else:
            ((loss, aux, g),) = grads
            if ray_mesh is not None:
                loss, g = _reduce_over_ranks(ray_mesh, aux, loss, g)
        g = limit_grad(g, clamp)
        aux["max_grad"] = g.abs().max()

        params, mom = state["params"], state["m"]
        if optimizer == "sgd":
            mom = momentum * mom + g
            params = params - lr * (g + momentum * mom)
            new = {**state, "params": params, "m": mom}
        else:
            b1, b2, eps = 0.9, 0.999, 1e-8
            count = state["count"] + 1
            t = count.to(g.dtype)
            mom = b1 * mom + (1 - b1) * g
            m_hat = mom / (1 - b1 ** t)
            if optimizer == "uadam":
                v2 = b2 * state["v"] + (1 - b2) * (g * g).max()
                new_v, new_vper = v2, state["v_per"]
            else:  # adam
                v2 = b2 * state["v_per"] + (1 - b2) * (g * g)
                new_v, new_vper = state["v"], v2
            denom = torch.sqrt(v2 / (1 - b2 ** t)) + eps
            params = params - lr * m_hat / denom
            new = {**state, "params": params, "m": mom, "v": new_v,
                   "v_per": new_vper, "count": count}
        new["silh_max"] = torch.maximum(
            state["silh_max"],
            aux["silh_edge_max"].to(state["silh_max"].device))
        return new, loss, aux

    def final_vertices(state, mesh: MeshState):
        if precond == "sobolev":
            return sobolev_solve(state["params"], mesh.neighbors,
                                 mesh.neighbor_valid, precond_lambda,
                                 maxiter=4 * cg_iters, tol=1e-8)
        return state["init_v"] + state["params"]

    step.ray_mesh = ray_mesh          # GraphedTrainStep refuses a sharded step
    return init_state, step, final_vertices


# Eager steps a pass's graph runs before its capture: one builds the
# kernels and makes every lazy thing of the step (the constants of
# geometry/vec.py, the cached tables, cuBLAS's workspace on the side
# stream, the autograd engine's thread), so that the capture meets none.
GRAPH_WARMUP_STEPS = 1
# One side stream a device for every pass's graph: a new stream each pass
# would leave a cuBLAS workspace behind each time (torch keeps one a
# stream).
_graph_streams: dict = {}


def _graph_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _graph_streams:
        _graph_streams[dev] = torch.cuda.Stream(device=dev)
    return _graph_streams[dev]


class GraphedTrainStep:
    """One LOD pass's train step on the card as one CUDA graph, captured
    once and replayed every iteration: the port's counterpart of the JAX
    package's jitted step (drt_tpu/optimize/loop.py, `@jax.jit`).

        run = GraphedTrainStep(step, state, lr, mesh, views, ray_idx,
                               silh_idx)
        for it in range(iters):
            loss, aux = run()
        state = run.close()

    `step` is make_train_step's eager step; `state` its state (copied into
    static buffers that each call updates in place); `lr` a number, held in
    a 0-d device tensor of the parameters' type; `ray_idx` [iters, R] and
    `silh_idx` [iters, S] int64 on the card, the views of each iteration,
    drawn before the pass: a device counter steps through their rows, so
    one graph serves every iteration. The first GRAPH_WARMUP_STEPS calls
    run the step eagerly (real steps of the pass); the next captures it with
    `torch.cuda.graph` (keep_graph, then `instantiate`) and replays it, and
    every later call replays it. All of it runs on a side stream, which the
    current stream waits for after each call. A call returns (loss, aux):
    tensors that the next call overwrites, read them before it. Each replay
    adds to `kernels.counters` the launches its capture recorded, so the
    counts read as the eager steps' would.

    The step's device spans (drt_tpu_torch/spans.py): the capture records
    their markers and keeps their graph nodes (`markers`), which are
    disabled right after `instantiate`. Each call compares whether a torch
    profiler records with the markers' state and, where they differ,
    switches every marker node on or off in one native call, with no new
    capture; a profiled call also runs inside a host range named
    `train_step`.

    Inside the wrapper every scatter ORs its out-of-range flag into
    `bounds_word` and reads nothing; the owner reads the word once, after
    `close()` (`optimize` reads it with the silhouette-edge maximum) and
    raises then. `setup` holds the warm-up, capture and instantiate seconds
    and the graph's memory pool (bytes reserved by the capture).

    No fallback: a capture or replay that fails raises. It refuses CPU
    tensors (the CPU runs the eager step), DRT_TPU_DEBUG (its checks read
    the host inside the step) and a sharded step (`ray_mesh`: gloo
    collectives cannot be captured; that step stays eager)."""

    def __init__(self, step, state: dict, lr, mesh: MeshState, views,
                 ray_idx: torch.Tensor, silh_idx: torch.Tensor):
        if debug_enabled():
            raise RuntimeError("GraphedTrainStep: DRT_TPU_DEBUG is set, and "
                               "its checks read counts back to the host "
                               "inside the step, which a CUDA graph cannot "
                               "capture; run make_train_step's eager step")
        if getattr(step, "ray_mesh", None) is not None:
            raise ValueError("GraphedTrainStep: a sharded step (ray_mesh) "
                             "is not captured: its gloo collectives cannot "
                             "be; run it eagerly")
        params = state["params"]
        dev = params.device
        if dev.type != "cuda":
            raise ValueError(f"GraphedTrainStep: the state is on {dev}; a "
                             "CUDA graph needs the card (the CPU runs "
                             "make_train_step's eager step)")
        for name, idx in (("ray_idx", ray_idx), ("silh_idx", silh_idx)):
            if (idx.dim() != 2 or idx.dtype != torch.int64
                    or idx.device != dev):
                raise ValueError(f"{name}: expected [iters, k] int64 on "
                                 f"{dev}, got {tuple(idx.shape)} "
                                 f"{idx.dtype} on {idx.device}")
        if ray_idx.shape[0] != silh_idx.shape[0]:
            raise ValueError(f"ray_idx has {ray_idx.shape[0]} iterations, "
                             f"silh_idx {silh_idx.shape[0]}")
        self._step, self._mesh, self._views = step, mesh, views
        self._ray_idx, self._silh_idx = ray_idx, silh_idx
        self.iters = ray_idx.shape[0]
        self.state = {k: v.clone() for k, v in state.items()}
        self.lr = torch.full((), float(lr), dtype=params.dtype, device=dev)
        self.bounds_word = torch.zeros(1, dtype=torch.int32, device=dev)
        self._it = torch.zeros(1, dtype=torch.int64, device=dev)
        self._stream = _graph_stream(dev)
        self._calls = 0
        self._graph = None
        self._out = None
        self._replay_launches = None
        self.markers = []
        self._markers_on = False
        self.setup = {"warmup_s": 0.0}

    def _body(self):
        with spans.step_span(self.lr):
            ray = self._ray_idx.index_select(0, self._it)[0]
            silh = self._silh_idx.index_select(0, self._it)[0]
            new, loss, aux = self._step(self.state, self.lr, self._mesh,
                                        self._views, ray, silh)
            self._it.add_(1)
            for k, v in new.items():
                if v is not self.state[k]:
                    self.state[k].copy_(v)
        return loss, aux

    def _capture(self):
        dev = self.lr.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()        # the pool: what the capture adds
        reserved = torch.cuda.memory_reserved(dev)
        before = kernels.counters.snapshot()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with spans.capturing() as markers, \
                torch.cuda.graph(graph, stream=self._stream):
            self._out = self._body()
        t1 = time.perf_counter()
        graph.instantiate()
        spans.set_enabled(graph, markers, False)
        t2 = time.perf_counter()
        self.markers, self._markers_on = markers, False
        after = kernels.counters.snapshot()
        # the capture recorded these launches and ran none of them
        self._replay_launches = {k: after[k] - before[k] for k in after}
        kernels.counters.add(self._replay_launches, -1)
        self._graph = graph
        self.setup.update(
            capture_s=t1 - t0, instantiate_s=t2 - t1,
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved)

    def __call__(self):
        """Run the pass's next iteration; returns (loss, aux)."""
        if self._calls >= self.iters:
            raise RuntimeError(f"GraphedTrainStep: all {self.iters} "
                               "iterations of the pass have run")
        if self._calls < 0:
            raise RuntimeError("GraphedTrainStep: closed")
        self._calls += 1
        if spans.recording():
            with torch.profiler.record_function("train_step"):
                return self._call()
        return self._call()

    def _call(self):
        cur = torch.cuda.current_stream(self.lr.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            if self._calls <= GRAPH_WARMUP_STEPS:
                t0 = time.perf_counter()
                with deferred_bounds_check(self.bounds_word):
                    out = self._body()
                self.setup["warmup_s"] += time.perf_counter() - t0
            else:
                if self._graph is None:
                    with deferred_bounds_check(self.bounds_word):
                        self._capture()
                on = spans.recording()
                if on != self._markers_on:
                    spans.set_enabled(self._graph, self.markers, on)
                    self._markers_on = on
                self._graph.replay()
                kernels.counters.add(self._replay_launches)
                out = self._out
        cur.wait_stream(self._stream)
        return out

    def close(self) -> dict:
        """End the pass: release the graph and its memory pool and return
        the state, whose buffers nothing overwrites any more. The caller
        drops the (loss, aux) of its calls first, which live in the pool."""
        torch.cuda.current_stream(self.lr.device).wait_stream(self._stream)
        self._calls = -1
        self._out = None
        if self._graph is not None:
            self._graph = None
            torch.cuda.empty_cache()
        return self.state


def find_resume_pass(checkpoint_dir: str, name: str):
    """Latest per-pass checkpoint (pass index, path) or None."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    best = None
    for fname in os.listdir(checkpoint_dir):
        m = re.fullmatch(rf"{re.escape(name)}_pass(\d+)\.ply", fname)
        if m:
            i = int(m.group(1))
            if best is None or i > best[0]:
                best = (i, os.path.join(checkpoint_dir, fname))
    return best


def optimize(
    hp: HyperParams,
    data: CaptureData,
    init_vertices: np.ndarray,
    init_faces: np.ndarray,
    remesh_fn: Optional[Callable] = None,
    checkpoint_dir: Optional[str] = None,
    log_fn: Callable = print,
    log_every: int = 100,
    metrics=None,
    resume: bool = False,
    run_info: Optional[dict] = None,
    device="cuda",
) -> MeshState:
    """Run the full LOD optimization on `device`; returns the final
    MeshState. `data` must hold its views on the same device; there is no
    fallback to the CPU when `device` names a card and none is present.

    remesh_fn(vertices, faces, target_len) -> (vertices, faces). Pass the
    string "isotropic" for the built-in in-process remesher, or None to skip
    remeshing (the reference remeshes every pass, optim.py:195).

    run_info, if given, is filled with remesh-health counters
    (remesh_attempts / remesh_retries / remesh_failures): the reference's
    meshlabserver either succeeds every pass or kills the run (optim.py:51);
    the retry guard here converts failure into a fixed-topology pass, so
    failures are counted loudly. The same counters go to the metrics JSONL.
    run_info also gets "remesher" ("native" or "numpy" for the built-in
    remesher) and "passes": per pass its index, face count, silhouette
    budget, the seconds spent remeshing and stepping and, on the card, its
    graph's `setup` (GraphedTrainStep).

    On the card each pass runs as one captured CUDA graph
    (`GraphedTrainStep`, for every optimizer and preconditioner), with no
    switch to the eager step: a scatter index out of bounds then raises
    `RuntimeError` at the pass's one read, not at its call. On the CPU
    every pass runs make_train_step's eager step.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("optimize(device='cuda'): torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    if data.views.ray_dir.device.type != device.type:
        raise ValueError(f"the capture's views are on "
                         f"{data.views.ray_dir.device}, optimize runs on "
                         f"{device}")
    dtype = getattr(torch, hp.dtype)
    if run_info is None:
        run_info = {}
    if remesh_fn == "isotropic":
        from drt_tpu_torch.remesh.isotropic import isotropic_remesh
        from drt_tpu_torch.remesh.native import load_native
        remesh_fn = isotropic_remesh
        run_info["remesher"] = ("native" if load_native() is not None
                                else "numpy")
        log_fn(f"remesher: isotropic, {run_info['remesher']} core")
    intersect_fn = get_intersect_fn(hp.backend)
    weights = LossWeights(ray_w=hp.ray_w, vh_w=hp.vh_w, sm_w=hp.sm_w,
                          ior=hp.ior, ext_ior=hp.ext_ior,
                          bilinear_mask=hp.bilinear_mask, huber=hp.huber)

    if isinstance(metrics, str):
        from drt_tpu_torch.utils.metrics import MetricsLogger
        metrics = MetricsLogger(metrics)

    v_np, f_np = np.asarray(init_vertices), np.asarray(init_faces)
    # no_coarsen clamp target: the ORIGINAL init's mean edge length, computed
    # before any resume load so fresh and resumed runs use the same clamp.
    # Directed-edge mean == undirected mean on a closed mesh.
    tri = v_np[f_np]
    init_len = float(np.mean(np.linalg.norm(
        tri - np.roll(tri, -1, axis=1), axis=2)))
    start_pass = 0
    if resume and checkpoint_dir:
        found = find_resume_pass(checkpoint_dir, hp.name)
        if found is not None:
            start_pass = found[0] + 1
            v_np, f_np = load_ply(found[1])
            log_fn(f"resuming from pass {found[0]} checkpoint {found[1]}")
    mesh = build_mesh_state(v_np, f_np, dtype=dtype, device=device)

    steps = {}   # silhouette budget -> (init_state, step, final_vertices)
    budget_floor = 0   # grown when a pass observes more silhouette edges
    remesh_health = {"remesh_attempts": 0, "remesh_retries": 0,
                     "remesh_failures": 0}
    run_info.update(remesh_health)
    run_info["passes"] = []
    t_start = time.time()

    # Coarsening policy while the scheduled target is coarser than the
    # init's own mean edge length (config.py coarsen_policy):
    # "schedule" = reference parity, "clamp" = never above init_len,
    # "skip" = no remesh at all until the schedule drops below init_len.
    policy = "clamp" if hp.no_coarsen else hp.coarsen_policy
    if policy == "auto":
        policy = "skip" if data.resy < 480 else "schedule"
        log_fn(f"coarsen_policy auto -> {policy} (resy {data.resy})")
    if policy not in ("schedule", "clamp", "skip"):
        raise ValueError(f"unknown coarsen_policy {policy!r}")

    for i_pass in range(start_pass, hp.num_passes):
        t_pass = time.time()
        remesh_len = interp_reciprocal(hp.start_len, hp.end_len, i_pass,
                                       hp.num_passes)
        skip_remesh = policy == "skip" and remesh_len > init_len
        if policy == "clamp":
            remesh_len = min(remesh_len, init_len)
        if hp.lr_schedule == "len":
            lr = hp.start_lr * remesh_len / hp.start_len
        else:
            lr = interp_reciprocal(hp.start_lr, hp.lr_decay * hp.start_lr,
                                   i_pass, hp.num_passes)
        log_fn(f"pass {i_pass}: remesh_len {remesh_len:g} lr {lr:g}"
               + (" (remesh skipped: coarser than init)" if skip_remesh
                  else ""))

        if remesh_fn is not None and not skip_remesh:
            v_np, f_np = mesh.host_arrays()
            # Optimizer-roughened geometry can occasionally drive a collapse
            # cascade that breaks watertightness. Retry slightly finer, then
            # keep the current mesh rather than dying mid-run.
            for attempt, target in enumerate((remesh_len, 0.8 * remesh_len,
                                              None)):
                if target is None:
                    remesh_health["remesh_failures"] += 1
                    log_fn(f"  WARNING: remesh failed at pass {i_pass}; "
                           "keeping the current mesh this pass")
                    break
                remesh_health["remesh_attempts"] += 1
                if attempt:
                    remesh_health["remesh_retries"] += 1
                try:
                    v2, f2 = remesh_fn(v_np, f_np, target)
                    f2 = morton_order_faces(v2, np.asarray(f2))
                    topo = build_topology(f2, len(v2))
                    if not topo.is_watertight:
                        raise ValueError("mesh is not watertight")
                except (ValueError, RuntimeError) as e:
                    log_fn(f"  remesh to {target:g} failed ({e}); retrying")
                    continue
                # The upload stands outside the try: an error of the device
                # is no remesh failure and must end the run.
                mesh = build_mesh_state(v2, f2, dtype=dtype, device=device,
                                        topology=topo)
                break
            run_info.update(remesh_health)
            if metrics is not None:
                metrics.log({"pass": i_pass, "event": "remesh",
                             **remesh_health})
        t_remeshed = time.time()

        budget = max(hp.silhouette_budget
                     or default_silhouette_budget(mesh.num_edges),
                     budget_floor)
        if budget not in steps:
            steps[budget] = make_train_step(
                intersect_fn, weights, data.resy, data.resx, budget,
                momentum=hp.momentum, optimizer=hp.optimizer,
                precond=hp.precond, precond_lambda=hp.precond_lambda,
                cg_iters=hp.cg_iters, grad_clamp=hp.grad_clamp,
                ray_chunk=hp.diff_ray_chunk)
        init_state, step, final_vertices = steps[budget]

        # Fresh optimizer state each pass (optim.py:164-171).
        state = init_state(mesh)
        ray_gen = data.ray_view_generator(seed=hp.seed + i_pass)
        silh_gen = data.silh_view_generator(seed=hp.seed + 1000 + i_pass)
        rvpi = max(1, hp.ray_views_per_iter)
        # The pass's views, drawn before it; 8 silhouette views per step
        # (optim.py:72).
        ray_idx = [[next(ray_gen) for _ in range(rvpi)]
                   for _ in range(hp.iters)]
        silh_idx = [[next(silh_gen) for _ in range(8)]
                    for _ in range(hp.iters)]
        graph = None
        if device.type == "cuda":
            graph = GraphedTrainStep(
                step, state, lr, mesh, data.views,
                torch.tensor(ray_idx, dtype=torch.int64, device=device),
                torch.tensor(silh_idx, dtype=torch.int64, device=device))

        loss = aux = None
        for it in range(hp.iters):
            if graph is not None:
                loss, aux = graph()
            else:
                state, loss, aux = step(state, lr, mesh, data.views,
                                        ray_idx[it], silh_idx[it])
            if it % log_every == 0:
                log_fn(f"  iter {it}: loss={float(loss):g} "
                       f"ray={float(aux['ray']):g} vh={float(aux['vh']):g} "
                       f"sm={float(aux['sm']):g} "
                       f"maxgrad={float(aux['max_grad']):g}")
                if metrics is not None:
                    metrics.log({"pass": i_pass, "iter": it,
                                 "loss": loss, **aux})

        # Silhouette budget guard: if ANY iteration's views had more
        # silhouette edges than the static budget, samples were truncated;
        # warn loudly and grow the budget for subsequent passes (next power
        # of two). The running max lives in the step state, so every
        # iteration is observed; this is the pass's one host read, which
        # on the card also takes the scatters' out-of-range word.
        del loss, aux                    # on the card, in the graph's pool
        if graph is not None:
            state = graph.close()
            silh_seen, bad = torch.stack(
                [state["silh_max"],
                 graph.bounds_word[0].to(torch.int64)]).tolist()
            raise_if_out_of_bounds(bad)
        else:
            silh_seen = int(state["silh_max"])
        if silh_seen > budget:
            grown = budget
            while grown < silh_seen:
                grown *= 2
            budget_floor = grown
            log_fn(f"  WARNING: silhouette edges ({silh_seen}) exceeded the "
                   f"sampling budget ({budget}); truncated this pass: "
                   f"budget grows to {grown} next pass")

        mesh = mesh.with_vertices(final_vertices(state, mesh).detach())
        run_info["passes"].append({
            "pass": i_pass, "faces": mesh.num_faces, "budget": budget,
            "remesh_s": t_remeshed - t_pass,
            "steps_s": time.time() - t_remeshed,
            **({"graph": graph.setup} if graph is not None else {})})

        if checkpoint_dir and hp.checkpoint_every_pass:
            os.makedirs(checkpoint_dir, exist_ok=True)
            v_out, f_out = mesh.host_arrays()
            save_ply(os.path.join(checkpoint_dir,
                                  f"{hp.name}_pass{i_pass:02d}.ply"),
                     v_out, f_out)

    log_fn(f"optimize time: {time.time() - t_start:.1f}s")
    return mesh

"""The three reconstruction losses and their weighted sum (port of
drt_tpu/optimize/losses.py; reference optim.py:59-130).

- ray_loss: squared difference between rendered exit directions and the
  environment-matting target directions, one view per step;
- silhouette (vh) loss: |soft mask - 0.5| at silhouette-edge samples;
- smoothness (sm) loss: sum of -log(1 + cos dihedral) over edges;
- total: ray_w*217.5/resy^2 * ray + vh_w*217.5/resy * vh
  + sm_w*mean_len/10 * sm (optim.py:127-129).

Ray batches above a full 1920x1080 view run in chunks with
rematerialization (render/chunked.py); `ray_chunk` sets the chunk size.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from drt_tpu_torch import spans
from drt_tpu_torch.geometry.metrics import dihedral_cos
from drt_tpu_torch.geometry.scatter import scatter_rows
from drt_tpu_torch.geometry.vec import clip
from drt_tpu_torch.render.bounce import ray_tail
from drt_tpu_torch.render.chunked import auto_ray_chunk, chunked_sum
from drt_tpu_torch.render.silhouette_kernels import (silhouette_view_loss,
                                                    tuple_camera,
                                                    view_camera)
from drt_tpu_torch.render.trace import trace_exit


class LossWeights(NamedTuple):
    ray_w: float
    vh_w: float
    sm_w: float
    ior: float
    ext_ior: float = 1.00029
    bilinear_mask: bool = False   # see silhouette_loss
    huber: float = 0.0            # see ray_loss; 0 = reference-parity L2
    compat: bool = False          # reference-exact refraction chain (f64)


def ray_loss(mesh, view, intersect_fn: Callable, ior: float,
             ext_ior: float, collect_evidence: bool = False,
             huber: float = 0.0, ray_chunk: int = -1, compat: bool = False):
    """One-view refraction loss (reference optim.py:91-108). Returns
    (loss, stats). collect_evidence adds stats["vertex_evidence"], the
    per-vertex count of contributing rays; huber > 0 caps each ray's
    influence above `huber` (0 = the reference's plain L2).

    ray_chunk: process the ray batch in sequential chunks of this size with
    rematerialization (render/chunked.py), so per-ray intermediates never
    exist for more than one chunk. -1 = auto policy (chunk only batches
    larger than a full 1920x1080 view), 0 = never chunk."""
    screen_pixel, valid, _mask, origin, ray_dir, _cam = view
    if ray_chunk < 0:
        ray_chunk = auto_ray_chunk(origin.shape[0])

    def body(screen_pixel, valid, origin, ray_dir):
        # lane_mask=valid: matting-invalid pixels (and the chunked path's
        # padding lanes, padded valid=False) start inactive.
        o, d, active, exit_hit, stats, tris = trace_exit(
            origin, ray_dir, mesh, intersect_fn, ior, ext_ior,
            lane_mask=valid, compat=compat)
        if collect_evidence:
            # both bounces' rows in one scatter, in the order JAX adds them
            w = valid & active & torch.logical_not(exit_hit)
            wf = w.float()[:, None].expand(-1, 3).reshape(-1, 1)
            idx = torch.cat([mesh.faces[tri].reshape(-1) for tri in tris])
            stats["vertex_evidence"] = scatter_rows(
                wf.repeat(len(tris), 1), idx, mesh.vertices.shape[0])[:, 0]
        # the tail (render/bounce.py, one kernel each way on the card): the
        # target from the (detached) exit origin to the matted screen point,
        # the squared difference of the exit direction, the Huber branch,
        # the sum over the lanes that count
        return ray_tail(o, d, screen_pixel, valid, active, exit_hit,
                        huber), stats

    return chunked_sum(body, (screen_pixel, valid, origin, ray_dir),
                       ray_chunk, pad_values=(0.0, False, 0.0, 1.0))


def silhouette_loss(mesh, view, intersect_fn: Callable, budget: int,
                    resy: int, resx: int, bilinear_mask: bool = False):
    """One-view silhouette loss (reference optim.py:67-80): the soft mask
    sampled at each boundary-crossing silhouette edge against the 0.5 level.
    Returns (loss, true silhouette-edge count).

    bilinear_mask=False reproduces the reference's integer truncation of the
    sample point (DiffRender.py:245); True samples the soft mask bilinearly,
    removing the +-half-pixel bias (helpful at low capture resolutions).
    The residual's sign is detached, so its subgradient is 0 at an exactly
    zero residual: samples on the mask's 0.5 transition band contribute no
    gradient.

    The chain is render/silhouette_kernels.py: three CUDA kernels around
    the oracle query on the card (csrc/silhouette.cu), their plain
    versions on the CPU; `primary_visibility` states the samples in torch
    operations."""
    return silhouette_view_loss(mesh, tuple_camera(view), intersect_fn,
                                budget, resy, resx, bilinear_mask)


def smooth_loss(mesh):
    """Dihedral smoothness (reference optim.py:82-89), log argument floored
    so a folded edge gives a huge-but-finite penalty."""
    cosd = dihedral_cos(mesh.vertices, mesh.faces, mesh.edge_faces)
    term = -torch.log(clip(1.0 + cosd, 1e-12))
    return torch.where(mesh.edge_valid, term, torch.zeros_like(term)).sum()


def _view_indices(idx):
    """View indices as a list: ints, or one-element device tensors (views,
    no host read) of an index tensor."""
    if isinstance(idx, torch.Tensor):
        return list(idx.reshape(-1, 1).unbind())
    if isinstance(idx, int):
        return [idx]
    return [int(i) for i in idx]


def total_loss(mesh, views, ray_view_idx, silh_view_idx: Sequence[int],
               intersect_fn, weights: LossWeights, resy: int, resx: int,
               silhouette_budget: int, collect_evidence: bool = False,
               ray_chunk: int = -1):
    """Weighted sum (reference all_loss, optim.py:110-130). ray_view_idx is
    an int (reference parity: one view per step) or a sequence of ints,
    averaged; silh_view_idx a sequence of ints (the reference uses 8).
    Either may be an int64 tensor of indices on the views' device instead,
    read on the device (`ViewBatch.take`), as a CUDA graph of the step
    selects its views. Returns (total, aux).

    Each term is a chain of the step's spans (drt_tpu_torch/spans.py),
    forward and backward; each reads the vertices through a view of its
    own (`MeshState.chain`)."""
    zero = mesh.vertices.new_zeros(())
    at = mesh.vertices
    if weights.ray_w:
        with spans.span("ray", at):
            chain = mesh.chain("ray")
            rls, trace_stats = [], {}
            for i in _view_indices(ray_view_idx):
                rl_i, st = ray_loss(chain, views.take(i), intersect_fn,
                                    weights.ior, weights.ext_ior,
                                    collect_evidence=collect_evidence,
                                    huber=weights.huber,
                                    ray_chunk=ray_chunk,
                                    compat=weights.compat)
                rls.append(rl_i)
                for k, v in st.items():
                    trace_stats[k] = v if k not in trace_stats \
                        else trace_stats[k] + v
            rl = spans.chain_output("ray", torch.stack(rls).mean())
    else:
        rl, trace_stats = zero, {}

    if weights.vh_w:
        with spans.span("silhouette", at):
            chain = mesh.chain("silhouette")
            # each view's camera and mask read in place, at its index
            vhs, counts = zip(*(silhouette_view_loss(
                chain, view_camera(views, i), intersect_fn,
                silhouette_budget, resy, resx,
                bilinear_mask=weights.bilinear_mask)
                for i in _view_indices(silh_view_idx)))
            vh = spans.chain_output("silhouette", torch.stack(vhs).sum())
            silh_edge_max = torch.stack(counts).max()
    else:
        vh, silh_edge_max = zero, torch.zeros((), dtype=torch.int64,
                                              device=zero.device)

    if weights.sm_w:
        with spans.span("smooth", at):
            sm = spans.chain_output("smooth",
                                    smooth_loss(mesh.chain("smooth")))
    else:
        sm = zero

    total = (weights.ray_w * 217.5 / resy / resy * rl
             + weights.vh_w * 217.5 / resy * vh
             + weights.sm_w * mesh.mean_len / 10.0 * sm)
    aux = {"ray": rl, "vh": vh, "sm": sm, "silh_edge_max": silh_edge_max,
           **trace_stats}
    return total, aux

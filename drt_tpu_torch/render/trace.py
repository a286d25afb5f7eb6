"""The 2-bounce differentiable refraction trace (port of
drt_tpu/render/trace.py; reference DiffRender.py:420-432, 503-546).

Static lanes with an `active` mask instead of ray compaction: every lane
keeps its pixel by position, dead lanes are parked outside the mesh so later
oracle queries spend no work on them, and all math stays finite on masked
lanes so the backward pass never sees NaN.

A bounce is its oracle query, the gather of each lane's triangle
(`_gather_tri9`) and the chain after it, which XLA fuses in the JAX package
and which here is one kernel forward and one backward
(render/bounce.py `bounce_chain`, csrc/bounce.cu; its plain version on CPU
tensors). `refract_ray` stays for its other callers and the debug checks.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import torch

from drt_tpu_torch.geometry.mt import moller_trumbore_verts
from drt_tpu_torch.geometry.scatter import scatter_rows
from drt_tpu_torch.geometry.vec import (clip, const_like, dot3,
                                       fresnel_dielectric, refract)
from drt_tpu_torch.render.bounce import bounce_chain


def debug_enabled() -> bool:
    """Debug mode (the reference's `debug` flag, DiffRender.py:15):
    DRT_TPU_DEBUG=1 turns on the TIR cross-check of FrDielectric against
    Refract (DiffRender.py:524-525) and the finite-ray check after each
    bounce. Each check reads a count back to the host, so with the variable
    unset neither runs."""
    return os.environ.get("DRT_TPU_DEBUG", "0") not in ("", "0")


def _debug_check(pred: torch.Tensor, msg: str) -> None:
    """Print the number of lanes where `pred` is False, if there are any."""
    bad = int(torch.logical_not(pred).sum())
    if bad:
        print(f"DRT_TPU_DEBUG VIOLATION [{msg}]: {bad} lanes", flush=True)


class TraceResult(NamedTuple):
    origin: torch.Tensor     # [N,3] exit-ray origin (zeros where invalid)
    direction: torch.Tensor  # [N,3] exit-ray direction (zeros where invalid)
    valid: torch.Tensor      # [N] bool — refracted twice AND escaped
    stats: dict              # diagnostic counters (see trace2)
    tris: tuple = ()         # (tri_b1, tri_b2) hit face ids (0 on dead lanes)


def refract_ray(origin, direction, t, n, int_ior, ext_ior,
                offset_eps: float = 1e-5, offset_rel: float = 1e-4,
                compat: bool = False):
    """One refraction event (reference refract_ray, DiffRender.py:503-535):
    entering/exiting etas by the sign of cos(theta_i), normal flipped for
    exiting rays, Snell bend, origin advanced by t and nudged along the new
    direction by max(offset_eps, offset_rel * t) — the reference's absolute
    1e-5 alone is below float32 resolution at ~100-unit coordinates.
    compat=True: the reference chain exactly (cosThetaT from sin²θI and the
    absolute nudge only); use with float64.
    Returns (refracted [N] bool — False on TIR, new_origin, new_dir)."""
    wo = -direction
    cos_i = clip(dot3(wo, n), -1.0, 1.0)
    entering = cos_i > 0
    ext = const_like(cos_i, ext_ior)
    inn = const_like(cos_i, int_ior)
    eta_i = torch.where(entering, ext, inn)
    eta_t = torch.where(entering, inn, ext)
    n_f = torch.where(entering[..., None], n, -n)
    # The reference also evaluates the Fresnel reflectance here and keeps
    # only the refracted branch (DiffRender.py:520-530); nothing reads R,
    # so only the debug check computes it.
    tir, wt = refract(wo, n_f, eta_i / eta_t,
                      compat_cos_from_incident=compat)
    if debug_enabled():
        tir_fr, _R = fresnel_dielectric(torch.abs(cos_i), eta_i, eta_t)
        _debug_check(tir_fr == tir, "TIR FrDielectric/Refract mismatch")
    if compat:
        offset = offset_eps
    else:
        offset = clip(offset_rel * torch.abs(t), offset_eps).detach()[..., None]
    new_origin = origin + t[..., None] * direction + offset * wt
    return torch.logical_not(tir), new_origin, wt


# Backward-scatter route threshold of the JAX package
# (drt_tpu/render/trace.py:149-155): at or below it the [N,9] cotangent is
# summed into [F,9] per face first, then [3F,3] into [V,3]; above it one
# direct [3N,3] -> [V,3] scatter. It fixes which sums are taken, so it is
# kept for parity in the order of the sums.
_SOUP_BWD_MAX_FACES = 2 ** 16


class _GatherTri9(torch.autograd.Function):
    """[N,9] per-ray triangle rows (the 9 coordinates of each ray's matched
    triangle), with the JAX package's `_gather_tri9` routes. Forward: the
    [F,9] triangle soup, then its rows, when N >= F; the [3N,3] vertex rows
    otherwise (the same bits either way; the soup is the faster on the card
    at N >= F, `scripts/tune_torch_oracle.py --what scatter`). Backward:
    `scatter_rows` of the [N,9] cotangent into [F,9] by safe_id, then
    [3F,3] into [V,3] by faces, at or below _SOUP_BWD_MAX_FACES faces; the
    direct [3N,3] -> [V,3] above."""

    @staticmethod
    def forward(ctx, vertices, faces, safe_id):
        ctx.save_for_backward(faces, safe_id)
        ctx.num_vertices = vertices.shape[0]
        if safe_id.shape[0] >= faces.shape[0]:
            tri9 = vertices[faces.reshape(-1)].reshape(-1, 9)
            return tri9[safe_id]
        return vertices[faces[safe_id].reshape(-1)].reshape(-1, 9)

    @staticmethod
    def backward(ctx, g9):
        faces, safe_id = ctx.saved_tensors
        V = ctx.num_vertices
        if faces.shape[0] <= _SOUP_BWD_MAX_FACES:
            df9 = scatter_rows(g9, safe_id, faces.shape[0])
            dv = scatter_rows(df9.reshape(-1, 3), faces.reshape(-1), V)
        else:
            dv = scatter_rows(g9.reshape(-1, 3), faces[safe_id].reshape(-1),
                              V)
        return dv, None, None


def _gather_tri9(vertices, faces, safe_id):
    return _GatherTri9.apply(vertices, faces, safe_id)


def _park_rays(mesh, dtype):
    """The origin [3] of the ray every dead lane is parked on, outside the
    mesh AABB; its direction, -0.57735027 in each component
    (render/bounce.py PARK_DIRECTION), points away from the box. Later
    queries give a parked lane zero candidate/MT work. The box is over the
    whole padded vertex array, as in the JAX package."""
    vmin, vmax = torch.aminmax(mesh.vertices.detach(), dim=0)
    return (vmin - (vmax - vmin) - 1.0).to(dtype)


def _debug_bounce(origin, direction, g9, hit, int_ior, ext_ior, offset_eps,
                  compat, o_out, d_out, active):
    """DRT_TPU_DEBUG's two checks beside the kernel: the TIR cross-check on
    a side recomputation of the chain that feeds nothing, and finite rays
    on what the chain returned."""
    with torch.no_grad():
        _u, _v, t, n = moller_trumbore_verts(
            origin, direction, g9[:, 0:3], g9[:, 3:6], g9[:, 6:9])
        t = torch.where(hit, t, torch.ones_like(t))
        refract_ray(origin, direction, t, n, int_ior, ext_ior, offset_eps,
                    compat=compat)          # checks FrDielectric/Refract
    # active lanes must carry finite rays into the next query
    fin = torch.isfinite(o_out).all(-1) & torch.isfinite(d_out).all(-1)
    _debug_check(torch.logical_not(active) | fin,
                 "non-finite ray after bounce")


def _bounce(origin, direction, active, mesh, intersect_fn, int_ior, ext_ior,
            offset_eps, compat=False, coherent=True):
    hits = intersect_fn(origin, direction, mesh.vertices, mesh.faces,
                        mesh.face_valid, coherent=coherent)
    hit = hits.hit
    safe_id = torch.where(hit, hits.tri_id, 0).long()
    g9 = _gather_tri9(mesh.vertices, mesh.faces, safe_id)
    o_out, d_out, active, tri = bounce_chain(
        origin, direction, g9, hit, active, safe_id,
        _park_rays(mesh, origin.dtype), int_ior, ext_ior, offset_eps,
        compat=compat)
    if debug_enabled():
        _debug_bounce(origin, direction, g9, hit, int_ior, ext_ior,
                      offset_eps, compat, o_out, d_out, active)
    return o_out, d_out, active, tri


def trace2(origin, direction, mesh, intersect_fn: Callable,
           int_ior: float, ext_ior: float = 1.00029,
           offset_eps: float = 1e-5, compat: bool = False, lane_mask=None):
    """Exactly two refraction bounces (reference trace2,
    DiffRender.py:537-546). lane_mask [N] bool: lanes that start inactive
    (matting-invalid pixels); excluded from the stats counters.
    Returns (origin, direction, active, stats, tris)."""
    active = (torch.ones(origin.shape[:-1], dtype=torch.bool,
                         device=origin.device)
              if lane_mask is None else lane_mask)
    o, d = origin, direction
    stats = {}
    tris = []
    for b in range(2):
        prev = active.sum()
        # bounce 1 sees camera-pixel rays, bounce 2 refracted interior rays
        o, d, active, tri = _bounce(o, d, active, mesh, intersect_fn,
                                    int_ior, ext_ior, offset_eps,
                                    compat=compat, coherent=(b == 0))
        tris.append(tri)
        stats[f"active_after_bounce{b + 1}"] = active.sum()
        stats[f"dropped_bounce{b + 1}"] = prev - active.sum()
    return o, d, active, stats, tuple(tris)


def trace_exit(origin, direction, mesh, intersect_fn: Callable,
               int_ior: float, ext_ior: float = 1.00029,
               offset_eps: float = 1e-5, compat: bool = False,
               lane_mask=None):
    """Two bounces, then the exit query (the reference's third, occlusion
    query, DiffRender.py:420-432). Returns (origin, direction, active,
    exit_hit, stats, tris): a lane is valid where active and not exit_hit;
    its rays are not zeroed (render_transparent zeroes them, the ray loss's
    tail masks them)."""
    o, d, active, stats, tris = trace2(origin, direction, mesh, intersect_fn,
                                       int_ior, ext_ior, offset_eps,
                                       compat=compat, lane_mask=lane_mask)
    exit_hit = intersect_fn(o, d, mesh.vertices, mesh.faces,
                            mesh.face_valid, coherent=False).hit
    stats["occluded_exit"] = (active & exit_hit).sum()
    stats["valid_rays"] = (active & torch.logical_not(exit_hit)).sum()
    return o, d, active, exit_hit, stats, tris


def render_transparent(origin, direction, mesh, intersect_fn: Callable,
                       int_ior: float, ext_ior: float = 1.00029,
                       offset_eps: float = 1e-5, compat: bool = False,
                       lane_mask=None) -> TraceResult:
    """Two bounces, then the exit ray must escape the mesh (`trace_exit`).
    Invalid lanes are zeroed."""
    o, d, active, exit_hit, stats, tris = trace_exit(
        origin, direction, mesh, intersect_fn, int_ior, ext_ior, offset_eps,
        compat=compat, lane_mask=lane_mask)
    valid = active & torch.logical_not(exit_hit)
    m = valid[..., None]
    return TraceResult(torch.where(m, o, torch.zeros_like(o)),
                       torch.where(m, d, torch.zeros_like(d)), valid,
                       stats, tris)


def render_mask(origin, direction, mesh, intersect_fn: Callable):
    """Binary hit image [N] (reference render_mask, DiffRender.py:434-438)."""
    hits = intersect_fn(origin, direction, mesh.vertices, mesh.faces,
                        mesh.face_valid, coherent=True)
    return hits.hit.to(origin.dtype)

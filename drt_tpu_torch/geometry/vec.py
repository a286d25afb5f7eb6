"""Differentiable 3-vector optics (port of drt_tpu/geometry/vec.py).

Every sqrt/div input is clamped *before* use: `torch.where`, like
`jnp.where`, leaks NaN gradients from the untaken branch. Clamps are written
with `torch.maximum`/`torch.minimum` against tensors, whose backward splits
the gradient evenly at a tie exactly as JAX's `clip` does (`torch.clamp`
passes all of it), so degenerate inputs (cos_i = +-1) give the same
gradients as the JAX package.
"""

from __future__ import annotations

import torch


def _c(x: torch.Tensor, value) -> torch.Tensor:
    return torch.as_tensor(value, dtype=x.dtype, device=x.device)


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """`jnp.clip` with JAX's gradient convention at the bounds."""
    if lo is not None:
        x = torch.maximum(x, _c(x, lo))
    if hi is not None:
        x = torch.minimum(x, _c(x, hi))
    return x


def dot3(a: torch.Tensor, b: torch.Tensor, keepdims: bool = False):
    """Batched 3-vector dot product (reference DiffRender.py:24-29)."""
    out = torch.sum(a * b, dim=-1)
    return out[..., None] if keepdims else out


def safe_normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalize along the last axis; zero vectors map to zero, not NaN."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(clip(n2, eps))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def reflect(wo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of outgoing dir `wo` about normal `n`
    (reference DiffRender.py:31-33)."""
    return -wo + 2.0 * dot3(wo, n, keepdims=True) * n


def refract(wo: torch.Tensor, n: torch.Tensor, eta,
            compat_cos_from_incident: bool = False):
    """Snell refraction (reference `Refract`, DiffRender.py:35-49).

    wo: [...,3] unit vector toward the source; n: [...,3] unit normal on
    wo's side; eta: scalar or [...] etaI/etaT. Returns (tir [...] bool,
    wt [...,3]); TIR lanes carry a finite garbage direction.
    compat_cos_from_incident=True reproduces the reference's cosThetaT from
    sin²θI (DiffRender.py:42)."""
    eta = torch.as_tensor(eta, dtype=wo.dtype, device=wo.device)
    if eta.ndim:
        eta = eta[..., None]
    cos_i = dot3(n, wo, keepdims=True)
    sin2_i = clip(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta * eta * sin2_i
    tir = (sin2_t >= 1.0)[..., 0]
    # 1e-12 floor: sqrt(0) NaN-poisons the backward pass
    if compat_cos_from_incident:
        cos_t = torch.sqrt(clip(1.0 - sin2_i, 1e-12, 1.0))
    else:
        cos_t = torch.sqrt(clip(1.0 - sin2_t, 1e-12, 1.0))
    wt = eta * -wo + (eta * cos_i - cos_t) * n
    # explicit (non-detached) renormalization, as the reference does
    return tir, safe_normalize(wt)


def fresnel_dielectric(cos_i: torch.Tensor, eta_i, eta_t):
    """Fresnel reflectance (reference `FrDielectric`, DiffRender.py:51-61).
    cos_i >= 0. Returns (tir, R); R is meaningless (but finite) on TIR."""
    sin_i = torch.sqrt(clip(1.0 - cos_i * cos_i, 1e-12, 1.0))
    sin_t = sin_i * eta_i / eta_t
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(clip(1.0 - sin_t * sin_t, 1e-12))
    denom_parl = eta_t * cos_i + eta_i * cos_t
    denom_perp = eta_i * cos_i + eta_t * cos_t
    r_parl = (eta_t * cos_i - eta_i * cos_t) / clip(denom_parl, 1e-12)
    r_perp = (eta_i * cos_i - eta_t * cos_t) / clip(denom_perp, 1e-12)
    R = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return tir, R

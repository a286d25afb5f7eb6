"""Sobolev (Laplacian) gradient preconditioning for vertex optimization
(port of drt_tpu/optimize/precondition.py).

Per-vertex SGD fits high-frequency noise while barely moving low-frequency
shape modes. The remedy (Nicolet, Jacobson & Jakob, "Large Steps in Inverse
Rendering of Geometry", SIGGRAPH Asia 2021) reparameterizes the vertices as

    v = (I + lam * L)^{-1} u,

with L the combinatorial graph Laplacian (D - Adj) of the current mesh.
Optimizing u premultiplies the gradient by A^{-1} = (I + lam*L)^{-1} twice,
which amplifies smooth displacement modes over per-vertex noise.

The solve is a matrix-free conjugate gradient on the padded fixed-degree
neighbor table of MeshState; padded vertices have degree 0, so A = I on
those lanes. `cg` follows jax.scipy.sparse.linalg.cg step for step (from
x0, 0 by default; one inner product over the whole [Vp,C] array, stop once
r.r <= tol^2 b.b, at most `maxiter` trips), so both packages take the same
iterations. It runs the fixed number of trips with every update masked by a
device-side "done" flag: the early exit's result exactly, and no host
synchronisation per iteration. `sobolev_solve` differentiates as JAX's custom_linear_solve
does: A is symmetric, so the backward is the same CG solve of the cotangent
(from the same x0, which JAX also hands its transpose solve, and which takes
no gradient), not a backward through the iterations.
"""

from __future__ import annotations

import torch


def laplacian_matvec(x: torch.Tensor, neighbors: torch.Tensor,
                     neighbor_valid: torch.Tensor) -> torch.Tensor:
    """Combinatorial Laplacian L = D - Adj applied to x [Vp,C].

    neighbors: [Vp,D] int64 (invalid entries clamped to 0),
    neighbor_valid: [Vp,D] bool."""
    nx = x[neighbors]                                        # [Vp,D,C]
    nx = torch.where(neighbor_valid[..., None], nx, torch.zeros_like(nx))
    deg = neighbor_valid.sum(dim=1).to(x.dtype)
    return deg[:, None] * x - nx.sum(dim=1)


def sobolev_matvec(x, neighbors, neighbor_valid, lam):
    """A x = (I + lam L) x."""
    return x + lam * laplacian_matvec(x, neighbors, neighbor_valid)


def sobolev_apply(v, neighbors, neighbor_valid, lam):
    """u = A v (the forward map; initializes u from mesh vertices)."""
    return sobolev_matvec(v, neighbors, neighbor_valid, lam)


@torch.no_grad()
def cg(matvec, b: torch.Tensor, tol: float = 1e-5, maxiter: int = 64,
       x0=None):
    """Solve A x = b for symmetric positive definite A from x0 (zeros if
    None; see the module docstring). Returns (x, trips): trips is a 0-d
    int64 tensor on b's device, the iterations an early exit would have
    taken. Fused multiply-adds and flat dot products keep a trip at a dozen
    launches."""
    def dot(u, v):
        return torch.dot(u.reshape(-1), v.reshape(-1))

    if x0 is None:
        x = torch.zeros_like(b)
        r = p = b                      # b - A x0 with x0 = 0
    else:
        x = x0.detach()
        r = p = b - matvec(x)
    gamma = dot(r, r)
    atol2 = (tol * tol) * dot(b, b)
    went = []
    for _ in range(maxiter):
        go = gamma > atol2             # false once, false ever after
        ap = matvec(p)
        alpha = gamma / dot(p, ap)
        x_new = torch.addcmul(x, alpha, p)
        r_new = torch.addcmul(r, alpha, ap, value=-1)
        gamma_new = dot(r_new, r_new)
        p_new = torch.addcmul(r_new, gamma_new / gamma, p)
        x = torch.where(go, x_new, x)
        r = torch.where(go, r_new, r)
        p = torch.where(go, p_new, p)
        gamma = torch.where(go, gamma_new, gamma)
        went.append(go)
    trips = (torch.stack(went).sum() if went
             else torch.zeros((), dtype=torch.int64, device=b.device))
    return x, trips


class _SobolevSolve(torch.autograd.Function):
    """v = A^{-1} u by CG; d/du is the same solve of the cotangent."""

    @staticmethod
    def forward(ctx, u, neighbors, neighbor_valid, lam, maxiter, tol, x0):
        ctx.save_for_backward(neighbors, neighbor_valid)
        ctx.args = (lam, maxiter, tol, x0)
        return _solve(u, neighbors, neighbor_valid, lam, maxiter, tol, x0)

    @staticmethod
    def backward(ctx, g):
        neighbors, neighbor_valid = ctx.saved_tensors
        return (_solve(g, neighbors, neighbor_valid, *ctx.args),
                None, None, None, None, None, None)


def _solve(u, neighbors, neighbor_valid, lam, maxiter, tol, x0=None):
    # `sobolev_matvec` with what does not change between trips hoisted
    u = u.detach()
    deg = neighbor_valid.sum(dim=1).to(u.dtype)[:, None]
    pad = torch.logical_not(neighbor_valid)[..., None]

    def matvec(x):
        lx = deg * x - x[neighbors].masked_fill(pad, 0.0).sum(dim=1)
        return x + lam * lx

    v, _ = cg(matvec, u, tol=tol, maxiter=maxiter, x0=x0)
    return v


def sobolev_solve(u, neighbors, neighbor_valid, lam, maxiter: int = 64,
                  tol: float = 1e-6, x0=None):
    """v = A^{-1} u by CG from x0 (a warm start; zeros if None).
    Differentiable in u."""
    return _SobolevSolve.apply(u, neighbors, neighbor_valid, lam, maxiter,
                               tol, x0)

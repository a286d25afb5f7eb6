"""The plain reference of the configuration dog-pointgray-largesteps: the
train step of Nicolet, Jacobson and Jakob, "Large Steps in Inverse
Rendering of Geometry" (ACM TOG 40(6), 2021, sections 4-5), in plain
PyTorch.

The optimizer's parameters are u = (I + lam L) v, L the combinatorial
graph Laplacian of the mesh's edges. A step recovers the vertices
v = (I + lam L)^-1 u, takes the loss and its gradient g_v at v, and, the
matrix being symmetric, the gradient in u as g_u = (I + lam L)^-1 g_v;
NaN entries become 0 and nothing is clamped; uniform Adam, whose second
moment is a running mean of each step's largest g^2, updates u. The
paper factorises the matrix once (sparse Cholesky); here, as in the
program, each solve is conjugate gradients from zero, stopped once
r.r <= tol^2 b.b (tol 1e-6) or after the configuration's `cg_iters`
trips: `step.sobolev_solve`, worked out on the reference's own edges.

The loss, the optimizer's rule, the precision and the read-back of the
gradient from the momentum are step.py's. Float32, TF32 off. It imports
nothing of the program.

`init_state` takes no configuration, so lam is this configuration's,
LAMBDA; `step` refuses a configuration that states another. Besides
step.py's faults ("half", "frozen") and its bfloat16 ray path, `step`
plants two of the mechanism's own: "adjoint" (the gradient in v taken as
the gradient in u: the adjoint solve left out) and "trips" (both solves
at half the configuration's trips).
"""

from __future__ import annotations

import torch

from port_bench.reference.step import (_laplacian, first_grad,  # noqa: F401
                                       grad_from_momentum, precision,
                                       sobolev_solve, total_loss, update)

LAMBDA = 29.0
TOL = 1e-6
OPTIMIZER, PRECOND = "uadam", "sobolev"
FAULTS = ("half", "frozen", "adjoint", "trips")


def init_state(mesh):
    """The pass's fresh state: u0 = (I + LAMBDA L) v0, the momentum and
    the second moment at nought."""
    v0 = mesh.vertices
    if v0.dtype != torch.float32:
        raise ValueError("the reference and its controls are written for "
                         f"float32, not {v0.dtype}")
    u0 = v0 + LAMBDA * _laplacian(v0, mesh.edges)
    return {"params": u0, "m": torch.zeros_like(v0), "v": 0.0, "count": 0}


def step(state, lr, mesh, views, ray_view, silh_views, cfg, fault=None,
         ray_dtype=None):
    """One train step: (new state, loss, parts). ray_view an int or a
    list of ints (`step.ray_views_loss`), silh_views a list of ints;
    `fault` one of FAULTS or None; `ray_dtype` runs the ray path in that
    type (a control)."""
    if cfg["precond_lambda"] != LAMBDA:
        raise ValueError(f"this reference solves with lambda {LAMBDA}, the "
                         f"configuration states {cfg['precond_lambda']}")
    if (cfg["optimizer"], cfg["precond"]) != (OPTIMIZER, PRECOND):
        raise ValueError(f"this reference runs {OPTIMIZER} + {PRECOND}, not "
                         f"{cfg['optimizer']} + {cfg['precond']}")
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    trips = cfg["cg_iters"] // 2 if fault == "trips" else cfg["cg_iters"]
    w = (cfg["ray_w"], cfg["vh_w"], cfg["sm_w"])
    v = sobolev_solve(state["params"], mesh, LAMBDA, TOL, trips)
    v = v.detach().requires_grad_(True)
    loss, parts, _ = total_loss(v, mesh, views, ray_view, silh_views, cfg, w,
                                fault == "half", False, ray_dtype)
    (g_v,) = torch.autograd.grad(loss, v)
    loss = loss.detach()
    g = g_v if fault == "adjoint" else sobolev_solve(g_v, mesh, LAMBDA, TOL,
                                                     trips)
    g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
    new = update(state, g, lr, cfg)
    if fault == "frozen":
        new["params"] = state["params"]
    return new, float(loss), {k: float(x) for k, x in parts.items()}

"""drt_tpu_torch.optimize.precondition and .schedules against drt_tpu, on
the CPU in float64: the schedules equal, the Laplacian and Sobolev matvecs
at rtol 1e-12, and `sobolev_solve` (the port's own CG, which must take JAX's
iterations) in value and input gradient at rtol 1e-9 (atol 1e-9 of the
largest entry) on the icosphere and the cube, with `maxiter` reached and not
reached."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
from drt_tpu.optimize import precondition as JP
from drt_tpu.optimize import schedules as JS
from drt_tpu_torch.mesh import build_mesh_state
from drt_tpu_torch.optimize import precondition as TP
from drt_tpu_torch.optimize import schedules as TS
from tests.meshes import make_cube, make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

MESHES = {"icosphere": lambda: make_icosphere(subdivisions=2, radius=10.0),
          "cube": lambda: make_cube(size=4.0)}


def _both(name):
    v, f = MESHES[name]()
    with jax.enable_x64(True):
        jms = JMESH.build_mesh_state(v, f, dtype=jnp.float64)
    tms = build_mesh_state(v, f, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(np.asarray(jms.neighbors),
                                  tms.neighbors.numpy())
    return jms, tms


def _close(t, j, rtol):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                               atol=rtol * np.abs(j).max())


def test_schedules_equal():
    for num in (1, 2, 5, 20):
        for it in range(num):
            for fn in ("interp_linear", "interp_reciprocal"):
                assert (getattr(TS, fn)(10.0, 1.0, it, num)
                        == getattr(JS, fn)(10.0, 1.0, it, num))
    with pytest.raises(ValueError):
        TS.interp_linear(10.0, 1.0, 5, 5)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_matvecs_match_jax(mesh):
    jms, tms = _both(mesh)
    x = np.random.default_rng(0).normal(size=tuple(tms.vertices.shape))
    with jax.enable_x64(True):
        jl = JP.laplacian_matvec(jnp.asarray(x), jms.neighbors,
                                 jms.neighbor_valid)
        ja = JP.sobolev_apply(jnp.asarray(x), jms.neighbors,
                              jms.neighbor_valid, 19.0)
    tx = torch.tensor(x)
    _close(TP.laplacian_matvec(tx, tms.neighbors, tms.neighbor_valid), jl,
           1e-12)
    _close(TP.sobolev_apply(tx, tms.neighbors, tms.neighbor_valid, 19.0),
           ja, 1e-12)
    ones = torch.ones_like(tx) * torch.tensor([1.0, -2.0, 3.0])
    lx = TP.laplacian_matvec(ones, tms.neighbors, tms.neighbor_valid)
    assert float(lx.abs().max()) < 1e-12          # constants are in L's kernel


# (maxiter, tol, reaches maxiter): 5 trips stop a 1e-10 solve short; 200
# let a 1e-6 solve converge first
CASES = [(5, 1e-10, True), (200, 1e-6, False)]


@pytest.mark.parametrize("maxiter,tol,cut", CASES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sobolev_solve_value_and_gradient_match_jax(mesh, maxiter, tol, cut):
    jms, tms = _both(mesh)
    rng = np.random.default_rng(1)
    u = rng.normal(size=tuple(tms.vertices.shape))
    w = rng.normal(size=tuple(tms.vertices.shape))
    lam = 29.0
    with jax.enable_x64(True):
        def jf(u_):
            v = JP.sobolev_solve(u_, jms.neighbors, jms.neighbor_valid, lam,
                                 maxiter=maxiter, tol=tol)
            return jnp.sum(v * jnp.asarray(w)), v
        (_, jv), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(u))
    tu = torch.tensor(u, requires_grad=True)
    tv = TP.sobolev_solve(tu, tms.neighbors, tms.neighbor_valid, lam,
                          maxiter=maxiter, tol=tol)
    (tg,) = torch.autograd.grad((tv * torch.tensor(w)).sum(), tu)
    _close(tv, jv, 1e-9)
    _close(tg, jg, 1e-9)
    # the masked fixed-trip loop reports the trips an early exit would take
    _, trips = TP.cg(lambda x: TP.sobolev_matvec(x, tms.neighbors,
                                                 tms.neighbor_valid, lam),
                     torch.tensor(u), tol=tol, maxiter=maxiter)
    assert (int(trips) == maxiter) == cut
    if not cut:
        back = TP.sobolev_apply(tv.detach(), tms.neighbors,
                                tms.neighbor_valid, lam)
        assert float((back - tu.detach()).norm()) <= 2 * tol * float(
            tu.detach().norm())


def test_solve_backward_is_the_solve_of_the_cotangent():
    """A symmetric: d/du <A^-1 u, w> = A^-1 w, by the same CG, not by a
    backward through the iterations."""
    _, tms = _both("icosphere")
    rng = np.random.default_rng(2)
    u = torch.tensor(rng.normal(size=tuple(tms.vertices.shape)),
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=tuple(tms.vertices.shape)))
    v = TP.sobolev_solve(u, tms.neighbors, tms.neighbor_valid, 9.0,
                         maxiter=7, tol=1e-12)
    (g,) = torch.autograd.grad((v * w).sum(), u)
    expect = TP.sobolev_solve(w, tms.neighbors, tms.neighbor_valid, 9.0,
                              maxiter=7, tol=1e-12)
    assert torch.equal(g, expect)

"""drt_tpu_torch.geometry against drt_tpu.geometry: values and input
gradients on the same numpy inputs, in float32 and float64, on random and
degenerate inputs (det = 0, cos_i = +-1, total internal reflection).

Tolerances: float64 rtol 1e-10 / atol 1e-12 (the two packages evaluate the
same formulas; only the order of a few sums differs); float32 rtol 2e-5 /
atol 2e-6 (a few ulps, amplified by the normalizations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.geometry.metrics as JM
import drt_tpu.geometry.mt as JT
import drt_tpu.geometry.normals as JN
import drt_tpu.geometry.vec as JV
import drt_tpu_torch.geometry.metrics as TM
import drt_tpu_torch.geometry.mt as TT
import drt_tpu_torch.geometry.normals as TN
import drt_tpu_torch.geometry.vec as TV
from drt_tpu.mesh import build_mesh_state
from tests.meshes import make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

TOL = {np.float32: dict(rtol=2e-5, atol=2e-6),
       np.float64: dict(rtol=1e-10, atol=1e-12)}


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def compare(jfn, tfn, args, dtype, n_diff=None, seed=0, tol=None, jit=True):
    """Run jfn (JAX) and tfn (torch) on the same numpy args; compare every
    floating output and the gradients of a random weighted sum of them
    w.r.t. the first n_diff args. jit=False runs JAX op by op, unfused, as
    torch does: for inputs whose result depends on the last bit."""
    wrap = jax.jit if jit else (lambda f: f)
    args = [np.asarray(a, dtype) if np.asarray(a).dtype.kind == "f"
            else np.asarray(a) for a in args]
    n_diff = len(args) if n_diff is None else n_diff
    with jax.enable_x64(dtype == np.float64):
        jout = wrap(jfn)(*[jnp.asarray(a) for a in args])
        jout = jout if isinstance(jout, tuple) else (jout,)
        rng = np.random.default_rng(seed)
        ws = [rng.normal(size=np.shape(o)).astype(dtype)
              if jnp.issubdtype(o.dtype, jnp.floating) else None
              for o in jout]

        def jscalar(*diff):
            outs = jfn(*diff, *[jnp.asarray(a) for a in args[n_diff:]])
            outs = outs if isinstance(outs, tuple) else (outs,)
            return sum(jnp.sum(o * w) for o, w in zip(outs, ws)
                       if w is not None)

        jgrads = wrap(jax.grad(jscalar, argnums=tuple(range(n_diff))))(
            *[jnp.asarray(a) for a in args[:n_diff]])

    targs = [torch.tensor(a, requires_grad=i < n_diff and a.dtype.kind == "f")
             for i, a in enumerate(args)]
    tout = tfn(*targs)
    tout = tout if isinstance(tout, tuple) else (tout,)
    tol = tol or TOL[dtype]
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)
    total = sum((o * torch.tensor(w)).sum() for o, w in zip(tout, ws)
                if w is not None)
    tgrads = torch.autograd.grad(total, targs[:n_diff], allow_unused=True)
    for jg, tg in zip(jgrads, tgrads):
        tg = np.zeros_like(np.asarray(jg)) if tg is None else tg.numpy()
        assert np.isfinite(tg).all()
        np.testing.assert_allclose(tg, np.asarray(jg), **tol)


DTYPES = [np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES)
def test_dot3_and_safe_normalize(dtype):
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 16, 3))
    a[3] = 0.0                                    # zero vector -> zero
    compare(JV.dot3, TV.dot3, [a, b], dtype)
    compare(JV.safe_normalize, TV.safe_normalize, [a], dtype)


def _refract_inputs(rng):
    n = _unit(rng.normal(size=(24, 3)))
    wo = _unit(rng.normal(size=(24, 3)))
    wo *= np.sign(np.sum(wo * n, axis=1, keepdims=True))   # same side as n
    wo[0] = n[0]                                  # cos_i = 1 (normal)
    wo[1] = _unit(np.cross(n[1], [0.3, 0.2, 0.9]))  # grazing: cos_i = 0
    return wo, n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("eta", [1.0 / 1.4723, 1.4723])   # 1.47: TIR lanes
def test_refract(dtype, compat, eta):
    wo, n = _refract_inputs(np.random.default_rng(2))

    def jf(wo, n):
        return JV.refract(wo, n, eta, compat_cos_from_incident=compat)

    def tf(wo, n):
        return TV.refract(wo, n, eta, compat_cos_from_incident=compat)

    with jax.enable_x64(dtype == np.float64):
        tir = np.asarray(jf(jnp.asarray(wo, dtype), jnp.asarray(n, dtype))[0])
    if eta > 1:
        assert tir.any() and not tir.all()
    compare(jf, tf, [wo, n], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fresnel_dielectric(dtype):
    cos_i = np.concatenate([[1.0, 0.0, 1e-7],
                            np.random.default_rng(3).uniform(0, 1, 20)])
    for eta_i, eta_t in ((1.00029, 1.4723), (1.4723, 1.00029)):
        compare(lambda c: JV.fresnel_dielectric(c, eta_i, eta_t),
                lambda c: TV.fresnel_dielectric(c, eta_i, eta_t),
                [cos_i], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moller_trumbore_verts(dtype):
    rng = np.random.default_rng(4)
    v0, v1, v2 = rng.normal(size=(3, 32, 3)) * 10
    o = rng.normal(size=(32, 3)) * 30
    d = _unit((v0 + v1 + v2) / 3 - o + rng.normal(size=(32, 3)))
    d[0] = _unit(v1[0] - v0[0])                   # parallel: det = 0
    v2[1] = v0[1] + 2 * (v1[1] - v0[1])           # degenerate triangle
    # float32: 1/det amplifies the last-ulp differences of the cross
    # products on the near-parallel random rays, so rtol 1e-4 there. The
    # det = 0 lane depends on the last bit: unfused JAX (a fused
    # multiply-add leaves det ~1e-9 instead of 0).
    tol = dict(rtol=1e-4, atol=2e-6) if dtype == np.float32 else None
    compare(JT.moller_trumbore_verts, TT.moller_trumbore_verts,
            [o, d, v0, v1, v2], dtype, tol=tol, jit=False)


@pytest.fixture(scope="module")
def sphere():
    v, f = make_icosphere(subdivisions=2, radius=50.0)
    ms = build_mesh_state(v, f)
    rng = np.random.default_rng(5)
    verts = np.asarray(ms.vertices, np.float64)
    verts[: ms.num_vertices] += rng.normal(scale=2.0,
                                           size=(ms.num_vertices, 3))
    return (verts, np.asarray(ms.faces), np.asarray(ms.face_valid),
            np.asarray(ms.edge_faces))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mesh_metrics(dtype, sphere):
    verts, faces, fv, ef = sphere
    compare(JM.edge_face_normals, TM.edge_face_normals,
            [verts, faces, ef], dtype, n_diff=1)
    compare(JM.dihedral_cos, TM.dihedral_cos, [verts, faces, ef], dtype,
            n_diff=1)
    tri = verts[faces]
    compare(JM.corner_angles_and_normals, TM.corner_angles_and_normals,
            [tri, fv], dtype, n_diff=1)
    compare(JN.vertex_normals, TN.vertex_normals, [verts, faces, fv], dtype,
            n_diff=1)

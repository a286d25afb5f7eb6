"""The last public functions of drt_tpu that the port lacked, against the
JAX package on the inputs of its own contract tests (tests/test_geometry.py,
tests/test_compat.py, tests/test_views.py, tests/test_camera.py and
tests/test_trace.py): values and the gradients of a seeded random
projection of every output, in float32 (rtol 1e-5) and float64 (rtol 1e-12),
with the contract tests' own checks on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.geometry as JG
import drt_tpu.geometry.laplacian as JL
import drt_tpu.geometry.mt as JMT
import drt_tpu.mesh as JMESH
import drt_tpu_torch.geometry as TG
import drt_tpu_torch.geometry.laplacian as TL
import drt_tpu_torch.geometry.mt as TMT
import drt_tpu_torch.render.trace as TT
from drt_tpu.data import synthesize_capture as j_synth
from drt_tpu.data.synthetic import intrinsics, look_at_extrinsic
from drt_tpu.data.views import ViewBatch as JViews
from drt_tpu.data.views import downsample_capture as j_downsample
from drt_tpu.render.camera import CameraM as JCam
from drt_tpu.render.camera import generate_rays as j_generate_rays
from drt_tpu_torch.convert import mesh_state_from_arrays, view_batch_from_arrays
from drt_tpu_torch.data.views import CaptureData
from drt_tpu_torch.data.views import downsample_capture as t_downsample
from drt_tpu_torch.intersect import get_intersect_fn as t_get_fn
from drt_tpu_torch.mesh import build_mesh_state
from drt_tpu_torch.render.camera import CameraM as TCam
from drt_tpu_torch.render.camera import generate_rays as t_generate_rays
from drt_tpu_torch.render.camera import project_vertices
from drt_tpu_torch.geometry.vec import safe_normalize
from tests.meshes import make_cube, make_icosphere

torch.set_num_threads(min(2, torch.get_num_threads()))

DTYPES = pytest.mark.parametrize("dt,rtol", [(np.float32, 1e-5),
                                             (np.float64, 1e-12)])
MESH_FIELDS = ("vertices", "faces", "face_valid", "vert_valid", "edges",
               "edge_valid", "edge_faces", "neighbors", "neighbor_valid",
               "normals", "mean_len")


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for item in x for y in _flat(item)]
    return [x]


def check(j_fn, t_fn, args, diff, dt, rtol):
    """j_fn and t_fn on the same numpy `args` (floating ones cast to dt):
    every floating output allclose, and the gradients of
    sum_k <out_k, w_k> (w_k seeded random) in the args at positions `diff`.
    Returns the port's outputs."""
    args = [a.astype(dt) if a.dtype.kind == "f" else a for a in args]
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a) for a in args]
        outs = [np.asarray(o) for o in _flat(j_fn(*jargs))]
        keep = [o.dtype.kind == "f" for o in outs]
        rng = np.random.default_rng(11)
        ws = [rng.standard_normal(o.shape).astype(o.dtype) if k else None
              for o, k in zip(outs, keep)]

        def j_obj(*d):
            full = list(jargs)
            for i, x in zip(diff, d):
                full[i] = x
            return sum(jnp.sum(o * w) for o, w, k in
                       zip(_flat(j_fn(*full)), ws, keep) if k)

        jgrads = jax.grad(j_obj, argnums=tuple(range(len(diff))))(
            *[jargs[i] for i in diff])
    targs = [torch.tensor(a) for a in args]
    for i in diff:
        targs[i].requires_grad_(True)
    touts = _flat(t_fn(*targs))
    assert len(touts) == len(outs)
    for i, (t, j, k) in enumerate(zip(touts, outs, keep)):
        t = t.detach().numpy()
        if not k:
            np.testing.assert_array_equal(t, j, err_msg=f"output {i}")
            continue
        assert t.dtype == j.dtype, (i, t.dtype, j.dtype)
        np.testing.assert_allclose(t, j, rtol=rtol,
                                   atol=rtol * max(np.abs(j).max(), 1e-30),
                                   err_msg=f"output {i}")
    obj = sum((t * torch.from_numpy(w)).sum()
              for t, w, k in zip(touts, ws, keep) if k)
    tgrads = torch.autograd.grad(obj, [targs[i] for i in diff])
    for i, t, j in zip(diff, tgrads, jgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                                   atol=rtol * max(np.abs(j).max(), 1e-30),
                                   err_msg=f"gradient in argument {i}")
    return touts


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


@DTYPES
def test_reflect(dt, rtol):
    rng = np.random.default_rng(0)
    wo = _unit(np.concatenate([[[1.0, 1.0, 0.0]],
                               rng.standard_normal((9, 3))]))
    n = _unit(np.concatenate([[[0.0, 1.0, 0.0]],
                              rng.standard_normal((9, 3))]))
    r = check(JG.reflect, TG.reflect, [wo, n], [0, 1], dt, rtol)[0]
    np.testing.assert_allclose(r[0].detach().numpy(),
                               _unit(np.array([-1.0, 1.0, 0.0])), atol=1e-7)


def _rays_and_triangles(n=32, seed=1):
    rng = np.random.default_rng(seed)
    tri = rng.standard_normal((n, 3, 3)) + np.array([0.0, 0.0, 3.0])
    o = rng.standard_normal((n, 3)) * 0.2
    d = _unit(tri.mean(axis=1) - o + 0.3 * rng.standard_normal((n, 3)))
    return o, d, tri


@DTYPES
def test_moller_trumbore(dt, rtol):
    o, d, tri = _rays_and_triangles()
    check(JG.moller_trumbore, TG.moller_trumbore, [o, d, tri], [0, 1, 2],
          dt, rtol)
    # the contract test's closed-form hit on the unit triangle at z=2
    u, v, t, n = TG.moller_trumbore(
        torch.tensor([[0.2, 0.3, 0.0]]), torch.tensor([[0.0, 0.0, 1.0]]),
        torch.tensor([[[0.0, 0.0, 2.0], [1.0, 0.0, 2.0], [0.0, 1.0, 2.0]]]))
    np.testing.assert_allclose([float(t), float(u), float(v)],
                               [2.0, 0.2, 0.3], rtol=1e-5)
    np.testing.assert_allclose(n[0].numpy(), [0, 0, 1], atol=1e-6)
    # dt/dz of a translating triangle is 1
    z = torch.tensor(2.0, requires_grad=True)
    base = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                          [0.0, 1.0, 0.0]]])
    t = TG.moller_trumbore(torch.tensor([[0.2, 0.3, 0.0]]),
                           torch.tensor([[0.0, 0.0, 1.0]]),
                           base + torch.tensor([0.0, 0.0, 1.0]) * z)[2][0]
    (g,) = torch.autograd.grad(t, z)
    np.testing.assert_allclose(float(g), 1.0, rtol=1e-6)
    # degenerate triangles stay finite
    out = TG.moller_trumbore(torch.tensor([[0.0, 0.0, -1.0]]),
                             torch.tensor([[0.0, 0.0, 1.0]]),
                             torch.zeros((1, 3, 3)))
    assert all(bool(torch.isfinite(x).all()) for x in out)


def _soa(mod):
    """moller_trumbore_soa of `mod` on [N,3] / [N,3,3] arrays, with n
    stacked back to [N,3]."""
    def fn(o, d, tri):
        split = lambda a: tuple(a[..., k] for k in range(3))  # noqa: E731
        u, v, t, n = mod.moller_trumbore_soa(
            split(o), split(d), split(tri[:, 0]), split(tri[:, 1]),
            split(tri[:, 2]))
        return u, v, t, n
    return fn


@DTYPES
def test_moller_trumbore_soa(dt, rtol):
    o, d, tri = _rays_and_triangles(seed=2)
    tri[0] = 0.0                                   # a degenerate lane
    out = check(_soa(JMT), _soa(TMT), [o, d, tri], [0, 1, 2], dt, rtol)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    # the same numbers as the [...,3,3] form
    aos = TG.moller_trumbore(*(torch.tensor(a.astype(dt))
                               for a in (o, d, tri)))
    for a, b in zip(out[:3], aos[:3]):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=rtol,
                                   atol=rtol * float(b.abs().max()))


def _mesh(make, dt, **kw):
    """(JAX MeshState fields as numpy in dt, port MeshState) of one mesh."""
    v, f = make(**kw)
    with jax.enable_x64(True):
        jms = JMESH.build_mesh_state(v, f, dtype=jnp.dtype(dt))
        d = {k: np.asarray(getattr(jms, k)) for k in MESH_FIELDS}
    d.update(num_vertices=jms.num_vertices, num_faces=jms.num_faces,
             num_edges=jms.num_edges)
    return d, mesh_state_from_arrays(d, "cpu")


@DTYPES
def test_face_areas_area_var_edge_var(dt, rtol):
    """Gradients on the real faces and edges: at the padding's degenerate
    (0,0,0) faces and (0,0) edges the norm's gradient is NaN in JAX and 0 in
    torch. The values are compared with the padding too."""
    d, ms = _mesh(make_icosphere, dt, subdivisions=2, radius=3.0)
    F, E = d["num_faces"], d["num_edges"]
    v, f, fv = d["vertices"], d["faces"], d["face_valid"]
    e, ev = d["edges"], d["edge_valid"]
    tf, te = torch.tensor(f[:F]), torch.tensor(e[:E])
    check(lambda v: JG.face_areas(v[f[:F]]),
          lambda v: TG.face_areas(v[tf]), [v], [0], dt, rtol)
    check(lambda v, fv: JG.area_var(v[f[:F]], fv),
          lambda v, fv: TG.area_var(v[tf], fv), [v, fv[:F]], [0], dt, rtol)
    check(lambda v, ev: JG.edge_var(v, e[:E], ev),
          lambda v, ev: TG.edge_var(v, te, ev), [v, ev[:E]], [0], dt, rtol)
    with jax.enable_x64(True):
        jav = float(JG.area_var(jnp.asarray(v)[f], jnp.asarray(fv)))
        jev = float(JG.edge_var(jnp.asarray(v), e, jnp.asarray(ev)))
    av = float(TG.area_var(ms.vertices[ms.faces], ms.face_valid))
    np.testing.assert_allclose(av, jav, rtol=rtol)
    np.testing.assert_allclose(
        float(TG.edge_var(ms.vertices, ms.edges, ms.edge_valid)), jev,
        rtol=rtol)
    assert 0 < av < 0.02                 # near-uniform, padding ignored
    # the contract tests' closed forms
    tri = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]], dtype=getattr(
        torch, np.dtype(dt).name))
    np.testing.assert_allclose(float(TG.face_areas(tri)[0]), 1.0, rtol=1e-6)
    _, cube = _mesh(make_cube, dt)
    ln = np.array([1.0] * 12 + [np.sqrt(2)] * 6)
    np.testing.assert_allclose(
        float(TG.edge_var(cube.vertices, cube.edges, cube.edge_valid)),
        np.mean(((ln - ln.mean()) / ln.mean()) ** 2), rtol=1e-5)


@DTYPES
def test_laplacian(dt, rtol):
    d, ms = _mesh(make_icosphere, dt, subdivisions=1, radius=5.0)
    v, nb, nv, nrm = (d["vertices"], d["neighbors"], d["neighbor_valid"],
                      d["normals"])
    check(JL.neighbor_average, TL.neighbor_average, [v, nb, nv], [0], dt,
          rtol)
    check(JL.uniform_laplacian_smooth, TG.uniform_laplacian_smooth,
          [v, nb, nv], [0], dt, rtol)
    # The hooks' Laplacian is detached (stop_gradient in JAX): no gradient
    # reaches the vertices, so only the gradient and normals are inputs.
    g = np.random.default_rng(3).standard_normal(v.shape)
    check(lambda g, v, nb, nv: JL.laplacian_grad_hook(g, v, nb, nv, 0.7),
          lambda g, v, nb, nv: TL.laplacian_grad_hook(g, v, nb, nv, 0.7),
          [g, v, nb, nv], [0], dt, rtol)
    for thr in (0.005, 0.5):
        check(lambda g, v, n, nb, nv: JL.laplacian_normal_grad_hook(
            g, v, n, nb, nv, 0.7, threshold=thr),
            lambda g, v, n, nb, nv: TL.laplacian_normal_grad_hook(
                g, v, n, nb, nv, 0.7, threshold=thr),
            [g[:, :1], v, nrm, nb, nv], [0, 2], dt, rtol)
    # the contract tests: weight 0 is the identity, a huge threshold zeroes
    # the normal hook, and the sphere's neighbour average lies inside it
    gt = torch.ones_like(ms.vertices)
    out = TL.laplacian_grad_hook(gt, ms.vertices, ms.neighbors,
                                 ms.neighbor_valid, weight=0.0)
    np.testing.assert_array_equal(out.numpy(), gt.numpy())
    out = TL.laplacian_grad_hook(gt, ms.vertices, ms.neighbors,
                                 ms.neighbor_valid, weight=1.0)
    assert out.shape == gt.shape and float((out - gt).abs().sum()) > 0
    out = TL.laplacian_normal_grad_hook(
        torch.zeros((ms.vertices.shape[0], 1), dtype=ms.vertices.dtype),
        ms.vertices, ms.normals, ms.neighbors, ms.neighbor_valid,
        weight=1.0, threshold=1e9)
    np.testing.assert_array_equal(out.numpy(), 0.0)
    r = TL.neighbor_average(ms.vertices, ms.neighbors, ms.neighbor_valid)[
        :ms.num_vertices].norm(dim=1)
    assert bool((r < 5.0).all()) and bool((r > 4.0).all())


@pytest.fixture(scope="module")
def capture():
    gt_v, gt_f = make_icosphere(subdivisions=2, radius=50.0)
    return j_synth(gt_v, gt_f, name="sphere_ds", num_views=3, resy=32,
                   resx=48, ior=1.5, backend="brute", num_view_used=3)


@DTYPES
def test_downsample_capture(capture, dt, rtol):
    views = {k: np.asarray(getattr(capture.views, k)) for k in JViews._fields}
    for k, a in views.items():
        if a.dtype.kind == "f":
            views[k] = a.astype(dt)
    with jax.enable_x64(True):
        jcap = capture.__class__(**{**capture.__dict__, "views": JViews(
            **{k: jnp.asarray(a) for k, a in views.items()})})
        jsub = j_downsample(jcap, 2)
        jviews = {k: np.asarray(getattr(jsub.views, k))
                  for k in JViews._fields}
    tcap = CaptureData(name="sphere_ds", resy=32, resx=48, num_views=3,
                       views=view_batch_from_arrays(views, "cpu"),
                       num_view_used=3)
    sub = t_downsample(tcap, 2)
    assert (sub.resy, sub.resx, sub.name, sub.num_views) == (16, 24,
                                                             "sphere_ds", 3)
    for k in JViews._fields:
        t = getattr(sub.views, k).numpy()
        assert t.shape == jviews[k].shape and t.dtype == jviews[k].dtype, k
        if k == "K_inv":
            np.testing.assert_allclose(t, jviews[k], rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(t, jviews[k], err_msg=k)
    # every kept ray is the (2i,2j) ray of the full grid
    full = views["ray_dir"].reshape(3, 32, 48, 3)
    np.testing.assert_array_equal(sub.views.ray_dir.numpy().reshape(
        3, 16, 24, 3), full[:, ::2, ::2])
    eye = (sub.views.K[0] @ sub.views.K_inv[0]).numpy()
    np.testing.assert_allclose(eye, np.eye(3), atol=1e-5)


def _camera(resy, resx, dt):
    R = look_at_extrinsic([120.0, 30.0, 40.0], [0.0, 0.0, 0.0])
    K = intrinsics(resy, resx, 45.0)
    return [a.astype(dt) for a in (R, K, np.linalg.inv(R),
                                   np.linalg.inv(K))]


@DTYPES
@pytest.mark.parametrize("s", [1, 2])
def test_generate_rays_supersample(dt, rtol, s):
    resy, resx = 12, 16
    cam = _camera(resy, resx, dt)
    check(lambda *c: j_generate_rays(resy, resx, JCam(*c), supersample=s),
          lambda *c: t_generate_rays(resy, resx, TCam(*c), supersample=s),
          cam, [2, 3], dt, rtol)
    tcam = TCam(*(torch.tensor(a) for a in cam))
    o, d = t_generate_rays(resy, resx, tcam, supersample=s)
    assert d.shape == (resy * resx * s * s, 3) and o.shape == d.shape
    # every sub-ray projects to its pixel's s x s sub-grid
    pix = project_vertices(tcam, o[0] + 7.0 * d).numpy().reshape(
        resy * s, resx * s, 2)
    yy, xx = np.meshgrid(np.arange(resy), np.arange(resx), indexing="ij")
    for sy in range(s):
        for sx in range(s):
            sub = pix[sy::s, sx::s]
            np.testing.assert_allclose(sub[..., 0], xx + (sx + 0.5) / s - 0.5,
                                       atol=2e-3)
            np.testing.assert_allclose(sub[..., 1], yy + (sy + 0.5) / s - 0.5,
                                       atol=2e-3)


@DTYPES
def test_supersample_one_is_the_integer_grid(dt, rtol):
    """supersample=1 gives the integer pixel centres bit for bit, as the
    port computed them before it had the keyword."""
    resy, resx = 12, 16
    cam = TCam(*(torch.tensor(a) for a in _camera(resy, resx, dt)))
    kw = dict(dtype=cam.K_inv.dtype)
    py, px = torch.meshgrid(torch.arange(resy, **kw),
                            torch.arange(resx, **kw), indexing="ij")
    pixel = torch.stack([px, py, torch.ones_like(py)], dim=2).reshape(-1, 3)
    world = (pixel @ cam.K_inv.T) @ cam.R_inv[:3, :3].T + cam.R_inv[:3, 3]
    d0 = safe_normalize(world - cam.R_inv[:3, 3])
    for o, d in (t_generate_rays(resy, resx, cam),
                 t_generate_rays(resy, resx, cam, supersample=1)):
        assert torch.equal(d, d0)
        assert torch.equal(o, cam.R_inv[:3, 3].expand(d0.shape))
    # and the s^2 sub-rays of a pixel average to its centre ray
    _, d2 = t_generate_rays(8, 10, cam, supersample=2)
    _, d1 = t_generate_rays(8, 10, cam)
    mean = d2.numpy().reshape(8, 2, 10, 2, 3).mean(axis=(1, 3))
    cos = np.sum(_unit(mean).reshape(-1, 3) * d1.numpy(), axis=-1)
    assert cos.min() > 1.0 - 1e-6


def _cube_trace():
    v, f = make_cube()
    ms = build_mesh_state(v, f, device="cpu")
    o = torch.tensor([[0.1, 0.2, -5.0], [0.3, -0.1, -5.0]])
    d = torch.tensor([0.0, 0.0, 1.0]).expand(o.shape)
    return TT.render_transparent(o, d, ms, t_get_fn("brute"), 1.5, 1.0)


def test_debug_clean_trace_identical_and_silent(monkeypatch, capfd):
    plain = _cube_trace()
    monkeypatch.setenv("DRT_TPU_DEBUG", "1")
    assert TT.debug_enabled()
    checks = []
    real = TT._debug_check
    monkeypatch.setattr(TT, "_debug_check",
                        lambda p, m: (checks.append(m), real(p, m)))
    dbg = _cube_trace()
    assert torch.equal(plain.valid, dbg.valid) and bool(plain.valid.all())
    assert torch.equal(plain.direction, dbg.direction)
    # each of the two bounces ran both checks
    assert checks == ["TIR FrDielectric/Refract mismatch",
                      "non-finite ray after bounce"] * 2
    captured = capfd.readouterr()
    assert "VIOLATION" not in captured.out + captured.err


def test_debug_violation_prints(capfd):
    TT._debug_check(torch.tensor([True, False, False]), "forced")
    TT._debug_check(torch.tensor([True, True]), "clean")
    captured = capfd.readouterr()
    assert captured.out == "DRT_TPU_DEBUG VIOLATION [forced]: 2 lanes\n"


@pytest.mark.parametrize("value", [None, "", "0"])
def test_debug_off_runs_no_check(monkeypatch, value):
    """With DRT_TPU_DEBUG unset (or empty, or 0) the trace calls neither
    fresnel_dielectric nor _debug_check, so it reads nothing back."""
    if value is None:
        monkeypatch.delenv("DRT_TPU_DEBUG", raising=False)
    else:
        monkeypatch.setenv("DRT_TPU_DEBUG", value)
    assert not TT.debug_enabled()

    def boom(*a, **k):
        raise AssertionError("a debug check ran")
    monkeypatch.setattr(TT, "fresnel_dielectric", boom)
    monkeypatch.setattr(TT, "_debug_check", boom)
    assert bool(_cube_trace().valid.all())

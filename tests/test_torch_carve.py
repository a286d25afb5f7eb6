"""Space carving in the port (`drt_tpu_torch.data.carve`) on the CPU against
the JAX package's `drt_tpu.data.carve`, both fed the same silhouettes of a
ring capture: the occupancy field within 1e-6 and `seen` equal, with the
voxels whose side of the 0.5 level differs counted (at most 1 in 10^4, each
within 1e-5 of 0.5; the port rounds the projection and the blend as XLA does,
so today none differ at all); the numpy stages equal array for array; the
hull end to end; and the behaviours of tests/test_carve.py run on the
port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.data.carve as JC
import drt_tpu_torch.data.carve as TC
from drt_tpu.data.views import CaptureData as JCapture
from drt_tpu.data.views import ViewBatch as JViews
from drt_tpu_torch.data.masks import process_mask
from drt_tpu_torch.data.synthetic import intrinsics, ring_cameras
from drt_tpu_torch.data.views import CaptureData, stack_views
from drt_tpu_torch.intersect import get_intersect_fn
from drt_tpu_torch.mesh import build_mesh_state
from drt_tpu_torch.mesh.topology import build_topology
from drt_tpu_torch.remesh.hausdorff import hausdorff_distance
from drt_tpu_torch.render import render_mask
from drt_tpu_torch.render.camera import CameraM, generate_rays
from tests.meshes import make_icosphere

torch.set_num_threads(min(2, torch.get_num_threads()))

FLIP_SHARE = 1e-4       # voxels whose side of the level may differ
FLIP_BAND = 1e-5        # ... each within this of 0.5


def mask_capture(gt_v, gt_f, num_views, resy, resx):
    """The silhouettes of a synthetic ring capture (the port's oracle, on
    the CPU), as a CaptureData whose other per-pixel arrays are zero: the
    carve reads masks, R and K alone, and the trace of a whole capture would
    cost the test seconds a view."""
    ms = build_mesh_state(gt_v, gt_f, device="cpu")
    fn = get_intersect_fn("auto")
    K = intrinsics(resy, resx)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    views = []
    n = resy * resx
    for R, _, _ in ring_cameras(gt_v, num_views):
        cam = CameraM(f32(R), f32(K), f32(np.linalg.inv(R)),
                      f32(np.linalg.inv(K)))
        o, d = generate_rays(resy, resx, cam)
        hit = render_mask(o, d, ms, fn).reshape(resy, resx) > 0.5
        views.append(dict(screen_pixel=np.zeros((n, 3)),
                          valid=np.zeros(n, bool),
                          mask=process_mask(hit.numpy().astype(np.uint8)),
                          origin=o[:1].numpy(), ray_dir=d.numpy(), R=R, K=K))
    return CaptureData(name="sphere", resy=resy, resx=resx,
                       num_views=num_views,
                       views=stack_views(views, device="cpu"),
                       num_view_used=num_views)


def _arrays(cap):
    return {k: getattr(cap.views, k).numpy() for k in JViews._fields}


def jax_capture(cap):
    """The same capture as the JAX package's CaptureData."""
    a = _arrays(cap)
    return JCapture(name=cap.name, resy=cap.resy, resx=cap.resx,
                    num_views=cap.num_views,
                    views=JViews(**{k: jnp.asarray(a[k]) for k in a}),
                    num_view_used=cap.num_view_used)


@pytest.fixture(scope="module")
def sphere_capture():
    """24 views of a radius-50 sphere at 96x96 (tests/test_carve.py's
    capture, silhouettes only)."""
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=50.0)
    return gt_v, gt_f, mask_capture(gt_v, gt_f, 24, 96, 96)


@pytest.fixture(scope="module")
def wide_capture():
    """The 4:1 capture of tests/test_carve.py (12 views at 24x96)."""
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=50.0)
    return gt_v, gt_f, mask_capture(gt_v, gt_f, 12, 24, 96)


def _compare_occupancy(cap, lo, hi, res):
    a = _arrays(cap)
    jf, js, jo, jsp = JC.carve_occupancy(a["mask"], a["R"], a["K"], lo, hi,
                                         res)
    tf, ts, to, tsp = TC.carve_occupancy(a["mask"], a["R"], a["K"], lo, hi,
                                         res, device="cpu")
    assert tf.dtype == np.float32 and tf.shape == (res,) * 3
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tsp, jsp)
    dfield = float(np.abs(tf - jf).max())
    flipped = (tf > 0.5) != (jf > 0.5)
    n_flip = int(flipped.sum())
    print(f"carve_occupancy at {res}^3: max |dfield| {dfield:.3g}, "
          f"{n_flip} of {tf.size} voxels on the other side of 0.5, "
          f"{int((tf != jf).sum())} differ at all")
    assert dfield <= 1e-6
    assert n_flip <= FLIP_SHARE * tf.size
    if n_flip:
        assert np.abs(jf[flipped] - 0.5).max() <= FLIP_BAND
    return tf, ts, n_flip


@pytest.mark.parametrize("case,res", [("sphere", 64), ("sphere", 96),
                                      ("wide", 64)])
def test_carve_occupancy_matches_jax_package(sphere_capture, wide_capture,
                                             case, res):
    gt_v, _, cap = sphere_capture if case == "sphere" else wide_capture
    margin = 65.0 if case == "sphere" else 110.0
    c = gt_v.mean(0)
    tf, ts, _ = _compare_occupancy(cap, c - margin, c + margin, res)
    assert 0 < int((tf > 0.5).sum()) < tf.size
    if case == "wide":
        assert not ts.all()        # the out-of-frustum slabs are unseen


def test_carve_occupancy_takes_tensors(sphere_capture):
    """The capture's own tensors (as carved_visual_hull passes them) give
    the numpy inputs' result."""
    _, _, cap = sphere_capture
    a = _arrays(cap)
    lo, hi = np.full(3, -60.0), np.full(3, 60.0)
    f1, s1, _, _ = TC.carve_occupancy(a["mask"][:4], a["R"][:4], a["K"][:4],
                                      lo, hi, 32, device="cpu")
    f2, s2, _, _ = TC.carve_occupancy(cap.views.mask[:4], cap.views.R[:4],
                                      cap.views.K[:4], lo, hi, 32,
                                      device="cpu")
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(s1, s2)


def _checkerboard_field(seed):
    """A random blob with 2D checkerboards and 3D corner contacts planted
    in it, which `_make_well_composed` must repair."""
    rng = np.random.default_rng(seed)
    n = 20
    ax = np.linspace(-1, 1, n)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
    occ = r + 0.15 * rng.standard_normal(r.shape) < 0.7
    occ[2, 2, 2] = occ[3, 3, 2] = True           # edge-only contact
    occ[3, 2, 2] = occ[2, 3, 2] = False
    occ[16, 16, 16] = occ[17, 17, 17] = True     # corner-only contact
    for dx, dy, dz in JC._CORNERS[1:7]:
        occ[16 + dx, 16 + dy, 16 + dz] = False
    return occ


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_stages_equal_the_jax_package(seed):
    occ = _checkerboard_field(seed)
    jw, tw = JC._make_well_composed(occ), TC._make_well_composed(occ)
    assert (jw != occ).any()                     # repair was needed
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(TC._cleanup_binary(occ),
                                  JC._cleanup_binary(occ))
    origin, spacing = np.array([-1.0, -2.0, 0.5]), np.array([0.1, 0.1, 0.2])
    jv, jf = JC.surface_nets(jw.astype(np.float64), origin, spacing)
    tv, tf = TC.surface_nets(tw.astype(np.float64), origin, spacing)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tv, jv)
    assert build_topology(tf, len(tv)).is_watertight


def test_surface_nets_sphere_sdf_equals_jax_package():
    """tests/test_carve.py's analytic sphere: equal arrays, watertight,
    radius within a voxel, outward."""
    n = 48
    ax = np.linspace(-1.2, 1.2, n)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    field = 1.0 - np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
    origin = np.array([-1.2, -1.2, -1.2])
    spacing = np.full(3, ax[1] - ax[0])
    v, f = TC.surface_nets(field, origin, spacing, iso=0.0)
    jv, jf = JC.surface_nets(field, origin, spacing, iso=0.0)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(v, jv)
    assert build_topology(f, len(v)).is_watertight
    assert abs(np.linalg.norm(v, axis=1).mean() - 1.0) < 0.05
    tri = v[f]
    vol = np.einsum("ij,ij->", np.cross(tri[:, 0], tri[:, 1]), tri[:, 2]) / 6
    assert abs(vol - 4.0 / 3.0 * np.pi) < 0.4


def test_rig_working_volume_equals_jax_package(sphere_capture):
    gt_v, _, cap = sphere_capture
    jlo, jhi = JC.rig_working_volume(jax_capture(cap))
    tlo, thi = TC.rig_working_volume(cap)
    np.testing.assert_array_equal(tlo, jlo)
    np.testing.assert_array_equal(thi, jhi)
    assert np.all(gt_v > tlo + 1.0) and np.all(gt_v < thi - 1.0)


def test_carved_visual_hull_matches_jax_package(sphere_capture):
    """End to end on the same capture: the same faces and vertices where no
    voxel flipped, else Hausdorff between the hulls under 0.1 voxel."""
    gt_v, gt_f, cap = sphere_capture
    c = gt_v.mean(0)
    lo, hi = c - 65.0, c + 65.0
    res = 64
    a = _arrays(cap)
    jf, _, _, _ = JC.carve_occupancy(a["mask"], a["R"], a["K"], lo, hi, res)
    tf, _, _, spacing = TC.carve_occupancy(a["mask"], a["R"], a["K"], lo, hi,
                                           res, device="cpu")
    jv, jfa = JC.carved_visual_hull(jax_capture(cap), lo, hi,
                                    resolution=res, target_len=8.0)
    tv, tfa = TC.carved_visual_hull(cap, lo, hi, resolution=res,
                                    target_len=8.0)
    assert build_topology(tfa, len(tv)).is_watertight
    if ((tf > 0.5) == (jf > 0.5)).all():
        np.testing.assert_array_equal(tfa, jfa)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-9)
    else:
        h = hausdorff_distance(tv, tfa, jv, jfa)
        assert h.max < 0.1 * float(spacing.min()), h


def test_carved_hull_contains_and_approximates(sphere_capture):
    gt_v, gt_f, cap = sphere_capture
    c = gt_v.mean(0)
    v, f = TC.carved_visual_hull(cap, c - 65.0, c + 65.0,
                                 resolution=96, target_len=8.0)
    assert build_topology(f.astype(np.int64), len(v)).is_watertight
    h = hausdorff_distance(v, f, gt_v, gt_f)
    assert h.mean < 1.5, h
    assert h.max < 8.0, h


def test_carved_hull_wide_aspect_rejects_out_of_frustum_slabs(wide_capture):
    """At 4:1 the carve volume's corners above/below every view's vertical
    frustum are never carved; they must not survive as the largest
    component in place of the object."""
    gt_v, gt_f, cap = wide_capture
    c = gt_v.mean(0)
    v, f = TC.carved_visual_hull(cap, c - 110.0, c + 110.0, resolution=64,
                                 target_len=10.0)
    assert build_topology(f.astype(np.int64), len(v)).is_watertight
    assert np.all(np.abs(v - c) < 70.0), (v.min(0), v.max(0))
    h = hausdorff_distance(v, f, gt_v, gt_f)
    assert h.mean < 25.0, h


def test_rig_working_volume_contains_object(sphere_capture):
    gt_v, gt_f, cap = sphere_capture
    lo, hi = TC.rig_working_volume(cap)
    assert np.all(gt_v > lo + 1.0) and np.all(gt_v < hi - 1.0), (lo, hi)
    v, f = TC.carved_visual_hull(cap, lo, hi, resolution=64,
                                 target_len=10.0)
    assert build_topology(f.astype(np.int64), len(v)).is_watertight
    h = hausdorff_distance(v, f, gt_v, gt_f)
    assert h.mean < 4.0, h


def test_carve_occupancy_cuda_without_a_card_raises(sphere_capture):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, _, cap = sphere_capture
    a = _arrays(cap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.carve_occupancy(a["mask"], a["R"], a["K"], np.zeros(3),
                           np.ones(3), 8)

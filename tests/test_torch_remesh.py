"""The port's host-side remeshing and Hausdorff evaluation
(drt_tpu_torch.remesh, its own copies of the numpy code and its own build of
native/remesh.cpp) against the JAX package's: equal outputs (the same
arithmetic on the same inputs, so array equality) on the icosphere through
the native and the numpy routes and on dog_mid20k through the native
route."""

import os

import numpy as np
import pytest

import drt_tpu.remesh as JR
import drt_tpu.remesh.native as JN
import drt_tpu_torch.remesh as TR
import drt_tpu_torch.remesh.native as TN
from drt_tpu_torch.mesh import build_mesh_state, load_ply
from tests.meshes import make_icosphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOG = os.path.join(ROOT, "reports", "tuning_meshes", "dog_mid20k.ply")


def _bumpy_sphere():
    v, f = make_icosphere(subdivisions=2, radius=50.0)
    rng = np.random.default_rng(11)
    return v * np.clip(1.0 + 0.10 * rng.standard_normal(len(v))[:, None],
                       0.88, 1.12), f


def test_native_core_builds_beside_the_package():
    lib = TN.load_native()
    assert lib is not None, "g++ is present here: the native core must build"
    assert TN._LIB == os.path.join(ROOT, "build", "drt_tpu_torch",
                                   "libdrtremesh.so")
    assert os.path.exists(TN._LIB)
    assert os.path.samefile(TN._SRC, JN._SRC)       # the unchanged source
    leftovers = [n for n in os.listdir(os.path.dirname(TN._LIB))
                 if n.startswith("libdrtremesh") and n.endswith(".tmp")]
    assert not leftovers


@pytest.mark.parametrize("use_native,target", [(True, 12.0), (True, 7.0),
                                               (False, 12.0)])
def test_isotropic_remesh_equals_jax_package_on_icosphere(use_native,
                                                          target):
    v, f = _bumpy_sphere()
    v1, f1 = TR.isotropic_remesh(v, f, target, use_native=use_native)
    v2, f2 = JR.isotropic_remesh(v, f, target, use_native=use_native)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(v1, v2)
    assert len(f1) != len(f)
    ms = build_mesh_state(v1, f1, device="cpu")      # still watertight
    assert ms.num_faces == len(f1)
    # edge lengths gather around the target
    e = np.linalg.norm(v1[f1] - np.roll(v1[f1], -1, axis=1), axis=2)
    assert 0.7 * target < e.mean() < 1.3 * target


def test_native_iteration_equals_jax_package():
    v, f = _bumpy_sphere()
    a = TN.native_remesh_iteration(v, f, 9.0, orig_vertices=v, orig_faces=f,
                                   max_surf_dist=1.0)
    b = JN.native_remesh_iteration(v, f, 9.0, orig_vertices=v, orig_faces=f,
                                   max_surf_dist=1.0)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def test_isotropic_remesh_equals_jax_package_on_dog():
    v, f = load_ply(DOG)
    v1, f1 = TR.isotropic_remesh(v, f, 3.0)
    v2, f2 = JR.isotropic_remesh(v, f, 3.0)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(v1, v2)
    assert len(f1) < len(f)                          # mean edge 2.26 -> 3
    build_mesh_state(v1, f1, device="cpu")


@pytest.mark.parametrize("mesh", ["icosphere", "dog_mid20k"])
def test_surface_index_and_hausdorff_equal_jax_package(mesh):
    if mesh == "icosphere":
        v, f = make_icosphere(subdivisions=3, radius=50.0)
        v2, f2 = _bumpy_sphere()
    else:
        v, f = load_ply(DOG)
        rng = np.random.default_rng(5)
        v2, f2 = v + 0.05 * rng.standard_normal(v.shape), f
    p = np.random.default_rng(1).uniform(v.min(0), v.max(0), (2000, 3))
    pt, dt = TR.SurfaceIndex(v, f).closest_points(p)
    pj, dj = JR.SurfaceIndex(v, f).closest_points(p)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(TR.point_mesh_distance(p, v, f), dj)
    for symmetric in (True, False):
        ht = TR.hausdorff_distance(v2, f2, v, f, symmetric=symmetric)
        hj = JR.hausdorff_distance(v2, f2, v, f, symmetric=symmetric)
        assert tuple(ht) == tuple(hj)
        assert ht.max >= ht.rms >= ht.mean > 0
    same = TR.hausdorff_distance(v, f, v, f)
    assert same.max < 1e-9


def test_duplicate_face_pairs_are_repaired_as_in_jax_package():
    from drt_tpu.remesh.isotropic import remove_duplicate_face_pairs as jrm
    from drt_tpu_torch.remesh.isotropic import remove_duplicate_face_pairs
    v, f = load_ply(os.path.join(ROOT, "tests", "fixtures",
                                 "dog_pillow_corrupt.ply"))
    a, b = remove_duplicate_face_pairs(v, f), jrm(v, f)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert len(a[1]) < len(f)

"""drt_tpu_torch.mesh against drt_tpu.mesh: every MeshState field of the
port's build_mesh_state equals the JAX package's (integer topology and
masks exactly, vertices exactly, normals and mean_len to float32
rounding: rtol 1e-5 / atol 1e-6), on an icosphere and on dog_mid20k; and
convert.mesh_state_from_arrays carries a JAX state across unchanged."""

import os

import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
import drt_tpu_torch.mesh as TMESH
from drt_tpu_torch.convert import mesh_state_from_arrays
from tests.meshes import make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

DOG20K = os.path.join(os.path.dirname(__file__), "..", "reports",
                      "tuning_meshes", "dog_mid20k.ply")
FIELDS = ("vertices", "faces", "face_valid", "vert_valid", "edges",
          "edge_valid", "edge_faces", "neighbors", "neighbor_valid",
          "normals", "mean_len")
STATIC = ("num_vertices", "num_faces", "num_edges")


def jax_arrays(ms):
    d = {k: np.asarray(getattr(ms, k)) for k in FIELDS}
    d.update({k: getattr(ms, k) for k in STATIC})
    return d


def assert_state_equal(tms, d):
    for k in STATIC:
        assert getattr(tms, k) == d[k], k
    for k in FIELDS:
        got = getattr(tms, k).detach().cpu().numpy()
        assert got.shape == d[k].shape, k
        if k in ("normals", "mean_len"):
            np.testing.assert_allclose(got, d[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, d[k], err_msg=k)


def _load(name):
    if name == "icosphere":
        return make_icosphere(subdivisions=3, radius=50.0)
    return TMESH.load_ply(DOG20K)


@pytest.mark.parametrize("name", ["icosphere", "dog_mid20k"])
def test_build_mesh_state_matches_jax(name):
    v, f = _load(name)
    ref = jax_arrays(JMESH.build_mesh_state(v, f))
    tms = TMESH.build_mesh_state(v, f, device="cpu")
    assert tms.vertices.dtype == torch.float32
    assert_state_equal(tms, ref)
    # host_arrays round-trips the unpadded mesh
    hv, hf = tms.host_arrays()
    np.testing.assert_array_equal(hf, ref["faces"][: ref["num_faces"]])
    np.testing.assert_allclose(hv, v, rtol=1e-6, atol=1e-5)


def test_ply_copy_matches_jax(tmp_path):
    v, f = TMESH.load_ply(DOG20K)
    jv, jf = JMESH.load_ply(DOG20K)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    p = str(tmp_path / "m.ply")
    TMESH.save_ply(p, v, f)
    v2, f2 = JMESH.load_ply(p)
    np.testing.assert_array_equal(f2, f)
    np.testing.assert_allclose(v2, v.astype(np.float32))


def test_convert_and_with_vertices():
    v, f = make_icosphere(subdivisions=2, radius=50.0)
    jms = JMESH.build_mesh_state(v, f)
    d = jax_arrays(jms)
    tms = mesh_state_from_arrays(d, device="cpu")
    assert_state_equal(tms, d)
    # with_vertices recomputes normals like the JAX package
    rng = np.random.default_rng(0)
    nv = d["vertices"] + rng.normal(scale=1.0, size=d["vertices"].shape
                                    ).astype(np.float32)
    jn = np.asarray(jms.with_vertices(np.asarray(nv)).normals)
    tn = tms.with_vertices(torch.from_numpy(nv)).normals.numpy()
    np.testing.assert_allclose(tn, jn, rtol=1e-5, atol=1e-6)
    assert tms.normals is not None and not np.allclose(tn, d["normals"])

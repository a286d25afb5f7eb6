"""The h5 capture path of the port (`drt_tpu_torch.data.captured`) on the
CPU: a round trip for a Pointgray object (rays read from the file) and a
Redmi object (rays made from K and R); files written by either package load
in the other to the arrays that package's own loader gives (R, K, mask,
valid and screen_pixel exactly, Redmi rays at 1e-6); the number of views and
the resolution come from the file."""

import numpy as np
import pytest
import torch

from drt_tpu.data import synthesize_capture as j_synth
from drt_tpu.data.captured import load_h5_capture as j_load
from drt_tpu.data.captured import save_h5_capture as j_save
from drt_tpu.data.views import ViewBatch as JViews
from drt_tpu_torch.data import load_h5_capture
from drt_tpu_torch.data.captured import save_h5_capture
from drt_tpu_torch.data.synthetic import synthesize_capture
from tests.meshes import make_icosphere

torch.set_num_threads(min(2, torch.get_num_threads()))

RES = (24, 32)


def _port_capture(name, num_views=3, res=RES):
    gt_v, gt_f = make_icosphere(subdivisions=2, radius=50.0)
    return synthesize_capture(gt_v, gt_f, name=name, num_views=num_views,
                              resy=res[0], resx=res[1], ior=1.5,
                              num_view_used=num_views, device="cpu")


@pytest.fixture(scope="module")
def jax_captures():
    """A 3-view capture of each rig, synthesized by the JAX package."""
    gt_v, gt_f = make_icosphere(subdivisions=2, radius=50.0)
    return {name: j_synth(gt_v, gt_f, name=name, num_views=3, resy=RES[0],
                          resx=RES[1], ior=1.5, backend="brute",
                          num_view_used=3)
            for name in ("mouse", "pig")}


def _views(cap):
    """Every ViewBatch field of either package's capture as numpy."""
    out = {}
    for k in JViews._fields:
        x = getattr(cap.views, k)
        out[k] = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out


def _assert_same_load(got, want, name):
    """Tolerances of a load across the packages: all exact but Redmi rays,
    which each package makes from K and R in float32."""
    assert set(got) == set(want)
    for k in ("R", "K", "R_inv", "K_inv", "mask", "valid", "screen_pixel"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if name == "mouse":
        np.testing.assert_array_equal(got["ray_dir"], want["ray_dir"])
        np.testing.assert_array_equal(got["origin"], want["origin"])
    else:
        np.testing.assert_allclose(got["ray_dir"], want["ray_dir"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got["origin"], want["origin"], rtol=0,
                                   atol=1e-6 * np.abs(want["origin"]).max())


@pytest.mark.parametrize("name", ["mouse", "pig"])  # Pointgray / Redmi rig
def test_h5_round_trip(tmp_path, name):
    cap = _port_capture(name)
    path = str(tmp_path / f"{name}.h5")
    save_h5_capture(cap, path)
    back = load_h5_capture(path, name, num_views=3, num_view_used=3,
                           resy=RES[0], resx=RES[1], device="cpu")
    a, b = _views(cap), _views(back)
    np.testing.assert_allclose(b["R"], a["R"], atol=1e-6)
    np.testing.assert_allclose(b["K"], a["K"], atol=1e-6)
    np.testing.assert_array_equal(b["valid"], a["valid"])
    assert a["valid"].sum() > 50
    np.testing.assert_allclose(b["screen_pixel"][a["valid"]],
                               a["screen_pixel"][a["valid"]], atol=1e-5)
    # binary -> process_mask reproduces the soft mask
    np.testing.assert_allclose(b["mask"], a["mask"], atol=1e-6)
    np.testing.assert_allclose(b["ray_dir"], a["ray_dir"], atol=1e-5)
    n = RES[0] * RES[1]
    np.testing.assert_allclose(np.broadcast_to(b["origin"], (3, n, 3)),
                               np.broadcast_to(a["origin"], (3, n, 3)),
                               atol=1e-4)
    assert back.views.mask.device.type == "cpu"


@pytest.mark.parametrize("name", ["mouse", "pig"])
def test_jax_written_file_loads_in_the_port(tmp_path, jax_captures, name):
    path = str(tmp_path / f"{name}.h5")
    j_save(jax_captures[name], path)
    want = _views(j_load(path, name))
    got = _views(load_h5_capture(path, name, device="cpu"))
    _assert_same_load(got, want, name)


@pytest.mark.parametrize("name", ["mouse", "pig"])
def test_port_written_file_loads_in_the_jax_package(tmp_path, name):
    path = str(tmp_path / f"{name}.h5")
    save_h5_capture(_port_capture(name), path)
    got = _views(load_h5_capture(path, name, device="cpu"))
    want = _views(j_load(path, name))
    _assert_same_load(got, want, name)


def test_h5_infers_views_and_resolution(tmp_path):
    cap = _port_capture("mouse", num_views=3, res=(24, 40))
    path = str(tmp_path / "m.h5")
    save_h5_capture(cap, path)
    back = load_h5_capture(path, "mouse", device="cpu")
    assert back.num_views == 3
    assert (back.resy, back.resx) == (24, 40)
    assert back.num_view_used == 3            # clamped to the file
    assert back.views.mask.shape == (3, 24, 40)
    few = load_h5_capture(path, "mouse", num_views=2, device="cpu")
    assert few.num_views == 2 and few.views.R.shape[0] == 2


def test_h5_unknown_object_and_missing_card(tmp_path):
    path = str(tmp_path / "m.h5")
    save_h5_capture(_port_capture("mouse", num_views=1), path)
    with pytest.raises(ValueError, match="unknown object"):
        load_h5_capture(path, "teapot", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_h5_capture(path, "mouse")     # device="cuda", no card

"""Image output of the port (`drt_tpu_torch.utils.images`) against the JAX
package's: `normalize_to_uint8` equal, and `save_image`, whose PNG the port
writes with the standard library, decodes (through imageio) to the pixels
of the file the JAX package writes through imageio, for flat, 2-D, [N,1]
and [N,3] inputs."""

import imageio
import numpy as np
import pytest

import drt_tpu.utils.images as JI
import drt_tpu_torch.utils.images as TI


@pytest.mark.parametrize("kind", ["random", "constant", "bool", "negative"])
def test_normalize_to_uint8_equals_jax_package(kind):
    rng = np.random.default_rng(3)
    img = {"random": rng.uniform(0, 1, (17, 23)),
           "constant": np.full((5, 7), 0.25),
           "bool": rng.uniform(0, 1, (9, 4)) > 0.5,
           "negative": rng.normal(size=(6, 6, 3)) * 100}[kind]
    out = TI.normalize_to_uint8(img)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, JI.normalize_to_uint8(img))


@pytest.mark.parametrize("shape,res", [((24 * 40,), (24, 40)),
                                       ((24, 40), (None, None)),
                                       ((24 * 40, 1), (24, 40)),
                                       ((24 * 40, 3), (24, 40)),
                                       ((24, 40, 3), (None, None))])
def test_save_image_decodes_to_the_jax_packages_pixels(tmp_path, shape, res):
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 2, shape).astype(np.float32)
    img.reshape(-1)[:7] = 0.0                  # some runs of equal values
    TI.save_image(str(tmp_path / "port.png"), img, *res)
    JI.save_image(str(tmp_path / "jax.png"), img, *res)
    got = np.asarray(imageio.imread(str(tmp_path / "port.png")))
    want = np.asarray(imageio.imread(str(tmp_path / "jax.png")))
    assert got.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_write_png_refuses_other_shapes(tmp_path):
    with pytest.raises(ValueError, match="cannot write"):
        TI.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError, match="cannot write"):
        TI.write_png(str(tmp_path / "x.png"), np.zeros(16, np.uint8))

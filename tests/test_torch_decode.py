"""The port's JPEG decode (``vipers_torch.data.native``, its own libjpeg
build) against the JAX package's ``vipers.data.native``, bit for bit: every
JPEG of the committed VOC fixture, a grayscale JPEG, sizes that are not
multiples of 16, other pad multiples, a PNG (the PIL path) and a JPEG that
libjpeg rejects (PIL too)."""

import glob
import os

import numpy as np
import pytest

from vipers.data import native as jnative
from vipers_torch.data import native

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_voc", "JPEGImages")
JPEGS = sorted(glob.glob(os.path.join(FIXTURE, "*.jpg")))


def _same(path, pad):
    got, got_hw = native.decode_pad(path, pad)
    want, want_hw = jnative.decode_pad(path, pad)
    assert got_hw == want_hw
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    h, w = got_hw
    assert got.shape[0] % pad == 0 and got.shape[1] % pad == 0
    assert not got[h:].any() and not got[:, w:].any()
    return got, got_hw


def test_the_library_is_built_and_used():
    assert native.available() and native.backend() == "libjpeg"
    assert native.build_error() is None
    assert os.path.basename(native.library_path()).startswith("libvipers_decode-")
    assert "build" in native.library_path().split(os.sep)


@pytest.mark.parametrize("path", JPEGS, ids=os.path.basename)
def test_fixture_jpegs_bit_equal(path):
    assert len(JPEGS) == 8
    _, (h, w) = _same(path, 16)
    assert native.jpeg_dims(path) == jnative.jpeg_dims(path) == (w, h)


@pytest.mark.parametrize("size,mode,pad", [((37, 53), "L", 16), ((100, 75), "RGB", 8),
                                           ((31, 17), "RGB", 14), ((64, 48), "L", 1)],
                         ids=["gray", "pad8", "pad14", "gray-pad1"])
def test_other_jpegs_bit_equal(tmp_path, size, mode, pad):
    from PIL import Image

    rng = np.random.default_rng(size[0])
    shape = (size[1], size[0]) + (() if mode == "L" else (3,))
    path = str(tmp_path / "im.jpeg")
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(path, quality=80)
    img, hw = _same(path, pad)
    assert hw == (size[1], size[0])
    if mode == "L":  # gray comes back as three equal channels
        assert np.array_equal(img[..., 0], img[..., 1])


def test_png_goes_through_pil(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(0).integers(0, 256, (21, 35, 3), dtype=np.uint8)
    path = str(tmp_path / "im.png")
    Image.fromarray(arr).save(path)
    img, hw = _same(path, 16)
    assert hw == (21, 35) and np.array_equal(img[:21, :35], arr)
    with pytest.raises(ValueError, match="not a decodable JPEG"):
        native.jpeg_dims(path)


def test_jpeg_libjpeg_rejects_falls_back_to_pil(tmp_path):
    """A PNG named .jpg: libjpeg refuses it, PIL decodes it, as in JAX."""
    from PIL import Image

    arr = np.random.default_rng(1).integers(0, 256, (19, 23, 3), dtype=np.uint8)
    path = str(tmp_path / "not_a_jpeg.jpg")
    Image.fromarray(arr).save(path, format="PNG")
    img, hw = _same(path, 16)
    assert hw == (19, 23) and np.array_equal(img[:19, :23], arr)

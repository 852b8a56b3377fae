"""io/image.py, the port's PIL-free image reader, against PIL (libjpeg-turbo
on this host) and the JAX CLI's _load_image: the repository's example
JPEGs, JPEGs that PIL writes here (4:4:4, 4:2:2, 4:2:0, gray, restart
markers, sizes that are not multiples of 16), PNGs (gray, RGB, RGBA) and
what must raise. The decoder follows libjpeg's integer IDCT, fancy
upsampling and colour tables, so the pixels must be equal."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from sparse_videogen_tpu.cli import wan_i2v as JCLI
from sparse_videogen_tpu_torch.io import image as TIMG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [os.path.join(ROOT, "examples", str(i), "image.jpg") for i in (1, 2, 3)]


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def encoded(img: Image.Image, fmt: str, **kw) -> bytes:
    bio = io.BytesIO()
    img.save(bio, format=fmt, **kw)
    return bio.getvalue()


@pytest.fixture(scope="module")
def source():
    return np.asarray(Image.open(EXAMPLES[0]).convert("RGB"))


@pytest.mark.parametrize("path", EXAMPLES, ids=["ex1", "ex2", "ex3"])
def test_example_jpegs_equal_pil(path):
    """The reference scripts' images (baseline, 480x832, 4:2:0): equal."""
    ours = TIMG.read_image(path)
    with open(path, "rb") as f:
        ref = pil_rgb(f.read())
    assert ours.shape == ref.shape == (480, 832, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("size,kw", [((480, 832), {"quality": 95}), ((37, 53), {"quality": 50}),
                                     ((17, 9), {"quality": 75}),
                                     ((100, 130), {"quality": 80, "restart_marker_blocks": 3}),
                                     ((61, 99), {"quality": 90, "restart_marker_rows": 1})],
                         ids=["480x832", "37x53", "17x9", "rst_blocks", "rst_rows"])
def test_pil_written_jpegs_equal_pil(source, subsampling, size, kw):
    h, w = size
    data = encoded(Image.fromarray(source[:h, :w]), "JPEG", subsampling=subsampling, **kw)
    if "restart_marker_blocks" in kw or "restart_marker_rows" in kw:
        assert b"\xff\xdd" in data  # a DRI segment
    np.testing.assert_array_equal(TIMG.decode_jpeg(data), pil_rgb(data))


@pytest.mark.parametrize("size", [(480, 832), (37, 53)])
def test_gray_jpeg_equals_pil(source, size):
    data = encoded(Image.fromarray(source[:size[0], :size[1]]).convert("L"), "JPEG", quality=90)
    ours = TIMG.decode_jpeg(data)
    np.testing.assert_array_equal(ours, pil_rgb(data))
    assert (ours[..., 0] == ours[..., 2]).all()


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_png_equals_pil(source, mode):
    """PIL picks the row filters; RGBA's alpha is dropped, as convert("RGB")."""
    arr = source[:45, :67]
    img = Image.fromarray(arr).convert(mode)
    if mode == "RGBA":
        rgba = np.asarray(img).copy()
        rgba[..., 3] = np.random.default_rng(0).integers(0, 256, rgba.shape[:2])
        img = Image.fromarray(rgba)
    data = encoded(img, "PNG")
    np.testing.assert_array_equal(TIMG.decode_png(data), pil_rgb(data))


def test_unsupported_inputs_raise_naming_npy(source, tmp_path):
    """Progressive JPEG, a 16-bit PNG and another format raise ValueError
    naming .npy."""
    cases = {"prog.jpg": encoded(Image.fromarray(source[:32, :32]), "JPEG", progressive=True),
             "deep.png": encoded(Image.fromarray((np.arange(32 * 32, dtype=np.uint16) * 60).reshape(32, 32)), "PNG"),
             "x.bmp": encoded(Image.fromarray(source[:8, :8]), "BMP")}
    for name, data in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=r"\.npy"):
            TIMG.load_image(str(path))


def test_load_image_equals_jax_cli(tmp_path):
    """load_image gives what the JAX CLI's _load_image gives (PIL, x / 127.5
    - 1; an .npy as f32): equal."""
    ours = TIMG.load_image(EXAMPLES[0])
    ref = JCLI._load_image(EXAMPLES[0])
    assert tuple(ours.shape) == ref.shape == (1, 3, 480, 832)
    np.testing.assert_array_equal(ours.numpy(), ref)
    arr = np.random.default_rng(1).uniform(-1, 1, (3, 20, 24))
    np.save(tmp_path / "img.npy", arr)
    np.testing.assert_array_equal(TIMG.load_image(str(tmp_path / "img.npy")).numpy(),
                                  JCLI._load_image(str(tmp_path / "img.npy")))

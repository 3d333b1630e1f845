"""The port's EXR and Radiance .hdr codec against the JAX package's
``utils/exr.py``: every checked-in golden read bitwise by both readers,
files written by both writers byte-identical (compressed and raw, RGB and
RGBA), and .hdr files (flat and run-length scanlines) the test writes
read bitwise by both."""

import glob
import os

import numpy as np
import pytest

from nrc_hpm_tpu.utils import exr as jexr
from nrc_hpm_tpu_torch.utils import exr as texr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = sorted(glob.glob(os.path.join(ROOT, "reference", "*", "*.exr")))


def test_goldens_are_present():
    assert len(GOLDENS) >= 7, GOLDENS


@pytest.mark.parametrize("path", GOLDENS,
                         ids=[os.path.relpath(p, ROOT) for p in GOLDENS])
def test_goldens_read_bitwise(path):
    got, want = texr.read_exr(path), jexr.read_exr(path)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(got[name].view(np.uint32),
                              want[name].view(np.uint32)), name
    rgba = texr.read_exr_rgba(path)
    assert np.array_equal(rgba.view(np.uint32),
                          jexr.read_exr_rgba(path).view(np.uint32))
    assert np.array_equal(texr.read_any_hdr(path), rgba)


def _image(channels: int) -> np.ndarray:
    r = np.random.RandomState(channels)
    img = r.gamma(0.7, 0.5, (13, 21, channels)).astype(np.float32)
    img[2:5, 3:9] = 0.0     # runs the zip predictor compresses
    return img


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("compress", [True, False], ids=["zips", "raw"])
def test_writers_byte_identical(tmp_path, compress, channels):
    img = _image(channels)
    tp, jp = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    texr.write_exr(tp, img, compress=compress)
    jexr.write_exr(jp, img, compress=compress)
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    back = texr.read_exr_rgba(tp)
    assert np.array_equal(back[..., :channels], img)
    if channels == 3:
        assert (back[..., 3] == 1.0).all()


def test_write_rejects_bad_shapes(tmp_path):
    with pytest.raises(ValueError):
        texr.write_exr(str(tmp_path / "x.exr"), np.zeros((4, 4, 2)))
    with pytest.raises(ValueError):
        texr.write_exr(str(tmp_path / "x.exr"), np.zeros((4, 4)))


def _hdr(w: int, h: int, rle: bool) -> bytes:
    """A Radiance file of h scanlines of w RGBE pixels."""
    r = np.random.RandomState(w * h)
    px = r.randint(0, 256, (h, w, 4)).astype(np.uint8)
    px[..., 3] = r.randint(120, 140, (h, w))
    px[0, 0, 3] = 0                                   # black
    head = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {h} +X {w}\n".encode())
    if not rle:
        return head + px.tobytes()
    body = b""
    for y in range(h):
        body += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            x = 0
            while x < w:
                n = min(w - x, 5)
                if x % 2 == 0 and n > 1:              # a run of n
                    body += bytes([128 + n, int(px[y, x, c])])
                    px[y, x:x + n, c] = px[y, x, c]
                else:                                 # n literals
                    body += bytes([n]) + px[y, x:x + n, c].tobytes()
                x += n
    return head + body


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_radiance_hdr_matches_jax(tmp_path, rle):
    p = tmp_path / "t.hdr"
    p.write_bytes(_hdr(17, 6, rle))
    got = texr.read_radiance_hdr(str(p))
    want = jexr.read_radiance_hdr(str(p))
    assert got.shape == (6, 17, 3)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got[0, 0] == 0).all() and (got > 0).mean() > 0.5
    assert np.array_equal(texr.read_any_hdr(str(p)), got)


def test_unsupported_inputs_raise(tmp_path):
    bad = tmp_path / "x.png"
    bad.write_bytes(b"\x89PNG")
    with pytest.raises(NotImplementedError):
        texr.read_any_hdr(str(bad))
    notexr = tmp_path / "y.exr"
    notexr.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError):
        texr.read_exr(str(notexr))

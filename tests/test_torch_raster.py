"""The port's triangle-model renderer and its assets against the JAX
package: the PNG codec (``utils/png.py``), the bilinear samplers and
``load_image`` (``utils/texture.py``), ``load_obj``, ``make_cube`` and
``flatten_model`` (``models/mesh.py``) and ``ModelRenderer``
(``models/raster.py``), on files the tests write.

Tolerances: the PNG codec is bitwise (decoded pixels and written bytes);
the OBJ/MTL loader, the cube and ``flatten_model`` are bitwise (numpy
both sides); the samplers agree within 1e-6 (float32 bilinear weights,
XLA may contract a multiply-add).  ``ModelRenderer``: the hit mask equal
on >= 99.9% of pixels (a ray that grazes a triangle edge may flip on an
ulp of the Möller-Trumbore sums), and on the pixels hit in both the rgb
within 1e-5 and the depth within 1e-5 relative."""

import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import camera as jcam
from nrc_hpm_tpu.models import mesh as jmesh
from nrc_hpm_tpu.models import raster as jraster
from nrc_hpm_tpu.utils import png as jpng
from nrc_hpm_tpu.utils import texture as jtex
from nrc_hpm_tpu_torch import camera as tcam
from nrc_hpm_tpu_torch.models import mesh as tmesh
from nrc_hpm_tpu_torch.models import raster as traster
from nrc_hpm_tpu_torch.utils import png as tpng
from nrc_hpm_tpu_torch.utils import texture as ttex

RNG = np.random.RandomState(11)


# --- PNG ---------------------------------------------------------------------

def _png_bytes(raw: np.ndarray, color_type: int, bit_depth: int,
               filters, palette=None) -> bytes:
    """A PNG of ``raw`` (H, W*bytes-per-pixel) uint8 scanlines with the
    given filter type per row (0-4), encoded as a writer would."""
    h, stride = raw.shape
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    bpp = nch * bit_depth // 8
    prev = np.zeros(stride, np.int32)
    lines = []
    for y in range(h):
        cur = raw[y].astype(np.int32)
        f = filters[y % len(filters)]
        out = np.zeros(stride, np.int32)
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (
                    b if pb <= pc else c)
            out[i] = (cur[i] - pred) & 0xFF
        lines.append(bytes([f]) + out.astype(np.uint8).tobytes())
        prev = cur

    def chunk(ctype, payload):
        body = ctype + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    w = stride // bpp
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    # two IDAT chunks: the decoder joins them
    z = zlib.compress(b"".join(lines))
    return (data + chunk(b"IDAT", z[:len(z) // 2])
            + chunk(b"IDAT", z[len(z) // 2:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("color_type,bit_depth", [
    (0, 8), (0, 16), (2, 8), (2, 16), (3, 8), (4, 8), (6, 8), (6, 16)],
    ids=["gray8", "gray16", "rgb8", "rgb16", "palette", "gray-alpha",
         "rgba8", "rgba16"])
def test_read_png_matches_jax(tmp_path, color_type, bit_depth):
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    h, w = 7, 9
    raw = RNG.randint(0, 256, (h, w * nch * bit_depth // 8)).astype(np.uint8)
    palette = None
    if color_type == 3:
        raw %= 5
        palette = RNG.randint(0, 256, (5, 3))
    path = str(tmp_path / "t.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(raw, color_type, bit_depth, [0, 1, 2, 3, 4],
                           palette))
    got, want = tpng.read_png(path), jpng.read_png(path)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape and np.array_equal(got, want)
    assert got.shape[:2] == (h, w)


@pytest.mark.parametrize("shape,dtype", [
    ((5, 6), np.uint8), ((5, 6, 1), np.uint8), ((5, 6, 3), np.uint8),
    ((5, 6, 4), np.uint8), ((5, 6, 3), np.float32)],
    ids=["2d", "gray", "rgb", "rgba", "float"])
def test_write_png_matches_jax(tmp_path, shape, dtype):
    img = (RNG.rand(*shape) * 1.2 - 0.1).astype(np.float32) \
        if dtype == np.float32 else RNG.randint(0, 256, shape).astype(dtype)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    tpng.write_png(a, img)
    jpng.write_png(b, img)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    back = tpng.read_png(a)
    if dtype == np.uint8:
        assert np.array_equal(back.reshape(img.shape), img)


def test_png_errors(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        tpng.read_png(str(bad))


# --- textures ------------------------------------------------------------------

@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_bilinear_sample_matches_jax(wrap):
    tex = RNG.rand(5, 7, 3).astype(np.float32)
    uv = RNG.uniform(-1.5, 2.5, (64, 2)).astype(np.float32)
    want = np.asarray(jtex.bilinear_sample(jnp.asarray(tex), jnp.asarray(uv),
                                           wrap=wrap))
    got = ttex.bilinear_sample(torch.from_numpy(tex), torch.from_numpy(uv),
                               wrap=wrap).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (64, 3)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("scaled", [True, False], ids=["scale", "no-scale"])
def test_bilinear_sample_layered_matches_jax(wrap, scaled):
    stack = RNG.rand(3, 6, 8, 3).astype(np.float32)
    uv = RNG.uniform(-0.5, 1.5, (8, 9, 2)).astype(np.float32)
    layer = RNG.randint(-1, 4, (8, 9)).astype(np.int32)
    scale = RNG.uniform(0.3, 1.0, (3, 2)).astype(np.float32) \
        if scaled else None
    want = np.asarray(jtex.bilinear_sample_layered(
        jnp.asarray(stack), jnp.asarray(uv), jnp.asarray(layer), wrap=wrap,
        scale=None if scale is None else jnp.asarray(scale)))
    got = ttex.bilinear_sample_layered(
        torch.from_numpy(stack), torch.from_numpy(uv),
        torch.from_numpy(layer), wrap=wrap,
        scale=None if scale is None else torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_load_image_matches_jax(tmp_path):
    img = RNG.randint(0, 256, (4, 5, 4)).astype(np.uint8)
    gray = RNG.randint(0, 256, (4, 5)).astype(np.uint8)
    paths = {}
    for name, a in (("rgba.png", img), ("gray.png", gray)):
        paths[name] = str(tmp_path / name)
        jpng.write_png(paths[name], a)
    paths["t.npy"] = str(tmp_path / "t.npy")
    np.save(paths["t.npy"], RNG.rand(3, 2, 4))
    for p in paths.values():
        got, want = ttex.load_image(p), jtex.load_image(p)
        assert got.dtype == np.float32 and got.shape[-1] == 3
        assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        ttex.load_image(str(tmp_path / "x.bmp"))


# --- OBJ, the cube, flatten_model ------------------------------------------------

def write_textured_model(root, big=(8, 8), small=(4, 6)) -> str:
    """A textured cube as OBJ + MTL + two PNGs of different sizes: the
    +x/-x faces in material ``a`` (``big``), the others in ``b``
    (``small``), one untextured quad in ``c``; faces in every vertex
    format.  Returns the OBJ's path."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(5)
    for name, (h, w) in (("a.png", big), ("b.png", small)):
        jpng.write_png(os.path.join(root, name),
                       rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    with open(os.path.join(root, "m.mtl"), "w") as f:
        f.write("newmtl a\nKd 1.0 0.8 0.6\nmap_Kd a.png\n"
                "newmtl b\nKd 0.5 0.9 1.0\nmap_Kd b.png\n"
                "newmtl c\nKd 0.3 0.6 0.2\n")
    cube = tmesh.make_cube(1.6).meshes[0]
    lines = ["mtllib m.mtl"]
    lines += [f"v {x} {y} {z}" for x, y, z in cube.positions]
    lines += [f"vt {u} {v}" for u, v in cube.uvs]
    lines += [f"vn {x} {y} {z}" for x, y, z in cube.normals]
    for q in range(6):
        lines.append(f"usemtl {'a' if q < 2 else 'b'}")
        c = [4 * q + k + 1 for k in range(4)]
        if q % 3 == 0:
            lines.append("f " + " ".join(f"{i}/{i}/{i}" for i in c))
        elif q % 3 == 1:
            lines.append("f " + " ".join(f"{i}/{i}" for i in c))
        else:
            lines.append("f " + " ".join(f"{i}//{i}" for i in c))
    lines += ["v 0 0 -3", "v 1 0 -3", "v 1 1 -3", "v 0 1 -3", "usemtl c",
              "f 25 26 27 28"]
    path = os.path.join(root, "m.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _same_model(got, want):
    assert len(got.meshes) == len(want.meshes)
    assert np.array_equal(got.transform, want.transform)
    for a, b in zip(got.meshes, want.meshes):
        for k in ("positions", "normals", "uvs", "indices"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        assert np.array_equal(a.material.diffuse_color,
                              b.material.diffuse_color)
        ta, tb = a.material.diffuse_texture, b.material.diffuse_texture
        assert (ta is None) == (tb is None)
        if ta is not None:
            assert np.array_equal(ta, tb)


def test_load_obj_matches_jax(tmp_path, capsys):
    path = write_textured_model(str(tmp_path))
    got, want = tmesh.load_obj(path), jmesh.load_obj(path)
    _same_model(got, want)
    assert [m.indices.shape[0] for m in got.meshes] == [4, 8, 2]
    assert [m.material.diffuse_texture.shape[:2] for m in got.meshes[:2]] \
        == [(8, 8), (4, 6)]
    # a missing texture warns and leaves the material untextured
    os.remove(os.path.join(str(tmp_path), "b.png"))
    got, want = tmesh.load_obj(path), jmesh.load_obj(path)
    _same_model(got, want)
    assert got.meshes[1].material.diffuse_texture is None
    assert "could not load texture" in capsys.readouterr().out


def test_make_cube_matches_jax():
    _same_model(tmesh.make_cube(2.5), jmesh.make_cube(2.5))


def _transform():
    c, s = np.cos(0.6), np.sin(0.6)
    rot = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                    [0, 0, 0, 1]], np.float32)
    rx = np.array([[1, 0, 0, 0], [0, np.cos(0.4), -np.sin(0.4), 0],
                   [0, np.sin(0.4), np.cos(0.4), 0], [0, 0, 0, 1]],
                  np.float32)
    m = rot @ rx @ np.diag([1.2, 0.8, 1.0, 1.0]).astype(np.float32)
    m[:3, 3] = [0.2, -0.1, 0.3]
    return m


def test_flatten_model_matches_jax(tmp_path):
    """Two models share one texture object (deduplicated by identity) and
    a third brings another; normals through the inverse transpose."""
    path = write_textured_model(str(tmp_path))
    tm = tmesh.load_obj(path).transformed(_transform())
    tex_t, tex_j = [], []
    for model in (tm, tm.transformed(np.eye(4, dtype=np.float32) * 2)):
        got = tmesh.flatten_model(model, tex_t, device="cpu")
        want = jmesh.flatten_model(jmesh.Model(model.meshes,
                                               model.transform), tex_j)
        for g, w in zip(got, want):
            assert g.numpy().dtype == np.asarray(w).dtype
            assert np.array_equal(g.numpy(), np.asarray(w))
    assert len(tex_t) == len(tex_j) == 2
    assert all(a is b for a, b in zip(tex_t, tex_j))
    no_list = tmesh.flatten_model(tm, device="cpu")
    assert (no_list[6] == -1).all()


# --- ModelRenderer -------------------------------------------------------------------

def _cams(w, h):
    args = ((0.5, 0.8, 4.0), (-0.1, -0.2, -1.0))
    return (jcam.Camera.create(*args, aspect=w / h),
            tcam.Camera.create(*args, aspect=w / h, device="cpu"))


def _same_render(got, want):
    (timg, tdep), (jimg, jdep) = got, want
    timg, tdep = timg.numpy(), tdep.numpy()
    jimg, jdep = np.asarray(jimg), np.asarray(jdep)
    assert timg.shape == jimg.shape and tdep.shape == jdep.shape
    hit_t, hit_j = timg[..., 3] == 1.0, jimg[..., 3] == 1.0
    assert np.array_equal(np.isfinite(tdep), hit_t)
    agree = hit_t == hit_j
    assert agree.mean() >= 0.999, f"hit mask agrees on {agree.mean():.5f}"
    assert 0.05 < hit_t.mean() < 0.95
    both = hit_t & hit_j
    np.testing.assert_allclose(timg[both], jimg[both], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tdep[both], jdep[both], rtol=1e-5)
    miss = ~hit_t & ~hit_j
    assert np.array_equal(timg[miss], jimg[miss])
    return timg


def test_model_renderer_transformed_cube_matches_jax():
    w, h = 64, 48
    jr = jraster.ModelRenderer(w, h)
    tr = traster.ModelRenderer(w, h, device="cpu")
    for r in (jr, tr):
        r.add_model(tmesh.make_cube(1.5).transformed(_transform()))
    jc, tc = _cams(w, h)
    img = _same_render(tr.render(tc), jr.render(jc))
    # untextured: the white cube's Lambert term, clamped to [0.2, 1]
    lit = img[img[..., 3] == 1.0, :3]
    assert lit.min() >= 0.2 - 1e-6 and lit.max() <= 1.0 + 1e-6


def test_model_renderer_textured_model_matches_jax(tmp_path, monkeypatch):
    """The written OBJ with its two texture sizes and an untextured
    quad, beside a second model that shares the first's textures."""
    path = write_textured_model(str(tmp_path))
    model = tmesh.load_obj(path).transformed(_transform())
    second = model.transformed(np.array(
        [[0.5, 0, 0, 1.4], [0, 0.5, 0, 0.0], [0, 0, 0.5, -0.5],
         [0, 0, 0, 1]], np.float32))
    w, h = 96, 54
    jr = jraster.ModelRenderer(w, h, background=(0.1, 0.2, 0.3))
    tr = traster.ModelRenderer(w, h, background=(0.1, 0.2, 0.3),
                               device="cpu")
    for m in (model, second):
        jr.add_model(jmesh.Model(m.meshes, m.transform))
        tr.add_model(m)
    jc, tc = _cams(w, h)
    got = tr.render(tc)
    _same_render(got, jr.render(jc))
    assert tr._tex_stack[0].shape == (2, 8, 8, 3)
    # the intersection in chunks of 100 pixels: the same result
    monkeypatch.setattr(traster, "CHUNK_ELEMS",
                        100 * tr._tris[0].shape[0])
    small = tr.render(tc)
    assert torch.equal(small[0], got[0]) and torch.equal(small[1], got[1])
    with pytest.raises(ValueError):
        traster.ModelRenderer(4, 4, device="cpu").render(tc)

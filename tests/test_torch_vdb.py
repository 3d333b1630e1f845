"""The port's VDB reader against the JAX package's Python parser, on files
written by ``tests/torch_vdb_writer.py`` (the repository holds no .vdb):
file versions 222 and 223; no compression, zip, and zip with the active
mask (with no, one and two inactive values); with and without the bbox
metadata; root, upper- and lower-node active tiles; several grids.

Tolerance: bitwise.  Both parsers run the same numpy code on the same
bytes, so the dense data, bbox, voxel size, name and metadata must be
equal, and the volumes built from them (the quantized grid and the macro
tables) equal bit for bit.  The errors are the JAX parser's: a non-VDB
file raises ValueError, blosc and unknown tree types NotImplementedError.
"""

import os
import sys

import numpy as np
import pytest
import torch

from nrc_hpm_tpu import config as jcfg
from nrc_hpm_tpu import renderer as jren
from nrc_hpm_tpu.utils.vdb import load_vdb as jload
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch import config as tcfg
from nrc_hpm_tpu_torch import renderer as tren
from nrc_hpm_tpu_torch.utils.vdb import load_vdb as tload
from nrc_hpm_tpu_torch.volume import Volume as TVolume

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_vdb_writer as vw  # noqa: E402

ZIP_MASK = vw.COMPRESS_ZIP | vw.COMPRESS_ACTIVE_MASK
ORIGIN = (-5, 3, 17)


def _data(seed=0, shape=(20, 13, 9)):
    rs = np.random.RandomState(seed)
    return (rs.rand(*shape) * (rs.rand(*shape) > 0.5)).astype(np.float32)


def _variants():
    out = {}
    for version in (222, 223):
        for comp, cname in ((vw.COMPRESS_NONE, "none"),
                            (vw.COMPRESS_ZIP, "zip"),
                            (ZIP_MASK, "zip-mask")):
            for inactive in ((), (0.25,), (0.25, 0.75)):
                key = f"v{version}-{cname}-inactive{len(inactive)}"
                out[key] = (dict(version=version, compression=comp),
                            [vw.Grid(_data(), ORIGIN, inactive=inactive,
                                     voxel_size=0.5)])
    out["no-bbox"] = ({}, [vw.Grid(_data(), ORIGIN, bbox_metadata=False)])
    out["no-bbox-lower-tile"] = ({}, [vw.Grid(
        _data(), ORIGIN, bbox_metadata=False, tiles=((2, (8, 8, 24), 0.5),))])
    out["tiles"] = ({}, [vw.Grid(_data(), ORIGIN, tiles=(
        (0, (-4096, 0, 0), 0.125), (2, (8, 8, 24), 0.5)))])
    out["upper-tile"] = ({}, [vw.Grid(_data(), ORIGIN, tiles=(
        (1, (0, 0, 0), 0.375),))])
    out["v222-tiles"] = (dict(version=222), out["tiles"][1])
    out["grids"] = ({}, [vw.Grid(_data(1, (6, 5, 4)), name="temperature"),
                         vw.Grid(_data(), ORIGIN)])
    return out


VARIANTS = _variants()


def _write(tmp_path, name):
    kw, grids = VARIANTS[name]
    path = str(tmp_path / f"{name}.vdb")
    vw.write_vdb(path, grids, **kw)
    return path


def _same_grid(t, j):
    assert t.name == j.name
    assert t.data.dtype == j.data.dtype == np.float32
    assert t.data.shape == j.data.shape
    assert t.data.tobytes() == j.data.tobytes()
    for a, b in ((t.bbox_min, j.bbox_min), (t.bbox_max, j.bbox_max)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert t.voxel_size == j.voxel_size
    assert t.metadata.keys() == j.metadata.keys()
    for k in t.metadata:
        assert np.array_equal(t.metadata[k], j.metadata[k]), k


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_load_vdb_matches_jax(tmp_path, name):
    path = _write(tmp_path, name)
    t = tload(path)
    _same_grid(t, jload(path, prefer_native=False))
    grids = VARIANTS[name][1]
    if grids[0].bbox_metadata and not grids[0].tiles:
        # what was written comes back: the first float grid, active voxels
        assert t.data.tobytes() == grids[0].data.tobytes()
        assert t.name == grids[0].name
        assert np.array_equal(t.bbox_min, grids[0].origin)
        assert t.voxel_size == grids[0].voxel_size
    assert t.data.sum() > 0


def test_named_grid_matches_jax(tmp_path):
    path = _write(tmp_path, "grids")
    t = tload(path, "density")
    _same_grid(t, jload(path, "density", prefer_native=False))
    assert t.data.tobytes() == _data().tobytes()
    for load in (tload, lambda p, n: jload(p, n, prefer_native=False)):
        with pytest.raises(ValueError, match="no float grid"):
            load(path, "velocity")


def test_tiles_fill_their_boxes(tmp_path):
    """Root, upper and lower tiles cover their boxes, clipped to the
    bbox, in place of the leaves under them."""
    o = np.asarray(ORIGIN)
    g = tload(_write(tmp_path, "tiles")).data
    assert (g[:5] == 0.125).all()                  # x < 0: the root tile
    assert (g[5:] != 0.125).all()
    box = g[8 - o[0]:16 - o[0], 8 - o[1]:16 - o[1], 24 - o[2]:]
    assert box.size and (box == 0.5).all()         # the lower tile
    g = tload(_write(tmp_path, "upper-tile")).data
    assert (g[5:] == 0.375).all()                  # x >= 0: the upper tile
    assert g[:5].tobytes() == _data()[:5].tobytes()


@pytest.mark.parametrize("case", ["not-vdb", "blosc", "tree-5-4-4"])
def test_errors_match_jax(tmp_path, case):
    path = str(tmp_path / f"{case}.vdb")
    if case == "not-vdb":
        with open(path, "wb") as f:
            f.write(b"not an openvdb file at all")
        err = ValueError
    elif case == "blosc":
        vw.write_vdb(path, [vw.Grid(_data())],
                     compression=vw.COMPRESS_BLOSC)
        err = NotImplementedError
    else:
        vw.write_vdb(path, [vw.Grid(_data(), grid_type="Tree_float_5_4_4")])
        err = NotImplementedError
    for load in (tload, lambda p: jload(p, prefer_native=False)):
        with pytest.raises(err):
            load(path)


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    """A 40x27x48 cloud written as the WDAS file is (version 223, zip
    with the active mask) at the scene's relative volume_path."""
    from nrc_hpm_tpu_torch.utils.procedural import cloud_density
    root = tmp_path_factory.mktemp("scene")
    path = root / tcfg.SceneConfig().volume_path
    path.parent.mkdir(parents=True)
    data = cloud_density(seed=0, shape=(40, 27, 48))
    vw.write_vdb(str(path), [vw.Grid(data)])
    return root, str(path), data


def _same_volume(t, j):
    assert np.array_equal(t.grid.numpy(), np.asarray(j.grid))
    for k in ("macro", "macro_min", "sky_size"):
        a, b = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert t.macro_packed.numpy().tobytes() == \
        np.asarray(j.macro_packed).tobytes()
    assert t.density_factor == float(j.density_factor)
    assert t.g == float(j.g)


def test_volume_from_vdb_matches_jax(cloud):
    _, path, data = cloud
    t = TVolume.from_vdb(path, 0.6, 0.8, device="cpu")
    _same_volume(t, JVolume.from_vdb(path, 0.6, 0.8))
    _same_volume(t, JVolume.from_dense(data, 0.6, 0.8))
    assert t.dims == data.shape


def test_volume_from_config_resolves_the_relative_path(cloud, monkeypatch,
                                                       tmp_path):
    root, path, _ = cloud
    monkeypatch.chdir(root)
    t = tren._volume_from_config(tcfg.AppConfig(), device="cpu")
    _same_volume(t, jren._volume_from_config(jcfg.AppConfig()))
    # the renderers load it when given no volume
    r = tren.McRenderer(tcfg.AppConfig(render_width=8, render_height=4),
                        device="cpu")
    assert torch.equal(r.vol.grid, t.grid) and r.device.type == "cpu"
    # from elsewhere the relative path is not found
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        tren._volume_from_config(tcfg.AppConfig(), device="cpu")

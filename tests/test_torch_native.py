"""The port's native VDB decoder (``nrc_hpm_tpu_torch/utils/native.py``
over ``csrc/nrcio.cpp``, built here with the host compiler) against the
port's numpy parser and the JAX package's (``load_vdb(prefer_native=
False)``), on every file of tests/test_torch_vdb.py's writer variants.

Tolerance: bitwise.  Where the decoder parses a file (every variant with
the bbox metadata: versions 222 and 223, no compression, zip, zip with
the active mask and its inactive values, tiles, several grids) the dense
data, the bbox and the voxel size equal both parsers'; like the JAX
package's native path it names the grid "density" and returns no
metadata.  A file it refuses (no bbox metadata, blosc, another tree type,
not a VDB) is parsed in Python, with the parser's result or error.
``NRC_HPM_NATIVE=0`` and ``prefer_native=False`` take the parser; a
decoder that fails to build raises.
"""

import numpy as np
import pytest

from nrc_hpm_tpu.utils.vdb import load_vdb as jload
from nrc_hpm_tpu_torch.ops import _build
from nrc_hpm_tpu_torch.utils import native
from nrc_hpm_tpu_torch.utils.vdb import load_vdb as tload
from test_torch_vdb import VARIANTS, _data, _write, vw

# the variants without the file_bbox metadata, which the decoder refuses
NO_BBOX = {"no-bbox", "no-bbox-lower-tile"}


def _same_data(got, want):
    assert got.data.dtype == want.data.dtype == np.float32
    assert got.data.shape == want.data.shape
    assert got.data.tobytes() == want.data.tobytes()
    for a, b in ((got.bbox_min, want.bbox_min), (got.bbox_max,
                                                 want.bbox_max)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.voxel_size == want.voxel_size


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_native_matches_both_parsers(tmp_path, name):
    path = _write(tmp_path, name)
    got = tload(path)
    for want in (tload(path, prefer_native=False),
                 jload(path, prefer_native=False)):
        _same_data(got, want)
    if name in NO_BBOX:
        with pytest.raises(ValueError, match="missing file_bbox"):
            native.vdb_load_native(path)
        assert got.metadata        # the parser's grid
    else:
        arr, bbox_min, voxel = native.vdb_load_native(path)
        assert arr.tobytes() == got.data.tobytes()
        assert (got.name, got.metadata) == ("density", {})


@pytest.mark.parametrize("case", ["not-vdb", "blosc", "tree-5-4-4"])
def test_refused_files_fall_through_to_the_parser(tmp_path, case):
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
    with pytest.raises(ValueError):
        native.vdb_load_native(path)
    with pytest.raises(err):
        tload(path)
    with pytest.raises(FileNotFoundError):
        tload(str(tmp_path / "absent.vdb"))


def test_the_parser_by_request(tmp_path, monkeypatch):
    """``prefer_native=False``, a ``grid_name`` and ``NRC_HPM_NATIVE=0``
    take the numpy parser: the grid's own name and metadata."""
    path = _write(tmp_path, "grids")
    assert tload(path).name == "density"     # the decoder's name
    for got in (tload(path, prefer_native=False),
                tload(path, "temperature")):
        assert got.name == "temperature" and got.metadata
    monkeypatch.setenv("NRC_HPM_NATIVE", "0")
    assert not native.enabled()
    got = tload(path)
    assert got.name == "temperature" and got.metadata


def test_the_decoder_builds_into_the_build_dir():
    native._lib()
    libs = sorted(_build.BUILD_DIR.glob("libnrcio-*.so"))
    assert libs and all(p.with_suffix(".log").exists() for p in libs)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a decoder that does not build fails the
    load."""
    path = _write(tmp_path, "v223-zip-inactive0")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "compiler_path", lambda: "false")
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="false failed for nrcio"):
            tload(path)
    finally:
        native._lib.cache_clear()

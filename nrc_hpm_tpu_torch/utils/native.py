"""ctypes bindings of the port's native VDB decoder (``csrc/nrcio.cpp``).

Port of ``nrc_hpm_tpu/utils/native.py``.  The JAX package loads a library
built beforehand (``make -C native``) and parses in Python where there is
none; here the host C++ compiler builds ``csrc/nrcio.cpp`` at first use
into ``_build/libnrcio-<hash>.so`` (``ops/_build.compile_shared``: ``-O2
-fPIC -std=c++17 -shared``, linked against zlib's ``libz.so.1``), and a
failed build raises.  ``NRC_HPM_NATIVE=0`` turns the decoder off, and
``utils/vdb.load_vdb`` then parses in Python.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import numpy as np

from ..ops import _build

FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-l:libz.so.1",)


def enabled() -> bool:
    """False where ``NRC_HPM_NATIVE=0`` asks for the Python parser."""
    return os.environ.get("NRC_HPM_NATIVE", "1") != "0"


def compiler_path() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++): the native VDB decoder "
                       "cannot be built")


@functools.cache
def _lib() -> ctypes.CDLL:
    so = _build.compile_shared(_build.CSRC / "nrcio.cpp", compiler_path(),
                               FLAGS, LIBS)
    lib = ctypes.CDLL(str(so))
    lib.nrcio_vdb_load.restype = ctypes.c_int
    lib.nrcio_vdb_load.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.nrcio_last_error.restype = ctypes.c_char_p
    lib.nrcio_last_error.argtypes = []
    lib.nrcio_free.restype = None
    lib.nrcio_free.argtypes = [ctypes.c_void_p]
    return lib


def vdb_load_native(path: str):
    """The first ``Tree_float_5_4_3`` grid of ``path`` as (dense [X, Y, Z]
    float32 over its ``file_bbox``, bbox_min (3,) int32, voxel size).
    Raises ValueError on a file the decoder does not parse (callers fall
    back to the numpy parser explicitly)."""
    lib = _lib()
    data = ctypes.POINTER(ctypes.c_float)()
    dims = (ctypes.c_int64 * 3)()
    bbox_min = (ctypes.c_int32 * 3)()
    voxel = ctypes.c_double()
    rc = lib.nrcio_vdb_load(os.fsencode(path), ctypes.byref(data), dims,
                            bbox_min, ctypes.byref(voxel))
    if rc != 0:
        raise ValueError(
            f"nrcio_vdb_load failed: {lib.nrcio_last_error().decode()}")
    shape = (dims[0], dims[1], dims[2])
    try:
        arr = np.ctypeslib.as_array(
            data, shape=(shape[0] * shape[1] * shape[2],)).reshape(
                shape).copy()
    finally:
        lib.nrcio_free(data)
    return arr, np.array(bbox_min[:], np.int32), float(voxel.value)

"""Build the CUDA sources in ``csrc/`` with nvcc and load them via ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` for ``sm_90a``, keyed by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, at the first call
that needs it.  Importing this module
needs no ``nvcc``; asking for a library without one raises.  The nvcc
output (with ``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``.log``.  ``compile_shared`` also builds the host
C++ VDB decoder (``utils/native.py``) the same way.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str, extra_flags: tuple = ()) -> Path:
    """Build ``csrc/<name>.cu`` if its hashed library is missing."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return compile_shared(CSRC / f"{name}.cu", nvcc_path(),
                          FLAGS + tuple(extra_flags), salt=headers)


def compile_shared(src: Path, compiler: str, flags: tuple, libs: tuple = (),
                   salt: bytes = b"") -> Path:
    """``_build/lib<stem>-<hash>.so`` of ``src``, compiled by ``compiler``
    with ``flags`` (linked against ``libs``) unless it exists, keyed by a
    hash of the source, ``salt`` and the flags.  The compiler's output is
    kept beside it as ``.log``; a failed build raises."""
    digest = hashlib.sha256(src.read_bytes() + salt + " ".join(
        flags + libs).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([compiler, *flags, "-o", str(tmp), str(src),
                          *libs], capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed for "
                           f"{src.name}:\n{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def load(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use).
    Every library exports ``const char* <name>_error_string(int)``."""
    lib = ctypes.CDLL(str(library_path(name, extra_flags)))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch function returned a non-zero cudaError_t."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> int:
    """The current stream of ``device`` (a ``cudaStream_t``, for a
    ``c_void_p`` argument), read without building a ``torch.cuda.Stream``
    (0.1 us a call against 5-7 on the H100's host)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def on_card(name: str, device: torch.device) -> bool:
    """True to launch the kernel (a CUDA tensor), False to run the plain
    version (a CPU tensor); any other device raises."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return True


def require_cuda(name: str, tensors: dict, device: torch.device) -> None:
    """Every tensor must be a contiguous tensor on ``device``."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def require(name: str, cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")

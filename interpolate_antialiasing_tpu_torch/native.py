"""Build and load the port's CUDA kernels.

``csrc/*.cu`` hold the kernels behind a plain C interface (no PyTorch
headers, so ``nvcc`` compiles them in seconds).  :func:`build` compiles them
at first use into ``_build/<hash of the sources and flags>/`` beside this
file and loads the result with ``ctypes``; a later call, or a later process
on the same checkout, reuses the library.  Nothing is fetched: the sources
are the package's own and the compiler is the local CUDA toolkit's.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_LIB_NAME = "libia_torch_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> (restype, argtypes) of every C entry point the wrappers call
_SIGNATURES = {
    "ia_pil_resample_tile_w": (_I, []),
    # x, out, B, H, W, OH, OW, xmin_w, wb_w, ntaps_w, ymin_h, wb_h, ntaps_h,
    # pb, tile_h, rows_cap, stream
    "ia_pil_resample_2pass": (
        _I, [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I,
             _P]),
}


def _nvcc() -> str | None:
    """The CUDA toolkit's compiler: on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    return None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / h.hexdigest()[:16] / _LIB_NAME


def _compile(lib: Path) -> None:
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the port's "
            "CUDA kernels are built from interpolate_antialiasing_tpu_torch/"
            "csrc at first use and need the CUDA toolkit"
        )
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent first uses of one
    # checkout never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)


@functools.cache
def build() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` if this checkout has no library for the current
    sources yet, load it and declare its entry points.  Raises RuntimeError
    when ``nvcc`` is missing or fails."""
    lib_path = _lib_path()
    if not lib_path.exists():
        _compile(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib

"""Build and load the port's CUDA kernels, and its host weight-table builder.

``csrc/*.cu`` hold the kernels behind a plain C interface (no PyTorch
headers, so ``nvcc`` compiles them in seconds).  :func:`build` compiles them
at first use into ``_build/<hash of the sources and flags>/`` beside this
file — one ``nvcc`` per source, all started together, then one link — and
loads the result with ``ctypes``; a later call, or a later process on the
same checkout, reuses the library.  What ``ptxas -v`` reports for every
kernel (registers, shared memory, spills) is kept beside the library in
``nvcc.log`` (:func:`ptxas_log`).  Nothing is fetched: the sources are the
package's own and the compiler is the local CUDA toolkit's.

Every launch of a hand-written kernel goes through :func:`launch` (or
:func:`launch_planes`, which splits a batch past the grid's limit): its
``ia.native.<name>`` span, the call, the check of the CUDA error it
returns and its count in :data:`launches`, by the kernel's name.  The C
ABI's dtype codes are :data:`DTYPES`.

:func:`compute_tables_native` is the JAX package's ``native`` module: the
float64 weight tables of ``ops.weights.compute_tables`` built by
``csrc/aa_tables.cpp`` (the port's copy) with the host C++ compiler, at
first use, into ``_build/`` beside the kernels.  It is a host tool, so it
runs wherever a C++ compiler does, and returns None where none does (or
under ``IA_TPU_NO_NATIVE``).  ``config.enable_compilation_cache`` moves
``_build/`` for both libraries.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .utils.trace import span

__all__ = ["build", "launch", "launch_planes", "occupancy", "launches", "KERNELS", "DTYPES",
           "GRID_LIMIT", "plane_chunks", "ptxas_log", "NVCC_FLAGS", "FILTER_IDS",
           "native_available", "compute_tables_native"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_LIB_NAME = "libia_torch_kernels.so"
_LOG_NAME = "nvcc.log"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> (restype, argtypes) of every C entry point the wrappers call
_SIGNATURES = {
    # x, out, B, H, W, OH, OW, xmin_w, wb_w, ntaps_w, ymin_h, wb_h, ntaps_h,
    # pb, tile_r, tile_c, rows_cap, cols_cap, chunk, smem, stream
    "ia_pil_resample_2pass": (
        _I, [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I]
        + [_I] * 6 + [_P]),
    # ntaps_w, ntaps_h, tile_r, tile_c, rows_cap, cols_cap, chunk, smem, &blocks
    "ia_pil_resample_2pass_occupancy": (_I, [_I] * 8 + [_P]),
    # x, out, in_dt, out_dt, B, H, W, OH, OW, xmin_w, w_w, ntaps_w, ymin_h,
    # w_h, ntaps_h, quant, tile_r, tile_c, rows_cap, cols_cap, chunk, smem,
    # stream
    "ia_resample2d": (
        _I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I,
             _I, _I, _I, _I, _I, _I, _P]),
    # in_dt, out_dt, ntaps_w, ntaps_h, tile_r, tile_c, rows_cap, cols_cap,
    # chunk, smem, &blocks (one each for the table and the fused kernel)
    "ia_resample2d_occupancy": (_I, [_I] * 10 + [_P]),
    "ia_resample2d_fused_occupancy": (_I, [_I] * 10 + [_P]),
    # x, out, in_dt, out_dt, B, H, W, OH, OW, xmin_w, w_w, ymin_h, w_h, ntaps,
    # seg, stages, cols_cap, smem, stream
    "ia_resample2d_stream": (_I, [_P, _P] + [_I] * 7 + [_P] * 4 + [_I] * 5 + [_P]),
    # in_dt, out_dt, ntaps, seg, stages, cols_cap, smem, &blocks
    "ia_resample2d_stream_occupancy": (_I, [_I] * 7 + [_P]),
    # x, out, in_dt, out_dt, outer, n_in, inner, n_out, xmin, w, ntaps, win0,
    # then the plan (tile_j, tile_o, tile_i, win, vec, smem), stream
    "ia_resample_axis": (
        _I, [_P, _P, _I, _I, _L, _I, _L, _I, _P, _P, _I, _P] + [_I] * 6 + [_P]),
    # fused, in_dt, out_dt, ntaps, vec, smem, &blocks
    "ia_resample_axis_occupancy": (_I, [_I] * 6 + [_P]),
    # x, out, in_dt, out_dt, B, H, W, OH, OW, &spec_w, &spec_h, quant, tile_r,
    # tile_c, rows_cap, cols_cap, chunk, smem, stream (spec: ia::Synth,
    # csrc/ia_taps.cuh)
    "ia_resample2d_fused": (
        _I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, _P]),
    # x, out, in_dt, out_dt, outer, n_in, inner, n_out, &spec, win0, the plan,
    # stream
    "ia_resample_axis_fused": (
        _I, [_P, _P, _I, _I, _L, _I, _L, _I, _P, _P] + [_I] * 6 + [_P]),
    # x, out, in_dt, out_dt, N, R, n_in, inner, n_out, first, w, T, pb, cnt,
    # boxes, axis, filter, support, antialias, k, align, hi_start, flip, then
    # the plan (tile_j, tile_o, tile_i, win, vec, smem), stream
    "ia_crop_pass": (
        _I, [_P, _P, _I, _I, _I, _L, _I, _L, _I, _P, _P, _I, _I, _P, _P, _I, _I,
             ctypes.c_float, _I, _I, _I, _I, _P] + [_I] * 6 + [_P]),
    # boxes, N, filter, support, antialias, then per axis (H, W) in_size,
    # out_size, k, align, hi_start, T, pb, lanes, blocks, first, cnt, w;
    # flip_w, stream
    "ia_crop_tables": (
        _I, [_P, _I, _I, ctypes.c_float, _I] + ([_I] * 9 + [_P] * 3) * 2 + [_P, _P]),
    # x, out, outer, n_in, inner, n_out, xmin, wb, ntaps, pb, win0, the plan,
    # stream
    "ia_pil_resample_axis": (
        _I, [_P, _P, _L, _I, _L, _I, _P, _P, _I, _I, _P] + [_I] * 6 + [_P]),
    # ntaps, vec, smem, &blocks
    "ia_pil_resample_axis_occupancy": (_I, [_I] * 3 + [_P]),
    # x, out, in_dt, out_dt, N, C, H, W, the input's strides sn, sc, sh,
    # mean, std, scale, blocks, stream
    "ia_normalize": (_I, [_P, _P] + [_I] * 6 + [_L] * 3 + [_P, _P, ctypes.c_float, _I, _P]),
    # blocks, threads, stream (an empty kernel: utils/timing.launch_floor_ms)
    "ia_launch_floor": (_I, [_I, _I, _P]),
}


# dtype codes of the C entry points (csrc/ia_dtypes.cuh::DType)
DTYPES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}
# Every block of a launch is on gridDim.x, whose limit this is.
GRID_LIMIT = 2**31 - 1
# The hand-written kernels the routes launch, by the names of their
# ia.native spans and of their launch counts.
KERNELS = ("pil_resample_2pass", "resample2d", "resample2d_stream", "resample_axis",
           "crop_tables", "crop_resample", "crop_f32", "pil_resample_axis",
           "resample2d_fused", "resample_axis_fused", "normalize")
# Launches of each kernel in this process: :func:`launch` adds one per
# launch and nowhere else, so a run can show that its main path went
# through the kernels (utils.inspect.launch_counts reads a copy).
launches = dict.fromkeys(KERNELS, 0)


def plane_chunks(n: int, max_per_launch: int) -> list[tuple[int, int]]:
    """``(start, count)`` launches that cover ``n`` planes with at most
    ``max_per_launch`` planes each: the wrappers split a batch whose grid
    would pass a grid-dimension limit into several launches."""
    if max_per_launch < 1:
        raise ValueError(f"max_per_launch must be >= 1, got {max_per_launch}")
    return [(s, min(max_per_launch, n - s)) for s in range(0, n, max_per_launch)]


def stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream, as the C entry points
    take it."""
    return torch.cuda.current_stream(dev).cuda_stream


def launch(name: str, dev: torch.device, *args, entry: str | None = None) -> None:
    """One launch of the kernel ``name`` on ``dev``'s current stream: the
    C entry point ``entry`` (by default ``ia_<name>``) with ``args`` and
    the stream, inside ``span("ia.native.<name>")``.  Raises RuntimeError
    where it returns a CUDA error, and counts nothing then; else adds one
    to ``launches[name]`` where ``name`` is one of :data:`KERNELS` (the
    empty kernel that ``utils.timing.launch_floor_ms`` times is none)."""
    with torch.cuda.device(dev), span(f"ia.native.{name}"):
        err = getattr(build(), entry or f"ia_{name}")(*args, stream(dev))
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        if name in launches:
            launches[name] += 1


def launch_planes(name: str, x: torch.Tensor, plane: tuple, dtype: torch.dtype,
                  blocks_per_plane: int, head: tuple, tail: tuple) -> torch.Tensor:
    """The kernel ``name`` over the planes of the contiguous ``x[B, ...]``
    into a new ``out[B, *plane]`` of ``dtype``, returned: a kernel whose
    grid has ``blocks_per_plane`` blocks per plane, in as few
    :func:`launch` calls as keep each grid within :data:`GRID_LIMIT`
    (:func:`plane_chunks`; none for an empty batch), each over planes
    ``[b0, b0 + n)`` as ``entry(x + b0 planes, out + b0 planes, *head, n,
    *tail, stream)``."""
    out = torch.empty((x.shape[0], *plane), dtype=dtype, device=x.device)
    sx, so = x.stride(0) * x.element_size(), out.stride(0) * out.element_size()
    for b0, n in plane_chunks(x.shape[0], GRID_LIMIT // blocks_per_plane):
        launch(name, x.device, x.data_ptr() + b0 * sx, out.data_ptr() + b0 * so, *head, n,
               *tail)
    return out


def occupancy(entry: str, *args) -> int:
    """Resident blocks per SM of a kernel on the current card, as its C
    occupancy query ``entry`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
    gives it for ``args``.  Launches nothing and counts nothing; raises
    RuntimeError where the query returns a CUDA error."""
    blocks = ctypes.c_int(0)
    err = getattr(build(), entry)(*args, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{entry} query failed: cudaError {err}")
    return blocks.value


def _cuda_tool(name: str) -> str | None:
    """A program of the CUDA toolkit (or the host's): on PATH, else under
    CUDA_HOME/bin."""
    found = shutil.which(name)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / name).exists():
        return str(Path(CUDA_HOME) / "bin" / name)
    return None


def _nvcc() -> str | None:
    """The CUDA toolkit's compiler: on PATH, else under CUDA_HOME."""
    return _cuda_tool("nvcc")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):  # kernels and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / h.hexdigest()[:16] / _LIB_NAME


def _run_all(cmds: list[list[str]]) -> list[tuple[str, float]]:
    """Run the commands at once; raise with the first failure's output, else
    return each one's output and its seconds from the common start."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs: list = [None] * len(procs)

    def wait(i):
        outs[i] = (procs[i].communicate()[0], time.perf_counter() - t0)

    threads = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for cmd, proc, (out, _) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def _compile(lib: Path) -> None:
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the port's "
            "CUDA kernels are built from interpolate_antialiasing_tpu_torch/"
            "csrc at first use and need the CUDA toolkit"
        )
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile into a private directory, then rename the library into place:
    # concurrent first uses of one checkout never load a half-written library
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                         for src, obj in zip(_sources(), objs)])
        out = str(Path(tmp) / _LIB_NAME)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs]])
        log = Path(tmp) / _LOG_NAME
        log.write_text("".join(f"== {src.name} ({sec:.1f} s)\n{text}"
                               for src, (text, sec) in zip(_sources(), logs)))
        os.replace(log, lib.parent / _LOG_NAME)
        os.replace(out, lib)


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


def ptxas_log() -> str:
    """What ``nvcc -Xptxas -v`` reported when :func:`build` compiled the
    current sources (``== <source> (<seconds> s)`` before each file's
    lines: its compile time, all started together); empty where
    this checkout has not built them."""
    log = _lib_path().parent / _LOG_NAME
    return log.read_text() if log.exists() else ""


def _use_build_dir(path: Path) -> None:
    """Build and look for both libraries under ``path`` from now on (the
    next :func:`build` or table call loads from there)."""
    global _BUILD_DIR
    _BUILD_DIR = Path(path)
    build.cache_clear()
    _tables_lib.cache_clear()


# ---------------------------------------------------------------------------
# The host weight-table builder (csrc/aa_tables.cpp)
# ---------------------------------------------------------------------------

FILTER_IDS = {
    "bilinear": 0,
    "linear": 0,
    "triangle": 0,
    "box": 1,
    "nearest": 1,
    "bicubic": 2,
    "cubic": 2,
    "lanczos3": 3,
    "bicubic075": 4,
    "hamming": 5,
}

_TABLES_SRC = _CSRC / "aa_tables.cpp"
_TABLES_LIB_NAME = "libaa_tables.so"
_HOST_FLAGS = ("-O3", "-shared", "-fPIC")


def _tables_lib_path() -> Path:
    h = hashlib.sha256(" ".join(_HOST_FLAGS).encode())
    h.update(_TABLES_SRC.read_bytes())
    return _BUILD_DIR / f"aa_tables-{h.hexdigest()[:16]}" / _TABLES_LIB_NAME


def _build_tables(lib: Path) -> bool:
    """Compile the table builder with the first host C++ compiler that
    succeeds, into a temporary name beside ``lib``, then rename it into
    place: processes that build at once each load a whole library.  False
    where no compiler builds it."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    for cc in ("c++", "g++", "clang++"):
        if shutil.which(cc) is None:
            continue
        fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so.tmp")
        os.close(fd)
        try:
            proc = subprocess.run([cc, *_HOST_FLAGS, str(_TABLES_SRC), "-o", tmp],
                                  capture_output=True, timeout=120)
            if proc.returncode == 0:
                os.replace(tmp, lib)
                return True
        except (OSError, subprocess.SubprocessError):
            continue
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return False


@functools.cache
def _tables_lib() -> ctypes.CDLL | None:
    lib_path = _tables_lib_path()
    if not lib_path.exists() and not _build_tables(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    lib.aa_ntaps.restype = ctypes.c_int32
    lib.aa_ntaps.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                             ctypes.c_int32, ctypes.c_int32]
    lib.aa_compute_tables_v2.restype = None
    lib.aa_compute_tables_v2.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, _P, _P, _P]
    return lib


def native_available() -> bool:
    """Whether :func:`compute_tables_native` builds tables here: a host C++
    compiler built (or had built) the library, and ``IA_TPU_NO_NATIVE`` is
    not set."""
    return not os.environ.get("IA_TPU_NO_NATIVE") and _tables_lib() is not None


def compute_tables_native(
    in_size: int,
    out_size: int,
    mode: str,
    antialias: bool = True,
    align_corners: bool = False,
):
    """Native float64 tables ``(xmin[out] int32, size[out] int32,
    weights[out, ntaps] float64)`` of ``ops.weights.compute_tables`` for the
    spec of these arguments, or None where :func:`native_available` is
    false.  ``mode`` is one of :data:`FILTER_IDS`."""
    if not native_available():
        return None
    lib = _tables_lib()
    # Same mode/border mapping as ops.weights.make_axis_spec: the classic
    # (non-AA) bicubic is Keys a=-0.75 with replicate borders.
    if not antialias and FILTER_IDS.get(mode) == 2:
        mode = "bicubic075"
    border = 0 if antialias else 1
    fid = FILTER_IDS[mode]
    ntaps = lib.aa_ntaps(in_size, out_size, fid, int(antialias), int(align_corners))
    xmin = np.empty(out_size, np.int32)
    size = np.empty(out_size, np.int32)
    w = np.empty((out_size, ntaps), np.float64)
    lib.aa_compute_tables_v2(in_size, out_size, fid, int(antialias), int(align_corners),
                             border, xmin.ctypes.data, size.ctypes.data, w.ctypes.data)
    return xmin, size, w

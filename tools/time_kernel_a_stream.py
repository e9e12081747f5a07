"""Kernel A's float route at BASELINE config 5 (bf16 [64, 3, 2160, 3840] ->
1080x1920, bilinear): where the tile kernel's time goes, and the streaming
kernel beside it.

    python3 tools/time_kernel_a_stream.py [--sweep] [--gate] [--out FILE]

Builds, apart from the port's library and in seconds rather than minutes,
small libraries from the checkout's sources with the CUDA toolkit's ``nvcc``
(into ``interpolate_antialiasing_tpu_torch/_build/tools/``):

  * the tile kernel ``resample2d_kernel<bf16, bf16, TableTaps, 128, 8>``
    (csrc/resample2d.cuh) as it is (``whole``); with its multiply-adds and
    stores compiled out (``copy_only``: ``with_taps`` defined away, so a
    block stages its weights and row window, waits for it and syncs, and
    reads every byte it reads in the whole kernel); and with its copies
    compiled out (``math_only``: ``cp_async16`` defined away, so it
    computes on whatever shared memory holds and writes every output);
  * csrc/resample2d_stream.cu, the streaming kernel, as it is, without its
    multiply-adds (``mac`` defined away: its copies, its walk's control and
    its stores remain) and without its copies.

It holds the streaming kernel against the plain version
(``cuda_resize._resample2d_plain``) on the card, bit for bit: config 5 at
its plan, config 5 at batch 4 and f32, u8 -> f32 and bicubic cases with
ragged strips, odd row widths and a plane off 16 bytes, each at every
candidate of ``_stream_candidates``.  Then it times, by CUDA events over
back-to-back launches on two alternating inputs (3.19 GB each, 64 times
the L2), every variant at its plan, twice in turns, and the bicubic
streaming kernel, beside the bytes bound (the frames read once and written
once over 3.35 TB/s); it also writes the streaming kernel's SASS and a
count of its opcodes.  ``--sweep`` times the streaming kernel at every
candidate of its plan (bf16 and f32); ``--gate`` builds the port's library
and times its tile and streaming kernels, each at its own plan, at the
shapes around the plan's gate (``GATE_CASES``).  Prints one JSON line per
reading, with the card's name and power limit, and writes them to
``--out``.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_MS = 3.35e9  # H100 SXM HBM3 peak, bytes per millisecond

# The tile kernel's one instantiation at config 5, with a C entry over the
# plan's arguments; PHASES puts each variant's definitions before it.
_TILE_SRC = """
#include "ia_dtypes.cuh"
{phase}
#define IA_R2D_TC 128
#include "resample2d.cuh"

extern "C" int tile_launch(const void* x, void* out, int B, int H, int W, int OH, int OW,
                           const void* xmin_w, const void* w_w, int ntaps_w,
                           const void* ymin_h, const void* w_h, int ntaps_h, int tile_r,
                           int rows_cap, int cols_cap, int chunk, int smem, void* stream) {{
  using namespace ia;
  using namespace ia::r2d;
  const TableTaps tw{{(const int*)xmin_w, (const float*)w_w, ntaps_w}};
  const TableTaps th{{(const int*)ymin_h, (const float*)w_h, ntaps_h}};
  const Plan2d p{{H, W, OH, OW, 0, tile_r, (OH + tile_r - 1) / tile_r, (OW + 127) / 128,
                 rows_cap, cols_cap, chunk, ntaps_w, ntaps_h}};
  const Args2d<TableTaps> a{{x, out, tw, th, p, 128, smem, (cudaStream_t)stream,
                            (unsigned)(B * p.n_ty * p.n_tx), nullptr}};
  return run_tc<__nv_bfloat16, __nv_bfloat16, TableTaps, 128, 8>(a);
}}
"""
PHASES = {
    "whole": "",
    "copy_only": (
        "namespace ia { template <int LO, int HI, typename F>\n"
        "__device__ __forceinline__ void with_taps_off(int, F&&) {} }\n"
        "#define with_taps with_taps_off"),
    "math_only": "#define cp_async16(s, g) ((void)(s), (void)(g))",
}
# The streaming kernel's variants: without its multiply-adds (``mac`` defined
# away, so its loads of staged rows fall away too: copies, the walk's
# control and the stores remain), and without its copies.
_STREAM_SRC = """
#include "ia_dtypes.cuh"
{phase}
#include "resample2d_stream.cu"
"""
STREAM_PHASES = {
    "copy_only": "#define mac(acc, w, x) (acc)",
    "math_only": PHASES["math_only"],
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_TILE_ARGS = [_P, _P] + [_I] * 5 + [_P, _P, _I, _P, _P, _I] + [_I] * 5 + [_P]


def _build(out_dir: Path) -> dict:
    """Compile the four libraries at once; their paths, and each source's
    ``ptxas -v`` lines."""
    from interpolate_antialiasing_tpu_torch import native

    nvcc = native._nvcc()
    if nvcc is None:
        raise SystemExit("time_kernel_a_stream: needs nvcc")
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = native._CSRC
    jobs = {}
    for name, phase in PHASES.items():
        src = out_dir / f"tile_{name}.cu"
        src.write_text(_TILE_SRC.format(phase=phase))
        jobs[f"tile_{name}"] = src
    jobs["stream"] = csrc / "resample2d_stream.cu"
    for name, phase in STREAM_PHASES.items():
        src = out_dir / f"stream_{name}.cu"
        src.write_text(_STREAM_SRC.format(phase=phase))
        jobs[f"stream_{name}"] = src
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [nvcc, *native.NVCC_FLAGS, "-I", str(csrc), "-shared", "-o",
         str(out_dir / f"lib{k}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, src in jobs.items()}
    logs = {}
    for k, p in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc {k} failed:\n{text}")
        logs[k] = [ln.strip() for ln in text.splitlines()
                   if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return {"seconds": round(time.perf_counter() - t0, 1), "ptxas": logs,
            "libs": {k: str(out_dir / f"lib{k}.so") for k in jobs}}


def _sass(lib: str, out_dir: Path, emit) -> None:
    """The streaming kernel's bf16 -> bf16 SASS in its 4-tap bucket
    (``cuobjdump -sass``) into ``out_dir``, and a count of its opcodes."""
    from collections import Counter

    from interpolate_antialiasing_tpu_torch import native

    tool = native._cuda_tool("cuobjdump")
    if tool is None:
        return
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300).stdout
    parts = text.split("Function : ")
    body = next((p for p in parts if p.startswith(
        "_ZN2ia3r2d6stream24resample2d_stream_kernelI13__nv_bfloat16S3_Li4E")), "")
    (out_dir / "stream_bf16_nt4.sass").write_text(body)
    ops = Counter()
    for ln in body.splitlines():
        if ln.strip().startswith("/*") and ";" in ln:
            words = ln.split("*/", 1)[1].split()
            if words:
                ops[(words[1] if words[0].startswith("@") else words[0]).split(".")[0]] += 1
    emit(phase="sass", kernel="stream bf16 nt4", instructions=sum(ops.values()),
         opcodes=dict(ops.most_common(30)))


# (name, planes, [H, W] -> [OH, OW], mode, dtype) around the plan's gate
GATE_CASES = [
    ("config5 b64", 192, (2160, 3840), (1080, 1920), "bilinear", "bfloat16"),
    ("config5 b4", 12, (2160, 3840), (1080, 1920), "bilinear", "bfloat16"),
    ("config5 b1", 3, (2160, 3840), (1080, 1920), "bilinear", "bfloat16"),
    ("config5 b64 bicubic", 192, (2160, 3840), (1080, 1920), "bicubic", "bfloat16"),
    ("config5 b16 f32", 48, (2160, 3840), (1080, 1920), "bilinear", "float32"),
    ("headline b64 f32", 192, (438, 906), (196, 320), "bilinear", "float32"),
    # long enough for the streaming plan, with tile plans of 5.8-7.8 waves
    ("config5 b2 bicubic u8", 6, (2160, 3840), (1080, 1920), "bicubic", "uint8"),
    ("512->224 b64 u8", 192, (512, 512), (224, 224), "bilinear", "uint8"),
    ("128->64 b1024 u8", 3072, (128, 128), (64, 64), "bilinear", "uint8"),
    ("128->64 b1024 bf16", 3072, (128, 128), (64, 64), "bilinear", "bfloat16"),
    ("64->32 b2048 f32", 6144, (64, 64), (32, 32), "bilinear", "float32"),
    ("720p->360p b16 bicubic u8", 48, (720, 1280), (360, 640), "bicubic", "uint8"),
]


def _gate(emit, dev, rand) -> None:
    """The port's tile kernel and streaming kernel, each at its own plan,
    in turns, at GATE_CASES: device ms by CUDA events over back-to-back
    launches, both held to the plain version first."""
    import torch

    from interpolate_antialiasing_tpu_torch.config import full_f32
    from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
    from interpolate_antialiasing_tpu_torch.ops import plans
    from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec

    n_sm = plans.n_sm(dev)
    for name, planes, (H, W), (OH, OW), mode, dt in GATE_CASES:
        dtype = getattr(torch, dt)
        sh, sw = make_axis_spec(H, OH, mode), make_axis_spec(W, OW, mode)
        isz = torch.empty(0, dtype=dtype).element_size()
        tile = plans.plan2d(sh, sw, isz, planes, n_sm)
        stream = plans.plan2d_stream(sh, sw, isz, planes, n_sm) or plans.plan2d_stream(
            sh, sw, isz, 4096, n_sm)  # under the gate: the plan at more planes
        picked = type(cr.resize2d_plan(sh, sw, isz, planes, n_sm)).__name__
        x3 = rand((planes, H, W), dtype, 31)
        with full_f32():
            want = cr._resample2d_plain(x3, sh, sw, dtype)
        calls = {"tile": lambda: cr._resample2d_cuda(x3, sh, sw, dtype, tile),
                 "stream": lambda: cr._resample2d_stream_cuda(x3, sh, sw, dtype, stream)}
        for k, fn in calls.items():
            if not torch.equal(fn(), want):
                raise SystemExit(f"gate {name}: {k} kernel != plain version")
        del want
        ms = {"tile": [], "stream": []}
        for k in ("tile", "stream", "stream", "tile"):
            for _ in range(2):
                calls[k]()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(10):
                calls[k]()
            b.record()
            torch.cuda.synchronize()
            ms[k].append(a.elapsed_time(b) / 10)
        emit(phase="gate", case=name, picked=picked, tile_plan=tile._asdict(),
             stream_plan=stream._asdict(), tile_ms=ms["tile"], stream_ms=ms["stream"])
        del x3
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time the streaming kernel at every candidate of its plan")
    ap.add_argument("--gate", action="store_true",
                    help="also build the port's library and time its tile and streaming "
                         "kernels at the shapes around the plan's gate")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "time_kernel_a_stream.jsonl"))
    args = ap.parse_args()
    import numpy as np
    import torch

    from interpolate_antialiasing_tpu_torch import native
    from interpolate_antialiasing_tpu_torch.config import full_f32
    from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
    from interpolate_antialiasing_tpu_torch.ops import plans
    from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec

    if not torch.cuda.is_available():
        raise SystemExit("time_kernel_a_stream: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    lines = []
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    def emit(**fields):
        line = json.dumps({"card": card, **fields})
        print(line, flush=True)
        lines.append(line)
        out_path.write_text("".join(ln + "\n" for ln in lines))

    built = _build(native._BUILD_DIR / "tools")
    emit(phase="build", seconds=built["seconds"], ptxas=built["ptxas"])
    libs = {k: ctypes.CDLL(v) for k, v in built["libs"].items()}
    for k in PHASES:
        fn = getattr(libs[f"tile_{k}"], "tile_launch")
        fn.restype, fn.argtypes = _I, _TILE_ARGS
    for k in ["stream", *(f"stream_{n}" for n in STREAM_PHASES)]:
        for name, (restype, argtypes) in native._SIGNATURES.items():
            if name.startswith("ia_resample2d_stream"):
                fn = getattr(libs[k], name)
                fn.restype, fn.argtypes = restype, argtypes
    stream_lib = libs["stream"]
    _sass(built["libs"]["stream"], out_path.parent, emit)
    n_sm = plans.n_sm(dev)
    dt_code = native.DTYPES

    def stream_call(x3, sh, sw, odt, plan, lib=None):
        B, H, W = x3.shape
        out = torch.empty((B, sh.out_size, sw.out_size), dtype=odt, device=dev)
        (xw, ww) = plans.stream_tables_on(sw, plan.ntaps, dev)
        (xh, wh) = plans.stream_tables_on(sh, plan.ntaps, dev)
        err = (lib or stream_lib).ia_resample2d_stream(
            x3.data_ptr(), out.data_ptr(), dt_code[x3.dtype], dt_code[odt], B, H, W,
            sh.out_size, sw.out_size, xw.data_ptr(), ww.data_ptr(), xh.data_ptr(),
            wh.data_ptr(), plan.ntaps, plan.seg, plan.stages, plan.cols_cap, plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"resample2d_stream launch failed: cudaError {err}")
        return out

    def candidates(x3, sh, sw, planes=None):
        nt = plans._stream_ntaps(sh, sw)
        th, tw = plans.stream_tables(sh, nt), plans.stream_tables(sw, nt)
        return list(dict.fromkeys(p for _, p in plans._stream_candidates(
            th[0], sh.in_size, tw[0], sw.in_size, nt, x3.element_size(),
            planes or x3.shape[0], n_sm)))

    def rand(shape, dtype, seed, offset=0):
        g = torch.Generator(device=dev).manual_seed(seed)
        n = int(np.prod(shape)) + offset
        return (torch.rand(n, device=dev, generator=g) * 255).to(dtype)[offset:].view(shape)

    # 1. bit for bit against the plain version, at every candidate (the
    #    small cases go under the plan's gate: its candidates are forced)
    cases = [
        ("c5_b4_bf16", (12, 2160, 3840), (1080, 1920), "bilinear", torch.bfloat16,
         torch.bfloat16, 0),
        ("c5_b4_f32", (12, 2160, 3840), (1080, 1920), "bilinear", torch.float32,
         torch.float32, 0),
        ("c5_b1_u8_f32_bicubic", (3, 2160, 3840), (1080, 1920), "bicubic", torch.uint8,
         torch.float32, 0),
        ("ragged_odd_offset_bf16", (6, 1003, 1499), (401, 653), "bilinear",
         torch.bfloat16, torch.bfloat16, 1),
        ("ragged_odd_f32_bicubic", (6, 997, 1301), (499, 651), "bicubic",
         torch.float32, torch.float32, 3),
        ("u8_u8", (4, 1201, 1001), (600, 500), "bilinear", torch.uint8, torch.uint8, 5),
    ]
    with full_f32():
        for name, shape, ohw, mode, idt, odt, off in cases:
            x3 = rand(shape, idt, 7, off)
            sh, sw = make_axis_spec(shape[1], ohw[0], mode), make_axis_spec(shape[2], ohw[1], mode)
            want = cr._resample2d_plain(x3, sh, sw, odt)
            cands = candidates(x3, sh, sw) or candidates(x3, sh, sw, 4096)  # below the gate
            bad = []
            for plan in cands:
                got = stream_call(x3, sh, sw, odt, plan)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad.append({"plan": plan._asdict(), "differing": int((got != want).sum())})
            emit(phase="check", case=name, plans=len(cands), equal=not bad, bad=bad[:3])
            if bad:
                raise SystemExit(f"{name}: streaming kernel != plain version")
            del x3, want

    # 2. config 5 at b64: its plan, checked, then timed beside the tile kernel
    shape, ohw = (192, 2160, 3840), (1080, 1920)
    sh, sw = make_axis_spec(shape[1], ohw[0]), make_axis_spec(shape[2], ohw[1])
    xs = [rand(shape, torch.bfloat16, 11 + i) for i in range(2)]
    plan = plans.plan2d_stream(sh, sw, 2, shape[0], n_sm)
    tile = plans.plan2d(sh, sw, 2, shape[0], n_sm)
    with full_f32():
        want = cr._resample2d_plain(xs[0], sh, sw, torch.bfloat16)
    got = stream_call(xs[0], sh, sw, torch.bfloat16, plan)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    emit(phase="check", case="config5_b64", plan=plan._asdict(), equal=equal)
    if not equal:
        raise SystemExit("config 5: streaming kernel != plain version")
    del want, got
    torch.cuda.empty_cache()
    nbytes = 2 * shape[0] * (shape[1] * shape[2] + ohw[0] * ohw[1])
    bound = nbytes / HBM_BYTES_PER_MS
    out = torch.empty((shape[0], *ohw), dtype=torch.bfloat16, device=dev)
    (xw, ww), (xh, whh) = plans.tables_on(sw, dev), plans.tables_on(sh, dev)

    def tile_fn(kind):
        fn = getattr(libs[f"tile_{kind}"], "tile_launch")

        def call(x3):
            err = fn(x3.data_ptr(), out.data_ptr(), shape[0], shape[1], shape[2], *ohw,
                     xw.data_ptr(), ww.data_ptr(), ww.shape[1], xh.data_ptr(),
                     whh.data_ptr(), whh.shape[1], tile.tile_r, tile.rows_cap,
                     tile.cols_cap, tile.chunk, tile.smem,
                     torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"tile {kind}: cudaError {err}")
        return call

    def timed(call, iters=20):
        for i in range(3):
            call(xs[i % 2])
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
        ev[0].record()
        for i in range(iters):
            call(xs[i % 2])
            ev[i + 1].record()
        torch.cuda.synchronize()
        ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(iters))
        return {"ms_median": ms[iters // 2], "ms_min": ms[0], "ms_max": ms[-1],
                "bound_ms": bound, "roofline_pct": 100 * bound / ms[iters // 2]}

    for turn in range(2):  # tile variants and the plan in turns, twice
        for kind in PHASES:
            emit(phase="time", kernel=f"tile_{kind}", turn=turn, plan=tile._asdict(),
                 **timed(tile_fn(kind)))
        emit(phase="time", kernel="stream", turn=turn, plan=plan._asdict(),
             **timed(lambda x3: stream_call(x3, sh, sw, torch.bfloat16, plan)))
        for kind in STREAM_PHASES:
            emit(phase="time", kernel=f"stream_{kind}", turn=turn, plan=plan._asdict(),
                 **timed(lambda x3, k=kind: stream_call(x3, sh, sw, torch.bfloat16, plan,
                                                        libs[f"stream_{k}"])))
    # bicubic (the 8-tap bucket) at its plan
    sb, swb = make_axis_spec(shape[1], ohw[0], "bicubic"), make_axis_spec(shape[2], ohw[1],
                                                                          "bicubic")
    pb = plans.plan2d_stream(sb, swb, 2, shape[0], n_sm)
    emit(phase="time", kernel="stream_bicubic", turn=0, plan=pb._asdict(),
         **timed(lambda x3: stream_call(x3, sb, swb, torch.bfloat16, pb)))
    if args.gate:
        del xs
        torch.cuda.empty_cache()
        _gate(emit, dev, rand)
    if args.sweep:
        for p in candidates(xs[0], sh, sw):
            emit(phase="sweep", kernel="stream", plan=p._asdict(), chosen=p == plan,
                 **timed(lambda x3, p=p: stream_call(x3, sh, sw, torch.bfloat16, p), 10))
        # config 5 in float32 (the plan's other itemsize) at its plan
        del xs
        torch.cuda.empty_cache()
        xs = [rand(shape, torch.float32, 21 + i) for i in range(2)]
        p32 = plans.plan2d_stream(sh, sw, 4, shape[0], n_sm)
        bound = 2 * nbytes / HBM_BYTES_PER_MS
        for p in candidates(xs[0], sh, sw):
            emit(phase="sweep_f32", kernel="stream", plan=p._asdict(), chosen=p == p32,
                 **timed(lambda x3, p=p: stream_call(x3, sh, sw, torch.float32, p), 10))


if __name__ == "__main__":
    main()

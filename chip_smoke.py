"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and the
CUDA toolkit.  It builds the port's CUDA kernel from the sources in the
checkout, holds the kernel against its plain PyTorch version (run on a CPU
copy of the same input) on every shape below, drives the port's main path
(the uint8 ImageNet-eval pipeline) through the kernel and checks it against
the same pipeline on the CPU, and times the kernel beside its plain version
on the card.  Every phase prints one line; any failure raises and exits
nonzero.  The last two lines are a JSON object describing the kernel and a
JSON object ``{"ok": true, "device": {...}}``.

It imports nothing of JAX: byte parity to Pillow and to the JAX package is
established by the CPU tests (tests/test_torch_port_*.py), and here the
kernel is held to the plain version.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from interpolate_antialiasing_tpu_torch import ImageNetEvalPipeline, native, resize
from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
from interpolate_antialiasing_tpu_torch.utils.timing import time_cuda

MODES = ("bilinear", "bicubic", "lanczos3", "box", "hamming")
# the four shapes of the JAX package's digit-kernel test
# (tests/test_pil_exact.py::test_digit_split_pallas_bit_identical)
SMALL = ((64, 96, 32, 40), (57, 83, 24, 31), (40, 120, 96, 48),
         (33, 31, 65, 67))
BENCH = ((64, 3, 438, 906), (196, 320))  # bench.py's workload
ENTRY = ((8, 3, 438, 906), (224, 224))  # __graft_entry__.entry()'s workload
UHD = ((3, 2160, 3840), (1080, 1920))  # 4K -> HD frame


def _line(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _cases():
    for mode in MODES:
        for H, W, oh, ow in SMALL:
            for digits in (3, 2):
                yield (f"{mode} {H}x{W}->{oh}x{ow} digits={digits}", (2, H, W),
                       dict(size=(oh, ow), method=mode, digits=digits))
    yield ("nhwc bicubic", (2, 40, 60, 3),
           dict(size=(20, 30), method="bicubic", data_format="NHWC"))
    yield ("box lanczos3", (3, 50, 70),
           dict(size=(20, 31), method="lanczos3", box=(3.3, 4.25, 61.7, 45.5)))
    yield ("bench bilinear", BENCH[0], dict(size=BENCH[1], method="bilinear"))
    yield ("4k->hd bilinear", UHD[0], dict(size=UHD[1], method="bilinear"))


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def main() -> None:
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    _line("device", kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    native.build()
    _line("build", seconds=round(time.perf_counter() - t0, 3))

    # 3. kernel vs plain version, on every shape
    rng = np.random.default_rng(0)
    worst = 0.0
    for name, shape, kw in _cases():
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        before = pe.launches
        got = pe.resize_pil_exact(x.to(dev), **kw)
        torch.cuda.synchronize()
        if pe.launches != before + 1:
            raise RuntimeError(f"{name}: the kernel was not launched")
        want = pe.resize_pil_exact(x, **kw)  # CPU tensor: plain version
        err = _max_abs(got.cpu(), want)
        worst = max(worst, err)
        if got.shape != want.shape or not torch.equal(got.cpu(), want):
            raise RuntimeError(f"{name}: kernel != plain version "
                               f"(max abs err {err})")
        _line("kernel_vs_plain", case=name, shape=list(shape),
              out=list(got.shape), max_abs_err=err)

    # 4. the main path: entry()'s seeded batch through the eval pipeline
    erng = np.random.default_rng(0)
    batch = (erng.random(ENTRY[0]) * 255).astype(np.uint8)
    pipe = ImageNetEvalPipeline(size=ENTRY[1]).to(dev)
    x = torch.from_numpy(batch).to(dev)
    calls = 3
    pe.launches = 0
    for _ in range(calls):
        y = pipe(x)
    torch.cuda.synchronize()
    main_launches = pe.launches
    if main_launches != calls:
        raise RuntimeError(f"main path: {main_launches} kernel launches in "
                           f"{calls} pipeline calls, expected one per call")
    y_cpu = ImageNetEvalPipeline(size=ENTRY[1])(torch.from_numpy(batch))
    u8_gpu = resize(x, ENTRY[1]).cpu()
    u8_cpu = resize(torch.from_numpy(batch), ENTRY[1])
    if not torch.equal(u8_gpu, u8_cpu):
        raise RuntimeError("main path: uint8 stage differs from the CPU run")
    if y.shape != (ENTRY[0][0], 3, *ENTRY[1]) or y.dtype != torch.float32:
        raise RuntimeError(f"main path: got {tuple(y.shape)} {y.dtype}")
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError("main path: non-finite output")
    out_err = _max_abs(y.cpu(), y_cpu)
    if out_err > 1e-6:  # float32 /255, -mean, /std on two devices
        raise RuntimeError(f"main path: output differs from the CPU run by "
                           f"{out_err} > 1e-6")
    _line("main_path", batch=list(ENTRY[0]), size=list(ENTRY[1]),
          launches=main_launches, calls=calls, u8_equal=True,
          max_abs_err_vs_cpu=out_err)

    # 5. times (informational): kernel and plain version on the card, in
    #    turns plain, kernel, kernel, plain
    def timed(shape, size, iters):
        x3 = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        x3 = x3.reshape(-1, shape[-2], shape[-1]).to(dev)
        tw = pe._int_tables(shape[-1], size[1], "bilinear")
        th = pe._int_tables(shape[-2], size[0], "bilinear")
        fns = {
            "plain": lambda: pe._resample_2pass_plain(x3, tw, th),
            "kernel": lambda: pe._resample_2pass(x3, tw, th),
        }
        ms = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            ms[which].append(time_cuda(fns[which], iters=iters, warmup=3))
        return ms

    bench = timed(*BENCH, iters=20)
    k_ms = sum(bench["kernel"]) / 2
    p_ms = sum(bench["plain"]) / 2
    n_out = BENCH[0][0] * BENCH[1][0] * BENCH[1][1]  # images x oh x ow
    _line("time_bench", card=card, shape=list(BENCH[0]), size=list(BENCH[1]),
          kernel_ms=bench["kernel"], plain_ms=bench["plain"],
          kernel_out_mpix_s=n_out / (k_ms * 1e-3) / 1e6,
          plain_out_mpix_s=n_out / (p_ms * 1e-3) / 1e6,
          kernel_faster=k_ms < p_ms)
    uhd = timed(*UHD, iters=10)
    _line("time_4k_hd", card=card, shape=list(UHD[0]), size=list(UHD[1]),
          kernel_ms=uhd["kernel"], plain_ms=uhd["plain"])
    pipe_ms = time_cuda(pipe, x, iters=20, warmup=3)
    _line("time_entry_pipeline", card=card, batch=list(ENTRY[0]),
          size=list(ENTRY[1]), ms=pipe_ms)

    print(json.dumps({"kernels": [{
        "name": "pil_resample_2pass",
        "route": "cuda",
        "source": "interpolate_antialiasing_tpu_torch/csrc/pil_resample.cu",
        "replaces": "interpolate_antialiasing_tpu/ops/pil_exact.py:504",
        "also_serves": "interpolate_antialiasing_tpu/ops/pil_exact.py:824",
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()

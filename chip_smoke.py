"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and the
CUDA toolkit.  It builds the port's CUDA kernels from the sources in the
checkout (resample2d and resample_axis each with a twin that synthesises its
weights in the kernel, ``fused=True``), prints the compile seconds of each
source, what ``ptxas -v`` reported for resample2d's and the per-axis
kernels' instantiations, resample2d's plan at config 5 and the headline
(tile, ring chunk, shared bytes, blocks, resident blocks per SM) and the
per-axis kernels' plan at every pass it times (``plan_resample_axis``), and
then:

1. holds each kernel against its plain PyTorch version, bit for bit: the
   Pillow kernel against a CPU copy (including a 70,000-plane batch, past
   the 65,535 planes one launch takes), the two float kernels on the card
   at every dtype pair, filter and layout, an extreme downscale and the JAX
   package's kernel-test shapes (they round each product and each sum in
   the plain version's tap order, so any difference is a fault), the same
   two kernels over transposed tables (the resize's adjoint, f32 and bf16),
   the crop kernel's integer and float variants on the JAX package's
   crop-test windows, at full size and on zoom-out boxes wider than the
   image (rows past the tables' tap bound, whose weights the kernel
   computes again from the box and stages with their tile's window in
   chunks; once as a strided view of ``[N, 5]`` detections; at b64 and on
   4K frames; boxes half past the image, whose edge tiles mix rows past
   the bound with rows within it), then one more call within the image; the
   crop's float32-intermediate route (its tables with flips at 0.5 folded
   in, the uint8 -> float32 and float32 -> uint8 passes, each flipped image
   the exact mirror of the unflipped call) on RandomResizedCrop and
   zoom-out boxes under each filter it admits, at b64 and on 4K frames; the
   crop's table kernel
   (``crop_tables``) against the plain table build on the same cases and
   edges, table by table (``first`` and ``cnt`` equal, ``w`` bit for bit),
   and at its group edges (``TABLE_EDGES``: rows over three sum windows, two
   sum levels, rows past every segment, sub-pixel and zero-count rows, row
   counts no block divides; each filter and precision, the boxes dense and
   strided, at the plan's choice, at one thread per row and at 8, 16
   and 32 lanes),
   the sharded byte-exact route's
   kernel (pil_resample_axis) over every shard's tables of 2, 4 and 8
   shards, each filter, divisible and ceil-padded sizes, middle axis, last
   axis and NHWC, and the per-axis float kernel over every shard's tables
   and their transposes (f32 and bf16), and the two fused twins (weights
   synthesised in the kernel) over every continuous filter, dtype pair and
   axis kind, up- and downscale, align_corners, a span and the case where
   no resample2d tile fits; and the two uint8 kernels at their edges (the
   Pillow two-pass kernel, kernel A over Pillow's tables: the bench batch,
   4K -> HD, 70,000 planes, more than 16 taps, pb 14, an upsample, one-row
   and one-column outputs, an input off 16 bytes, the route where no tile
   fits; the crop passes, kernel B with per-image tables: sub-pixel boxes,
   boxes at each edge, max_box_frac 1.0 and 0.45, more than 128 outputs,
   zoom-out boxes, tiles mixing rows past and within the tap bound, a row
   past every chunk (it reads device memory), the 4K RandomResizedCrop,
   both precisions), each through the plan and
   with every tile the plan considers forced, byte for byte;
2. drives the port's main paths through their public entry points, each
   with every launch count set to 0 just before it and read just after:
   the uint8 ImageNet-eval pipeline (Pillow kernel); BASELINE config 5
   through ``VideoDownscaler`` (bf16 [64, 3, 2160, 3840] -> 1080x1920);
   configs 1-2 through ``resize`` (f32 [1, 3, 438, 906] -> 196x320,
   bilinear and bicubic, NCHW and NHWC); the float32-domain eval pipeline
   on ``entry()``'s batch; BASELINE config 4 (``torch.autograd.grad``
   through ``resize_plane``, f32 [8, 3, 438, 906] -> 196x320: forward and
   adjoint kernels); the train path (``ImageNetTrainPipeline`` on a uint8
   [64, 3, 438, 906] batch with its flips: one ``crop_tables`` and two
   ``crop_f32`` launches, also within one grey level of the CPU's dense
   route; ``Trainer`` steps on its output,
   ``crop_and_resize`` on the batch and ``random_resized_crop`` on 4K
   frames through the table kernel and the crop kernel: one ``crop_tables``
   and two ``crop_resample`` launches each).  Each is checked bit for bit against
   the same call with every kernel replaced by its plain version on the
   card, with TF32 off and cuDNN deterministic.  Then the sharded path at
   the size it exists for, through the shard bodies on 4 shards (each
   extended block built from the padded image as the ring delivers it):
   ``resize_sharded_pil_exact``'s passes on a uint8 [3, 32768, 32768]
   image -> 8192x8192 and a ceil-padded lanczos3 case, byte-equal to the
   same shard bodies on the plain versions and to ``resize_pil_exact``;
   ``resize_sharded`` and its VJP on a float32 [1, 3, 16384, 16384] image
   -> 4096x4096 bicubic, equal bit for bit to the same shard bodies on the
   plain versions and within 1e-5 of the largest value of ``resize`` and
   ``resize_plane``'s VJP; and the public entry points (DTensor out) at the
   same sizes and ``Trainer(mesh=...)`` in a one-rank NCCL group, against
   their single-device counterparts (``--ranks N`` runs these group phases
   across N cards of one host, one rank per card).  Then the fused route at
   full width (config 5 and configs 1-2 through ``resize2d(fused=True)`` /
   ``resize_axis(fused=True)``, the bench batch u8 -> u8), against the
   fused plain versions bit for bit and the table route within its bound;
   BASELINE config 3 through ``ShapeBucketResizer`` (64 uint8 images in 8
   ImageNet-like shapes -> 224x224, one Pillow-kernel launch per shape);
   ``scale_and_translate`` and its VJP on config 1's image; and
   ``reducing_gap`` 2 and 3 on a 4K frame -> 224x224;
3. times each kernel beside its plain version on the card, in turns, with
   the least time the card could take for the same work and, where one
   PyTorch call computes the same function, that call's time; the float
   kernels also by device time per launch (torch.profiler kernel records,
   ``*_device_ms``) apart from the wrapper's host time per call
   (``*_host_us``), since CUDA events around back-to-back calls measure the
   host where it is the slower (batch 1), and the uint8 kernels the same way
   (the Pillow kernel at the bench batch and 4K -> HD, the crop's two
   passes per call, the crop's table kernel per launch); the whole crop
   calls with the table kernel and with the plain table build, in turns,
   by events and by device time (``time_crop_call``), at b64 for boxes
   within the image and for zoom-out boxes; the float32-intermediate passes
   at the train cell's call, and that whole call beside the dense route it
   replaces (``time_crop_f32``); the shard passes of both per-axis
   kernels the same way; and kernel B at config 5's frames in NHWC (bf16
   [64, 2160, 3840, 3] -> 1080x1920 through ``resize``, tables and fused,
   beside ``F.interpolate`` on the same channels-last tensor,
   ``time_nhwc_config5``);
4. drives the command line in-process (``cli.main``, the ``cli`` phase):
   ``--inspect`` at the bench batch and ``kernel_report`` at configs 1-2
   (NCHW and NHWC), config 5 and two calls where no kernel-A tile fits,
   each against the launch counters of the same call through ``resize``
   (route and launches equal, the bounds of the bench batch and config 5
   those of the timing phase); ``--bench`` (device times, named with the
   card, through kernel A and the Pillow kernel); ``--backward`` (forward
   and adjoint launches of resample2d); ``--profile`` (a trace with a
   resample2d kernel record); lanczos5 accuracy against the dense float64
   route; ``--dump-hlo`` (the launched kernel's SASS); and ``lower_text``
   of one b64 ``crop_and_resize`` call (its aten operators, at most 16, and
   its launches: ``crop_tables`` and two ``crop_resample``; with the plain
   table build forced, for comparison).

Every phase prints one JSON line (each kernel-vs-plain case goes to
``smoke_out/chip_smoke_cases.jsonl``); any failure raises and exits
nonzero.  The last two lines are a JSON object describing the kernels and a
JSON object ``{"ok": true, "device": {...}}``.

It imports nothing of JAX: parity to the JAX package and to Pillow is
established by the CPU tests (tests/test_torch_port_*.py); here each kernel
is held to its plain version.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import os
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from interpolate_antialiasing_tpu_torch import (
    ImageNetEvalPipeline,
    ImageNetTrainPipeline,
    Trainer,
    VideoDownscaler,
    crop_and_resize,
    native,
    random_resized_crop,
    resize,
    resize_plane,
    scale_and_translate,
)
from interpolate_antialiasing_tpu_torch.config import full_f32
from interpolate_antialiasing_tpu_torch.models import ShapeBucketResizer
from interpolate_antialiasing_tpu_torch.ops import crop_cuda as cc
from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
from interpolate_antialiasing_tpu_torch.ops.crop import box_fracs, sample_boxes
from interpolate_antialiasing_tpu_torch.ops.resize_xla import resize_axis_dense
from interpolate_antialiasing_tpu_torch.ops.weights import adjoint_tables, make_axis_spec
from interpolate_antialiasing_tpu_torch.parallel import halo
from interpolate_antialiasing_tpu_torch.utils.inspect import bound_of, launch_counts
from interpolate_antialiasing_tpu_torch.utils.timing import device_time_per_call, host_us, time_cuda

MODES = ("bilinear", "bicubic", "lanczos3", "box", "hamming")
# the four shapes of the JAX package's digit-kernel test
# (tests/test_pil_exact.py::test_digit_split_pallas_bit_identical)
SMALL = ((64, 96, 32, 40), (57, 83, 24, 31), (40, 120, 96, 48),
         (33, 31, 65, 67))
BENCH = ((64, 3, 438, 906), (196, 320))  # bench.py's workload
ENTRY = ((8, 3, 438, 906), (224, 224))  # __graft_entry__.entry()'s workload
UHD = ((3, 2160, 3840), (1080, 1920))  # 4K -> HD frame
CONFIG5 = ((64, 3, 2160, 3840), (1080, 1920))  # BASELINE config 5, bf16
HEADLINE = ((1, 3, 438, 906), (196, 320))  # BASELINE configs 1-2, f32
CONFIG4 = ((8, 3, 438, 906), (196, 320))  # BASELINE config 4: the VJP, f32
TRAIN_B64 = ((64, 3, 438, 906), (224, 224))  # run_all's crop / train-aug batch
CROP_4K = ((8, 3, 2160, 3840), (224, 224))  # RandomResizedCrop of 4K frames
TRAIN_STEPS = 3
# the sharded main path: images too large for one card, H split over 4 shards
SHARDS = 4
SHARD_U8 = ((3, 32768, 32768), (8192, 8192), "bilinear")  # uint8 CHW, 3.2 GB
SHARD_U8_CEIL = ((3, 16387, 16411), (4099, 4097), "lanczos3")  # ceil-padded blocks
SHARD_F32 = ((1, 3, 16384, 16384), (4096, 4096), "bicubic")  # float32 NCHW, 3.2 GB
# the filters the fused kernels synthesise (triangle, Keys cubic, Hamming,
# Lanczos 3 and 5)
FUSED_MODES = ("bilinear", "bicubic", "hamming", "lanczos3", "lanczos5")
# BASELINE config 3: batch-64 arbitrary-size -> 224x224, ImageNet eval-style;
# 8 ImageNet-like (H, W) shapes, 8 uint8 CHW images each
CONFIG3_SHAPES = ((375, 500), (500, 375), (333, 500), (500, 333), (500, 500),
                  (480, 640), (600, 800), (768, 1024))
CONFIG3_SIZE = (224, 224)
REDUCE_4K = ((3, 2160, 3840), (224, 224))  # reducing_gap on a 4K frame
# scale_and_translate on config 1's image: (out H, W), scale, translation
AFFINE_CASES = (("zoom and shift", (188, 317), (0.43, 0.35), (3.0, -2.5)),
                ("negative scale", (188, 317), (-0.43, 0.35), (188.0, -2.5)))

U8, F32, BF16 = torch.uint8, torch.float32, torch.bfloat16
DTYPES = (U8, F32, BF16)
# the JAX package's float kernel tests (tests/test_resize2d_fused.py
# ONEK_CASES, STREAM_CASES): (shape, (oh, ow), mode, in, out)
JAX_CASES = (
    ((2, 3, 438, 906), (196, 320), "bilinear", U8, U8),
    ((2, 3, 438, 906), (196, 320), "bicubic", U8, F32),
    ((1, 3, 100, 150), (250, 75), "bilinear", F32, F32),
    ((2, 130, 140), (64, 72), "lanczos3", F32, F32),
    ((5, 97, 131), (40, 1200), "bilinear", F32, F32),
    ((2, 3, 96, 128), (96, 128), "box", U8, U8),
    ((1, 64, 64), (130, 260), "bicubic", U8, U8),
    ((2, 216, 384), (108, 192), "bilinear", F32, F32),
    ((1, 216, 384), (108, 192), "bilinear", BF16, BF16),
    ((1, 440, 1024), (196, 320), "bilinear", U8, U8),
    ((3, 256, 512), (700, 300), "bicubic", F32, F32),
    ((1, 64, 256), (320, 96), "lanczos3", F32, F32),
    ((1, 219, 391), (108, 192), "bilinear", F32, F32),
    ((1, 438, 906), (196, 320), "bilinear", U8, U8),
    ((2, 301, 400), (150, 333), "bicubic", F32, F32),
    ((1, 64, 256), (130, 512), "bicubic", U8, U8),
    ((1, 215, 250), (430, 125), "bilinear", BF16, BF16),
)


# Per-case lines of the kernel-vs-plain phase go to this file (stdout keeps
# one summary line per kernel, so the whole output stays short).
CASES_LOG = Path("smoke_out") / "chip_smoke_cases.jsonl"
_cases: list[str] = []


def _line(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _case(**fields) -> None:
    _cases.append(json.dumps({"phase": "kernel_vs_plain", **fields}))


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _compare(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel output against its plain version: finite and equal bit for
    bit (a wrong rounding of a store, or a sum in another order, shows)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                           f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got.float()).all()):
        raise RuntimeError(f"{name}: non-finite output")
    err = _max_abs(got, want)
    differing = int((got != want).sum())
    if differing:
        raise RuntimeError(f"{name}: kernel != plain version in {differing} "
                           f"of {got.numel()} elements (max abs err {err})")
    return {"max_abs_err": err}


def _rand(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(shape, device=dev, generator=g).mul_(255.0)
    return x.to(dtype)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _nz(w) -> int:
    """Taps with nonzero weight over all outputs of a pass's table."""
    return int(np.count_nonzero(np.asarray(w)))


def _nbytes(*arrays) -> int:
    return sum(int(np.asarray(a).nbytes) for a in arrays)


def _library(fn, want: torch.Tensor | None = None):
    """``(ms, note)`` of one PyTorch call that computes the kernel's function:
    timed where it runs and (for the uint8 kernels) gives the same bytes,
    else ``(None, why not)``."""
    try:
        got = fn()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — a yardstick that does not exist
        return None, f"{type(e).__name__}: {str(e)[:120]}"
    if want is not None and (got.shape != want.shape or not torch.equal(got, want)):
        return None, "differs from the kernel's bytes"
    return time_cuda(fn, iters=10, warmup=2), "same function"


def _kernel_times(fn, iters: int, match: str) -> dict:
    return {"device_ms": device_time_per_call(fn, iters=iters, match=match),
            "host_us": host_us(fn, iters=iters)}


def _plan_of(x: torch.Tensor, sh, sw, fused: bool = False) -> list | None:
    """Kernel A's plan for ``x`` as :func:`cr.resize2d` takes it."""
    plan = (cr._plan2d_synth if fused else cr._plan2d)(
        sh, sw, x.element_size(), max(1, math.prod(x.shape[:-2])), cr._n_sm(x.device))
    return None if plan is None else list(plan)


def print_kernel_a_plans(dev) -> None:
    """Kernel A's plan at config 5 and the headline, tables and synthesised
    weights: tile, ring chunk, shared bytes, blocks, the plan's estimate of
    resident blocks per SM and the card's (occupancy API: registers count
    too)."""
    for name, (shape, ohw), dt, mode in [("config 5", CONFIG5, BF16, "bilinear"),
                                         ("headline", HEADLINE, F32, "bilinear"),
                                         ("headline", HEADLINE, F32, "bicubic")]:
        sh = make_axis_spec(shape[-2], ohw[0], mode)
        sw = make_axis_spec(shape[-1], ohw[1], mode)
        for fused in (False, True):
            plan = (cr._plan2d_synth if fused else cr._plan2d)(
                sh, sw, torch.empty(0, dtype=dt).element_size(), math.prod(shape[:-2]),
                cr._n_sm(dev))
            _line("plan_resample2d", case=name, mode=mode, fused=fused, shape=list(shape),
                  size=list(ohw), dtype=str(dt), taps=[sh.ntaps, sw.ntaps],
                  **plan._asdict(), sms=cr._n_sm(dev),
                  card_resident_per_sm=cr.occupancy_2d(plan, dt, dt, sw.ntaps, sh.ntaps,
                                                        fused))


def _axis_timed_passes():
    """The axis kernels' timed passes: (case, kind, first taps int64, ntaps,
    n_in, outer, inner, dtype): the NHWC headline's and NHWC config 5's W
    and H passes (tables and fused), row 3's sharded uint8 W and H pass
    (Pillow tables) and row 9's sharded float H pass and its adjoint."""
    for case, (shape, ohw), dt in (("nhwc headline", HEADLINE, F32),
                                   ("nhwc config 5", CONFIG5, BF16)):
        N, C, H, W = shape
        sh, sw = make_axis_spec(H, ohw[0]), make_axis_spec(W, ohw[1])
        for p, spec, outer, inner in (("w", sw, N * H, C), ("h", sh, N, ohw[1] * C)):
            for kind in ("table", "fused"):
                first = (cr._synth_first(spec) if kind == "fused"
                         else cr._tables(spec)[0].astype(np.int64))
                yield (f"{case} {p} pass", kind, first, spec.ntaps, spec.in_size, outer,
                       inner, dt)
    (shape, size, mode), d = SHARD_U8, 1
    plan, starts, wsh = halo._int_halo_tables(shape[1], size[0], mode, SHARDS)
    tw = pe._int_tables(shape[2], size[1], mode)
    yield ("row 3 w pass", "pil", np.asarray(tw[0], np.int64), tw[1].shape[1], shape[2],
           shape[0] * plan.hl, 1, U8)
    yield ("row 3 h pass", "pil", np.asarray(starts[d], np.int64), wsh[d].shape[1], plan.ext,
           shape[0], size[1], U8)
    (shape, size, mode) = SHARD_F32
    plan = halo.plan_halo_banded(shape[2], size[0], mode, True, SHARDS)
    for p, t in zip(("forward", "adjoint"), halo._shard_tables(plan, d)):
        yield (f"row 9 {p}", "table", t.xmin.astype(np.int64), t.ntaps, t.in_size, shape[1],
               size[1], F32)


def print_axis_plans(dev) -> None:
    """The axis kernels' plan at every timed pass: tile, window, vec, shared
    bytes, blocks, the plan's estimate of resident blocks per SM and the
    card's (occupancy API: registers count too)."""
    n_sm = cr._n_sm(dev)
    for case, kind, first, ntaps, n_in, outer, inner, dt in _axis_timed_passes():
        isz = torch.empty(0, dtype=dt).element_size()
        plan = cr._plan_axis_first(first.tobytes(), ntaps, n_in, outer, inner, isz, n_sm, True,
                                   kind == "fused")
        fields = {"unstaged": True} if plan is None else dict(
            **plan._asdict(), card_resident_per_sm=cr.occupancy_axis(plan, kind, dt, dt, ntaps))
        _line("plan_resample_axis", case=case, kind=kind, dtype=str(dt), taps=ntaps,
              view=[outer, n_in, inner], n_out=len(first), sms=n_sm, **fields)


PTXAS_LOG = Path("smoke_out") / "ptxas.jsonl"
# kernel -> the names of its two template values after the weight source
PTXAS_KERNELS = {"resample2d_kernel": ("tile_c", "tap_bucket"),
                 "resample_axis_kernel": ("tap_bucket", "vec")}


def print_ptxas() -> None:
    """What ``nvcc -Xptxas -v`` reported for kernel A's and the axis
    kernels' instantiations (native.ptxas_log): one ``ptxas_<kernel>`` line
    per (weight source, two template values: TC and tap bucket for kernel
    A, tap bucket and vec for the axis kernels) with the most registers,
    spill bytes and static shared memory over the dtype pairs; every
    instantiation's line to ``PTXAS_LOG``."""
    rows, cur = [], None
    for line in native.ptxas_log().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = next((k for k in PTXAS_KERNELS if k in m.group(1)), None)
            cur = {"name": m.group(1), "kernel": kernel} if kernel else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
            t = re.search(r"(TableTaps|SynthTaps|PilTaps)ELi(\d+)ELi(\d+)E", cur["name"])
            cur["group"] = [cur["kernel"], t.group(1), int(t.group(2)), int(t.group(3))] \
                if t else [cur["kernel"], "?", 0, 0]
            rows.append(cur)
            cur = None
    for kernel in PTXAS_KERNELS:
        if not any(r["kernel"] == kernel for r in rows):
            raise RuntimeError(f"ptxas -v reported no {kernel} instantiation")
    PTXAS_LOG.parent.mkdir(exist_ok=True)
    PTXAS_LOG.write_text("".join(json.dumps(r) + "\n" for r in rows))
    groups = {}
    for r in rows:
        groups.setdefault(json.dumps(r["group"]), []).append(r)
    for key, rs in sorted(groups.items()):
        kernel, taps, a, b = json.loads(key)
        names = PTXAS_KERNELS[kernel]
        _line("ptxas_" + kernel.removesuffix("_kernel"), taps=taps, **{names[0]: a, names[1]: b},
              instantiations=len(rs), max_registers=max(r["registers"] for r in rs),
              max_spill_bytes=max(r.get("spill", 0) for r in rs),
              static_smem=max(r["static_smem"] for r in rs))


# ---------------------------------------------------------------------------
# 1. the Pillow kernel against its plain version
# ---------------------------------------------------------------------------


def _pil_cases():
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
    # past the 65,535 planes of a grid's y or z dimension: one launch
    yield ("70000 planes", (70000, 8, 8), dict(size=(4, 5), method="bilinear"))


def check_pil_kernel(dev, rng) -> float:
    worst, n = 0.0, 0
    for name, shape, kw in _pil_cases():
        n += 1
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        before = pe.launches
        got = pe.resize_pil_exact(x.to(dev), **kw)
        torch.cuda.synchronize()
        if pe.launches != before + 1:  # every block on gridDim.x: 70,000 planes too
            raise RuntimeError(f"{name}: {pe.launches - before} launches")
        want = pe.resize_pil_exact(x, **kw)  # CPU tensor: plain version
        err = _max_abs(got.cpu(), want)
        worst = max(worst, err)
        if got.shape != want.shape or not torch.equal(got.cpu(), want):
            raise RuntimeError(f"{name}: kernel != plain version "
                               f"(max abs err {err})")
        _case(kernel="pil_resample_2pass", case=name,
              shape=list(shape), out=list(got.shape),
              launches=pe.launches - before, max_abs_err=err)
    _line("kernel_vs_plain_summary", kernel="pil_resample_2pass", cases=n,
          max_abs_err=worst)
    return worst


# ---------------------------------------------------------------------------
# 2. the float kernels against their plain versions, on the card
# ---------------------------------------------------------------------------


def _float2d_cases():
    """(name, x shape, (oh, ow), mode, spec kwargs, in dtype, out dtype)"""
    for idt in DTYPES:
        for odt in DTYPES:
            yield ("down", (3, 57, 83), (24, 31), "bicubic", {}, idt, odt)
            yield ("up", (3, 41, 60), (90, 130), "lanczos3", {}, idt, odt)
    for mode in ("bilinear", "bicubic", "lanczos3", "box", "hamming", "area"):
        yield (mode, (2, 97, 131), (40, 60), mode, {}, F32, F32)
    yield ("no_antialias", (2, 97, 131), (40, 160), "bicubic",
           dict(antialias=False), F32, F32)
    yield ("align_corners", (2, 97, 131), (40, 160), "bilinear",
           dict(align_corners=True), F32, F32)
    # 2160 -> 8 lanczos3 reads ~1,600 rows per output row: tile_c < 64
    yield ("extreme_downscale", (1, 2160, 96), (8, 48), "lanczos3", {}, F32, F32)
    yield from _kernel_a_edges(("lanczos3", "lanczos5", "bicubic", "bilinear"))
    for shape, ohw, mode, idt, odt in JAX_CASES:
        yield ("jax_case", shape, ohw, mode, {}, idt, odt)


def _kernel_a_edges(modes):
    """Kernel A's edges: an extreme downscale along W (a span of 2160
    columns through the ring), taps past the largest unrolled bucket
    (lanczos5 x6: 61 taps), fewer blocks than SMs, one output column and one
    output row; and rows that start off 16 bytes (odd widths, and a plane
    offset: a name starting "offset" runs on ``x[1:]``) for each dtype."""
    lanczos3, lanczos5, bicubic, bilinear = modes
    yield ("extreme_downscale_w", (1, 96, 2160), (48, 8), lanczos3, {}, F32, F32)
    yield ("ntaps_61", (1, 64, 600), (10, 100), lanczos5, {}, F32, F32)
    yield ("few_blocks", (1, 17, 23), (8, 11), bicubic, {}, F32, F32)
    yield ("one_column", (2, 50, 70), (30, 1), bilinear, {}, F32, F32)
    yield ("one_row", (2, 50, 70), (1, 30), bilinear, {}, F32, F32)
    for dt in DTYPES:
        yield ("offset_unaligned", (4, 37, 83), (17, 29), bicubic, {}, dt, dt)


def _axis_cases():
    """(name, x shape, axis, n_out, mode, in dtype, out dtype)"""
    for idt in DTYPES:
        for odt in DTYPES:
            yield ("last", (2, 57, 83), -1, 31, "bicubic", idt, odt)
            yield ("mid", (2, 57, 83, 3), 1, 130, "lanczos3", idt, odt)
    for mode in ("bilinear", "box", "hamming", "area"):
        yield (mode, (2, 3, 97, 131), -2, 40, mode, F32, F32)
    yield from _axis_edges("bicubic", "lanczos3", "bilinear")


def _axis_edges(bicubic, lanczos3, bilinear):
    """The axis kernels' tile kinds and edges: the last axis, inner 3, 5
    and 960, one output, upsamples, and rows that start off 16 bytes (a
    name starting "offset" runs on ``x[1:]`` of one more plane) for each
    dtype."""
    yield ("inner3", (2, 57, 83, 3), 2, 31, bicubic, F32, F32)
    yield ("inner5", (2, 57, 5), 1, 23, lanczos3, F32, F32)
    yield ("inner960", (1, 60, 960), 1, 27, bilinear, F32, F32)
    yield ("n_out_1", (2, 50, 7), 1, 1, bilinear, F32, F32)
    yield ("upsample", (2, 31, 70), 1, 90, bicubic, F32, F32)
    yield ("upsample_last", (3, 4, 31), -1, 77, lanczos3, F32, F32)
    for dt in DTYPES:
        yield ("offset_last", (4, 37, 83), -1, 29, bicubic, dt, dt)
        yield ("offset_inner3", (3, 57, 83, 3), 2, 31, bicubic, dt, dt)
        yield ("offset_inner960", (2, 60, 960), 1, 27, bilinear, dt, dt)


def _axis_input(name, shape, dtype, dev, seed):
    if name.startswith("offset"):
        return _rand((shape[0] + 1, *shape[1:]), dtype, dev, seed)[1:]
    return _rand(shape, dtype, dev, seed)


def _view3(x: torch.Tensor, axis: int) -> torch.Tensor:
    axis %= x.ndim
    return x.reshape(math.prod(x.shape[:axis]), x.shape[axis],
                     math.prod(x.shape[axis + 1:]))


class _Tally:
    """Cases and worst error of one kernel's kernel-vs-plain phase; logs one
    line per case."""

    def __init__(self, kernel: str):
        self.kernel, self.cases, self.worst = kernel, 0, 0.0

    def add(self, case: str, res: dict, **fields) -> None:
        self.cases += 1
        self.worst = max(self.worst, res["max_abs_err"])
        _case(kernel=self.kernel, case=case, **fields, **res)

    def summary(self, **fields) -> float:
        _line("kernel_vs_plain_summary", kernel=self.kernel, cases=self.cases,
              max_abs_err=self.worst, **fields)
        return self.worst


def check_float_kernels(dev) -> tuple[float, float]:
    t2d, tax = _Tally("resample2d"), _Tally("resample_axis")
    seed = 0
    for name, shape, ohw, mode, kw, idt, odt in _float2d_cases():
        seed += 1
        x = _rand(shape, idt, dev, seed)
        if name.startswith("offset"):
            x = x[1:]
        sh = make_axis_spec(shape[-2], ohw[0], mode, **kw)
        sw = make_axis_spec(shape[-1], ohw[1], mode, **kw)
        before = cr.launches_2d
        got = cr.resize2d(x, sh, sw, odt)
        torch.cuda.synchronize()
        if cr.launches_2d != before + 1:
            raise RuntimeError(f"resample2d {name}: not launched")
        want = cr._resample2d_plain(_view3(x, -2), sh, sw, odt).reshape(got.shape)
        t2d.add(name, _compare(f"resample2d {name}", got, want), shape=list(x.shape),
                out=list(got.shape), mode=mode, **kw, dtypes=[str(idt), str(odt)],
                plan=_plan_of(x, sh, sw))
    if cr._plan2d(make_axis_spec(2160, 8, "lanczos3"), make_axis_spec(96, 48, "lanczos3"),
                  4, 1, cr._n_sm(dev)).tile_c >= 64:
        raise RuntimeError("the extreme downscale kept 64-column tiles")
    # NHWC uint8 through the public entry: moves through NCHW around one
    # resample2d launch
    x = _rand((2, 40, 60, 3), U8, dev, 201)
    sh, sw = make_axis_spec(40, 20, "area"), make_axis_spec(60, 30, "area")
    before = cr.launches_2d
    got = resize(x, (20, 30), method="area", data_format="NHWC")
    torch.cuda.synchronize()
    if cr.launches_2d != before + 1:
        raise RuntimeError("u8 NHWC: expected one resample2d launch")
    want = cr._resample2d_plain(_view3(x.movedim(-1, -3), -2), sh, sw, U8)
    want = want.reshape(2, 3, 20, 30).movedim(-3, -1)
    t2d.add("nhwc u8 area resize", _compare("nhwc u8", got, want),
            shape=list(x.shape), out=list(got.shape))

    # no output tile's row window fits shared memory: two resample_axis passes
    x = _rand((2, 58200, 4), F32, dev, 100)
    sh, sw = make_axis_spec(58200, 1, "box"), make_axis_spec(4, 4, "box")
    if _plan_of(x, sh, sw) is not None:
        raise RuntimeError("the fallback case fits a tile")
    before = cr.launches_axis
    got = cr.resize2d(x, sh, sw, F32)
    torch.cuda.synchronize()
    if cr.launches_axis != before + 2:
        raise RuntimeError("the fallback did not run two resample_axis passes")
    y = cr._resample_axis_plain(_view3(x, 2), sw, F32).reshape(x.shape)
    want = cr._resample_axis_plain(_view3(y, 1), sh, F32).reshape(got.shape)
    res = _compare("fallback", got, want)
    # and against the dense product (TF32 off), an independent formulation:
    # a 58,201-term float32 sum in another order, so the worst-case bound of
    # float32 summation, n * 2^-24 relative
    dense = resize_axis_dense(resize_axis_dense(x, sw, -1), sh, -2)
    res["dense_max_abs_err"] = _max_abs(got, dense)
    if res["dense_max_abs_err"] > sh.ntaps * 2**-24 * float(dense.abs().max()):
        raise RuntimeError(f"fallback: {res['dense_max_abs_err']} from the "
                           "dense product")
    tax.add("no_tile_fits_fallback", res, shape=list(x.shape),
            out=list(got.shape))
    for name, shape, axis, n_out, mode, idt, odt in _axis_cases():
        seed += 1
        x = _axis_input(name, shape, idt, dev, seed)
        spec = make_axis_spec(shape[axis], n_out, mode)
        before = cr.launches_axis
        got = cr.resize_axis(x, spec, axis, odt)
        torch.cuda.synchronize()
        if cr.launches_axis != before + 1:
            raise RuntimeError(f"resample_axis {name}: not launched")
        want = cr._resample_axis_plain(_view3(x, axis), spec, odt).reshape(got.shape)
        tax.add(name, _compare(f"resample_axis {name}", got, want),
                shape=list(shape), axis=axis, out=list(got.shape),
                dtypes=[str(idt), str(odt)])
    # NHWC float32 through the public entry: two resample_axis passes
    x = _rand((2, 40, 60, 3), F32, dev, 200)
    sh, sw = make_axis_spec(40, 20, "bicubic"), make_axis_spec(60, 30, "bicubic")
    before = (cr.launches_2d, cr.launches_axis)
    got = resize(x, (20, 30), method="bicubic", data_format="NHWC")
    torch.cuda.synchronize()
    if (cr.launches_2d, cr.launches_axis) != (before[0], before[1] + 2):
        raise RuntimeError("f32 NHWC: expected two resample_axis launches")
    y = cr._resample_axis_plain(_view3(x, 2), sw, F32).reshape(2, 40, 30, 3)
    want = cr._resample_axis_plain(_view3(y, 1), sh, F32).reshape(got.shape)
    tax.add("nhwc f32 resize", _compare("nhwc f32", got, want),
            shape=list(x.shape), out=list(got.shape))
    return t2d.summary(), tax.summary()


def _adjoint2d_cases():
    """(name, cotangent shape, (H, W) of the adjoint's output, mode)"""
    # tests/test_resize2d_fused.py::test_onekernel_adjoint_matches_dense
    yield ("fused_adjoint", (2, 196, 320), (438, 906), "bilinear")
    yield ("fused_adjoint", (2, 200, 50), (97, 131), "bicubic")
    for shape, ohw, mode, _, _ in JAX_CASES:  # the forward cases, reversed
        yield ("jax_case", (*shape[:-2], *ohw), shape[-2:], mode)
    for mode in ("bilinear", "bicubic", "lanczos3", "box"):
        yield (mode, (3, 40, 260), (97, 131), mode)  # H down, W up


def _adjoint_axis_cases():
    """(name, cotangent shape, axis, size of the adjoint's output, mode)"""
    # tests/test_resize2d_fused.py::test_transpose_pass_matches_dense
    yield ("transpose_pass", (2, 3, 10, 320), 3, 906, "bicubic")
    yield ("transpose_pass", (2, 3, 196, 33), 2, 64, "bicubic")
    yield ("transpose_pass", (1, 2, 4, 300), 3, 50, "bicubic")
    for mode in ("bilinear", "bicubic", "lanczos3", "box"):
        yield (f"mid {mode}", (2, 40, 57, 3), 1, 131, mode)
        yield (f"last up {mode}", (2, 57, 130), -1, 41, mode)


def check_adjoint_kernels(dev) -> tuple[float, float]:
    """resample2d and resample_axis over transposed tables (the resize's
    adjoint), f32 and bf16, against their plain versions on the card."""
    t2d, tax = _Tally("resample2d adjoint"), _Tally("resample_axis adjoint")
    seed = 300
    for name, gshape, (H, W), mode in _adjoint2d_cases():
        th = adjoint_tables(make_axis_spec(H, gshape[-2], mode))
        tw = adjoint_tables(make_axis_spec(W, gshape[-1], mode))
        for dt in (F32, BF16):
            seed += 1
            g = _rand(gshape, dt, dev, seed)
            before = cr.launches_2d
            got = cr.resize2d(g, th, tw, dt)
            torch.cuda.synchronize()
            if cr.launches_2d != before + 1:
                raise RuntimeError(f"resample2d adjoint {name}: not launched")
            want = cr._resample2d_plain(_view3(g, -2), th, tw, dt).reshape(got.shape)
            t2d.add(name, _compare(f"resample2d adjoint {name}", got, want),
                    shape=list(gshape), out=list(got.shape), mode=mode,
                    dtype=str(dt), taps=[th.ntaps, tw.ntaps], plan=_plan_of(g, th, tw))
    for name, gshape, axis, n_out, mode in _adjoint_axis_cases():
        t = adjoint_tables(make_axis_spec(n_out, gshape[axis], mode))
        for dt in (F32, BF16):
            seed += 1
            g = _rand(gshape, dt, dev, seed)
            before = cr.launches_axis
            got = cr.resize_axis(g, t, axis, dt)
            torch.cuda.synchronize()
            if cr.launches_axis != before + 1:
                raise RuntimeError(f"resample_axis adjoint {name}: not launched")
            want = cr._resample_axis_plain(_view3(g, axis), t, dt).reshape(got.shape)
            tax.add(name, _compare(f"resample_axis adjoint {name}", got, want),
                    shape=list(gshape), axis=axis, out=list(got.shape),
                    mode=mode, dtype=str(dt), taps=t.ntaps)
    return t2d.summary(), tax.summary()


def _run_all_boxes(n: int) -> np.ndarray:
    """benchmarks/run_all.py's crop boxes: corners uniform in [0, 0.35) and
    [0.65, 1)."""
    rng = np.random.default_rng(0)
    b01 = rng.uniform(0.0, 0.35, size=(n, 2)).astype(np.float32)
    b23 = rng.uniform(0.65, 1.0, size=(n, 2)).astype(np.float32)
    return np.concatenate([b01, b23], axis=1)


# boxes wider than the image (a row can count more taps than the tables'
# bound T, and the crop kernel computes its weights again from the box)
# beside boxes within it: past every edge, a 40% and two one-axis 30%
# zoom-outs, one inside, one wider than a 0.5 bound on one axis
ZOOM_OUT = [[-1.0, -1.5, 2.0, 2.5], [-0.2, -0.2, 1.2, 1.2], [0.0, 0.0, 1.3, 1.0],
            [0.0, 0.0, 1.0, 1.3], [0.1, 0.2, 0.8, 0.9], [0.0, 0.2, 1.0, 0.6]]


# boxes half past one edge or two (rows within the box's part of the image
# count more taps than T, the rows near its edge fewer, and one-hot rows
# past it one): tiles at the image's edge mix rows past T with rows within
# it; one box inside
MIXED_TILE = [[0.5, 0.0, 2.0, 1.0], [0.0, 0.6, 1.0, 2.2], [-0.8, -0.2, 0.9, 1.0],
              [-0.3, -0.9, 1.3, 0.7], [0.1, 0.2, 0.8, 0.9], [0.3, 0.3, 1.9, 1.9]]
# a box ten times the image beside a 40% zoom-out, on a quarter bound: a
# row counts more taps than a tile's window holds, so even a chunk of that
# one output cannot be staged and it reads device memory
ROW_PAST_EVERY_CHUNK = [[-4.5, -4.5, 5.5, 5.5], [-0.2, -0.2, 1.2, 1.2]]
# inverted boxes (y1 < y0, x1 < x0) on a 0.3 bound: no tap is valid, and a
# tile's rows run away from its window, so the nearest input of many lies
# outside it and they count 0 taps
INVERTED = [[0.9, 0.9, 0.1, 0.1], [0.6, 0.2, 0.5, 0.25], [0.3, 0.95, 0.2, 0.05]]
# (name, x shape, (oh, ow), boxes, max_box_frac): the table kernel's group
# edges (csrc/crop_tables.cu: G lanes per output row, segments of 4 G taps,
# windows of 32 taps).  W rows of 44 taps that span three sum windows; a
# window over 1024 taps on both axes (two sum levels); rows of about 300
# taps (a box ten times the image: the long path at every G); sub-pixel
# boxes (the one-hot) and inverted ones (counts of 0); 111 and 159 rows,
# which no group size's rows per block (16, 8, 4) divides
TABLE_EDGES = [
    ("three sum windows", (6, 1, 300, 520), (96, 112), ZOOM_OUT, 1.0),
    ("two sum levels", (2, 1, 2160, 3840), (224, 224),
     [[0.0, 0.0, 1.0, 1.0], [0.1, 0.3, 0.7, 0.9]], 1.0),
    ("row past every segment", (2, 1, 300, 520), (16, 16), ROW_PAST_EVERY_CHUNK, 0.25),
    ("sub-pixel", (4, 1, 300, 520), (96, 112),
     [[0.47, 0.55, 0.4701, 0.5502], [0.0, 0.0, 1e-4, 1e-4], [0.9999, 0.9999, 1.0, 1.0],
      [0.2, 0.3, 0.2 + 1 / 256, 0.31]], 1.0),
    ("zero-count rows", (3, 1, 300, 520), (96, 112), INVERTED, 0.3),
    ("ragged rows per block", (3, 1, 300, 520), (37, 53),
     [[0.1, 0.1, 0.9, 0.8], [0.0, 0.2, 0.5, 1.0], [0.3, 0.0, 1.0, 0.6]], 1.0),
]


def _zoom_out_boxes(n: int) -> np.ndarray:
    """``n`` zoom-out boxes: each axis spans 1.2 to 1.5 times the image,
    reaching past both edges (rows count more taps than T on W in every
    image, on H in most)."""
    rng = np.random.default_rng(1)
    span = rng.uniform(1.2, 1.5, (n, 2))
    lo = -rng.uniform(0.0, 1.0, (n, 2)) * (span - 1.0)
    return np.concatenate([lo, lo + span], axis=1).astype(np.float32)


def _crop_cases():
    """(name, x shape, boxes, (oh, ow), method, max_box_frac)"""
    rng = np.random.default_rng(7)
    # tests/test_crop.py's windowed-route cases
    full_and_border = [[0.0, 0.0, 1.0, 1.0], [0.1, 0.2, 0.8, 0.9],
                       [0.0, 0.5, 0.3, 1.0], [0.47, 0.55, 0.4701, 0.5502]]
    for m in ("bilinear", "box", "hamming"):
        yield (f"oracle {m}", (4, 3, 96, 160), full_and_border, (48, 64), m, 1.0)
    u = rng.uniform(0, 1, (3, 4))
    yield ("dense_route", (3, 2, 80, 144),
           np.stack([u[:, 0] * 0.4, u[:, 1] * 0.4, u[:, 0] * 0.4 + 0.3 + u[:, 2] * 0.3,
                     u[:, 1] * 0.4 + 0.3 + u[:, 3] * 0.3], -1), (32, 48), "bilinear", 1.0)
    for frac in (1.0, 0.45):
        yield (f"max_box_frac {frac}", (2, 1, 128, 256),
               [[0.2, 0.3, 0.55, 0.65], [0.0, 0.0, 0.4, 0.4]], (32, 32), "bilinear", frac)
    gen = torch.Generator().manual_seed(3)
    yield ("rrc", (4, 3, 120, 200), sample_boxes(gen, 4, 120, 200, (0.2, 0.9), (0.8, 1.25)),
           (32, 32), "bilinear", box_fracs(120, 200, (0.2, 0.9), (0.8, 1.25)))
    (shape, ohw) = TRAIN_B64
    yield ("b64 438x906 run_all boxes", shape, _run_all_boxes(shape[0]), ohw, "bilinear", 1.0)
    (shape, ohw) = CROP_4K
    yield ("4k rrc boxes", shape, sample_boxes(gen, shape[0], *shape[2:]), ohw, "bilinear",
           box_fracs(*shape[2:]))
    for m in ("bilinear", "box", "hamming"):
        yield (f"zoom-out {m}", (6, 3, 300, 520), ZOOM_OUT, (96, 112), m, 1.0)
    yield ("zoom-out frac 0.5", (6, 3, 300, 520), ZOOM_OUT, (160, 200), "bilinear", 0.5)
    # the boxes as a strided view: the first four columns of [N, 5] detections
    yield ("zoom-out strided boxes", (6, 3, 300, 520), ZOOM_OUT, (96, 112), "bilinear", 1.0)
    (shape, ohw) = TRAIN_B64
    yield ("b64 zoom-out boxes", shape, _zoom_out_boxes(shape[0]), ohw, "bilinear", 1.0)
    yield ("b64 mixed tiles", shape, (MIXED_TILE * 11)[:shape[0]], ohw, "bilinear", 1.0)
    (shape, ohw) = CROP_4K
    yield ("4k zoom-out boxes", shape, _zoom_out_boxes(shape[0]), ohw, "bilinear", 1.0)


def _crop_tables_vs_plain(tally: _Tally, name: str, x, b, ohw, method: str, frac,
                          precision: str):
    """The crop's per-image tables from the table kernel (one launch) against
    the plain build on the card, table by table: ``first`` and ``cnt``
    (each row's true count, past ``T`` for a zoom-out box) equal, ``w``
    equal bit for bit.  Returns the kernel's tables."""
    before = cc.launches_crop_tables
    got = cc._windowed_tables(x, b, ohw, method, True, frac, precision)
    torch.cuda.synchronize()
    if cc.launches_crop_tables != before + 1:
        raise RuntimeError(f"crop_tables {name}: not launched once")
    with _forced(cc, "_windowed_tables_cuda", cc._windowed_tables_plain):
        want = cc._windowed_tables(x, b, ohw, method, True, frac, precision)
    if got[2:] != want[2:] or [t.wins for t in got[:2]] != [t.wins for t in want[:2]]:
        raise RuntimeError(f"crop_tables {name} {precision}: pb or windows differ")
    err = 0.0
    for axis, g, w in zip("hw", got[:2], want[:2]):
        for f in ("first", "cnt", "w"):
            bits = _compare(f"crop_tables {name} {precision} {axis} {f}",
                            getattr(g, f).view(torch.int32), getattr(w, f).view(torch.int32))
            err = max(err, bits["max_abs_err"])
    tally.add(f"{name} {precision}", {"max_abs_err": err}, shape=list(x.shape), out=list(ohw),
              method=method, max_box_frac=frac, tables=2,
              taps=[int(got[0].cnt.max()), int(got[1].cnt.max())],
              tap_bound=[got[0].w.shape[-1], got[1].w.shape[-1]])
    return got


def _tables_at_lanes(tally: _Tally, name: str, shape, b, ohw, method: str, frac,
                     precision: str, lanes: int) -> None:
    """The table kernel with the plan forced to ``lanes`` lanes per row on
    both axes (1: one thread per row; 8, 16 or 32: a group) against the
    plain build, table by table."""
    N, _, H, W = shape
    mode = cc._mode(method, True)
    axes = [a for a, _ in cc._table_geometry(H, W, *ohw, mode, True, cc._fracs(frac),
                                             precision)]
    before = cc.launches_crop_tables
    with _forced(cc, "_table_plan", lambda *_: (lanes, lanes)):
        got = cc._windowed_tables_cuda(b, mode, True, axes)
    torch.cuda.synchronize()
    if cc.launches_crop_tables != before + 1:
        raise RuntimeError(f"crop_tables {name}: not launched once")
    want = cc._windowed_tables_plain(b, mode, True, axes)
    err = 0.0
    for axis, g, w in zip("hw", got, want):
        for f, x, y in zip(("first", "cnt", "w"), g, w):
            bits = _compare(f"crop_tables {name} {method} {precision} G={lanes} {axis} {f}",
                            x.view(torch.int32), y.view(torch.int32))
            err = max(err, bits["max_abs_err"])
    tally.add(f"{name} {method} {precision} G={lanes}", {"max_abs_err": err},
              shape=list(shape), out=list(ohw), method=method, max_box_frac=frac, lanes=lanes,
              taps=[int(g[1].max()) for g in got], tap_bound=[a.T for a in axes],
              window=[a.k for a in axes])


def check_table_groups(dev) -> float:
    """The table kernel at its group edges (:data:`TABLE_EDGES`, the boxes
    also as a strided view) for each filter and precision: through the
    call's own plan (:func:`_crop_tables_vs_plain`), then with one thread
    per row and every group size forced, and the 4K RandomResizedCrop at
    each of them: rows longer than G (chunks) and than 4 G (the long
    path)."""
    tt = _Tally("crop_tables group edges")
    (shape4k, ohw4k) = CROP_4K
    rrc4k = sample_boxes(torch.Generator().manual_seed(1), shape4k[0], *shape4k[2:])
    cases = [(*e, m) for e in TABLE_EDGES for m in ("bilinear", "box", "hamming")]
    cases.append(("4k rrc", shape4k, ohw4k, rrc4k, box_fracs(*shape4k[2:]), "bilinear"))
    for name, shape, ohw, boxes, frac, method in cases:
        x = torch.empty(shape, dtype=U8, device=dev)
        b = torch.as_tensor(np.asarray(boxes, np.float32)).to(dev)
        strided = torch.cat([b, torch.ones_like(b[:, :1])], 1)[:, :4]
        for precision in ("pil_int8", "split"):
            _crop_tables_vs_plain(tt, f"{name} {method}", x, b, ohw, method, frac, precision)
            _crop_tables_vs_plain(tt, f"{name} {method} strided", x, strided, ohw, method,
                                  frac, precision)
            for lanes in (1, *cc._TABLE_LANES):
                _tables_at_lanes(tt, name, shape, b, ohw, method, frac, precision, lanes)
        del x
    return tt.summary(tables_compared=2 * tt.cases)


def check_crop_kernel(dev) -> tuple[float, float]:
    """Both variants of crop_resample against their plain version on the
    card, over the same device-built tables; and those tables, from the
    table kernel, against the plain build.  The zoom-out cases come last
    (rows past the tables' bound, served whole); then one more call of
    boxes within the image in the same process, held to the plain version
    too: the context is still usable."""
    tally, tt = _Tally("crop_resample"), _Tally("crop_tables")
    seed = 500
    (b64, ohw64) = TRAIN_B64
    after = ("b64 after zoom-out", b64, _run_all_boxes(b64[0]), ohw64, "bilinear", 1.0)
    for name, shape, boxes, ohw, method, frac in [*_crop_cases(), after]:
        seed += 1
        x = _rand(shape, U8, dev, seed)
        b = torch.as_tensor(np.asarray(boxes, np.float32)).to(dev)
        if "strided" in name:
            b = torch.cat([b, torch.ones_like(b[:, :1])], 1)[:, :4]
            if b.is_contiguous():
                raise RuntimeError(f"crop_resample {name}: the boxes are not strided")
        for precision in ("pil_int8", "split"):
            tables = _crop_tables_vs_plain(tt, name, x, b, ohw, method, frac, precision)
            before = cc.launches_crop
            got = cc._crop_resample(x, *tables)
            torch.cuda.synchronize()
            if cc.launches_crop != before + 2:
                raise RuntimeError(f"crop_resample {name}: not launched twice")
            want = cc._crop_resample_plain(x, *tables)
            tally.add(f"{name} {precision}",
                      _compare(f"crop_resample {name} {precision}", got, want),
                      shape=list(shape), out=list(got.shape), method=method,
                      max_box_frac=frac, pb=[tables[2], tables[3]],
                      tap_bound=[tables[0].w.shape[-1], tables[1].w.shape[-1]],
                      taps=[int(tables[0].cnt.max()), int(tables[1].cnt.max())],
                      rows_past_bound=[int((t.cnt > t.w.shape[-1]).sum()) for t in tables[:2]])
            del tables, got, want
    return tally.summary(), tt.summary(tables_compared=2 * tt.cases)


def _f32_flips(n: int, seed: int) -> torch.Tensor:
    """Per-image flips at 0.5 (the preset's ``hflip_prob``), the first two
    fixed to both values."""
    flip = torch.rand(n, generator=torch.Generator().manual_seed(seed)) < 0.5
    flip[:2] = torch.tensor([True, False])
    return flip


def _crop_f32_cases():
    """(name, x shape, boxes, (oh, ow), method) of the float32-intermediate
    route: RandomResizedCrop and zoom-out boxes (rows past T, mirrored) at
    300x520 under each filter it admits, the train batch with both kinds
    of boxes, and 4K frames."""
    gen = torch.Generator().manual_seed(9)
    rrc = sample_boxes(gen, 6, 300, 520).numpy()
    for m in ("bilinear", "hamming", "box"):
        yield (f"rrc {m}", (6, 3, 300, 520), rrc, (96, 112), m)
        yield (f"zoom-out {m}", (6, 3, 300, 520), ZOOM_OUT, (96, 112), m)
    (shape, ohw) = TRAIN_B64
    yield ("b64 rrc", shape, sample_boxes(gen, shape[0], *shape[2:]).numpy(), ohw, "bilinear")
    yield ("b64 zoom-out", shape, _zoom_out_boxes(shape[0]), ohw, "bilinear")
    (shape, ohw) = CROP_4K
    yield ("4k rrc", shape, sample_boxes(gen, shape[0], *shape[2:]).numpy(), ohw, "bilinear")


def check_crop_f32_kernel(dev) -> float:
    """The float32-intermediate crop route (``crop_and_resize_f32``: one
    ``crop_tables`` launch with the flip folded into the W tables, then the
    uint8 -> float32 and float32 -> uint8 passes) against its plain version
    on the card: the tables against the plain build (``first``, ``cnt``
    equal, ``w`` bit for bit), the output against
    ``_crop_resample_plain`` over them bit for bit, and each flipped image
    exactly the mirror of the same call unflipped."""
    tally = _Tally("crop_f32")
    seed = 600
    for name, shape, boxes, ohw, method in _crop_f32_cases():
        seed += 1
        x = _rand(shape, U8, dev, seed)
        b = torch.as_tensor(np.asarray(boxes, np.float32)).to(dev)
        flip = _f32_flips(shape[0], seed).to(dev)
        before = (cc.launches_crop_tables, cc.launches_crop_f32, cc.launches_crop)
        got = cc.crop_and_resize_f32(x, b, ohw, method, flip=flip)
        torch.cuda.synchronize()
        if (cc.launches_crop_tables, cc.launches_crop_f32, cc.launches_crop) != (
                before[0] + 1, before[1] + 2, before[2]):
            raise RuntimeError(f"crop_f32 {name}: not one table and two f32 launches")
        tables = cc._f32_tables(x, b, ohw, method, flip)
        with _forced(cc, "_windowed_tables_cuda", cc._windowed_tables_plain):
            want_tables = cc._f32_tables(x, b, ohw, method, flip)
        for axis, g, w in zip("hw", tables[:2], want_tables[:2]):
            for f in ("first", "cnt", "w"):
                _compare(f"crop_f32 {name} tables {axis} {f}",
                         getattr(g, f).view(torch.int32), getattr(w, f).view(torch.int32))
        res = _compare(f"crop_f32 {name}", got,
                       cc._crop_resample_plain(x, *want_tables, torch.float32))
        unflipped = cc.crop_and_resize_f32(x, b, ohw, method)
        _compare(f"crop_f32 {name} mirror", got,
                 torch.where(flip[:, None, None, None], unflipped.flip(-1), unflipped))
        tally.add(name, res, shape=list(shape), out=list(got.shape), method=method,
                  flips=int(flip.sum()), tap_bound=[t.w.shape[-1] for t in tables[:2]],
                  taps=[int(t.cnt.max()) for t in tables[:2]],
                  rows_past_bound=[int((t.cnt > t.w.shape[-1]).sum()) for t in tables[:2]])
        del x, got, tables, want_tables, unflipped
    return tally.summary()


def _pil_axis_cases():
    """(name, x shape, axis, (xmin, Wb)): every shard's tables of n in {2,
    4, 8} shards, each filter, divisible and ceil-padded sizes, on the
    middle axis, the last axis and an NHWC view; and the W pass's tables."""
    for n in (2, 4, 8):
        for mode in MODES:
            for ih, oh in ((96, 40), (97, 41)):
                plan, starts, wsh = halo._int_halo_tables(ih, oh, mode, n)
                for layout, shape, axis in (("mid", (3, plan.ext, 70), 1),
                                            ("last", (3, 70, plan.ext), 2),
                                            ("nhwc", (2, plan.ext, 70, 3), 1)):
                    for d in range(n):
                        yield (f"n={n} {mode} {ih}->{oh} {layout} shard {d}", shape, axis,
                               (starts[d], wsh[d]))
    for mode in MODES:
        yield (f"w pass {mode}", (3, 40, 111), 2, pe._int_tables(111, 59, mode))
    # the tile kinds: inner 3, 5, 6 and 962 (no multiple of 4: one column
    # per thread), 8 and 960 (four), one output, an upsample; and a byte
    # offset (a name starting "offset": no row aligned, no vector path)
    for name, shape, n_in, n_out, mode in (
            ("inner3", (2, 83, 3), 83, 31, "lanczos3"), ("inner5", (2, 57, 5), 57, 23, "hamming"),
            ("inner6", (2, 57, 6), 57, 23, "bilinear"), ("inner8", (2, 57, 8), 57, 23, "bicubic"),
            ("inner960", (1, 60, 960), 60, 27, "bilinear"),
            ("inner962", (1, 60, 962), 60, 27, "bicubic"),
            ("n_out_1", (2, 50, 8), 50, 1, "box"), ("upsample", (2, 31, 72), 31, 90, "bicubic"),
            ("offset_last", (3, 40, 83), 83, 29, "bicubic"),
            ("offset_inner960", (1, 60, 960), 60, 27, "bilinear"),
            ("no_tile_fits", (2, 5000, 64), 5000, 1, "box")):
        axis = 2 if name.endswith("last") else 1
        yield (name, shape, axis, pe._int_tables(n_in, n_out, mode))


def check_pil_axis_kernel(dev) -> float:
    """pil_resample_axis against its plain version on the card, byte for
    byte."""
    tally = _Tally("pil_resample_axis")
    seed = 700
    for name, shape, axis, tables in _pil_axis_cases():
        seed += 1
        x = _rand(shape, U8, dev, seed)
        if name.startswith("offset"):
            x = _rand((math.prod(shape) + 1,), U8, dev, seed)[1:].reshape(shape)
        before = pe.launches_axis
        got = pe._resample_axis(x, tables, axis)
        torch.cuda.synchronize()
        if pe.launches_axis != before + 1:
            raise RuntimeError(f"pil_resample_axis {name}: not launched")
        want = pe._resample_axis_plain(_view3(x, axis), tables).reshape(got.shape)
        tally.add(name, _compare(f"pil_resample_axis {name}", got, want),
                  shape=list(shape), axis=axis, out=list(got.shape),
                  taps=int(tables[1].shape[1]))
    return tally.summary()


def check_shard_tables_kernel(dev) -> float:
    """Kernel B over every shard's compact tables of ``Wl[d]`` and of
    ``Wl[d]^T`` (the sharded float H pass, queue 2 row 9, and its adjoint),
    f32 and bf16, bit for bit."""
    tally = _Tally("resample_axis shard tables")
    seed = 900
    for n in (2, 4, 8):
        for mode in ("bilinear", "bicubic", "lanczos3"):
            for ih, oh in ((128, 48), (129, 40)):
                plan = halo.plan_halo_banded(ih, oh, mode, True, n)
                for d in range(n):
                    for which, t in zip(("forward", "adjoint"), halo._shard_tables(plan, d)):
                        for dt in (F32, BF16):
                            seed += 1
                            x = _rand((2, t.in_size, 37), dt, dev, seed)
                            before = cr.launches_axis
                            got = cr.resize_axis(x, t, 1, dt)
                            torch.cuda.synchronize()
                            if cr.launches_axis != before + 1:
                                raise RuntimeError("resample_axis shard tables: not launched")
                            want = cr._resample_axis_plain(x, t, dt)
                            name = f"n={n} {mode} {ih}->{oh} shard {d} {which} {dt}"
                            tally.add(name, _compare(name, got, want), taps=t.ntaps)
    return tally.summary()


def _fused2d_cases():
    """(name, x shape, (oh, ow), mode, spec kwargs, in dtype, out dtype)"""
    for mode in FUSED_MODES:
        for idt in DTYPES:
            for odt in DTYPES:
                yield (f"down {mode}", (3, 57, 83), (24, 31), mode, {}, idt, odt)
        yield (f"up {mode}", (3, 41, 60), (90, 130), mode, {}, F32, F32)
        yield (f"align_corners {mode}", (2, 97, 131), (40, 160), mode,
               dict(align_corners=True), F32, F32)
        yield (f"span {mode}", (2, 97, 131), (40, 60), mode, dict(span=(3.5, 90.0)),
               F32, F32)
    yield ("extreme_downscale", (1, 2160, 96), (8, 48), "lanczos3", {}, F32, F32)
    yield from _kernel_a_edges(("lanczos3", "lanczos5", "bicubic", "bilinear"))
    for shape, ohw, mode, idt, odt in JAX_CASES:
        if mode in FUSED_MODES:
            yield ("jax_case", shape, ohw, mode, {}, idt, odt)


def _fused_axis_cases():
    """(name, x shape, axis, n_out, mode, spec kwargs, in dtype, out dtype):
    inner == 1 (the last axis) and inner > 1 (a middle axis)."""
    for mode in FUSED_MODES:
        for idt in DTYPES:
            for odt in DTYPES:
                yield (f"last {mode}", (2, 57, 83), -1, 31, mode, {}, idt, odt)
                yield (f"mid {mode}", (2, 57, 83, 3), 1, 130, mode, {}, idt, odt)
        yield (f"align_corners {mode}", (2, 3, 97, 131), -2, 40, mode,
               dict(align_corners=True), F32, F32)
        yield (f"span {mode}", (2, 3, 97, 131), -1, 60, mode, dict(span=(3.5, 90.0)),
               F32, F32)
    for name, shape, axis, n_out, mode, idt, odt in _axis_edges("bicubic", "lanczos3",
                                                                "bilinear"):
        yield (name, shape, axis, n_out, mode, {}, idt, odt)


def check_fused_kernels(dev) -> tuple[float, float]:
    """The fused twins of resample2d and resample_axis (weights synthesised
    in the kernel) against their plain versions on the card, bit for bit:
    the plain versions build the weights with the kernels' float32
    operations in their order, through torch's CUDA sin and cos."""
    t2d, tax = _Tally("resample2d_fused"), _Tally("resample_axis_fused")
    seed = 1000
    for name, shape, ohw, mode, kw, idt, odt in _fused2d_cases():
        seed += 1
        x = _rand(shape, idt, dev, seed)
        if name.startswith("offset"):
            x = x[1:]
        sh = make_axis_spec(shape[-2], ohw[0], mode, **kw)
        sw = make_axis_spec(shape[-1], ohw[1], mode, **kw)
        before = launch_counts()
        got = cr.resize2d(x, sh, sw, odt, fused=True)
        torch.cuda.synchronize()
        if launch_counts() != dict(before, resample2d_fused=before["resample2d_fused"] + 1):
            raise RuntimeError(f"resample2d_fused {name}: not launched once, alone")
        want = cr._resample2d_fused_plain(_view3(x, -2), sh, sw, odt).reshape(got.shape)
        t2d.add(name, _compare(f"resample2d_fused {name}", got, want), shape=list(x.shape),
                out=list(got.shape), mode=mode, **kw, dtypes=[str(idt), str(odt)],
                plan=_plan_of(x, sh, sw, fused=True))
    # no output tile's row window fits shared memory: two fused axis passes
    x = _rand((2, 58200, 4), F32, dev, 1100)
    sh, sw = make_axis_spec(58200, 1, "bilinear"), make_axis_spec(4, 4, "bilinear")
    if _plan_of(x, sh, sw, fused=True) is not None:
        raise RuntimeError("the fused fallback case fits a tile")
    before = launch_counts()
    got = cr.resize2d(x, sh, sw, F32, fused=True)
    torch.cuda.synchronize()
    if launch_counts() != dict(before, resample_axis_fused=before["resample_axis_fused"] + 2):
        raise RuntimeError("the fused fallback did not run two fused resample_axis passes")
    y = cr._resample_axis_fused_plain(_view3(x, 2), sw, F32).reshape(x.shape)
    want = cr._resample_axis_fused_plain(_view3(y, 1), sh, F32).reshape(got.shape)
    tax.add("no_tile_fits_fallback", _compare("fused fallback", got, want),
            shape=list(x.shape), out=list(got.shape), taps=sh.ntaps)
    for name, shape, axis, n_out, mode, kw, idt, odt in _fused_axis_cases():
        seed += 1
        x = _axis_input(name, shape, idt, dev, seed)
        spec = make_axis_spec(shape[axis], n_out, mode, **kw)
        before = launch_counts()
        got = cr.resize_axis(x, spec, axis, odt, fused=True)
        torch.cuda.synchronize()
        if launch_counts() != dict(before, resample_axis_fused=before["resample_axis_fused"] + 1):
            raise RuntimeError(f"resample_axis_fused {name}: not launched once, alone")
        want = cr._resample_axis_fused_plain(_view3(x, axis), spec, odt).reshape(got.shape)
        tax.add(name, _compare(f"resample_axis_fused {name}", got, want),
                shape=list(shape), axis=axis, out=list(got.shape), mode=mode, **kw,
                dtypes=[str(idt), str(odt)])
    return t2d.summary(), tax.summary()


# ---------------------------------------------------------------------------
# 2b. the axis kernels' staged body at every tile the plan considers
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _forced(module, name, fn):
    """``module.name`` is ``fn`` inside the block (a wrapper's plan forced
    past the host's: the axis kernels' ``cuda_resize._plan_axis_first``, a
    ``PlanAxis`` tile of the staged body or None, the unstaged body; the
    Pillow kernel's ``pil_exact._plan_2pass``; the crop's
    ``crop_cuda._crop_plan``)."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


def _every_tile(first, ntaps: int, x3: torch.Tensor) -> list:
    """Every tile ``cuda_resize._axis_candidates`` lists for a pass over
    ``x3`` (the tiles the plan picks from; partial last tiles along each
    axis included), then None: the unstaged body."""
    outer, n_in, inner = x3.shape
    plans = [p for _, p in cr._axis_candidates(
        np.asarray(first, np.int64), ntaps, n_in, outer, inner, x3.element_size(),
        cr._H100_SMS, x3.data_ptr() % 4 == 0)]
    return list(dict.fromkeys(plans)) + [None]


def _tile_cases():
    """(name, x shape, axis, n_out, mode, in dtype, out dtype): the axis
    edges, every dtype pair on the last axis and a wide inner, and more
    than 16 taps (the loop bucket)."""
    yield from _axis_edges("bicubic", "lanczos3", "bilinear")
    for idt in DTYPES:
        for odt in DTYPES:
            yield ("pair_last", (2, 37, 83), -1, 29, "bicubic", idt, odt)
            yield ("pair_inner249", (2, 57, 83, 3), 1, 23, "lanczos3", idt, odt)
    yield ("taps_gt16_last", (3, 5, 240), -1, 30, "lanczos3", F32, F32)
    yield ("taps_gt16_inner5", (2, 240, 5), 1, 30, "lanczos3", F32, F32)
    yield ("offset_taps_gt16", (3, 241, 7), 1, 25, "bicubic", BF16, BF16)


def _pil_tile_cases():
    """(name, x shape, axis, (xmin, Wb)): the Pillow axis edges, more than
    16 taps, and a byte offset."""
    for name, shape, axis, tables in _pil_axis_cases():
        if not name.startswith("n=") and not name.startswith("w pass"):
            yield name, shape, axis, tables
    yield ("taps_gt16", (2, 240, 8), 1, pe._int_tables(240, 20, "bicubic"))
    yield ("offset_taps_gt16_last", (3, 6, 240), 2, pe._int_tables(240, 20, "lanczos3"))


def _staged_offset_cases():
    """Passes above the unstaged body's cut, on inputs that start off 16
    bytes, through the production plan: (name, kind, x shape, axis, n_out,
    mode, dtype)."""
    for kind in ("table", "fused"):
        yield (f"nhwc_w_offset {kind}", kind, (16, 437, 905, 3), 2, 300, "bicubic", F32)
        yield (f"wide_h_offset {kind}", kind, (16, 437, 2715), 1, 200, "bilinear", F32)
    yield ("last_offset pil", "pil", (8, 2001, 4001), 2, 1000, "bilinear", U8)
    yield ("wide_h_offset pil", "pil", (4, 3001, 4003), 1, 1000, "bicubic", U8)


def _offset_input(shape, dtype, dev, seed):
    """A tensor of ``shape`` that starts one element after a 16-byte
    boundary."""
    return _rand((math.prod(shape) + 1,), dtype, dev, seed)[1:].reshape(shape)


def check_axis_tiles(dev) -> tuple[float, float, float]:
    """kernel B, its fused twin and pil_resample_axis at every tile of each
    edge case (forced past the plan, which picks the unstaged body for
    passes this small), bit for bit against the plain version; then
    passes above the cut on inputs off 16 bytes through the plan itself."""
    tallies = {k: _Tally(f"{n} every tile") for k, n in (
        ("table", "resample_axis"), ("fused", "resample_axis_fused"),
        ("pil", "pil_resample_axis"))}
    counters = {"table": "resample_axis", "fused": "resample_axis_fused",
                "pil": "pil_resample_axis"}
    seed = 1500

    def launch(kind, x, spec, axis, odt, plan):
        before = launch_counts()
        with _forced(cr, "_plan_axis_first", lambda *args, p=plan: p):
            if kind == "pil":
                got = pe._resample_axis(x, spec, axis)
            else:
                got = cr.resize_axis(x, spec, axis, odt, fused=kind == "fused")
        torch.cuda.synchronize()
        c = counters[kind]
        if launch_counts() != dict(before, **{c: before[c] + 1}):
            raise RuntimeError(f"{c}: not launched once, alone")
        return got

    def every_tile(kind, name, x, spec, axis, odt, first, ntaps, want, **fields):
        plans = _every_tile(first, ntaps, _view3(x, axis))
        staged = 0
        for plan in plans:
            got = launch(kind, x, spec, axis, odt, plan)
            res = _compare(f"{counters[kind]} {name} {plan}", got, want.reshape(got.shape))
            staged += plan is not None
        tallies[kind].add(name, res, tiles=staged, unstaged=1, shape=list(x.shape), axis=axis,
                          taps=ntaps, dtypes=[str(x.dtype), str(odt)], **fields)

    for name, shape, axis, n_out, mode, idt, odt in _tile_cases():
        seed += 1
        x = _axis_input(name, shape, idt, dev, seed)
        spec = make_axis_spec(shape[axis], n_out, mode)
        first, w = cr._tables(spec)
        want = cr._resample_axis_plain(_view3(x, axis), spec, odt)
        every_tile("table", name, x, spec, axis, odt, first, w.shape[1], want)
        want = cr._resample_axis_fused_plain(_view3(x, axis), spec, odt)
        every_tile("fused", name, x, spec, axis, odt, cr._synth_first(spec), spec.ntaps, want)
    for name, shape, axis, tables in _pil_tile_cases():
        seed += 1
        x = (_offset_input(shape, U8, dev, seed) if name.startswith("offset")
             else _rand(shape, U8, dev, seed))
        want = pe._resample_axis_plain(_view3(x, axis), tables)
        every_tile("pil", name, x, tables, axis, U8, tables[0], tables[1].shape[1], want)
    for name, kind, shape, axis, n_out, mode, dt in _staged_offset_cases():
        seed += 1
        x = _offset_input(shape, dt, dev, seed)
        x3 = _view3(x, axis)
        if kind == "pil":
            spec = pe._int_tables(shape[axis], n_out, mode)
            first, ntaps = spec[0], spec[1].shape[1]
            want = pe._resample_axis_plain(x3, spec)
        else:
            spec = make_axis_spec(shape[axis], n_out, mode)
            fused = kind == "fused"
            first = cr._synth_first(spec) if fused else cr._tables(spec)[0]
            ntaps = spec.ntaps if fused else cr._tables(spec)[1].shape[1]
            want = (cr._resample_axis_fused_plain if fused else cr._resample_axis_plain)(
                x3, spec, dt)
        plan = cr._plan_axis_first(np.asarray(first, np.int64).tobytes(), ntaps,
                                   x3.shape[1], x3.shape[0], x3.shape[2], x.element_size(),
                                   cr._n_sm(dev), x3.data_ptr() % 4 == 0, kind == "fused")
        if plan is None:
            raise RuntimeError(f"{name}: the plan ran the unstaged body above the cut")
        before = launch_counts()
        if kind == "pil":
            got = pe._resample_axis(x, spec, axis)
        else:
            got = cr.resize_axis(x, spec, axis, dt, fused=kind == "fused")
        torch.cuda.synchronize()
        c = counters[kind]
        if launch_counts() != dict(before, **{c: before[c] + 1}):
            raise RuntimeError(f"{c} {name}: not launched once, alone")
        tallies[kind].add(name, _compare(f"{c} {name}", got, want.reshape(got.shape)),
                          plan=plan._asdict(), shape=list(shape), axis=axis,
                          offset_bytes=x.data_ptr() % 16)
        del x, x3, got, want
    torch.cuda.empty_cache()
    return tuple(t.summary() for t in tallies.values())


# ---------------------------------------------------------------------------
# 2c. the two uint8 kernels on kernels A and B at every tile
# ---------------------------------------------------------------------------


def _pil_2pass_edges():
    """(name, x3 shape, (oh, ow), mode, pb, offset): the bench batch and the
    4K -> HD frame, 70,000 planes, lanczos3 past 16 taps (the loop bucket),
    pb 14 (digits=2), an upsample, one-row and one-column outputs, an input
    off 16 bytes, and a downscale where no tile fits (two pil_resample_axis
    passes; no tile to force)."""
    (b, c, h, w), ohw = BENCH
    yield ("bench", (b * c, h, w), ohw, "bilinear", 22, False)
    yield ("4k->hd", UHD[0], UHD[1], "bilinear", 22, False)
    yield ("70000 planes", (70000, 8, 8), (4, 5), "bilinear", 22, False)
    yield ("lanczos3 > 16 taps", (2, 300, 400), (40, 50), "lanczos3", 22, False)
    yield ("pb 14", (3, 57, 83), (24, 31), "bicubic", 14, False)
    yield ("upsample", (2, 31, 72), (90, 150), "bicubic", 22, False)
    yield ("one row", (2, 40, 60), (1, 30), "hamming", 22, False)
    yield ("one column", (2, 40, 60), (20, 1), "box", 22, False)
    yield ("offset", (2, 57, 83), (24, 31), "bicubic", 22, True)
    yield ("no tile fits", (1, 20000, 64), (10, 32), "lanczos3", 22, False)


def _crop_edge_cases():
    """(name, x shape, boxes, (oh, ow), max_box_frac): sub-pixel boxes,
    boxes touching each edge, RandomResizedCrop draws past a 0.45 bound,
    more than 128 outputs, zoom-out boxes, tiles that mix rows past the tap
    bound with rows within it, a row too wide for a chunk of one output,
    the 4K random_resized_crop."""
    sub = [[0.47, 0.55, 0.4701, 0.5502], [0.0, 0.0, 1e-4, 1e-4], [0.9999, 0.9999, 1.0, 1.0],
           [0.2, 0.3, 0.2 + 1 / 256, 0.31]]
    edges = [[0.0, 0.0, 1.0, 1.0], [0.0, 0.3, 0.5, 0.7], [0.5, 0.3, 1.0, 0.7],
             [0.3, 0.0, 0.7, 0.5], [0.3, 0.5, 0.7, 1.0], [0.6, 0.0, 1.0, 1.0]]
    rrc = sample_boxes(torch.Generator().manual_seed(5), 6, 300, 520).numpy()
    yield ("sub-pixel", (4, 3, 300, 520), sub, (96, 112), 1.0)
    for frac in (1.0, 0.45):
        yield (f"edges frac {frac}", (6, 3, 300, 520), edges, (96, 112), frac)
    yield ("rrc frac 0.45", (6, 3, 300, 520), rrc, (160, 200), 0.45)
    yield ("wide out", (6, 1, 300, 520), rrc, (150, 300), 1.0)
    for frac in (1.0, 0.5):
        yield (f"zoom-out frac {frac}", (6, 3, 300, 520), ZOOM_OUT, (96, 112), frac)
    yield ("mixed tiles", (6, 3, 300, 520), MIXED_TILE, (96, 112), 1.0)
    yield ("row past every chunk", (2, 3, 150, 260), ROW_PAST_EVERY_CHUNK, (16, 16), 0.25)
    (shape, ohw) = CROP_4K
    yield ("4k rrc", shape, sample_boxes(torch.Generator().manual_seed(1), shape[0],
                                         *shape[2:]).numpy(), ohw, box_fracs(*shape[2:]))


def check_u8_tiles(dev) -> tuple[float, float, float]:
    """The Pillow two-pass kernel (kernel A over Pillow's tables) and the
    crop passes (kernel B with per-image tables) at their edges: each case
    through the production plan, then with every tile the plan considers
    forced (both crop passes in turn, the other on its plan, and kernel B's
    unstaged body), byte for byte against the plain version; the crop's
    tables from the table kernel against the plain build at each edge."""
    tp, tc = _Tally("pil_resample_2pass every tile"), _Tally("crop_resample every tile")
    tt = _Tally("crop_tables edges")
    for name, shape, ohw, mode, pb, offset in _pil_2pass_edges():
        x3 = (_offset_input(shape, U8, dev, 41) if offset else _rand(shape, U8, dev, 41))
        tw = pe._int_tables(shape[2], ohw[1], mode, pb=pb)
        th = pe._int_tables(shape[1], ohw[0], mode, pb=pb)
        want = pe._resample_2pass_plain(x3, tw, th, pb)
        plan = pe._plan_2pass(tw, th, shape[0], shape[1], shape[2], cr._n_sm(dev))
        before = launch_counts()
        res = _compare(f"pil_resample_2pass {name}", pe._resample_2pass(x3, tw, th, pb), want)
        c = ("pil_resample_2pass", 1) if plan is not None else ("pil_resample_axis", 2)
        if launch_counts() != dict(before, **{c[0]: before[c[0]] + c[1]}):
            raise RuntimeError(f"pil_resample_2pass {name}: not {c[1]} {c[0]} launch(es)")
        tiles = [p for _, p in cr._rows_candidates(
            th[0], th[1].shape[1], shape[1], tw[0], tw[1].shape[1], shape[2], 1, shape[0],
            cr._n_sm(dev), inter_size=1)]
        for p in tiles:
            with _forced(pe, "_plan_2pass", lambda *a, p=p: p):
                _compare(f"pil_resample_2pass {name} {p}", pe._resample_2pass(x3, tw, th, pb),
                         want)
        tp.add(name, res, shape=list(shape), out=list(ohw), mode=mode, pb=pb,
               offset_bytes=x3.data_ptr() % 16, plan=None if plan is None else plan._asdict(),
               tiles=len(tiles))
        del x3, want
    for name, shape, boxes, ohw, frac in _crop_edge_cases():
        x = _rand(shape, U8, dev, 42)
        b = torch.as_tensor(np.asarray(boxes, np.float32)).to(dev)
        N, C, H, W = shape
        for precision in ("pil_int8", "split"):
            tables = _crop_tables_vs_plain(tt, name, x, b, ohw, "bilinear", frac, precision)
            want = cc._crop_resample_plain(x, *tables)
            res = _compare(f"crop_resample {name} {precision}", cc._crop_resample(x, *tables),
                           want)
            n, plans = 0, []
            for which, tab, n_in, n_out, R, inner in (
                    ("h", tables[0], H, ohw[0], C, W), ("w", tables[1], W, ohw[1], C * ohw[0], 1)):
                T = tab.w.shape[-1]
                plans.append(cc._crop_plan(tab.wins, n_in, n_out, T, N, R, inner,
                                           cr._n_sm(dev), x.data_ptr() % 4 == 0, 1))
                cands = [p for _, p in cr._axis_tiles(
                    tab.wins, n_out, T, n_in, N * R, inner, 1, cr._n_sm(dev),
                    x.data_ptr() % 4 == 0, per_img=R)]
                for p in list(dict.fromkeys(cands)) + [None]:
                    def pick(wins, n_in, n_out, T, N, R, inner, n_sm, vec4, itemsize, p=p,
                             which=which, real=cc._crop_plan):
                        if (inner > 1) == (which == "h"):
                            return p
                        return real(wins, n_in, n_out, T, N, R, inner, n_sm, vec4, itemsize)
                    with _forced(cc, "_crop_plan", pick):
                        _compare(f"crop_resample {name} {precision} {which} {p}",
                                 cc._crop_resample(x, *tables), want)
                    n += 1
            tc.add(f"{name} {precision}", res, shape=list(shape), out=list(ohw),
                   max_box_frac=frac, taps=[tables[0].w.shape[-1], tables[1].w.shape[-1]],
                   plans=[None if p is None else p._asdict() for p in plans], tiles=n)
            del tables, want
        del x
        torch.cuda.empty_cache()
    return tp.summary(), tc.summary(), tt.summary(tables_compared=2 * tt.cases)


# ---------------------------------------------------------------------------
# 3. the main paths
# ---------------------------------------------------------------------------


def _reset() -> None:
    pe.launches = cr.launches_2d = cr.launches_axis = cc.launches_crop = 0
    cc.launches_crop_tables = cc.launches_crop_f32 = 0
    pe.launches_axis = cr.launches_2d_fused = cr.launches_axis_fused = 0


def _expect(phase: str, want: dict) -> dict:
    """The launch counts since :func:`_reset` against ``want`` (kernels it
    does not name: 0)."""
    got = launch_counts()
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        raise RuntimeError(f"{phase}: kernel launches {got}, expected {want}")
    return got


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel's wrapper runs its plain version on the card instead of
    launching (no count moves): the reference run of a main path."""
    saved = (cr._resample2d_cuda, cr._resample_axis_cuda,
             pe._resample_2pass_cuda, cc._crop_resample_cuda, pe._resample_axis_cuda,
             cr._resample2d_fused_cuda, cr._resample_axis_fused_cuda, cc._windowed_tables_cuda)
    cr._resample2d_cuda = lambda x3, sh, sw, odt, plan: cr._resample2d_plain(x3, sh, sw, odt)
    cr._resample_axis_cuda = cr._resample_axis_plain
    pe._resample_2pass_cuda = pe._resample_2pass_plain
    cc._crop_resample_cuda = cc._crop_resample_plain
    pe._resample_axis_cuda = pe._resample_axis_plain
    cr._resample2d_fused_cuda = (
        lambda x3, sh, sw, odt, plan: cr._resample2d_fused_plain(x3, sh, sw, odt))
    cr._resample_axis_fused_cuda = cr._resample_axis_fused_plain
    cc._windowed_tables_cuda = cc._windowed_tables_plain
    try:
        yield
    finally:
        (cr._resample2d_cuda, cr._resample_axis_cuda,
         pe._resample_2pass_cuda, cc._crop_resample_cuda, pe._resample_axis_cuda,
         cr._resample2d_fused_cuda, cr._resample_axis_fused_cuda,
         cc._windowed_tables_cuda) = saved


def main_path_u8_pipeline(dev) -> int:
    erng = np.random.default_rng(0)
    batch = (erng.random(ENTRY[0]) * 255).astype(np.uint8)
    pipe = ImageNetEvalPipeline(size=ENTRY[1]).to(dev)
    x = torch.from_numpy(batch).to(dev)
    calls = 3
    _reset()
    for _ in range(calls):
        y = pipe(x)
    torch.cuda.synchronize()
    counts = _expect("u8 eval pipeline", {"pil_resample_2pass": calls,
                                          "resample2d": 0, "resample_axis": 0})
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
    _line("main_path", path="u8 eval pipeline", batch=list(ENTRY[0]),
          size=list(ENTRY[1]), launches=counts, calls=calls, u8_equal=True,
          max_abs_err_vs_cpu=out_err)
    return counts["pil_resample_2pass"]


def main_path_config5(dev) -> int:
    (shape, ohw), calls = CONFIG5, 2
    x = _rand(shape, BF16, dev, 5)
    vd = VideoDownscaler(out_hw=ohw)
    _reset()
    for _ in range(calls):
        y = vd(x)
    torch.cuda.synchronize()
    counts = _expect("config 5", {"pil_resample_2pass": 0, "resample2d": calls,
                                  "resample_axis": 0})
    sh, sw = make_axis_spec(shape[-2], ohw[0]), make_axis_spec(shape[-1], ohw[1])
    with full_f32():
        want = cr._resample2d_plain(_view3(x, -2), sh, sw, BF16).reshape(y.shape)
    res = _compare("config 5", y, want)
    _line("main_path", path="config 5 VideoDownscaler", shape=list(shape),
          out=list(y.shape), dtype=str(y.dtype), launches=counts, calls=calls,
          **res)
    return counts["resample2d"]


def main_path_headline(dev) -> tuple[int, int]:
    shape, ohw = HEADLINE
    n2d = naxis = 0
    for layout in ("NCHW", "NHWC"):
        for mode in ("bilinear", "bicubic"):
            x = _rand(shape, F32, dev, 7)
            sh, sw = make_axis_spec(shape[-2], ohw[0], mode), \
                make_axis_spec(shape[-1], ohw[1], mode)
            if layout == "NHWC":
                x = x.permute(0, 2, 3, 1).contiguous()
            _reset()
            y = resize(x, ohw, method=mode, data_format=layout)
            torch.cuda.synchronize()
            if layout == "NCHW":
                counts = _expect(f"headline {layout} {mode}", {
                    "pil_resample_2pass": 0, "resample2d": 1, "resample_axis": 0})
                want = cr._resample2d_plain(_view3(x, -2), sh, sw, F32)
            else:
                counts = _expect(f"headline {layout} {mode}", {
                    "pil_resample_2pass": 0, "resample2d": 0, "resample_axis": 2})
                t = cr._resample_axis_plain(_view3(x, 2), sw, F32)
                t = t.reshape(1, shape[-2], ohw[1], 3)
                want = cr._resample_axis_plain(_view3(t, 1), sh, F32)
            n2d += counts["resample2d"]
            naxis += counts["resample_axis"]
            res = _compare(f"headline {layout} {mode}", y, want.reshape(y.shape))
            _line("main_path", path=f"configs 1-2 resize {layout} {mode}",
                  shape=list(x.shape), out=list(y.shape), launches=counts, **res)
    return n2d, naxis


def main_path_f32_pipeline(dev) -> int:
    erng = np.random.default_rng(0)
    batch = (erng.random(ENTRY[0]) * 255).astype(np.uint8)
    pipe = ImageNetEvalPipeline(size=ENTRY[1], resize_domain="float32").to(dev)
    x = torch.from_numpy(batch).to(dev)
    calls = 3
    _reset()
    for _ in range(calls):
        y = pipe(x)
    torch.cuda.synchronize()
    counts = _expect("f32 eval pipeline", {"pil_resample_2pass": 0,
                                           "resample2d": calls, "resample_axis": 0})
    sh = make_axis_spec(ENTRY[0][-2], ENTRY[1][0])
    sw = make_axis_spec(ENTRY[0][-1], ENTRY[1][1])
    # the kernel reads the uint8 batch and writes float32; then the
    # pipeline's own normalisation, op for op
    r = cr._resample2d_plain(_view3(x, -2), sh, sw, F32)
    r = r.reshape(ENTRY[0][0], 3, *ENTRY[1]) * torch.tensor(1.0 / 255.0)
    want = (r - pipe.mean) / pipe.std
    res = _compare("f32 eval pipeline", y, want)
    _line("main_path", path="f32 eval pipeline", batch=list(ENTRY[0]),
          size=list(ENTRY[1]), launches=counts, calls=calls, **res)
    return counts["resample2d"]


def main_path_config4(dev) -> tuple[int, int]:
    """BASELINE config 4 as benchmarks/run_all.py runs it: the VJP of
    ``resize_plane`` (cotangent = the output), bilinear and bicubic, and the
    train-step resize backward (grad of a mean squared error); then the
    NHWC bicubic VJP (the per-axis kernel and its adjoint)."""
    (shape, ohw) = CONFIG4
    x = _rand(shape, F32, dev, 41).div_(255.0)
    tgt = _rand((shape[0], shape[1], *ohw), F32, dev, 42).div_(255.0)

    def vjp(mode, layout="NCHW"):
        xr = (x if layout == "NCHW" else x.permute(0, 2, 3, 1).contiguous())
        xr = xr.detach().requires_grad_()
        h, w = (2, 3) if layout == "NCHW" else (1, 2)
        y = resize_plane(xr, ohw, h, w, mode=mode)
        return torch.autograd.grad(y, xr, grad_outputs=y)[0]

    def train_bwd():
        xr = x.detach().requires_grad_()
        loss = ((resize_plane(xr, ohw, 2, 3, mode="bilinear") - tgt) ** 2).mean()
        return torch.autograd.grad(loss, xr)[0]

    n2d = naxis = 0
    for name, fn, want in [
        ("bilinear-vjp-b8", lambda: vjp("bilinear"), {"resample2d": 2}),
        ("bicubic-vjp-b8", lambda: vjp("bicubic"), {"resample2d": 2}),
        ("train-step-resize-bwd-b8", train_bwd, {"resample2d": 2}),
        ("bicubic-vjp-b8 NHWC", lambda: vjp("bicubic", "NHWC"), {"resample_axis": 4}),
    ]:
        _reset()
        got = fn()
        torch.cuda.synchronize()
        counts = _expect(f"config 4 {name}", want)
        n2d += counts["resample2d"]
        naxis += counts["resample_axis"]
        with _plain_kernels():
            ref = fn()
        res = _compare(f"config 4 {name}", got, ref)
        _line("main_path", path=f"config 4 {name}", shape=list(shape), out=list(ohw),
              grad_shape=list(got.shape), launches=counts, **res)
    return n2d, naxis


def _within_bf16_step(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """bfloat16 outputs of two float32 sums that differ in their last bits:
    each element within one bfloat16 step (2^-7 of the larger value)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if not bool((d <= 2.0**-7 * torch.maximum(g.abs(), w.abs())).all()):
        raise RuntimeError(f"{name}: more than one bfloat16 step from the table route")
    return float(d.max())


def main_path_fused(dev) -> tuple[int, int]:
    """Row 8 at full width, through the fused route's entry points: BASELINE
    config 5 through ``resize2d(fused=True)``, configs 1-2 NCHW through
    ``resize2d(fused=True)`` and NHWC through two ``resize_axis(fused=True)``,
    and the bench batch u8 -> u8; each with the counts set to 0 just before
    and read just after (the fused kernels only, no table kernel), held to
    the fused plain versions bit for bit and to the table route within one
    bfloat16 step (config 5), 3e-5 * max (float32: the JAX package's kernel
    test bound, tests/test_pallas_kernels.py:39) or one grey level (u8,
    tests/test_resize2d_fused.py:89-90)."""
    n2d = naxis = 0
    # config 5: bf16 [64, 3, 2160, 3840] -> 1080 x 1920
    (shape, ohw) = CONFIG5
    x = _rand(shape, BF16, dev, 5)
    sh, sw = make_axis_spec(shape[-2], ohw[0]), make_axis_spec(shape[-1], ohw[1])
    _reset()
    y = cr.resize2d(x, sh, sw, BF16, fused=True)
    torch.cuda.synchronize()
    counts = _expect("fused config 5", {"resample2d_fused": 1})
    n2d += counts["resample2d_fused"]
    res = _compare("fused config 5 vs plain", y,
                   cr._resample2d_fused_plain(_view3(x, -2), sh, sw, BF16).reshape(y.shape))
    res["max_abs_err_vs_tables"] = _within_bf16_step(
        "fused config 5", y, cr.resize2d(x, sh, sw, BF16))
    _line("main_path", path="config 5 resize2d(fused=True)", shape=list(shape),
          out=list(y.shape), dtype=str(y.dtype), launches=counts, **res)
    del x, y
    torch.cuda.empty_cache()

    # configs 1-2: f32 [1, 3, 438, 906] -> 196 x 320, NCHW and NHWC
    (shape, ohw) = HEADLINE
    for mode in ("bilinear", "bicubic"):
        sh, sw = make_axis_spec(shape[-2], ohw[0], mode), make_axis_spec(shape[-1], ohw[1], mode)
        x = _rand(shape, F32, dev, 7)
        _reset()
        y = cr.resize2d(x, sh, sw, F32, fused=True)
        torch.cuda.synchronize()
        counts = _expect(f"fused headline NCHW {mode}", {"resample2d_fused": 1})
        n2d += counts["resample2d_fused"]
        res = _compare(f"fused headline NCHW {mode} vs plain", y,
                       cr._resample2d_fused_plain(_view3(x, -2), sh, sw, F32).reshape(y.shape))
        table = cr.resize2d(x, sh, sw, F32)
        res["max_abs_err_vs_tables"] = _max_abs(y, table)
        if res["max_abs_err_vs_tables"] > 3e-5 * float(table.abs().max()):
            raise RuntimeError(f"fused headline NCHW {mode}: {res['max_abs_err_vs_tables']} "
                               "from the table route")
        _line("main_path", path=f"configs 1-2 resize2d(fused=True) NCHW {mode}",
              shape=list(shape), out=list(y.shape), launches=counts, **res)

        xn = x.permute(0, 2, 3, 1).contiguous()
        _reset()
        y = cr.resize_axis(cr.resize_axis(xn, sw, 2, fused=True), sh, 1, fused=True)
        torch.cuda.synchronize()
        counts = _expect(f"fused headline NHWC {mode}", {"resample_axis_fused": 2})
        naxis += counts["resample_axis_fused"]
        t = cr._resample_axis_fused_plain(_view3(xn, 2), sw, F32).reshape(1, shape[-2], ohw[1], 3)
        res = _compare(f"fused headline NHWC {mode} vs plain", y,
                       cr._resample_axis_fused_plain(_view3(t, 1), sh, F32).reshape(y.shape))
        table = cr.resize_axis(cr.resize_axis(xn, sw, 2), sh, 1)
        res["max_abs_err_vs_tables"] = _max_abs(y, table)
        if res["max_abs_err_vs_tables"] > 3e-5 * float(table.abs().max()):
            raise RuntimeError(f"fused headline NHWC {mode}: {res['max_abs_err_vs_tables']} "
                               "from the table route")
        _line("main_path", path=f"configs 1-2 resize_axis(fused=True) NHWC {mode}",
              shape=list(xn.shape), out=list(y.shape), launches=counts, **res)

    # the bench batch, u8 [64, 3, 438, 906] -> 196 x 320 u8 -> u8
    (shape, ohw) = BENCH
    x = _rand(shape, U8, dev, 8)
    sh, sw = make_axis_spec(shape[-2], ohw[0]), make_axis_spec(shape[-1], ohw[1])
    _reset()
    y = cr.resize2d(x, sh, sw, U8, fused=True)
    torch.cuda.synchronize()
    counts = _expect("fused bench u8", {"resample2d_fused": 1})
    n2d += counts["resample2d_fused"]
    res = _compare("fused bench u8 vs plain", y,
                   cr._resample2d_fused_plain(_view3(x, -2), sh, sw, U8).reshape(y.shape))
    table = cr.resize2d(x, sh, sw, U8)
    res["max_abs_err_vs_tables"] = _max_abs(y, table)
    res["differing_from_tables"] = int((y != table).sum())
    if res["max_abs_err_vs_tables"] > 1.0:
        raise RuntimeError(f"fused bench u8: {res['max_abs_err_vs_tables']} grey levels "
                           "from the table route")
    _line("main_path", path="bench batch resize2d(fused=True) u8->u8", shape=list(shape),
          out=list(y.shape), launches=counts, elements=y.numel(), **res)
    return n2d, naxis


def main_path_config3(dev) -> int:
    """BASELINE config 3 through ``ShapeBucketResizer`` (its default device,
    the card): 64 uint8 CHW images from a seed in 8 ImageNet-like shapes, in
    shuffled order, -> 224 x 224 on the Pillow route.  One
    ``pil_resample_2pass`` launch per shape (8); the output in input order
    byte-equal to per-image ``resize_pil_exact`` and to the same call with
    the kernel replaced by its plain version."""
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (3, h, w), dtype=np.uint8)
              for h, w in CONFIG3_SHAPES for _ in range(8)]
    images = [images[i] for i in rng.permutation(len(images))]
    r = ShapeBucketResizer(CONFIG3_SIZE)
    _reset()
    y = r(images)
    torch.cuda.synchronize()
    counts = _expect("config 3", {"pil_resample_2pass": len(CONFIG3_SHAPES)})
    if tuple(y.shape) != (len(images), 3, *CONFIG3_SIZE) or y.device != dev:
        raise RuntimeError(f"config 3: {tuple(y.shape)} on {y.device}")
    want = torch.stack([pe.resize_pil_exact(torch.from_numpy(im).to(dev), CONFIG3_SIZE)
                        for im in images])
    if not torch.equal(y, want):
        raise RuntimeError(f"config 3: {int((y != want).sum())} bytes differ from "
                           "per-image resize_pil_exact")
    with _plain_kernels():
        ref = r(images)
    _compare("config 3 vs plain", y, ref)
    t0 = time.perf_counter()
    calls = 5
    for _ in range(calls):
        r(images)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    _line("main_path", path="config 3 ShapeBucketResizer", images=len(images),
          shapes=[list(s) for s in CONFIG3_SHAPES], size=list(CONFIG3_SIZE),
          launches=counts, shapes_served=r.shapes_compiled,
          bytes_equal_to_per_image=True, bytes_equal_to_plain=True,
          host_ms_per_batch=host_ms)
    return counts["pil_resample_2pass"]


def main_path_scale_translate(dev) -> int:
    """``scale_and_translate`` on config 1's f32 image [1, 3, 438, 906] with
    Python parameters (the static route): one resample2d launch forward and
    one (its adjoint) for the VJP; equal to the same calls on the plain
    versions, and within 5e-5 of the tensor-parameter (dense) route, output
    and gradient (relative to the gradient's largest value)."""
    shape = HEADLINE[0]
    x = _rand(shape, F32, dev, 91).div_(255.0)
    total = 0
    for name, ohw, sc, tr in AFFINE_CASES:
        out_shape = (*shape[:2], *ohw)
        cot = _rand(out_shape, F32, dev, 92).div_(255.0)

        def fwd_vjp(sc=sc, tr=tr):
            xr = x.detach().requires_grad_()
            y = scale_and_translate(xr, out_shape, (2, 3), sc, tr, "linear")
            return y.detach(), torch.autograd.grad(y, xr, grad_outputs=cot)[0]

        _reset()
        y, g = fwd_vjp()
        torch.cuda.synchronize()
        counts = _expect(f"scale_and_translate {name}", {"resample2d": 2})
        total += counts["resample2d"]
        with _plain_kernels():
            y_p, g_p = fwd_vjp()
        res = {"max_abs_err_vs_plain": _compare(f"{name} vs plain", y, y_p)["max_abs_err"],
               "grad_max_abs_err_vs_plain": _compare(f"{name} grad vs plain", g,
                                                     g_p)["max_abs_err"]}
        yd, gd = fwd_vjp(torch.tensor(sc, device=dev), torch.tensor(tr, device=dev))
        res.update(max_abs_err_vs_dense=_max_abs(y, yd), grad_max_abs_err_vs_dense=_max_abs(g, gd))
        if res["max_abs_err_vs_dense"] > 5e-5 or \
                res["grad_max_abs_err_vs_dense"] > 5e-5 * float(gd.abs().max()):
            raise RuntimeError(f"scale_and_translate {name}: {res} against the dense route")
        _line("main_path", path=f"scale_and_translate {name}", shape=list(shape),
              out=list(out_shape), scale=list(sc), translation=list(tr), launches=counts,
              **res)
    return total


def main_path_reducing_gap(dev) -> int:
    """``resize`` with ``reducing_gap`` 2 and 3 on a uint8 4K frame ->
    224 x 224: ``reduce_pil_exact`` (plain torch) then one
    ``pil_resample_2pass`` launch; equal to the same call with the kernel
    replaced by its plain version."""
    (shape, size) = REDUCE_4K
    g = torch.Generator(device=dev).manual_seed(93)
    x = torch.randint(0, 256, shape, dtype=U8, device=dev, generator=g)
    total = 0
    for gap in (2.0, 3.0):
        _reset()
        y = resize(x, size, reducing_gap=gap)
        torch.cuda.synchronize()
        counts = _expect(f"reducing_gap {gap}", {"pil_resample_2pass": 1})
        total += counts["pil_resample_2pass"]
        with _plain_kernels():
            ref = resize(x, size, reducing_gap=gap)
        res = _compare(f"reducing_gap {gap} vs plain", y, ref)
        _line("main_path", path=f"resize reducing_gap={gap}", shape=list(shape),
              out=list(y.shape), launches=counts, bytes_equal_to_plain=True, **res)
    return total


def main_path_train(dev) -> tuple[int, int, int, int]:
    """The train path on one uint8 batch: ``ImageNetTrainPipeline`` (flip
    folded into the W tables: the float32-intermediate route, one
    ``crop_tables`` and two ``crop_f32`` launches; bit for bit its plain
    run on the card, within one grey level of the CPU's dense route),
    ``Trainer`` steps on its output
    (one resample2d launch per step, no adjoint: the images do not require
    grad), ``crop_and_resize`` with run_all's boxes and
    ``random_resized_crop`` of 4K frames (no flip: the table kernel, then
    the two crop passes)."""
    (shape, size) = TRAIN_B64
    erng = np.random.default_rng(0)
    batch = torch.from_numpy((erng.random(shape) * 255).astype(np.uint8))
    x = batch.to(dev)
    pipe = ImageNetTrainPipeline(size=size).to(dev)
    _reset()
    imgs = pipe(torch.Generator().manual_seed(0), x)
    torch.cuda.synchronize()
    counts = _expect("train pipeline", {"crop_tables": 1, "crop_f32": 2})
    n_f32 = counts["crop_f32"]
    with _plain_kernels():
        plain = pipe(torch.Generator().manual_seed(0), x)
    res = _compare("train pipeline", imgs, plain)
    del plain
    want = ImageNetTrainPipeline(size=size)(torch.Generator().manual_seed(0), batch)
    err = _max_abs(imgs.cpu(), want)
    # the same boxes and flips on the CPU: float32 products in another order
    # may move a uint8 crop value by one grey level, 1 / (255 * std)
    if imgs.shape != (shape[0], 3, *size) or not bool(torch.isfinite(imgs).all()) \
            or err > 1.0 / (255.0 * 0.224) + 1e-5:
        raise RuntimeError(f"train pipeline: {tuple(imgs.shape)}, max abs err "
                           f"vs the CPU run {err}")
    _line("main_path", path="train pipeline (float32-intermediate crop + flip)",
          batch=list(shape), size=list(size), launches=counts, **res,
          max_abs_err_vs_cpu=err)

    labels = torch.from_numpy(erng.integers(0, 10, shape[0])).to(dev)
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        tr = Trainer(seed=0, device=dev)
        _reset()
        losses = [float(tr.step(imgs, labels)) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        counts = _expect("trainer", {"resample2d": TRAIN_STEPS})
        ref = Trainer(seed=0, device=dev)
        with _plain_kernels():
            ref_losses = [float(ref.step(imgs, labels)) for _ in range(TRAIN_STEPS)]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    if not all(math.isfinite(v) for v in losses) or losses != ref_losses:
        raise RuntimeError(f"trainer: losses {losses} vs plain run {ref_losses}")
    for k, p in tr.params.items():
        _compare(f"trainer param {k}", p.detach(), ref.params[k].detach())
    _line("main_path", path="Trainer steps", images=list(imgs.shape),
          resize_to=list(tr.resize_to), steps=TRAIN_STEPS, launches=counts,
          losses=losses, params_equal_to_plain_run=True)
    del imgs, tr, ref

    n_crop = n_tables = 0
    boxes = torch.from_numpy(_run_all_boxes(shape[0])).to(dev)
    x4k = _rand(CROP_4K[0], U8, dev, 61)
    for name, fn, xin in [
        ("crop_and_resize b64", lambda: crop_and_resize(x, boxes, size), x),
        ("random_resized_crop 4k", lambda: random_resized_crop(
            torch.Generator().manual_seed(1), x4k, CROP_4K[1]), x4k),
    ]:
        _reset()
        y = fn()
        torch.cuda.synchronize()
        counts = _expect(name, {"crop_tables": 1, "crop_resample": 2})
        n_crop += counts["crop_resample"]
        n_tables += counts["crop_tables"]
        with _plain_kernels():
            ref = fn()
        res = _compare(name, y, ref)
        _line("main_path", path=name, shape=list(xin.shape), out=list(y.shape),
              launches=counts, **res)
    return n_crop, n_tables + 1, TRAIN_STEPS, n_f32


def _sharded_pil(x: torch.Tensor, size, mode: str) -> torch.Tensor:
    """resize_sharded_pil_exact's shard bodies over SHARDS shards of H: each
    shard's W pass on its block, each extended block built from the padded
    W-pass image as the ring delivers it, each shard's H pass, stitched."""
    tables = halo._int_halo_tables(x.shape[1], size[0], mode, SHARDS)
    plan = tables[0]
    xp = halo._pad_axis(x, 1, SHARDS * plan.hl - x.shape[1])
    tw = pe._int_tables(x.shape[2], size[1], mode)
    yw = torch.cat([halo._pil_w_pass(b, tw, 2, True) for b in xp.split(plan.hl, 1)], 1)
    exts = halo._extended_blocks(yw, plan, SHARDS, 1)
    del yw
    return torch.cat([halo._own_rows(halo._shard_h_int(e, tables, d, 1), 1, size[0],
                                     plan.ol, d) for d, e in enumerate(exts)], 1)


def main_path_sharded_pil(dev) -> int:
    """The sharded byte-exact route at the size it exists for: uint8 CHW
    [3, 32768, 32768] (3.2 GB) -> 8192 x 8192 bilinear, and a ceil-padded
    lanczos3 case, through the shard bodies on 4 shards; byte-equal to the
    same shard bodies with pil_resample_axis replaced by its plain version,
    and to the single-device resize_pil_exact."""
    total = 0
    for (shape, size, mode) in (SHARD_U8, SHARD_U8_CEIL):
        g = torch.Generator(device=dev).manual_seed(31)
        x = torch.randint(0, 256, shape, dtype=U8, device=dev, generator=g)
        _reset()
        y = _sharded_pil(x, size, mode)
        torch.cuda.synchronize()
        counts = _expect(f"sharded pil {shape}", {"pil_resample_axis": 2 * SHARDS})
        total += counts["pil_resample_axis"]
        with _plain_kernels():
            ref = _sharded_pil(x, size, mode)
        res = _compare(f"sharded pil {shape} vs plain", y, ref)
        del ref
        want = pe.resize_pil_exact(x, size, method=mode)
        if y.shape != want.shape or not torch.equal(y, want):
            raise RuntimeError(f"sharded pil {shape}: differs from resize_pil_exact in "
                               f"{int((y != want).sum())} bytes")
        _line("main_path", path=f"sharded resize_sharded_pil_exact {mode}",
              shape=list(shape), out=list(y.shape), shards=SHARDS,
              halo=halo._int_halo_tables(shape[1], size[0], mode, SHARDS)[0].halo,
              launches=counts, **res, bytes_equal_to_single_device=True)
        del x, y, want
        torch.cuda.empty_cache()
    return total


def main_path_sharded_float(dev) -> int:
    """resize_sharded and its VJP at the size the route exists for: f32
    [1, 3, 16384, 16384] (3.2 GB) -> 4096 x 4096 bicubic through the shard
    bodies on 4 shards (W pass and H pass on kernel B, the H pass over each
    shard's tables; backward over their transposes); output and gradient
    equal bit for bit to the same bodies with kernel B replaced by its plain
    version, and within 1e-5 of the largest value of the single-device
    resize and resize_plane's VJP."""
    (shape, size, mode) = SHARD_F32
    x = _rand(shape, F32, dev, 33).div_(255.0)
    cot = _rand((*shape[:2], *size), F32, dev, 34).div_(255.0)
    plan = halo.plan_halo_banded(shape[2], size[0], mode, True, SHARDS)
    spec_w = make_axis_spec(shape[3], size[1], mode)
    from interpolate_antialiasing_tpu_torch.ops.resize import _apply_axis_diff

    def sharded_vjp():
        xr = x.detach().requires_grad_()
        xp = halo._pad_axis(xr, 2, SHARDS * plan.hl - shape[2])
        yw = torch.cat([_apply_axis_diff(b, spec_w, 3, "auto")
                        for b in xp.split(plan.hl, 2)], 2)
        y = torch.cat([halo._own_rows(halo._shard_h_float(e, plan, d, 2), 2, size[0],
                                      plan.ol, d)
                       for d, e in enumerate(halo._extended_blocks(yw, plan, SHARDS, 2))], 2)
        g, = torch.autograd.grad(y, xr, grad_outputs=cot)
        return y.detach(), g

    _reset()
    y, g = sharded_vjp()
    torch.cuda.synchronize()
    counts = _expect("sharded float", {"resample_axis": 4 * SHARDS})
    with _plain_kernels():
        y_plain, g_plain = sharded_vjp()
    res = {"max_abs_err_vs_plain": _compare("sharded float vs plain", y, y_plain)["max_abs_err"],
           "grad_max_abs_err_vs_plain": _compare("sharded float gradient vs plain", g,
                                                 g_plain)["max_abs_err"]}
    del y_plain, g_plain
    xr = x.detach().requires_grad_()
    want = resize_plane(xr, size, 2, 3, mode=mode)
    gw, = torch.autograd.grad(want, xr, grad_outputs=cot)
    res.update(max_abs_err=_max_abs(y, want.detach()), grad_max_abs_err=_max_abs(g, gw))
    for k, a, b in (("max_abs_err", y, want.detach()), ("grad_max_abs_err", g, gw)):
        if not bool(torch.isfinite(a).all()) or res[k] > 1e-5 * float(b.abs().max()):
            raise RuntimeError(f"sharded float: {k} {res[k]} against the single device")
    _line("main_path", path=f"sharded resize_sharded + VJP {mode}", shape=list(shape),
          out=list(y.shape), shards=SHARDS, halo=plan.halo, launches=counts, **res)
    return counts["resample_axis"]


# launches per rank of each phase of group_phases, whatever the number of ranks
GROUP_LAUNCHES = {
    "pil": {"pil_resample_axis": 2},  # the W pass and the H pass of the rank's block
    "float": {"resample_axis": 4},  # W and H passes, and their adjoints backward
    "halo_h": {"resample_axis": 1},
    "dp": {"pil_resample_2pass": 1},
    "trainer": {"resample_axis": 2 * 2},  # two steps, W and H passes (no adjoint)
}


def group_phases(dev, n: int) -> list[dict]:
    """This rank's share of the sharded path in an ``n``-rank NCCL group,
    one rank per card: the public entry points at the sharded main path's
    full size, H split over the ``n`` ranks of the ``sp`` axis (the ring
    exchanges halo rows between cards; with one rank the halo is 0).  The
    forward calls take a DTensor sharded over H, the float VJP the tensor
    every rank holds whole; every output is a DTensor.  Each phase runs with
    the launch counts set to 0 just before it and read just after, and the
    rank's rows are held to the single-device result on its own card; then
    the data-parallel resize and the dp x sp Trainer against the
    single-device Trainer.  Raises on the first failure; returns one line
    per phase, with host-clock times of the sharded call and of the ring."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from interpolate_antialiasing_tpu_torch.parallel import (
        data_parallel_resize,
        halo_resize_h,
        make_mesh,
        resize_sharded,
        resize_sharded_pil_exact,
        shard_batch,
    )
    from interpolate_antialiasing_tpu_torch.parallel.sharding import _as_dtensor, _block

    mesh = make_mesh((1, n), ("data", "sp"))
    d, group, rank = mesh.get_local_rank("sp"), mesh.get_group("sp"), dist.get_rank()
    where = f"group of {n}, rank {rank}"

    def run(phase, fn):
        _reset()
        out = fn()
        torch.cuda.synchronize()
        return out, _expect(f"{where}: {phase}", GROUP_LAUNCHES[phase])

    def sharded(x, h_axis):
        return _as_dtensor(_block(x, h_axis, n, d), mesh, (Replicate(), Shard(h_axis)),
                           tuple(x.shape))

    def local(name, y, want_shape):
        if not isinstance(y, DTensor) or tuple(y.shape) != tuple(want_shape):
            raise RuntimeError(f"{where}: {name} gave {type(y).__name__} "
                               f"{tuple(y.shape)}, not a DTensor {tuple(want_shape)}")
        return y.to_local().detach()

    def within(name, got, want):
        err = _max_abs(got, want)
        if not bool(torch.isfinite(got).all()) or err > 1e-5 * float(want.abs().max()):
            raise RuntimeError(f"{where}: {name} max abs err {err} against the single device")
        return err

    def host_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    lines = []
    # the byte-exact route: uint8 [3, 32768, 32768] -> 8192^2
    (shape, size, mode) = SHARD_U8
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randint(0, 256, shape, dtype=U8, device=dev, generator=gen)
    xd = sharded(x, 1)
    y, counts = run("pil", lambda: resize_sharded_pil_exact(xd, size, mesh, mode=mode))
    ref = pe.resize_pil_exact(x, size, method=mode)
    if not torch.equal(local("resize_sharded_pil_exact", y, ref.shape), _block(ref, 1, n, d)):
        raise RuntimeError(f"{where}: resize_sharded_pil_exact != resize_pil_exact")
    plan = halo._int_halo_tables(shape[1], size[0], mode, n)[0]
    rows = _rand((shape[0], plan.hl, size[1]), U8, dev, 35)
    lines.append({
        "phase": "group_pil", "rank": rank, "ranks": n, "shape": list(shape),
        "size": list(size), "halo": plan.halo, "launches": counts,
        "bytes_equal_to_single_device": True,
        "sharded_call_host_ms": host_ms(
            lambda: resize_sharded_pil_exact(xd, size, mesh, mode=mode), 5),
        "ring_host_ms": host_ms(lambda: halo._ring_halo_extend(rows, plan.halo, 1, group), 20),
        "single_card_ms": time_cuda(lambda: pe.resize_pil_exact(x, size, method=mode),
                                    iters=5)})
    del x, xd, y, ref, rows
    torch.cuda.empty_cache()

    # the float route and its VJP, then the H pass alone: f32 [1, 3, 16384, 16384]
    (shape, size, mode) = SHARD_F32
    x = _rand(shape, F32, dev, 33).div_(255.0)
    cot = _rand((*shape[:2], *size), F32, dev, 34).div_(255.0)

    def vjp():
        xr = x.detach().requires_grad_()
        y = resize_sharded(xr, size, mesh, mode=mode)
        g, = torch.autograd.grad(y.to_local(), xr, grad_outputs=_block(cot, 2, n, d))
        return y, g

    (y, gx), counts = run("float", vjp)
    xr = x.detach().requires_grad_()
    want = resize_plane(xr, size, 2, 3, mode=mode)
    gw, = torch.autograd.grad(want, xr, grad_outputs=cot)
    want = want.detach()
    lines.append({
        "phase": "group_float", "rank": rank, "ranks": n, "shape": list(shape),
        "size": list(size), "launches": counts,
        "max_abs_err": within("resize_sharded", local("resize_sharded", y, want.shape),
                              _block(want, 2, n, d)),
        "grad_max_abs_err": within("resize_sharded's VJP", _block(gx, 2, n, d),
                                   _block(gw, 2, n, d))})
    del y, gx, xr, want, gw
    torch.cuda.empty_cache()
    xd = sharded(x, 2)
    yh, counts = run("halo_h", lambda: halo_resize_h(xd, size[0], mesh, mode=mode))
    want = cr.resize_axis(x, make_axis_spec(shape[2], size[0], mode), 2)
    lines.append({
        "phase": "group_halo_h", "rank": rank, "ranks": n, "shape": list(shape),
        "out_h": size[0], "launches": counts,
        "max_abs_err": within("halo_resize_h", local("halo_resize_h", yh, want.shape),
                              _block(want, 2, n, d))})
    del x, cot, xd, yh, want
    torch.cuda.empty_cache()

    # data-parallel resize and the Trainer on a dp x sp mesh
    mesh_dp = make_mesh((2, n // 2), ("data", "sp")) if n % 2 == 0 else mesh
    xb = _rand(ENTRY[0], U8, dev, 43)
    yd, counts = run("dp", lambda: data_parallel_resize(shard_batch(xb, mesh_dp), ENTRY[1],
                                                        mesh_dp))
    blk = _block(xb, 0, mesh_dp.size(0), mesh_dp.get_local_rank("data"))
    if not torch.equal(local("data_parallel_resize", yd, (ENTRY[0][0], 3, *ENTRY[1])),
                       resize(blk, ENTRY[1])):
        raise RuntimeError(f"{where}: data_parallel_resize != resize of the rank's block")
    lines.append({"phase": "group_dp", "rank": rank, "mesh": list(mesh_dp.shape),
                  "batch": list(ENTRY[0]), "launches": counts, "bytes_equal": True})
    imgs = _rand((16, 3, 224, 224), F32, dev, 44).div_(255.0)
    labels = torch.from_numpy(np.random.default_rng(0).integers(0, 10, 16)).to(dev)
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        tr = Trainer(mesh=mesh_dp, seed=0)
        losses, counts = run("trainer", lambda: [float(tr.step(imgs, labels))
                                                 for _ in range(2)])
        ref = Trainer(seed=0, device=dev)
        ref_losses = [float(ref.step(imgs, labels)) for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    if not all(math.isfinite(a) and abs(a - b) <= 1e-5 * abs(b)
               for a, b in zip(losses, ref_losses)):
        raise RuntimeError(f"{where}: Trainer losses {losses} vs single device {ref_losses}")
    perr = max(_max_abs(p.detach(), ref.params[k].detach())
               / float(ref.params[k].detach().abs().max()) for k, p in tr.params.items())
    if perr > 1e-5:
        raise RuntimeError(f"{where}: Trainer parameters differ by {perr} (relative)")
    lines.append({"phase": "group_trainer", "rank": rank, "mesh": list(mesh_dp.shape),
                  "launches": counts, "losses": losses, "ref_losses": ref_losses,
                  "param_rel_err": perr})
    return lines


def _in_group(rank: int, n: int, store: str) -> list[dict]:
    """:func:`group_phases` as rank ``rank`` (on card ``rank``) of an
    ``n``-rank NCCL group started over the file ``store``, TF32 off."""
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=180))
    try:
        with full_f32():
            return group_phases(torch.device("cuda", rank), n)
    finally:
        dist.destroy_process_group()


def main_path_one_rank_group() -> tuple[int, int]:
    """:func:`group_phases` in a one-rank NCCL group (NCCL takes one rank
    per card; ``--ranks N`` runs the same phases across N cards)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        lines = _in_group(0, 1, f"{tmp}/store")
    for ln in lines:
        _line("main_path", path=f"one-rank NCCL group: {ln.pop('phase')}", **ln)
    return (sum(ln["launches"]["pil_resample_axis"] for ln in lines),
            sum(ln["launches"]["resample_axis"] for ln in lines))


def check_crop_against_dense(dev) -> None:
    """The windowed route against the dense route on the main path's calls:
    within one grey level (the windowed route rounds its intermediate to
    the uint8 lattice, as the JAX package's does)."""
    (shape, size) = TRAIN_B64
    x = _rand(shape, U8, dev, 71)
    boxes = torch.from_numpy(_run_all_boxes(shape[0])).to(dev)
    yw = crop_and_resize(x, boxes, size)
    yd = crop_and_resize(x, boxes, size, use_windowed=False)
    err = _max_abs(yw, yd)
    if err > 1.0:
        raise RuntimeError(f"windowed crop vs dense route: {err} > 1")
    _line("crop_vs_dense", shape=list(shape), out=list(size), max_abs_err=err,
          differing=int((yw != yd).sum()), elements=yw.numel())


# ---------------------------------------------------------------------------
# 4. times, kernel beside plain version, in turns plain, kernel, kernel, plain
# ---------------------------------------------------------------------------


def _turns(kernel, plain, iters: int, warmup: int) -> dict:
    ms = {"plain": [], "kernel": []}
    fns = {"plain": plain, "kernel": kernel}
    for which in ("plain", "kernel", "kernel", "plain"):
        ms[which].append(time_cuda(fns[which], iters=iters, warmup=warmup))
    return ms


def time_pil_kernel(dev, rng, card) -> dict:
    def timed(shape, size, iters):
        x3 = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        x3 = x3.reshape(-1, shape[-2], shape[-1]).to(dev)
        tw = pe._int_tables(shape[-1], size[1], "bilinear")
        th = pe._int_tables(shape[-2], size[0], "bilinear")
        ms = _turns(lambda: pe._resample_2pass(x3, tw, th),
                    lambda: pe._resample_2pass_plain(x3, tw, th), iters, 3)
        ms.update(_kernel_times(lambda: pe._resample_2pass(x3, tw, th), iters,
                                "resample2d_kernel"))
        P, (H, W), (OH, OW) = x3.shape[0], shape[-2:], size
        bound = bound_of(P * (H * W + OH * OW) + _nbytes(*tw, *th),
                         P * (H * _nz(tw[1]) + OW * _nz(th[1])))
        x4 = x3.reshape(P, 1, H, W)
        lib_ms, lib_note = _library(
            lambda: torch.nn.functional.interpolate(x4, size, mode="bilinear",
                                                    antialias=True),
            pe._resample_2pass(x3, tw, th).reshape(P, 1, OH, OW))
        return ms, bound, lib_ms, lib_note

    bench, bound, lib_ms, lib_note = timed(*BENCH, iters=20)
    k_ms = sum(bench["kernel"]) / 2
    p_ms = sum(bench["plain"]) / 2
    n_out = BENCH[0][0] * BENCH[1][0] * BENCH[1][1]  # images x oh x ow
    _line("time_bench", card=card, shape=list(BENCH[0]), size=list(BENCH[1]),
          kernel_ms=bench["kernel"], plain_ms=bench["plain"],
          kernel_device_ms=bench["device_ms"], kernel_host_us=bench["host_us"],
          kernel_out_mpix_s=n_out / (bench["device_ms"] * 1e-3) / 1e6,
          plain_out_mpix_s=n_out / (p_ms * 1e-3) / 1e6,
          kernel_faster=k_ms < p_ms, **bound, library_ms=lib_ms, library=lib_note)
    uhd, uhd_bound, uhd_lib, uhd_note = timed(*UHD, iters=10)
    _line("time_4k_hd", card=card, shape=list(UHD[0]), size=list(UHD[1]),
          kernel_ms=uhd["kernel"], plain_ms=uhd["plain"], kernel_device_ms=uhd["device_ms"],
          kernel_host_us=uhd["host_us"], **uhd_bound, library_ms=uhd_lib, library=uhd_note)
    erng = np.random.default_rng(0)
    x = torch.from_numpy((erng.random(ENTRY[0]) * 255).astype(np.uint8)).to(dev)
    pipe = ImageNetEvalPipeline(size=ENTRY[1]).to(dev)
    _line("time_entry_pipeline", card=card, batch=list(ENTRY[0]),
          size=list(ENTRY[1]), ms=time_cuda(pipe, x, iters=20, warmup=3))
    return {"ms": bench["device_ms"], "device_ms": bench["device_ms"], "call_ms": k_ms,
            "host_us": bench["host_us"], "uhd_device_ms": uhd["device_ms"], "plain_ms": p_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": lib_ms}


def time_float_kernels(dev, card) -> tuple[dict, dict]:
    F = torch.nn.functional
    with full_f32():
        # resample2d on config 5 (bf16 4K -> HD, 192 planes)
        (shape, ohw) = CONFIG5
        x = _rand(shape, BF16, dev, 11)
        x3 = _view3(x, -2)
        sh, sw = make_axis_spec(shape[-2], ohw[0]), make_axis_spec(shape[-1], ohw[1])
        c5 = _turns(lambda: cr.resize2d(x3, sh, sw, BF16),
                    lambda: cr._resample2d_plain(x3, sh, sw, BF16), 5, 1)
        k5 = sum(c5["kernel"]) / 2
        P = x3.shape[0]
        bound = bound_of(2 * P * (shape[-2] * shape[-1] + ohw[0] * ohw[1])
                         + _nbytes(*cr._tables(sh), *cr._tables(sw)),
                         P * (shape[-2] * _nz(cr._tables(sw)[1]) + ohw[1] * _nz(cr._tables(sh)[1])))
        lib5, note5 = _library(lambda: F.interpolate(x, ohw, mode="bilinear", antialias=True))
        d5 = _kernel_times(lambda: cr.resize2d(x3, sh, sw, BF16), 5, "resample2d_kernel")
        lib5_dev = device_time_per_call(
            lambda: F.interpolate(x, ohw, mode="bilinear", antialias=True), iters=5)
        _line("time_config5", card=card, kernel="resample2d", shape=list(shape),
              size=list(ohw), kernel_ms=c5["kernel"], plain_ms=c5["plain"],
              kernel_device_ms=d5["device_ms"], kernel_host_us=d5["host_us"],
              kernel_gb_s=bound["bytes"] / (d5["device_ms"] * 1e-3) / 1e9,
              frames_per_s=shape[0] / (d5["device_ms"] * 1e-3), **bound, library_ms=lib5,
              library_device_ms=lib5_dev, library=note5)
        del x, x3
        torch.cuda.empty_cache()
        # resample2d on the f32 headline, NCHW
        (shape, ohw) = HEADLINE
        x3 = _view3(_rand(shape, F32, dev, 12), -2)
        sh, sw = make_axis_spec(shape[-2], ohw[0]), make_axis_spec(shape[-1], ohw[1])
        hd = _turns(lambda: cr.resize2d(x3, sh, sw, F32),
                    lambda: cr._resample2d_plain(x3, sh, sw, F32), 50, 3)
        P, H, W = x3.shape
        hb = bound_of(4 * P * (H * W + ohw[0] * ohw[1])
                      + _nbytes(*cr._tables(sh), *cr._tables(sw)),
                      P * (H * _nz(cr._tables(sw)[1]) + ohw[1] * _nz(cr._tables(sh)[1])))
        x4 = x3.reshape(shape)
        libh, noteh = _library(lambda: F.interpolate(x4, ohw, mode="bilinear", antialias=True))
        dh = _kernel_times(lambda: cr.resize2d(x3, sh, sw, F32), 50, "resample2d_kernel")
        _line("time_headline_nchw", card=card, kernel="resample2d",
              shape=list(shape), size=list(ohw), kernel_ms=hd["kernel"],
              plain_ms=hd["plain"], kernel_device_ms=dh["device_ms"],
              kernel_host_us=dh["host_us"], **hb, library_ms=libh,
              library_device_ms=device_time_per_call(
                  lambda: F.interpolate(x4, ohw, mode="bilinear", antialias=True), iters=50),
              library=noteh)
        # resample_axis on the f32 headline, NHWC: the W pass, then the H pass
        xn = _rand(shape, F32, dev, 13).permute(0, 2, 3, 1).contiguous()
        t = cr.resize_axis(xn, sw, 2)
        wp = _turns(lambda: cr.resize_axis(xn, sw, 2),
                    lambda: cr._resample_axis_plain(_view3(xn, 2), sw, F32), 50, 3)
        hp = _turns(lambda: cr.resize_axis(t, sh, 1),
                    lambda: cr._resample_axis_plain(_view3(t, 1), sh, F32), 50, 3)
        H, W, C = shape[-2], shape[-1], shape[1]
        bw = bound_of(4 * C * H * (W + ohw[1]) + _nbytes(*cr._tables(sw)),
                      C * H * _nz(cr._tables(sw)[1]))
        bh = bound_of(4 * C * ohw[1] * (H + ohw[0]) + _nbytes(*cr._tables(sh)),
                      C * ohw[1] * _nz(cr._tables(sh)[1]))
        libn, noten = _library(lambda: F.interpolate(xn.permute(0, 3, 1, 2), ohw,
                                                     mode="bilinear", antialias=True))
        dw = _kernel_times(lambda: cr.resize_axis(xn, sw, 2), 50, "resample_axis")
        dhp = _kernel_times(lambda: cr.resize_axis(t, sh, 1), 50, "resample_axis")
        libn_dev = device_time_per_call(
            lambda: F.interpolate(xn.permute(0, 3, 1, 2), ohw, mode="bilinear",
                                  antialias=True), iters=50)
        _line("time_headline_nhwc", card=card, kernel="resample_axis",
              shape=list(xn.shape), size=list(ohw),
              w_pass_kernel_ms=wp["kernel"], w_pass_plain_ms=wp["plain"],
              h_pass_kernel_ms=hp["kernel"], h_pass_plain_ms=hp["plain"],
              w_pass_device_ms=dw["device_ms"], h_pass_device_ms=dhp["device_ms"],
              w_pass_host_us=dw["host_us"], h_pass_host_us=dhp["host_us"],
              w_pass_bound_ms=bw["bound_ms"], h_pass_bound_ms=bh["bound_ms"],
              bound_by=[bw["bound_by"], bh["bound_by"]], library_ms=libn,
              library_device_ms=libn_dev, library=noten)
    r2d = {"ms": d5["device_ms"], "call_ms": k5, "host_us": d5["host_us"],
           "plain_ms": sum(c5["plain"]) / 2, "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"], "library_ms": lib5_dev}
    rax = {"ms": dw["device_ms"] + dhp["device_ms"],
           "call_ms": sum(wp["kernel"]) / 2 + sum(hp["kernel"]) / 2,
           "host_us": dw["host_us"] + dhp["host_us"],
           "plain_ms": sum(wp["plain"]) / 2 + sum(hp["plain"]) / 2,
           "bound_ms": bw["bound_ms"] + bh["bound_ms"],
           "bound_by": bw["bound_by"] if bw["bound_by"] == bh["bound_by"] else "bytes",
           "library_ms": libn_dev}
    return r2d, rax


def _synth_nz(spec) -> int:
    """Taps with nonzero synthesised weight over all outputs of a pass."""
    return int(torch.count_nonzero(cr._synth_tables(spec, torch.device("cpu"))[1]))


def time_fused_kernels(dev, card) -> tuple[dict, dict]:
    """Row 8: the fused kernels beside the table kernels at the same shapes
    and their plain versions, in turns (plain, fused, fused, plain; the
    table kernel before and after), with the bound (bytes over 3.35 TB/s,
    no table bytes; or the nonzero taps' multiply-adds over 67 T/s) and
    ``F.interpolate(antialias=True)``: config 5 (resample2d_fused), configs
    1-2 NCHW (resample2d_fused) and NHWC (resample_axis_fused, W pass then
    H pass)."""
    F = torch.nn.functional
    out = {}
    with full_f32():
        (shape, ohw) = CONFIG5
        x = _rand(shape, BF16, dev, 11)
        x3 = _view3(x, -2)
        sh, sw = make_axis_spec(shape[-2], ohw[0]), make_axis_spec(shape[-1], ohw[1])
        table = [time_cuda(lambda: cr.resize2d(x3, sh, sw, BF16), iters=5, warmup=1)]
        c5 = _turns(lambda: cr.resize2d(x3, sh, sw, BF16, fused=True),
                    lambda: cr._resample2d_fused_plain(x3, sh, sw, BF16), 5, 1)
        table.append(time_cuda(lambda: cr.resize2d(x3, sh, sw, BF16), iters=5, warmup=1))
        P = x3.shape[0]
        bound = bound_of(2 * P * (shape[-2] * shape[-1] + ohw[0] * ohw[1]),
                         P * (shape[-2] * _synth_nz(sw) + ohw[1] * _synth_nz(sh)))
        lib5, note5 = _library(lambda: F.interpolate(x, ohw, mode="bilinear", antialias=True))
        k5 = sum(c5["kernel"]) / 2
        d5 = _kernel_times(lambda: cr.resize2d(x3, sh, sw, BF16, fused=True), 5,
                           "resample2d_kernel")
        t5 = device_time_per_call(lambda: cr.resize2d(x3, sh, sw, BF16), iters=5,
                                  match="resample2d_kernel")
        lib5_dev = device_time_per_call(
            lambda: F.interpolate(x, ohw, mode="bilinear", antialias=True), iters=5)
        _line("time_fused_config5", card=card, kernel="resample2d_fused", shape=list(shape),
              size=list(ohw), kernel_ms=c5["kernel"], plain_ms=c5["plain"],
              table_kernel_ms=table, kernel_device_ms=d5["device_ms"],
              kernel_host_us=d5["host_us"], table_kernel_device_ms=t5,
              kernel_gb_s=bound["bytes"] / (d5["device_ms"] * 1e-3) / 1e9,
              **bound, library_ms=lib5, library_device_ms=lib5_dev, library=note5)
        out["2d"] = {"ms": d5["device_ms"], "call_ms": k5, "host_us": d5["host_us"],
                     "plain_ms": sum(c5["plain"]) / 2, "bound_ms": bound["bound_ms"],
                     "bound_by": bound["bound_by"], "library_ms": lib5_dev}
        del x, x3
        torch.cuda.empty_cache()

        (shape, ohw) = HEADLINE
        for mode in ("bilinear", "bicubic"):
            x3 = _view3(_rand(shape, F32, dev, 12), -2)
            sh, sw = make_axis_spec(shape[-2], ohw[0], mode), make_axis_spec(shape[-1], ohw[1], mode)
            table = [time_cuda(lambda: cr.resize2d(x3, sh, sw, F32), iters=50, warmup=3)]
            hd = _turns(lambda: cr.resize2d(x3, sh, sw, F32, fused=True),
                        lambda: cr._resample2d_fused_plain(x3, sh, sw, F32), 50, 3)
            table.append(time_cuda(lambda: cr.resize2d(x3, sh, sw, F32), iters=50, warmup=3))
            P, H, W = x3.shape
            hb = bound_of(4 * P * (H * W + ohw[0] * ohw[1]),
                          P * (H * _synth_nz(sw) + ohw[1] * _synth_nz(sh)))
            x4 = x3.reshape(shape)
            libh, noteh = _library(lambda: F.interpolate(x4, ohw, mode=mode, antialias=True))
            dh = _kernel_times(lambda: cr.resize2d(x3, sh, sw, F32, fused=True), 50,
                               "resample2d_kernel")
            th = _kernel_times(lambda: cr.resize2d(x3, sh, sw, F32), 50, "resample2d_kernel")
            lib_dev = device_time_per_call(
                lambda: F.interpolate(x4, ohw, mode=mode, antialias=True), iters=50)
            _line("time_fused_headline_nchw", card=card, kernel="resample2d_fused", mode=mode,
                  shape=list(shape), size=list(ohw), kernel_ms=hd["kernel"],
                  plain_ms=hd["plain"], table_kernel_ms=table,
                  kernel_device_ms=dh["device_ms"], kernel_host_us=dh["host_us"],
                  table_kernel_device_ms=th["device_ms"], table_kernel_host_us=th["host_us"],
                  **hb, library_ms=libh, library_device_ms=lib_dev, library=noteh,
                  fused_over_library=dh["device_ms"] / lib_dev,
                  table_over_library=th["device_ms"] / lib_dev)

        xn = _rand(shape, F32, dev, 13).permute(0, 2, 3, 1).contiguous()
        sh, sw = make_axis_spec(shape[-2], ohw[0]), make_axis_spec(shape[-1], ohw[1])
        t = cr.resize_axis(xn, sw, 2, fused=True)
        tables = {"w": [time_cuda(lambda: cr.resize_axis(xn, sw, 2), iters=50, warmup=3)],
                  "h": [time_cuda(lambda: cr.resize_axis(t, sh, 1), iters=50, warmup=3)]}
        wp = _turns(lambda: cr.resize_axis(xn, sw, 2, fused=True),
                    lambda: cr._resample_axis_fused_plain(_view3(xn, 2), sw, F32), 50, 3)
        hp = _turns(lambda: cr.resize_axis(t, sh, 1, fused=True),
                    lambda: cr._resample_axis_fused_plain(_view3(t, 1), sh, F32), 50, 3)
        tables["w"].append(time_cuda(lambda: cr.resize_axis(xn, sw, 2), iters=50, warmup=3))
        tables["h"].append(time_cuda(lambda: cr.resize_axis(t, sh, 1), iters=50, warmup=3))
        H, W, C = shape[-2], shape[-1], shape[1]
        bw = bound_of(4 * C * H * (W + ohw[1]), C * H * _synth_nz(sw))
        bh = bound_of(4 * C * ohw[1] * (H + ohw[0]), C * ohw[1] * _synth_nz(sh))
        libn, noten = _library(lambda: F.interpolate(xn.permute(0, 3, 1, 2), ohw,
                                                     mode="bilinear", antialias=True))
        dw = _kernel_times(lambda: cr.resize_axis(xn, sw, 2, fused=True), 50, "resample_axis")
        dhp = _kernel_times(lambda: cr.resize_axis(t, sh, 1, fused=True), 50, "resample_axis")
        libn_dev = device_time_per_call(
            lambda: F.interpolate(xn.permute(0, 3, 1, 2), ohw, mode="bilinear",
                                  antialias=True), iters=50)
        _line("time_fused_headline_nhwc", card=card, kernel="resample_axis_fused",
              shape=list(xn.shape), size=list(ohw),
              w_pass_kernel_ms=wp["kernel"], w_pass_plain_ms=wp["plain"],
              w_pass_table_kernel_ms=tables["w"], h_pass_kernel_ms=hp["kernel"],
              h_pass_plain_ms=hp["plain"], h_pass_table_kernel_ms=tables["h"],
              w_pass_device_ms=dw["device_ms"], h_pass_device_ms=dhp["device_ms"],
              w_pass_host_us=dw["host_us"], h_pass_host_us=dhp["host_us"],
              w_pass_bound_ms=bw["bound_ms"], h_pass_bound_ms=bh["bound_ms"],
              bound_by=[bw["bound_by"], bh["bound_by"]], library_ms=libn,
              library_device_ms=libn_dev, library=noten)
    out["axis"] = {"ms": dw["device_ms"] + dhp["device_ms"],
                   "call_ms": sum(wp["kernel"]) / 2 + sum(hp["kernel"]) / 2,
                   "host_us": dw["host_us"] + dhp["host_us"],
                   "plain_ms": sum(wp["plain"]) / 2 + sum(hp["plain"]) / 2,
                   "bound_ms": bw["bound_ms"] + bh["bound_ms"],
                   "bound_by": bw["bound_by"] if bw["bound_by"] == bh["bound_by"] else "bytes",
                   "library_ms": libn_dev}
    return out["2d"], out["axis"]


def time_train_kernels(dev, card) -> tuple[dict, dict]:
    """The adjoint of config 4, the crop kernel and the crop's table kernel,
    beside their plain versions; and the whole crop calls the main path
    makes, with the table kernel and with the plain table build; and the
    same at b64 for zoom-out boxes (rows past the tables' bound, their
    weights computed again in the crop kernel once per block), printed
    beside the call within the image (``time_crop_zoom_out``)."""
    with full_f32():
        (shape, ohw) = CONFIG4
        sh, sw = make_axis_spec(shape[-2], ohw[0]), make_axis_spec(shape[-1], ohw[1])
        th, tw = adjoint_tables(sh), adjoint_tables(sw)
        g3 = _view3(_rand((*shape[:2], *ohw), F32, dev, 81), -2)
        adj = _turns(lambda: cr.resize2d(g3, th, tw, F32),
                     lambda: cr._resample2d_plain(g3, th, tw, F32), 20, 3)
        P = g3.shape[0]
        ab = bound_of(4 * P * (ohw[0] * ohw[1] + shape[2] * shape[3])
                      + _nbytes(th.xmin, tw.xmin) + 4 * (th.w.size + tw.w.size),
                      P * (ohw[0] * _nz(tw.w) + shape[3] * _nz(th.w)))
        g4 = g3.reshape(*shape[:2], *ohw)
        liba, notea = _library(lambda: torch.ops.aten._upsample_bilinear2d_aa_backward(
            g4, list(ohw), list(shape), False, None, None))
        x = _rand(shape, F32, dev, 82).requires_grad_()

        def vjp():
            y = resize_plane(x, ohw, 2, 3)
            return torch.autograd.grad(y, x, grad_outputs=y)[0]

        da = _kernel_times(lambda: cr.resize2d(g3, th, tw, F32), 20, "resample2d_kernel")
        _line("time_config4", card=card, kernel="resample2d adjoint",
              shape=list(shape), size=list(ohw), adjoint_kernel_ms=adj["kernel"],
              adjoint_plain_ms=adj["plain"], adjoint_device_ms=da["device_ms"],
              adjoint_host_us=da["host_us"], vjp_call_ms=time_cuda(vjp, iters=10),
              **ab, library_ms=liba, library_device_ms=device_time_per_call(
                  lambda: torch.ops.aten._upsample_bilinear2d_aa_backward(
                      g4, list(ohw), list(shape), False, None, None), iters=20),
              library=notea)
        del x
        out, tables, calls = {}, {}, {}
        for name, (shape, size), boxes in [
            ("b64", TRAIN_B64, _run_all_boxes(TRAIN_B64[0][0])),
            ("4k", CROP_4K, sample_boxes(torch.Generator().manual_seed(1),
                                         CROP_4K[0][0], *CROP_4K[0][2:])),
            ("b64 zoom-out", TRAIN_B64, _zoom_out_boxes(TRAIN_B64[0][0])),
        ]:
            x = _rand(shape, U8, dev, 83)
            b = torch.as_tensor(np.asarray(boxes, np.float32)).to(dev)
            frac = box_fracs(*shape[2:]) if name == "4k" else 1.0
            for precision in ("pil_int8", "split"):
                t = cc._windowed_tables(x, b, size, "bilinear", True, frac, precision)
                ms = _turns(lambda: cc._crop_resample_cuda(x, *t),
                            lambda: cc._crop_resample_plain(x, *t), 10, 2)
                # both passes' launches; device_ms per call (two launches)
                dt = _kernel_times(lambda: cc._crop_resample_cuda(x, *t), 10,
                                   "resample_axis_kernel")
                ms["device_ms"], ms["host_us"] = 2 * dt["device_ms"], dt["host_us"]
                fh, ch, fw, cw = t[0].first, t[0].cnt, t[1].first, t[1].cnt
                N, C, H, W = shape
                # the tables' bytes this run's boxes need: first, count and
                # the weights of the counted taps the tables hold (a row
                # past the bound T computes the rest)
                tab = 8 * (fh.numel() + fw.numel()) + 4 * int(
                    ch.clamp(max=t[0].w.shape[-1]).sum() + cw.clamp(max=t[1].w.shape[-1]).sum())
                bound = bound_of(N * C * (H * W + size[0] * size[1]) + tab,
                                 C * W * int(ch.sum()) + C * size[0] * int(cw.sum()))
                out[(name, precision)] = (ms, bound)
                _line("time_crop", card=card, kernel="crop_resample", case=name,
                      precision=precision, shape=list(shape), size=list(size),
                      kernel_ms=ms["kernel"], plain_ms=ms["plain"],
                      kernel_device_ms=ms["device_ms"], kernel_host_us=ms["host_us"],
                      taps=[t[0].w.shape[-1], t[1].w.shape[-1]],
                      rows_past_bound=[int((ch > t[0].w.shape[-1]).sum()),
                                       int((cw > t[1].w.shape[-1]).sum())], **bound,
                      library_ms=None, library="no PyTorch call crops per-image boxes "
                      "with antialiasing")
            def win():
                return crop_and_resize(x, b, size, max_box_frac=frac)

            def win_plain():
                with _forced(cc, "_windowed_tables_cuda", cc._windowed_tables_plain):
                    return win()

            def table_kernel():
                return cc._windowed_tables(x, b, size, "bilinear", True, frac, "pil_int8")

            def table_plain():
                with _forced(cc, "_windowed_tables_cuda", cc._windowed_tables_plain):
                    return table_kernel()

            # the tables alone: the kernel beside the plain build, in turns
            tms = _turns(table_kernel, table_plain, 10, 2)
            tdt = _kernel_times(table_kernel, 20, "crop_tables_kernel")
            t = table_kernel()
            # what the kernel must move: the boxes in, the tables out
            tb = bound_of(16 * shape[0] + sum(8 * tab.first.numel() + tab.w.nbytes
                                              for tab in t[:2]),
                          int(t[0].cnt.sum() + t[1].cnt.sum()))
            # an empty kernel at the table kernel's grid: the launch floor
            from interpolate_antialiasing_tpu_torch.utils.timing import launch_floor_ms

            axes = tuple(tab.rows.ax for tab in t[:2])
            plan = cc._table_plan(axes, shape[0], cr._n_sm(dev))
            grid = sum(cc._table_blocks(shape[0], axes, plan))
            tdt["launch_floor_ms"] = launch_floor_ms(grid, cc._TABLE_THREADS, iters=20)
            tables[name] = (tms, tdt, tb)
            _line("time_crop_tables", card=card, kernel="crop_tables", case=name,
                  precision="pil_int8", shape=list(shape), size=list(size),
                  kernel_ms=tms["kernel"], plain_ms=tms["plain"],
                  kernel_device_ms=tdt["device_ms"], kernel_host_us=tdt["host_us"],
                  plain_device_ms=device_time_per_call(table_plain, iters=5), **tb,
                  launch_floor_ms=tdt["launch_floor_ms"],
                  grid=[grid, cc._TABLE_THREADS], lanes=plan,
                  library_ms=None, library="no PyTorch call builds per-image "
                  "antialiasing tables")
            # the whole call: plain build, kernel, kernel, plain build
            turns = _turns(win, win_plain, 5, 1)
            calls[name] = device_time_per_call(win, iters=10)
            _line("time_crop_call", card=card, case=name, shape=list(shape),
                  size=list(size), windowed_ms=turns["kernel"],
                  windowed_plain_tables_ms=turns["plain"],
                  windowed_device_ms=calls[name],
                  windowed_plain_tables_device_ms=device_time_per_call(win_plain, iters=5),
                  windowed_host_us=host_us(win, iters=10),
                  crop_tables_device_ms=tdt["device_ms"],
                  dense_ms=time_cuda(lambda: crop_and_resize(x, b, size, use_windowed=False),
                                     iters=5, warmup=1))
            del x, t
            torch.cuda.empty_cache()
    b64, bound = out[("b64", "pil_int8")]
    # the zoom-out call beside the call within the image: the same bytes
    # moved (the bound is the in-bound call's), more taps per row
    _line("time_crop_zoom_out", card=card, shape=list(TRAIN_B64[0]), size=list(TRAIN_B64[1]),
          in_bound_device_ms=calls["b64"], zoom_out_device_ms=calls["b64 zoom-out"],
          ratio=calls["b64 zoom-out"] / calls["b64"],
          zoom_out_passes_device_ms=out[("b64 zoom-out", "pil_int8")][0]["device_ms"],
          zoom_out_split_passes_device_ms=out[("b64 zoom-out", "split")][0]["device_ms"],
          in_bound_passes_device_ms=b64["device_ms"], bound_ms=bound["bound_ms"])
    tms, tdt, tb = tables["b64"]
    return ({"ms": b64["device_ms"], "device_ms": b64["device_ms"],
             "call_ms": sum(b64["kernel"]) / 2, "host_us": b64["host_us"],
             "split_device_ms": out[("b64", "split")][0]["device_ms"],
             "zoom_out_device_ms": out[("b64 zoom-out", "pil_int8")][0]["device_ms"],
             "zoom_out_split_device_ms": out[("b64 zoom-out", "split")][0]["device_ms"],
             "plain_ms": sum(b64["plain"]) / 2, "bound_ms": bound["bound_ms"],
             "bound_by": bound["bound_by"], "library_ms": None},
            {"ms": tdt["device_ms"], "device_ms": tdt["device_ms"],
             "call_ms": sum(tms["kernel"]) / 2, "host_us": tdt["host_us"],
             "4k_device_ms": tables["4k"][1]["device_ms"],
             "zoom_out_device_ms": tables["b64 zoom-out"][1]["device_ms"],
             "launch_floor_ms": tdt["launch_floor_ms"],
             "plain_ms": sum(tms["plain"]) / 2, "bound_ms": tb["bound_ms"],
             "bound_by": tb["bound_by"], "library_ms": None})


def time_crop_f32(dev, card) -> dict:
    """The float32-intermediate crop passes at the train cell's call (b64
    u8 3x438x906 -> 224^2, RandomResizedCrop boxes, flips at 0.5) beside
    their plain version, in turns, by device time per launch and against
    the least time the card could take: the image read and the output
    written once, and the float32 intermediate written and read again; and
    the whole call (the table launch and both passes) beside the dense
    route it replaces on the card."""
    (shape, size) = TRAIN_B64
    N, C, H, W = shape
    x = _rand(shape, U8, dev, 91)
    b = sample_boxes(torch.Generator().manual_seed(91), N, H, W).to(dev)
    flip = _f32_flips(N, 91).to(dev)
    t = cc._f32_tables(x, b, size, "bilinear", flip)
    ms = _turns(lambda: cc._crop_resample_cuda(x, *t, torch.float32),
                lambda: cc._crop_resample_plain(x, *t, torch.float32), 10, 2)
    dt = _kernel_times(lambda: cc._crop_resample_cuda(x, *t, torch.float32), 10,
                       "resample_axis_kernel")
    ch, cw = t[0].cnt, t[1].cnt
    tab = 8 * (ch.numel() + cw.numel()) + 4 * int(
        ch.clamp(max=t[0].w.shape[-1]).sum() + cw.clamp(max=t[1].w.shape[-1]).sum())
    bound = bound_of(N * C * (H * W + size[0] * size[1]) + 2 * 4 * N * C * size[0] * W + tab,
                     C * W * int(ch.sum()) + C * size[0] * int(cw.sum()))
    call_ms = device_time_per_call(lambda: cc.crop_and_resize_f32(x, b, size, flip=flip),
                                   iters=10)
    dense_ms = device_time_per_call(
        lambda: crop_and_resize(x, b, size, flip=flip, use_windowed=False), iters=5)
    _line("time_crop_f32", card=card, kernel="crop_f32", shape=list(shape), size=list(size),
          kernel_ms=ms["kernel"], plain_ms=ms["plain"], kernel_device_ms=2 * dt["device_ms"],
          kernel_host_us=dt["host_us"], taps=[t[0].w.shape[-1], t[1].w.shape[-1]],
          flips=int(flip.sum()), **bound, call_device_ms=call_ms,
          dense_route_device_ms=dense_ms, library_ms=None,
          library="no PyTorch call crops per-image boxes with antialiasing")
    return {"ms": 2 * dt["device_ms"], "device_ms": 2 * dt["device_ms"],
            "call_ms": sum(ms["kernel"]) / 2, "host_us": dt["host_us"],
            "call_device_ms": call_ms, "dense_route_device_ms": dense_ms,
            "plain_ms": sum(ms["plain"]) / 2, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None}


def time_sharded_kernels(dev, card) -> tuple[dict, dict]:
    """The two kernels of the sharded path at its shard shapes, beside their
    plain versions: pil_resample_axis on one shard of the 32768^2 uint8
    image (the H pass over shard 1's tables, and the W pass), and kernel B
    on one shard of the 16384^2 float32 image (the H pass over shard 1's
    tables of Wl[1], and over those of its transpose)."""
    (shape, size, mode), d = SHARD_U8, 1
    tables = halo._int_halo_tables(shape[1], size[0], mode, SHARDS)
    plan, starts, wsh = tables
    th = (starts[d], wsh[d])
    ext = _rand((shape[0], plan.ext, size[1]), U8, dev, 51)
    _compare("pil_resample_axis shard H pass", pe._resample_axis(ext, th, 1),
             pe._resample_axis_plain(ext, th))
    hp = _turns(lambda: pe._resample_axis(ext, th, 1),
                lambda: pe._resample_axis_plain(ext, th), 5, 1)
    hd = _kernel_times(lambda: pe._resample_axis(ext, th, 1), 5, "resample_axis_kernel")
    hb = bound_of(shape[0] * size[1] * (plan.ext + plan.ol) + _nbytes(*th),
                  shape[0] * size[1] * _nz(th[1]))
    del ext
    tw = pe._int_tables(shape[2], size[1], mode)
    blk = _rand((shape[0], plan.hl, shape[2]), U8, dev, 52)
    _compare("pil_resample_axis shard W pass", pe._resample_axis(blk, tw, 2),
             pe._resample_axis_plain(_view3(blk, 2), tw).reshape(shape[0], plan.hl, size[1]))
    wp = _turns(lambda: pe._resample_axis(blk, tw, 2),
                lambda: pe._resample_axis_plain(_view3(blk, 2), tw), 5, 1)
    wd = _kernel_times(lambda: pe._resample_axis(blk, tw, 2), 5, "resample_axis_kernel")
    wb = bound_of(shape[0] * plan.hl * (shape[2] + size[1]) + _nbytes(*tw),
                  shape[0] * plan.hl * _nz(tw[1]))
    del blk
    torch.cuda.empty_cache()
    _line("time_sharded_pil", card=card, kernel="pil_resample_axis", image=list(shape),
          size=list(size), shard=d, h_pass_shape=[shape[0], plan.ext, size[1]],
          h_pass_kernel_ms=hp["kernel"], h_pass_plain_ms=hp["plain"], h_pass_bound=hb,
          h_pass_device_ms=hd["device_ms"], h_pass_host_us=hd["host_us"],
          w_pass_shape=[shape[0], plan.hl, shape[2]], w_pass_kernel_ms=wp["kernel"],
          w_pass_plain_ms=wp["plain"], w_pass_bound=wb, w_pass_device_ms=wd["device_ms"],
          w_pass_host_us=wd["host_us"], library_ms=None,
          library="none: the pass is an int32 product, a shift and a clamp, and "
          "CUDA has no integer matmul")
    pil = {"ms": hd["device_ms"], "call_ms": sum(hp["kernel"]) / 2, "host_us": hd["host_us"],
           "w_pass_ms": wd["device_ms"], "plain_ms": sum(hp["plain"]) / 2,
           "bound_ms": hb["bound_ms"], "bound_by": hb["bound_by"], "library_ms": None}

    (shape, size, mode) = SHARD_F32
    plan = halo.plan_halo_banded(shape[2], size[0], mode, True, SHARDS)
    fwd, adj = halo._shard_tables(plan, d)
    C, W = shape[1], size[1]
    with full_f32():
        ext = _rand((C, plan.ext_pad, W), F32, dev, 53)
        g = _rand((C, plan.ol, W), F32, dev, 54)
        _compare("resample_axis shard forward", cr.resize_axis(ext, fwd, 1, F32),
                 cr._resample_axis_plain(ext, fwd, F32))
        _compare("resample_axis shard adjoint", cr.resize_axis(g, adj, 1, F32),
                 cr._resample_axis_plain(g, adj, F32))
        fp = _turns(lambda: cr.resize_axis(ext, fwd, 1, F32),
                    lambda: cr._resample_axis_plain(ext, fwd, F32), 10, 2)
        ap = _turns(lambda: cr.resize_axis(g, adj, 1, F32),
                    lambda: cr._resample_axis_plain(g, adj, F32), 10, 2)
        fd = _kernel_times(lambda: cr.resize_axis(ext, fwd, 1, F32), 10, "resample_axis_kernel")
        ad = _kernel_times(lambda: cr.resize_axis(g, adj, 1, F32), 10, "resample_axis_kernel")
        # the library's yardstick: one float32 matmul of the dense Wl[d]
        # (and of its transpose) with the shard's rows
        wd = torch.from_numpy(np.asarray(plan.Wl[d], np.float32)).to(dev)
        wdt = wd.t().contiguous()
        libf, notef = _library(lambda: torch.matmul(wd, ext))
        liba, notea = _library(lambda: torch.matmul(wdt, g))
    fb = bound_of(4 * C * W * (plan.ext_pad + plan.ol)
                  + _nbytes(fwd.xmin, fwd.w.astype(np.float32)),
                  C * W * _nz(fwd.w))
    ab = bound_of(4 * C * W * (plan.ol + plan.ext_pad)
                  + _nbytes(adj.xmin, adj.w.astype(np.float32)),
                  C * W * _nz(adj.w))
    del ext, g, wd, wdt
    torch.cuda.empty_cache()
    _line("time_sharded_float", card=card, kernel="resample_axis over shard tables",
          image=list(shape), size=list(size), shard=d, ext_shape=[C, plan.ext_pad, W],
          forward_kernel_ms=fp["kernel"], forward_plain_ms=fp["plain"], forward_bound=fb,
          forward_device_ms=fd["device_ms"], forward_host_us=fd["host_us"],
          adjoint_kernel_ms=ap["kernel"], adjoint_plain_ms=ap["plain"], adjoint_bound=ab,
          adjoint_device_ms=ad["device_ms"], adjoint_host_us=ad["host_us"],
          library_ms=libf, library=f"torch.matmul(Wl[d], rows), TF32 off: {notef}",
          adjoint_library_ms=liba, adjoint_library=f"torch.matmul(Wl[d]^T, rows): {notea}")
    return pil, {"ms": fd["device_ms"], "call_ms": sum(fp["kernel"]) / 2,
                 "adjoint_ms": ad["device_ms"], "plain_ms": sum(fp["plain"]) / 2,
                 "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"], "library_ms": libf}


def time_nhwc_config5(dev, card) -> None:
    """Kernel B at a device-bound shape: BASELINE config 5's frames in NHWC,
    bf16 [64, 2160, 3840, 3] -> 1080x1920 through ``resize(...,
    data_format="NHWC")`` (a W pass with inner 3, then an H pass with inner
    5760), tables and fused, each pass's device time per launch beside its
    bound and ``F.interpolate``'s device time on the same channels-last
    tensor; the output of one frame against the plain versions, bit for
    bit."""
    F = torch.nn.functional
    (shape, ohw) = CONFIG5
    N, C, H, W = shape
    sh, sw = make_axis_spec(H, ohw[0]), make_axis_spec(W, ohw[1])
    with full_f32():
        x = _rand((N, H, W, C), BF16, dev, 21)
        before = launch_counts()
        y = resize(x, ohw, method="bilinear", data_format="NHWC")
        torch.cuda.synchronize()
        if launch_counts() != dict(before, resample_axis=before["resample_axis"] + 2):
            raise RuntimeError("nhwc config 5: expected two resample_axis launches")
        x1 = x[:1]
        t1 = cr._resample_axis_plain(_view3(x1, 2), sw, BF16).reshape(1, H, ohw[1], C)
        res = _compare("nhwc config 5", y[:1],
                       cr._resample_axis_plain(_view3(t1, 1), sh, BF16).reshape(1, *ohw, C))
        yf = cr.resize_axis(cr.resize_axis(x, sw, 2, fused=True), sh, 1, fused=True)
        t1 = cr._resample_axis_fused_plain(_view3(x1, 2), sw, BF16).reshape(1, H, ohw[1], C)
        res_f = _compare("nhwc config 5 fused", yf[:1], cr._resample_axis_fused_plain(
            _view3(t1, 1), sh, BF16).reshape(1, *ohw, C))
        del y, yf, t1
        t = cr.resize_axis(x, sw, 2)
        times = {}
        for fused in (False, True):
            k = "fused" if fused else "table"
            times[f"{k}_w"] = _kernel_times(lambda: cr.resize_axis(x, sw, 2, fused=fused), 5,
                                            "resample_axis_kernel")
            times[f"{k}_h"] = _kernel_times(lambda: cr.resize_axis(t, sh, 1, fused=fused), 5,
                                            "resample_axis_kernel")
        xc = x.permute(0, 3, 1, 2)  # NCHW view of the channels-last frames
        lib_dev = device_time_per_call(
            lambda: F.interpolate(xc, ohw, mode="bilinear", antialias=True), iters=3)
        del x, t, xc
        torch.cuda.empty_cache()
    bw = bound_of(2 * N * H * C * (W + ohw[1]) + _nbytes(*cr._tables(sw)),
                  N * H * C * _nz(cr._tables(sw)[1]))
    bh = bound_of(2 * N * ohw[1] * C * (H + ohw[0]) + _nbytes(*cr._tables(sh)),
                  N * ohw[1] * C * _nz(cr._tables(sh)[1]))
    fields = {}
    for k, v in times.items():
        b = bw if k.endswith("_w") else bh
        fields[f"{k}_device_ms"] = v["device_ms"]
        fields[f"{k}_host_us"] = v["host_us"]
        fields[f"{k}_share_of_bound"] = b["bound_ms"] / v["device_ms"]
    tables = times["table_w"]["device_ms"] + times["table_h"]["device_ms"]
    fused = times["fused_w"]["device_ms"] + times["fused_h"]["device_ms"]
    _line("time_nhwc_config5", card=card, kernel="resample_axis", shape=[N, H, W, C],
          size=list(ohw), dtype=str(BF16), **fields, w_pass_bound=bw, h_pass_bound=bh,
          table_ms=tables, fused_ms=fused,
          table_gb_s=(bw["bytes"] + bh["bytes"]) / (tables * 1e-3) / 1e9,
          library_device_ms=lib_dev, table_over_library=tables / lib_dev,
          fused_over_library=fused / lib_dev, fused_over_table=fused / tables,
          max_abs_err=res["max_abs_err"], fused_max_abs_err=res_f["max_abs_err"])


# ---------------------------------------------------------------------------
# 5. with --ranks N: the group phases across N cards, one rank per card
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# 4. the command line and the inspection tools
# ---------------------------------------------------------------------------

# kernel_report's cases beside the CLI's bench batch: (name, shape, size,
# mode, dtype, data_format); the last two fit no kernel-A tile
REPORT_CASES = (
    ("configs 1-2 NCHW", HEADLINE[0], HEADLINE[1], "bilinear", F32, None),
    ("configs 1-2 NHWC", (1, 438, 906, 3), HEADLINE[1], "bilinear", F32, "NHWC"),
    ("config 5", CONFIG5[0], CONFIG5[1], "bilinear", BF16, None),
    ("no tile fits, float", (2, 58200, 4), (1, 4), "box", F32, None),
    ("no tile fits, uint8", (1, 20000, 64), (10, 32), "lanczos3", U8, None),
)
# PERF.md section 6's bounds of rows 1 (the bench batch) and 5 (config 5), ms
PERF_BOUNDS = {"bench batch": 0.0263, "config 5": 1.1885}


def _report_matches_run(name: str, rep, x: torch.Tensor, size, mode: str,
                        data_format=None) -> dict:
    """Run ``resize`` on ``x`` with the counts at 0 and hold what it launched
    to the report's route and launch counts."""
    _reset()
    resize(x, size, method=mode, data_format=data_format)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    if got != rep.launches or rep.n_sm_assumed or rep.n_sm != cr._n_sm(x.device):
        raise RuntimeError(f"kernel_report {name}: route {rep.route!r} launches "
                           f"{rep.launches} on {rep.n_sm} SMs (assumed "
                           f"{rep.n_sm_assumed}); the call launched {got}")
    fields = dict(case=name, shape=list(x.shape), size=list(size), dtype=str(x.dtype),
                  route=rep.route, launches=got, bound_ms=rep.bound_ms,
                  bound_by=rep.bound_by, plan=rep.plan)
    if name in PERF_BOUNDS:
        want = PERF_BOUNDS[name]
        if abs(rep.bound_ms - want) > 0.005 * want:
            raise RuntimeError(f"kernel_report {name}: bound {rep.bound_ms} ms, "
                               f"PERF.md gives {want}")
        fields["perf_md_bound_ms"] = want
    _line("cli", step="inspect", **fields)
    return got


def cli_phase(dev, card) -> None:
    """The CLI and the inspection tools on the card, each step checked
    against the launch counters (see the module docstring, item 4)."""
    from interpolate_antialiasing_tpu_torch import cli
    from interpolate_antialiasing_tpu_torch.utils.imageio import synthetic_image
    from interpolate_antialiasing_tpu_torch.utils.inspect import kernel_report, lower_text

    t0 = last = time.perf_counter()

    def lap() -> float:  # seconds since the last step ended
        nonlocal last
        now = time.perf_counter()
        dt, last = now - last, now
        return round(dt, 3)

    img = synthetic_image()
    size = ("320", "196")
    rep = cli.main(["--inspect", "--size", *size, "--batch", "64"])
    bench = torch.from_numpy(np.stack([img] * 64)).to(dev)
    _report_matches_run("bench batch", rep, bench, BENCH[1], "bilinear")
    for i, (name, shape, ohw, mode, dt, fmt) in enumerate(REPORT_CASES):
        rep = kernel_report(shape, ohw, mode=mode, dtype=dt, data_format=fmt)
        x = _rand(shape, dt, dev, 900 + i)
        _report_matches_run(name, rep, x, ohw, mode, fmt)
        del x
    torch.cuda.empty_cache()
    _line("cli", step="inspect: every report equals its run", cases=1 + len(REPORT_CASES),
          seconds=lap())

    _reset()
    (row,) = cli.main(["--bench", "--size", *size, "--batch", "64"])
    counts = launch_counts()
    if row["device"] != card or counts["resample2d"] < 1 or counts["pil_resample_2pass"] < 1:
        raise RuntimeError(f"cli --bench: row on {row['device']!r} (card {card!r}), "
                           f"launches {counts}")
    _line("cli", step="bench", row=row, launches={k: v for k, v in counts.items() if v},
          seconds=lap())

    res = cli.main(["--backward", "--size", "64", "48"])
    if res["forward_launches"].get("resample2d", 0) < 1 or \
            res["adjoint_launches"].get("resample2d", 0) < 1:
        raise RuntimeError(f"cli --backward: launches {res}")
    _line("cli", step="backward", **res, seconds=lap())

    trace_dir = Path("smoke_out") / "trace"
    os.environ["IA_TPU_TRACE_DIR"] = str(trace_dir)
    path = cli.main(["--profile", "--size", *size])
    events = json.loads(Path(path).read_text())["traceEvents"]
    hits = [e for e in events if e.get("cat") == "kernel" and "resample2d" in e.get("name", "")]
    if not hits:
        raise RuntimeError(f"cli --profile: no resample2d kernel record in {path}")
    _line("cli", step="profile", trace=str(path), resample2d_records=len(hits),
          seconds=lap())

    (acc,) = cli.main(["--mode", "lanczos5", "--size", *size])
    if acc["oracle"] != "dense-f64" or acc["max_abs_err"] > 1:
        raise RuntimeError(f"cli lanczos5 accuracy: {acc}")
    _line("cli", step="accuracy", **acc, seconds=lap())

    dump = Path("smoke_out") / "bench_compiled.txt"
    cli.main(["--dump-hlo", str(dump), "--size", *size, "--batch", "64"])
    txt = dump.read_text()
    sass = re.findall(r"Function : (\S*resample2d_kernel\S*)", txt)
    if not sass or "[hand-written]" not in txt:
        raise RuntimeError(f"cli --dump-hlo: no resample2d_kernel SASS in {dump}")
    _line("cli", step="dump-hlo", file=str(dump), chars=len(txt), sass_functions=sass,
          seconds=lap())

    (shape, ohw) = TRAIN_B64
    x = torch.from_numpy((np.random.default_rng(0).random(shape) * 255).astype(np.uint8))
    x = x.to(dev)
    boxes = torch.from_numpy(_run_all_boxes(shape[0])).to(dev)
    def counts(text):
        return [int(v) for v in re.match(r"# (\d+) aten ops, (\d+) kernel", text).groups()]

    text = lower_text(lambda: crop_and_resize(x, boxes, ohw))
    n_ops, n_launches = counts(text)
    launched = sorted(ln for ln in text.splitlines() if ln.startswith("launch "))
    if launched != ["launch crop_resample"] * 2 + ["launch crop_tables"] or n_ops > 16:
        raise RuntimeError(f"lower_text crop_and_resize: {n_ops} aten ops (at most 16), "
                           f"launches {launched}, expected crop_tables + 2 crop_resample")
    n_table_ops, _ = counts(lower_text(lambda: cc._windowed_tables(
        x, boxes.float(), ohw, "bilinear", True, 1.0, "pil_int8")))
    with _forced(cc, "_windowed_tables_cuda", cc._windowed_tables_plain):
        plain_ops, _ = counts(lower_text(lambda: crop_and_resize(x, boxes, ohw)))
        plain_table_ops, _ = counts(lower_text(lambda: cc._windowed_tables(
            x, boxes.float(), ohw, "bilinear", True, 1.0, "pil_int8")))
    lowered = Path("smoke_out") / "crop_lower.txt"
    lowered.write_text(text)
    _line("cli", step="lower_text crop_and_resize b64", shape=list(shape), size=list(ohw),
          aten_ops=n_ops, table_build_aten_ops=n_table_ops, kernel_launches=n_launches,
          plain_tables_aten_ops=plain_ops, plain_table_build_aten_ops=plain_table_ops,
          file=str(lowered), seconds=lap(), phase_seconds=time.perf_counter() - t0)


def _rank_child(rank: int, n: int, tmp: str) -> None:
    """One spawned rank of ``--ranks n``: its lines, or its error, to a file
    the parent reads."""
    try:
        lines = _in_group(rank, n, f"{tmp}/store")
    except Exception as e:  # noqa: BLE001 — reported by the parent
        import traceback

        lines = [{"phase": "error", "rank": rank, "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-3000:]}]
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(lines))


def ranks_main(n: int) -> None:
    """``--ranks n``: :func:`group_phases` across ``n`` cards of one host,
    one spawned rank per card."""
    import tempfile

    import torch.multiprocessing as mp

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        raise SystemExit(f"chip_smoke --ranks {n}: needs {n} CUDA cards")
    card = _card()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    native.build()  # once, before the ranks load it
    _line("build", seconds=round(time.perf_counter() - t0, 3))
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_child, args=(n, tmp), nprocs=n, start_method="spawn")
        results = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(n)]
    failed = 0
    for lines in results:
        for ln in lines:
            print(json.dumps(ln), flush=True)
        failed += len(lines) != len(GROUP_LAUNCHES)
    if failed:
        raise SystemExit(f"chip_smoke --ranks {n}: {failed} rank(s) failed")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA card")
    card = _card()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    _line("device", kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    native.build()
    per_source = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^== (\S+) \(([\d.]+) s\)$", native.ptxas_log(), re.M)}
    _line("build", seconds=round(time.perf_counter() - t0, 3), nvcc_seconds=per_source,
          slowest=max(per_source, key=per_source.get) if per_source else None)
    print_ptxas()
    print_kernel_a_plans(dev)
    print_axis_plans(dev)

    rng = np.random.default_rng(0)
    with full_f32():
        try:
            pil_err = check_pil_kernel(dev, rng)
            err_2d, err_axis = check_float_kernels(dev)
            adj_2d, adj_axis = check_adjoint_kernels(dev)
            crop_err, tables_err = check_crop_kernel(dev)
            crop_f32_err = check_crop_f32_kernel(dev)
            pil_axis_err = check_pil_axis_kernel(dev)
            shard_err = check_shard_tables_kernel(dev)
            fused_2d_err, fused_axis_err = check_fused_kernels(dev)
            tile_err, tile_fused_err, tile_pil_err = check_axis_tiles(dev)
            u8_pil_err, u8_crop_err, u8_tables_err = check_u8_tiles(dev)
            group_tables_err = check_table_groups(dev)
        finally:
            CASES_LOG.parent.mkdir(exist_ok=True)
            CASES_LOG.write_text("".join(c + "\n" for c in _cases))
        _line("kernel_vs_plain_cases", written=str(CASES_LOG), cases=len(_cases))
        torch.cuda.empty_cache()
        pil_launches = main_path_u8_pipeline(dev)
        c5_launches = main_path_config5(dev)
        torch.cuda.empty_cache()
        fused_2d, fused_axis = main_path_fused(dev)
        torch.cuda.empty_cache()
        hl_2d, hl_axis = main_path_headline(dev)
        f32_launches = main_path_f32_pipeline(dev)
        c4_2d, c4_axis = main_path_config4(dev)
        torch.cuda.empty_cache()
        c3_launches = main_path_config3(dev)
        st_2d = main_path_scale_translate(dev)
        gap_launches = main_path_reducing_gap(dev)
        torch.cuda.empty_cache()
        crop_launches, table_launches, train_2d, crop_f32_launches = main_path_train(dev)
        torch.cuda.empty_cache()
        check_crop_against_dense(dev)
        torch.cuda.empty_cache()
        sh_pil = main_path_sharded_pil(dev)
        sh_axis = main_path_sharded_float(dev)
        torch.cuda.empty_cache()
        rank_pil, rank_axis = main_path_one_rank_group()
        torch.cuda.empty_cache()
    t_pil = time_pil_kernel(dev, rng, card)
    t_2d, t_axis = time_float_kernels(dev, card)
    torch.cuda.empty_cache()
    t_2d_fused, t_axis_fused = time_fused_kernels(dev, card)
    torch.cuda.empty_cache()
    t_crop, t_tables = time_train_kernels(dev, card)
    torch.cuda.empty_cache()
    t_crop_f32 = time_crop_f32(dev, card)
    torch.cuda.empty_cache()
    t_pil_axis, t_shard = time_sharded_kernels(dev, card)
    torch.cuda.empty_cache()
    time_nhwc_config5(dev, card)
    torch.cuda.empty_cache()
    cli_phase(dev, card)

    print(card, flush=True)  # again, near the end of a long output
    print(json.dumps({"kernels": [
        {"name": "pil_resample_2pass", "route": "cuda",
         "source": "interpolate_antialiasing_tpu_torch/csrc/resample2d.cuh",
         "entry": "interpolate_antialiasing_tpu_torch/csrc/pil_resample.cu",
         "weights": "interpolate_antialiasing_tpu_torch/csrc/ia_taps.cuh",
         "replaces": "interpolate_antialiasing_tpu/ops/pil_exact.py:504",
         "also_serves": "interpolate_antialiasing_tpu/ops/pil_exact.py:824",
         "launches": pil_launches + c3_launches + gap_launches,
         "max_abs_err": max(pil_err, u8_pil_err), **t_pil},
        {"name": "resample2d", "route": "cuda",
         "source": "interpolate_antialiasing_tpu_torch/csrc/resample2d.cuh",
         "entry": "interpolate_antialiasing_tpu_torch/csrc/resample2d.cu",
         "replaces": "interpolate_antialiasing_tpu/ops/pallas_resize.py:1003",
         "also_serves": "interpolate_antialiasing_tpu/ops/pallas_resize.py:1475, "
                        ":1176 (adjoint)",
         "launches": c5_launches + hl_2d + f32_launches + c4_2d + train_2d + st_2d,
         "max_abs_err": max(err_2d, adj_2d), **t_2d},
        {"name": "resample_axis", "route": "cuda",
         "source": "interpolate_antialiasing_tpu_torch/csrc/resample_axis.cuh",
         "entry": "interpolate_antialiasing_tpu_torch/csrc/resample_axis.cu",
         "replaces": "interpolate_antialiasing_tpu/ops/pallas_resize.py:172",
         "also_serves": "interpolate_antialiasing_tpu/ops/pallas_resize.py:184, "
                        ":258, :275, :1727 (adjoint), :583 (sharded H pass over "
                        "per-shard tables)",
         "launches": hl_axis + c4_axis + sh_axis + rank_axis,
         "max_abs_err": max(err_axis, adj_axis, shard_err, tile_err), **t_axis,
         "shard_tables": t_shard},
        {"name": "crop_resample", "route": "cuda",
         "source": "interpolate_antialiasing_tpu_torch/csrc/resample_axis.cuh",
         "entry": "interpolate_antialiasing_tpu_torch/csrc/crop_resample.cu",
         "weights": "interpolate_antialiasing_tpu_torch/csrc/ia_taps.cuh",
         "rows": "interpolate_antialiasing_tpu_torch/csrc/crop_row.cuh",
         "replaces": "interpolate_antialiasing_tpu/ops/crop_pallas.py:250, :280",
         "also_serves": "interpolate_antialiasing_tpu/ops/crop_pallas.py:303, :318",
         "launches": crop_launches, "max_abs_err": max(crop_err, u8_crop_err), **t_crop},
        {"name": "crop_tables", "route": "cuda",
         "source": "interpolate_antialiasing_tpu_torch/csrc/crop_tables.cu",
         "rows": "interpolate_antialiasing_tpu_torch/csrc/crop_row.cuh",
         "replaces": "interpolate_antialiasing_tpu/ops/crop_pallas.py:117, :190 (the band "
                     "build XLA fuses ahead of :541 and :617)",
         "launches": table_launches,
         "max_abs_err": max(tables_err, u8_tables_err, group_tables_err),
         **t_tables},
        {"name": "crop_f32", "route": "cuda",
         "source": "interpolate_antialiasing_tpu_torch/csrc/resample_axis.cuh",
         "entry": "interpolate_antialiasing_tpu_torch/csrc/crop_resample.cu",
         "instantiations": "interpolate_antialiasing_tpu_torch/csrc/crop_resample_f32.cu",
         "rows": "interpolate_antialiasing_tpu_torch/csrc/crop_row.cuh",
         "replaces": "interpolate_antialiasing_tpu_torch/ops/crop.py:_axis_matrix and its two "
                     "float32 matrix products on the card (the JAX package's flipped calls "
                     "take its dense route)",
         "launches": crop_f32_launches, "max_abs_err": crop_f32_err, **t_crop_f32},
        {"name": "pil_resample_axis", "route": "cuda",
         "source": "interpolate_antialiasing_tpu_torch/csrc/resample_axis.cuh",
         "entry": "interpolate_antialiasing_tpu_torch/csrc/pil_resample_axis.cu",
         "replaces": "interpolate_antialiasing_tpu/ops/pil_exact.py:407",
         "launches": sh_pil + rank_pil, "max_abs_err": max(pil_axis_err, tile_pil_err),
         **t_pil_axis},
        {"name": "resample2d_fused", "route": "cuda",
         "source": "interpolate_antialiasing_tpu_torch/csrc/resample2d.cuh",
         "entry": "interpolate_antialiasing_tpu_torch/csrc/resample2d_fused.cu",
         "weights": "interpolate_antialiasing_tpu_torch/csrc/ia_taps.cuh",
         "replaces": "interpolate_antialiasing_tpu/ops/pallas_resize.py:258",
         "also_serves": "interpolate_antialiasing_tpu/ops/pallas_resize.py:275 (the "
                        "fused_spec branches of _kernel_{last,mid}_unrolled, "
                        "resize2d_pallas(fused=True))",
         "launches": fused_2d, "max_abs_err": fused_2d_err, **t_2d_fused},
        {"name": "resample_axis_fused", "route": "cuda",
         "source": "interpolate_antialiasing_tpu_torch/csrc/resample_axis.cuh",
         "entry": "interpolate_antialiasing_tpu_torch/csrc/resample_axis.cu",
         "weights": "interpolate_antialiasing_tpu_torch/csrc/ia_taps.cuh",
         "replaces": "interpolate_antialiasing_tpu/ops/pallas_resize.py:227",
         "also_serves": "interpolate_antialiasing_tpu/ops/pallas_resize.py:239, "
                        ":197 (_synth_band)",
         "launches": fused_axis, "max_abs_err": max(fused_axis_err, tile_fused_err),
         **t_axis_fused},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=1,
                    help="run only the sharded phases across this many cards of one "
                         "host, one rank per card (default: the one-card smoke test)")
    ranks = ap.parse_args().ranks
    if ranks > 1:
        ranks_main(ranks)
    else:
        main()

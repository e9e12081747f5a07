"""Device time per launch of the per-axis kernels (kernel B with host tables
and with synthesised weights, and pil_resample_axis) at the shapes that
PERF.md times, for one checkout of the port.

    python3 tools/time_axis_kernels.py [--root DIR] [--label NAME]

``--root`` is the root of the checkout whose ``interpolate_antialiasing_tpu_torch``
is imported (default: this one), so one command can time two commits on
one card in turns: unpack the other commit with ``git archive`` into a
git-ignored directory and run

    for r in OLD . . OLD; do python3 tools/time_axis_kernels.py --root $r; done

Each run builds its checkout's kernels at first use (into that checkout's
``_build/``), checks every pass against its plain version on one plane,
and prints one JSON line: the card's name and power limit, and per reading
the device time per launch from torch.profiler's kernel records (the host's
pace does not enter it).  Needs a CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path


def _device_ms(fn, iters: int) -> float:
    """Device time per launch of the kernels whose name holds
    "resample_axis", over ``iters`` calls after one untimed call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hit = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "resample_axis" in e.name]
        total_us = sum(e.time_range.elapsed_us() for e in hit)
        if hit and total_us > 0:
            return total_us / 1e3 / len(hit)
    raise RuntimeError("the profiler saw no resample_axis kernel")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_axis_kernels: needs a CUDA card")
    from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
    from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
    from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec
    from interpolate_antialiasing_tpu_torch.parallel import halo

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype):
        return (torch.rand(shape, device=dev, generator=gen) * 255).to(dtype)

    def view3(x, axis):
        return x.reshape(math.prod(x.shape[:axis]), x.shape[axis], math.prod(x.shape[axis + 1:]))

    def same(got, want, name):
        if not torch.equal(got, want):
            raise SystemExit(f"{name}: kernel != plain version")

    out = {}

    def float_pass(name, x, spec, axis, iters):
        for fused in (False, True):
            plain = cr._resample_axis_fused_plain if fused else cr._resample_axis_plain
            x1 = x[:1]
            same(cr.resize_axis(x1, spec, axis, fused=fused),
                 plain(view3(x1, axis), spec, x.dtype).reshape(
                     *x1.shape[:axis], spec.out_size, *x1.shape[axis + 1:]),
                 f"{name} fused={fused}")
            out[f"{name} {'fused' if fused else 'tables'}"] = _device_ms(
                lambda: cr.resize_axis(x, spec, axis, fused=fused), iters)

    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    # the NHWC headline, f32 [1, 438, 906, 3] -> 196x320: W pass, H pass
    sh, sw = make_axis_spec(438, 196), make_axis_spec(906, 320)
    x = rand((1, 438, 906, 3), f32)
    float_pass("headline nhwc w", x, sw, 2, 50)
    float_pass("headline nhwc h", cr.resize_axis(x, sw, 2), sh, 1, 50)
    # the last axis of the NCHW headline's planes
    float_pass("headline last axis", x.permute(0, 3, 1, 2).contiguous(), sw, 3, 50)
    # config 5 in NHWC, bf16 [64, 2160, 3840, 3] -> 1080x1920
    sh, sw = make_axis_spec(2160, 1080), make_axis_spec(3840, 1920)
    x = rand((64, 2160, 3840, 3), bf16)
    float_pass("config5 nhwc w", x, sw, 2, 5)
    t = cr.resize_axis(x, sw, 2)
    del x
    torch.cuda.empty_cache()
    float_pass("config5 nhwc h", t, sh, 1, 5)
    del t
    torch.cuda.empty_cache()
    # row 9: one shard of the sharded float H pass, f32 16384^2 -> 4096^2
    # bicubic on 4 shards, and its adjoint
    plan = halo.plan_halo_banded(16384, 4096, "bicubic", True, 4)
    fwd, adj = halo._shard_tables(plan, 1)
    with torch.no_grad():
        ext, g = rand((3, plan.ext_pad, 4096), f32), rand((3, plan.ol, 4096), f32)
        same(cr.resize_axis(ext, fwd, 1), cr._resample_axis_plain(ext, fwd, f32), "row 9")
        same(cr.resize_axis(g, adj, 1), cr._resample_axis_plain(g, adj, f32), "row 9 adjoint")
        out["row9 forward"] = _device_ms(lambda: cr.resize_axis(ext, fwd, 1), 10)
        out["row9 adjoint"] = _device_ms(lambda: cr.resize_axis(g, adj, 1), 10)
    del ext, g
    # row 3: one shard of the sharded uint8 route, 32768^2 -> 8192^2 on 4
    # shards: the H pass over shard 1's tables, the W pass of its block
    iplan, starts, wsh = halo._int_halo_tables(32768, 8192, "bilinear", 4)
    th = (starts[1], wsh[1])
    tw = pe._int_tables(32768, 8192, "bilinear")
    ext = rand((3, iplan.ext, 8192), u8)
    same(pe._resample_axis(ext, th, 1), pe._resample_axis_plain(ext, th), "row 3 h")
    out["row3 h pass"] = _device_ms(lambda: pe._resample_axis(ext, th, 1), 5)
    del ext
    blk = rand((3, iplan.hl, 32768), u8)
    same(pe._resample_axis(blk[:1], tw, 2),
         pe._resample_axis_plain(view3(blk[:1], 2), tw).reshape(1, iplan.hl, 8192), "row 3 w")
    out["row3 w pass"] = _device_ms(lambda: pe._resample_axis(blk, tw, 2), 5)
    print(json.dumps({"label": args.label or args.root, "card": card,
                      "device_ms": out}), flush=True)


if __name__ == "__main__":
    main()

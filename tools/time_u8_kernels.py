"""Device time of the two uint8 kernels (the Pillow two-pass kernel and the
windowed crop's two passes) and of kernel A's float route, at the shapes
PERF.md times, for one checkout of the port.

    python3 tools/time_u8_kernels.py [--root DIR] [--label NAME] [--tiles]

``--root`` is the root of the checkout whose ``interpolate_antialiasing_tpu_torch``
is imported (default: this one), so one command can time two commits on
one card in turns: unpack the other commit with ``git archive`` into a
git-ignored directory and run

    for r in OLD . . OLD; do python3 tools/time_u8_kernels.py --root $r; done

Readings: the bench batch (uint8 [64, 3, 438, 906] -> 196x320 bilinear,
PERF.md row 1), the 4K -> HD frame (uint8 [3, 2160, 3840] -> 1080x1920, row
2), the crop at the train shape (uint8 [64, 3, 438, 906] -> 224x224 with
benchmarks/run_all.py's boxes, both precisions: rows 10 and 11) and the
RandomResizedCrop of 4K frames ([8, 3, 2160, 3840] -> 224x224), and kernel
A's float route at the f32 headline ([1, 3, 438, 906] -> 196x320, row 4)
and config 5 (bf16 [64, 3, 2160, 3840] -> 1080x1920, row 5).  Each call's
output is first held against the checkout's plain version on the card,
byte for byte.  Each reading is the device time per call of the kernels
whose names the reading lists (torch.profiler's kernel records; CUDA
events around the calls, less the L2 flushes alone, where the profiler
misses a launch), with the card's 50 MB L2 cache overwritten before every
call (a call re-run on the same input finds part of it there), beside the
device time of every kernel of the call (the crop's window tables
included) and the bytes bound (inputs read once and outputs written once
over 3.35 TB/s).  A kernel reading below its bound cannot be right: it is
flagged (``below_bound``) and makes the run exit 1.

``--tiles`` also times, for this checkout's Pillow kernel at rows 1 and 2
and each crop pass at the train shape (pil_int8), every tile its plan
considers, forced past the plan (the crop: each pass in turn, the other on
its plan; and kernel B's unstaged body), and prints where the plan's own
tile ranks.  Prints one JSON line per checkout (and, with ``--tiles``, one
per swept pass), with the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_MS = 3.35e9  # H100 SXM HBM3 peak, bytes per millisecond


def _time(fn, iters: int, match: tuple[str, ...], flush) -> dict:
    """Device time per call of ``fn``, ``flush`` overwritten before each
    call: ``kernel_ms``, the kernels whose names hold one of ``match``, and
    ``call_ms``, every kernel of the call but the flush."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        hit = [e for e in ev if any(m in e.name for m in match)]
        rest = [e for e in ev if "Fill" not in e.name and "fill" not in e.name]
        if hit and len(hit) % iters == 0:
            us = sum(e.time_range.elapsed_us() for e in hit)
            return {"kernel_ms": us / 1e3 / iters, "launches": len(hit) // iters,
                    "call_ms": sum(e.time_range.elapsed_us() for e in rest) / 1e3 / iters,
                    "method": "profiler"}

    def per_call(body):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    ms = per_call(lambda: (flush.zero_(), fn())) - per_call(flush.zero_)
    return {"kernel_ms": ms, "launches": None, "call_ms": ms, "method": "events"}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    ap.add_argument("--tiles", action="store_true",
                    help="also time every tile the plans consider (this checkout's)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_u8_kernels: needs a CUDA card")
    from interpolate_antialiasing_tpu_torch.ops import crop_cuda as cc
    from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
    from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
    from interpolate_antialiasing_tpu_torch.ops import plans
    from interpolate_antialiasing_tpu_torch.ops.crop import box_fracs, sample_boxes
    from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    pil_names = ("pil_resample_2pass_kernel", "resample2d_kernel")
    crop_names = ("crop_pass_kernel", "resample_axis_kernel")
    out, failed = {}, []

    def rand(shape, dtype):
        return (torch.rand(shape, device=dev, generator=gen) * 255).to(dtype)

    def reading(name, fn, want, nbytes, iters, match):
        got = fn()
        if not torch.equal(got, want):
            raise SystemExit(f"{name}: kernel != plain version")
        r = _time(fn, iters, match, flush)
        r["bound_ms"] = nbytes / HBM_BYTES_PER_MS
        if r["kernel_ms"] < r["bound_ms"]:
            r["below_bound"] = True
            failed.append(name)
        out[name] = r
        return r

    # rows 1 and 2: the Pillow two-pass kernel
    for name, shape, size, iters in (("row1 bench", (192, 438, 906), (196, 320), 20),
                                     ("row2 4k->hd", (3, 2160, 3840), (1080, 1920), 20)):
        x3 = rand(shape, torch.uint8)
        tw = pe._int_tables(shape[2], size[1], "bilinear")
        th = pe._int_tables(shape[1], size[0], "bilinear")
        nbytes = shape[0] * (shape[1] * shape[2] + size[0] * size[1])
        reading(name, lambda: pe._resample_2pass(x3, tw, th),
                pe._resample_2pass_plain(x3, tw, th), nbytes, iters, pil_names)
        if args.tiles:
            _sweep_pil(name, x3, tw, th, pe, plans, flush, card)
        del x3
    # rows 10 and 11: the crop at the train shape, and the 4K RandomResizedCrop
    rng = np.random.default_rng(0)
    run_all = np.concatenate([rng.uniform(0.0, 0.35, (64, 2)), rng.uniform(0.65, 1.0, (64, 2))],
                             axis=1).astype(np.float32)
    for name, shape, boxes, frac, iters in (
            ("crop b64", (64, 3, 438, 906), torch.from_numpy(run_all), 1.0, 20),
            ("crop 4k", (8, 3, 2160, 3840),
             sample_boxes(torch.Generator().manual_seed(1), 8, 2160, 3840), box_fracs(2160, 3840),
             10)):
        x = rand(shape, torch.uint8)
        b = boxes.to(dev)
        nbytes = shape[0] * shape[1] * (shape[2] * shape[3] + 224 * 224)
        for precision, row in (("pil_int8", "row10"), ("split", "row11")):
            t = cc._windowed_tables(x, b, (224, 224), "bilinear", True, frac, precision)
            reading(f"{row} {name} {precision}", lambda: cc._crop_resample_cuda(x, *t),
                    cc._crop_resample_plain(x, *t), nbytes, iters, crop_names)
            if args.tiles and name == "crop b64" and precision == "pil_int8":
                _sweep_crop(name, x, t, cc, plans, flush, card)
            del t
        del x
        torch.cuda.empty_cache()
    # rows 4 and 5: kernel A's float route
    for name, shape, size, dtype, iters in (
            ("row4 headline f32", (3, 438, 906), (196, 320), torch.float32, 50),
            ("row5 config5 bf16", (192, 2160, 3840), (1080, 1920), torch.bfloat16, 5)):
        x3 = rand(shape, dtype)
        sh, sw = make_axis_spec(shape[1], size[0]), make_axis_spec(shape[2], size[1])
        isz = x3.element_size()
        nbytes = isz * shape[0] * (shape[1] * shape[2] + size[0] * size[1])
        want = cr._resample2d_plain(x3[:1], sh, sw, dtype)
        got = cr.resize2d(x3[:1], sh, sw, dtype)
        if not torch.equal(got, want):
            raise SystemExit(f"{name}: kernel != plain version")
        out[name] = _time(lambda: cr.resize2d(x3, sh, sw, dtype), iters, ("resample2d_kernel",),
                          flush)
        out[name]["bound_ms"] = nbytes / HBM_BYTES_PER_MS
        if out[name]["kernel_ms"] < out[name]["bound_ms"]:
            out[name]["below_bound"] = True
            failed.append(name)
        del x3, want, got
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or args.root, "card": card, "readings": out}),
          flush=True)
    if failed:
        raise SystemExit(f"time_u8_kernels: readings below the bytes bound: {failed}")


def _rank(times: dict, plan_key) -> dict:
    times = {k: v for k, v in times.items() if v is not None}
    order = sorted(times, key=times.get)
    best = times[order[0]]
    return {"plan": plan_key, "plan_ms": times.get(plan_key), "plan_rank": order.index(plan_key)
            if plan_key in times else None, "fastest": [[k, times[k]] for k in order[:5]],
            "plan_over_fastest": times[plan_key] / best if plan_key in times else None,
            "tiles": len(times)}


def _sweep_pil(name, x3, tw, th, pe, plans, flush, card) -> None:
    """Every tile of the Pillow kernel's plan, forced; device ms each."""
    import torch

    B, H, W = x3.shape
    want = pe._resample_2pass_plain(x3, tw, th)
    real = plans.plan_pil_2pass
    plan = real(tw, th, B, H, W, plans.n_sm(x3.device))
    times = {}
    try:
        for _, p in plans._rows_candidates(th[0], th[1].shape[1], H, tw[0], tw[1].shape[1], W, 1,
                                           B, plans.n_sm(x3.device), inter_size=1):
            plans.plan_pil_2pass = lambda *a, p=p: p
            got = pe._resample_2pass(x3, tw, th)
            if not torch.equal(got, want):
                raise SystemExit(f"{name} {p}: kernel != plain version")
            times[str((p.tile_r, p.tile_c, p.chunk))] = _time(
                lambda: pe._resample_2pass(x3, tw, th), 10, ("resample2d_kernel",),
                flush)["kernel_ms"]
    finally:
        plans.plan_pil_2pass = real
    print(json.dumps({"sweep": name, "card": card,
                      **_rank(times, str((plan.tile_r, plan.tile_c, plan.chunk)))}), flush=True)


def _sweep_crop(name, x, t, cc, plans, flush, card) -> None:
    """Every tile of each crop pass's plan (and the unstaged body), forced
    for that pass with the other on its plan; device ms of the forced
    pass's launch."""
    import torch

    N, C, H, W = x.shape
    want = cc._crop_resample_plain(x, *t)
    real = cc._crop_plan
    for which, tab, n_in, n_out, R, inner in (("h", t[0], H, 224, C, W),
                                              ("w", t[1], W, 224, C * 224, 1)):
        T = tab.w.shape[-1]
        vec4 = x.data_ptr() % 4 == 0
        plan = real(tab.wins, n_in, n_out, T, N, R, inner, plans.n_sm(x.device), vec4, 1)
        cands = [p for _, p in plans.axis_tiles(tab.wins, n_out, T, n_in, N * R, inner, 1,
                                                plans.n_sm(x.device), vec4, per_img=R)]
        times = {}
        for p in list(dict.fromkeys(cands)) + [None]:
            def pick(wins, n_in, n_out, T, N, R, inner, n_sm, vec4, itemsize, p=p,
                     which=which):
                if (inner > 1) == (which == "h"):
                    return p
                return real(wins, n_in, n_out, T, N, R, inner, n_sm, vec4, itemsize)

            cc._crop_plan = pick
            try:
                if not torch.equal(cc._crop_resample_cuda(x, *t), want):
                    raise SystemExit(f"{name} {which} {p}: kernel != plain version")
                # the forced pass's launch: the H pass is the first, the W the second
                r = _pass_ms(lambda: cc._crop_resample_cuda(x, *t), 10, flush,
                             0 if which == "h" else 1)
            finally:
                cc._crop_plan = real
            key = "unstaged" if p is None else str((p.tile_j, p.tile_o, p.tile_i, p.win, p.vec))
            times[key] = r
        plan_key = "unstaged" if plan is None else str(
            (plan.tile_j, plan.tile_o, plan.tile_i, plan.win, plan.vec))
        print(json.dumps({"sweep": f"{name} {which} pass", "card": card,
                          **_rank(times, plan_key)}), flush=True)


def _pass_ms(fn, iters, flush, index) -> float | None:
    """Device ms of the ``index``-th resample_axis launch of each call;
    None where five profiles in a row missed a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        hit = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and "resample_axis_kernel" in e.name), key=lambda e: e.time_range.start)
        if len(hit) == 2 * iters:
            return sum(e.time_range.elapsed_us() for e in hit[index::2]) / 1e3 / iters
    return None


if __name__ == "__main__":
    main()

"""Every tile the per-axis kernels' host plan considers, timed on the card,
at the passes PERF.md times: which tile is fastest, and where the plan's
own choice ranks; and, with ``--cut``, the staged body against the
unstaged one at passes of 2 to 110 MB, which sets the plan's
``cuda_resize._AXIS_UNSTAGED_BYTES`` and ``_AXIS_UNSTAGED_BYTES_FUSED``.

    python3 tools/sweep_axis_plans.py [--top N] [--cases NAME ...] [--cut]

For each pass (the NHWC headline's and NHWC config 5's W and H passes,
with host tables and, for config 5, synthesised weights; row 3's sharded
uint8 W and H pass; row 9's sharded float H pass and its adjoint), each
candidate of ``cuda_resize._axis_candidates`` is forced through the
wrapper and timed: device time per launch (torch.profiler's kernel
records, CUDA events above 0.2 ms), with the card's 50 MB L2 cache
overwritten before every launch
(a pass re-run on the same input finds part of it there and would read
faster than the memory allows).  The first candidate's output is held
against the plain version, and every other candidate's against the first,
bit for bit.  A reading below the pass's bytes bound (input and output
over 3.35 TB/s) is flagged (``below_bound``) and makes the run exit 1.

Prints one JSON line per pass: the plan's choice, its rank and its time
over the fastest tile's, the fastest ``--top`` candidates, the unstaged
body's time (the plan's None), the bound, and the card's name and power
limit; ``--all FILE`` appends every candidate's time to FILE.

``--cut`` instead times, at the NHWC headline's passes for 1 to 32
frames (tables and synthesised weights), config 4's NHWC adjoint passes
(8 frames) and a Pillow NHWC W pass (4 to 64 frames): the unstaged body
against the plan's three best-ranked tiles with the cut ignored, one line
per pass with the bytes it moves.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM_BYTES_PER_MS = 3.35e9  # H100 SXM HBM3 peak, bytes per millisecond


def _device_ms(fn, iters: int, flush) -> float:
    """Device time per launch of the axis kernel ``fn`` launches, ``flush``
    overwritten before each launch: above 0.2 ms, CUDA events around
    ``iters`` launches less the flushes alone (the card's queue stays ahead
    of the host there); below, torch.profiler's kernel records (the host's
    pace would enter events; the flush's own kernel is not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def per_launch(body):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    fn()
    torch.cuda.synchronize()
    ms = per_launch(lambda: (flush.zero_(), fn())) - per_launch(flush.zero_)
    if ms > 0.2:
        return ms
    for _ in range(3):  # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        hit = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "resample_axis" in e.name]
        if len(hit) == iters:
            return sum(e.time_range.elapsed_us() for e in hit) / 1e3 / len(hit)
    raise RuntimeError("the profiler did not record every resample_axis launch")


@contextlib.contextmanager
def _forced(cr, plan):
    """The axis kernels' wrappers launch ``plan`` (None: the unstaged body)."""
    real = cr._plan_axis_first
    cr._plan_axis_first = lambda *a: plan
    try:
        yield
    finally:
        cr._plan_axis_first = real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--cases", nargs="*", default=None)
    ap.add_argument("--cut", action="store_true",
                    help="staged against unstaged at passes of 2 to 110 MB")
    ap.add_argument("--all", default=None, help="append every candidate's time to this file")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_axis_plans: needs a CUDA card")
    from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
    from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
    from interpolate_antialiasing_tpu_torch.ops.weights import adjoint_tables, make_axis_spec
    from interpolate_antialiasing_tpu_torch.parallel import halo

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = cr._n_sm(dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    def rand(shape, dtype):
        return (torch.rand(shape, device=dev, generator=gen) * 255).to(dtype)

    def sweep_cases():
        """(name, x3, tables or spec, fused, iters)"""
        sh, sw = make_axis_spec(438, 196), make_axis_spec(906, 320)
        x = rand((1, 438, 906, 3), torch.float32)
        yield "headline nhwc w", x.view(438, 906, 3), sw, False, 50
        yield "headline nhwc h", cr.resize_axis(x, sw, 2).view(1, 438, 960), sh, False, 50
        yield "headline last axis", x.permute(0, 3, 1, 2).reshape(1314, 906, 1), sw, False, 50
        sh, sw = make_axis_spec(2160, 1080), make_axis_spec(3840, 1920)
        x = rand((64 * 2160, 3840, 3), torch.bfloat16)
        yield "config5 nhwc w", x, sw, False, 3
        yield "config5 nhwc w fused", x, sw, True, 3
        t = cr.resize_axis(x, sw, 1).view(64, 2160, 5760)
        del x
        yield "config5 nhwc h", t, sh, False, 3
        yield "config5 nhwc h fused", t, sh, True, 3
        del t
        plan = halo.plan_halo_banded(16384, 4096, "bicubic", True, 4)
        fwd, adj = halo._shard_tables(plan, 1)
        yield "row9 forward", rand((3, plan.ext_pad, 4096), torch.float32), fwd, False, 5
        yield "row9 adjoint", rand((3, plan.ol, 4096), torch.float32), adj, False, 5
        iplan, starts, wsh = halo._int_halo_tables(32768, 8192, "bilinear", 4)
        yield ("row3 h pass", rand((3, iplan.ext, 8192), torch.uint8), (starts[1], wsh[1]),
               False, 3)
        yield ("row3 w pass", rand((3 * iplan.hl, 32768, 1), torch.uint8),
               pe._int_tables(32768, 8192, "bilinear"), False, 3)

    def cut_cases():
        sh, sw = make_axis_spec(438, 196), make_axis_spec(906, 320)
        for b in (1, 2, 4, 8, 16, 32):
            x = rand((b, 438, 906, 3), torch.float32)
            for fused in (False, True):
                tag = " fused" if fused else ""
                if b <= 16:
                    yield f"headline nhwc w b{b}{tag}", x.view(b * 438, 906, 3), sw, fused, 20
                yield (f"headline nhwc h b{b}{tag}", cr.resize_axis(x, sw, 2).view(b, 438, 960),
                       sh, fused, 20)
        sh, sw = make_axis_spec(438, 196, "bicubic"), make_axis_spec(906, 320, "bicubic")
        yield ("config4 nhwc adjoint h b8", rand((8, 196, 960), torch.float32),
               adjoint_tables(sh), False, 20)
        yield ("config4 nhwc adjoint w b8", rand((8 * 438, 320, 3), torch.float32),
               adjoint_tables(sw), False, 20)
        tw = pe._int_tables(906, 320, "bilinear")
        for b in (4, 16, 64):
            yield f"pil nhwc w b{b}", rand((b * 438, 906, 3), torch.uint8), tw, False, 20

    def first_taps(t, fused):
        if isinstance(t, tuple):  # Pillow's (xmin, Wb)
            return np.asarray(t[0], np.int64), t[1].shape[1]
        if fused:
            return cr._synth_first(t), t.ntaps
        first, w = cr._tables(t)
        return first.astype(np.int64), w.shape[1]

    def runner(x3, t, fused):
        if isinstance(t, tuple):
            return (lambda: pe._resample_axis(x3, t, 1)), lambda: pe._resample_axis_plain(x3, t)
        if fused:
            return (lambda: cr.resize_axis(x3, t, 1, fused=True),
                    lambda: cr._resample_axis_fused_plain(x3, t, x3.dtype))
        return lambda: cr.resize_axis(x3, t, 1), lambda: cr._resample_axis_plain(x3, t, x3.dtype)

    below = 0
    for name, x3, t, fused, iters in (cut_cases() if args.cut else sweep_cases()):
        if args.cases and name not in args.cases:
            continue
        outer, n_in, inner = x3.shape
        first, ntaps = first_taps(t, fused)
        isz, vec4 = x3.element_size(), x3.data_ptr() % 4 == 0
        run, plain = runner(x3, t, fused)
        nbytes = x3.numel() * isz * (1 + len(first) / n_in)
        bound = nbytes / HBM_BYTES_PER_MS
        ranked = sorted(cr._axis_candidates(first, ntaps, n_in, outer, inner, isz, n_sm, vec4),
                        key=lambda kp: kp[0], reverse=True)
        chosen = (ranked[0][1] if args.cut else
                  cr._plan_axis_first(first.tobytes(), ntaps, n_in, outer, inner, isz, n_sm,
                                      vec4, fused))
        cands = [p for _, p in (ranked[:3] if args.cut else ranked)] + [None]
        times, ref = [], None
        for p in cands:
            with _forced(cr, p):
                y = run()
                if ref is None:
                    if not torch.equal(y, plain()):
                        raise SystemExit(f"{name}: kernel != plain version")
                    ref = y
                elif not torch.equal(y, ref):
                    raise SystemExit(f"{name} {p}: differs from the first candidate")
                times.append((_device_ms(run, iters, flush), p))
        times.sort(key=lambda tp: tp[0])
        rank = next(i for i, (_, p) in enumerate(times) if p == chosen)
        flagged = [ms for ms, _ in times if ms < bound]
        below += len(flagged)

        def row(ms, p):
            return {"ms": ms, **(p._asdict() if p is not None else {"unstaged": True})}

        staged = min(ms for ms, p in times if p is not None)
        unstaged = next(ms for ms, p in times if p is None)
        print(json.dumps({"case": name, "card": card, "view": [outer, n_in, inner],
                          "itemsize": isz, "taps": ntaps, "fused": fused,
                          "bytes": int(nbytes), "bound_ms": bound,
                          "candidates": len(times), "plan": row(*times[rank]),
                          "plan_rank": rank, "plan_over_fastest": times[rank][0] / times[0][0],
                          "unstaged_ms": unstaged, "best_staged_ms": staged,
                          "staged_over_unstaged": staged / unstaged,
                          "below_bound": flagged,
                          "fastest": [row(ms, p) for ms, p in times[:args.top]]}), flush=True)
        if args.all:
            with open(args.all, "a") as f:
                f.write(json.dumps({"case": name, "view": [outer, n_in, inner],
                                    "itemsize": isz, "taps": ntaps, "fused": fused,
                                    "all": [row(ms, p) for ms, p in times]}) + "\n")
        del x3, ref, y
        torch.cuda.empty_cache()
    if below:
        raise SystemExit(f"sweep_axis_plans: {below} reading(s) below the bytes bound")


if __name__ == "__main__":
    main()

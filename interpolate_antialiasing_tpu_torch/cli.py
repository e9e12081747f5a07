"""Command line of the port, the JAX package's CLI with PyTorch inside:

    python -m interpolate_antialiasing_tpu_torch.cli --mode bilinear --bench
    python -m interpolate_antialiasing_tpu_torch.cli --device cpu --inspect

The JAX CLI's flags, names and choices, and ``--device`` (default ``cuda``):
accuracy against Pillow or a dense float64 oracle (default), ``--bench``
(one JSON row per size), ``--profile`` (a torch.profiler trace),
``--backward`` (the VJP against finite differences and the adjoint
identity), ``--inspect`` (``utils.inspect.kernel_report``: runs nothing,
needs no device) and ``--dump-hlo FILE`` (``utils.inspect.compiled_text``:
the kernels, ``ptxas -v`` lines and SASS of the call on the card).

Every branch that runs a resize runs it on ``--device``; without a card it
raises unless ``--device cpu`` is given.  On the card the times are device
times and a kernel that fails to build or launch fails the run; on the CPU
they are host-clock times of the kernels' plain versions, and say so.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from .ops.resize import _BACKENDS

# Reference's size sweep (test.py:15-21); original image is 906x438.
SIZES = [(320, 196), (460, 220), (120, 96), (1200, 196), (120, 1200)]

# Every registered resample mode.  Modes with a Pillow analogue check
# against PIL; the rest (area / nearest_legacy / bicubic075 / lanczos5)
# check against the dense float64 route.
MODES = [
    "bilinear", "linear", "triangle", "nearest", "box", "bicubic", "cubic",
    "bicubic075", "lanczos3", "lanczos5", "hamming", "area",
    "nearest_legacy", "pil_nearest",
]
_PIL_MODES = {"bilinear", "linear", "triangle", "nearest", "box", "bicubic",
              "cubic", "lanczos3", "hamming", "pil_nearest"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("interpolate_antialiasing_tpu_torch")
    p.add_argument("--mode", default="bilinear", choices=MODES)
    p.add_argument("--size", nargs=2, type=int, default=None,
                   metavar=("W", "H"), help="output size (PIL order: W H)")
    p.add_argument("--backend", default="auto", choices=list(_BACKENDS),
                   help="pallas: the hand-written CUDA kernels (auto picks them too)")
    p.add_argument("--device", default="cuda",
                   help="where the resizes run (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--bench", action="store_true", help="run the benchmark table")
    p.add_argument("--profile", action="store_true", help="write a torch.profiler trace")
    p.add_argument("--backward", action="store_true", help="run backward + grad check")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--image", default=None, help="input PNG (default: synthetic 906x438)")
    p.add_argument("--save", default=None, help="save resized PNG here")
    p.add_argument("--debug", action="store_true", help="print kernel dispatch info")
    p.add_argument("--inspect", action="store_true",
                   help="print route / plan / band geometry / cost report (no execution)")
    p.add_argument("--dump-hlo", default=None, metavar="FILE",
                   help="write what the call ran on the card to FILE: its kernels, "
                        "their ptxas -v lines and SASS (the JAX CLI writes optimized HLO)")
    p.add_argument("--precision", default=None, choices=["split", "bf16", "f32"],
                   help="the JAX package's MXU precision dial (sets IA_TPU_PRECISION); "
                        "the port's kernels sum float32 products at every setting, so "
                        "it changes nothing here")
    p.add_argument("--digits", type=int, default=None, choices=[2, 3],
                   help="uint8 accuracy dial: 3 = byte-exact Pillow grid (default), "
                        "2 = pb=14 MaxAbsE<=1 (sets IA_TPU_PIL_DIGITS)")
    return p


def _load_image(path: str | None) -> np.ndarray:
    from .utils.imageio import load_png, synthetic_image

    return load_png(path) if path else synthetic_image()


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: this machine has no CUDA device; "
                           "pass --device cpu to run the resizes on the CPU")
    return dev


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def run_accuracy(args, img, dev) -> list[dict]:
    """MAE/MaxAbsE vs Pillow, or vs the dense float64 route where Pillow has
    no such filter (reference test.py:334-379)."""
    from . import resize
    from .ops.pil_exact import resize_pil_exact
    from .utils.metrics import mae, max_abs_err
    from .utils.oracle import pil_resize

    sizes = [tuple(args.size)] if args.size else SIZES
    x = torch.from_numpy(img).to(dev)
    rows = []
    for w, h in sizes:
        if args.mode == "pil_nearest":
            # PIL's NEAREST point sample is the Pillow pipeline's, not a
            # resample filter (resize() calls torch's rule nearest_legacy)
            y = resize_pil_exact(x, (h, w), method="pil_nearest")
        else:
            y = resize(x, (h, w), method=args.mode, backend=args.backend)
        y = y.cpu().numpy()
        if args.mode in _PIL_MODES:
            ref, oracle = pil_resize(img, (h, w), args.mode), "pillow"
        else:
            o = resize(x.to(torch.float64), (h, w), method=args.mode, backend="dense")
            ref = np.clip(np.floor(o.cpu().numpy() + 0.5), 0, 255).astype(np.uint8)
            oracle = "dense-f64"
        row = {"mode": args.mode, "size": f"{w}x{h}", "oracle": oracle,
               "mae": mae(y, ref), "max_abs_err": max_abs_err(y, ref)}
        print(f"mode={args.mode} size={w}x{h} oracle={oracle} "
              f"MAE={row['mae']:.4f} MaxAbsE={row['max_abs_err']:.1f}")
        rows.append(row)
        if args.save:
            from .utils.imageio import save_png

            save_png(args.save, y)
    return rows


def _timer(dev):
    """Milliseconds per call: CUDA-event device time on the card, host-clock
    time on the CPU."""
    from .utils.timing import time_calls, time_cuda

    if dev.type == "cuda":
        return lambda fn, x: time_cuda(fn, x, iters=10)
    return lambda fn, x: time_calls(fn, x, iters=3, repeats=3).seconds * 1e3


def run_bench(args, img, dev) -> list[dict]:
    """One JSON row per size: Pillow (single thread, host), the float32
    ``dense`` / ``gather`` / ``pallas`` routes of ``resize_plane`` and the
    uint8 Pillow-exact routes (3 and 2 digits) over ``--batch`` copies of the
    image (reference test.py:163-238)."""
    from .ops.pil_exact import resize_pil_exact
    from .ops.resize import resize_plane
    from .utils.oracle import pil_available, pil_resize
    from .utils.timing import device_time_per_call

    sizes = [tuple(args.size)] if args.size else SIZES
    b = args.batch
    x_u8 = torch.from_numpy(np.stack([img] * b)).to(dev)
    xf = x_u8.float()
    timed = _timer(dev)
    device = _card() if dev.type == "cuda" else "cpu"
    rows = []
    for w, h in sizes:
        row = {"size": f"{w}x{h}", "device": device}
        if pil_available():
            t0 = time.perf_counter()
            n = max(1, 20 // b)
            for _ in range(n):
                for _ in range(b):
                    pil_resize(img, (h, w), args.mode)
            row["pil_ms"] = (time.perf_counter() - t0) / (n * b) * 1e3
        else:
            row["pil_ms"], row["pil"] = None, "not installed"
        for backend in ("dense", "gather", "pallas"):
            def fn(t, backend=backend):
                return resize_plane(t, (h, w), 2, 3, mode=args.mode, backend=backend)
            ms = timed(fn, xf)
            row[f"{backend}_ms"] = ms
            row[f"{backend}_Mpix_s"] = b * h * w / (ms * 1e-3) / 1e6
            if backend == "pallas" and dev.type == "cuda":
                row["pallas_device_ms"] = device_time_per_call(fn, xf, iters=10)
        if args.mode in _PIL_MODES and args.mode != "pil_nearest":
            for name, digits in (("pil_exact", 3), ("pil2digit", 2)):
                ms = timed(lambda t, d=digits: resize_pil_exact(
                    t, (h, w), method=args.mode, digits=d), x_u8)
                row[f"{name}_ms"] = ms
                row[f"{name}_Mpix_s"] = b * h * w / (ms * 1e-3) / 1e6
        print(json.dumps(row))
        rows.append(row)
    return rows


def run_profile(args, img, dev) -> str:
    """A torch.profiler trace of 10 calls of the float32 ``resize_plane``,
    written as a Chrome trace under ``IA_TPU_TRACE_DIR`` (default
    ``<tmp>/ia_tpu_trace``), and the device time of each kernel (on the card;
    a trace with no device record is an error there) or the host time of
    each operator (on the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    from .ops.resize import resize_plane

    w, h = tuple(args.size) if args.size else (320, 196)
    xf = torch.from_numpy(np.stack([img] * args.batch)).to(dev, torch.float32)

    def f():
        return resize_plane(xf, (h, w), 2, 3, mode=args.mode, backend=args.backend)

    on_card = dev.type == "cuda"
    f()  # build and plan outside the trace
    if on_card:
        torch.cuda.synchronize(dev)
    trace_dir = os.environ.get("IA_TPU_TRACE_DIR",
                               os.path.join(tempfile.gettempdir(), "ia_tpu_trace"))
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        for _ in range(10):
            f()
        if on_card:
            torch.cuda.synchronize(dev)
    path = os.path.join(trace_dir, f"resize_plane_{args.mode}_{w}x{h}_{dev.type}.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path} (chrome://tracing or ui.perfetto.dev)")
    if on_card:
        kernels: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = kernels.get(e.name, (0, 0.0))
                kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if not kernels:
            raise RuntimeError("the profiler saw no device record of the 10 calls")
        print(f"{'device us':>12} {'launches':>9}  kernel")
        for name, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
            print(f"{us:12.3f} {n:9d}  {name}")
    else:
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))
    return path


def run_backward(args, img, dev) -> dict:
    """Backward smoke + finite-difference check (reference test.py:387-401):
    the float32 ``resize_plane`` of a ``[1, 3, 128, 160] / 255`` crop, its
    VJP against central differences (atol = rtol = 5e-2, the JAX CLI's
    ``check_grads``) and the adjoint identity <A x, u> = <x, A^T u> to 1e-4
    relative.  Returns the launch counts of the forward and of the adjoint
    (0 on the CPU, which runs the plain versions)."""
    from .ops.resize import resize_plane
    from .utils.inspect import launch_counts

    w, h = tuple(args.size) if args.size else (64, 48)
    # [0,1] scale: finite differences in f32 are ill-conditioned on 0..255
    # magnitudes (the reference ran gradcheck in f64 for the same reason)
    x = torch.from_numpy(img[:, :128, :160].copy()).to(dev, torch.float32)[None] / 255.0

    def f(t):
        return resize_plane(t, (h, w), 2, 3, mode=args.mode, backend=args.backend)

    before = launch_counts()
    xg = x.clone().requires_grad_()
    y = f(xg)
    mid = launch_counts()
    g = torch.Generator().manual_seed(0)
    u = torch.randn(y.shape, generator=g).to(dev)
    v = torch.randn(x.shape, generator=g).to(dev)
    (gx,) = torch.autograd.grad(y, xg, u)
    after = launch_counts()
    print(f"backward smoke: out {tuple(y.shape)} grad {tuple(gx.shape)} "
          f"grad-mean {float(gx.mean()):.6f}")
    eps = 1e-3
    with torch.no_grad():
        fd = (f(x + eps * v) - f(x - eps * v)) / (2 * eps)
    lhs = float((u.double() * fd.double()).sum())  # <u, J v> by differences
    rhs = float((gx.double() * v.double()).sum())  # <J^T u, v> by the adjoint
    if abs(lhs - rhs) > 5e-2 + 5e-2 * abs(rhs):
        raise RuntimeError(f"finite-difference check failed: <u, Jv> {lhs} vs "
                           f"<J^T u, v> {rhs}")
    ax_u = float((y.detach().double() * u.double()).sum())
    x_atu = float((x.double() * gx.double()).sum())
    if abs(ax_u - x_atu) > 1e-4 * max(abs(ax_u), abs(x_atu)):
        raise RuntimeError(f"adjoint identity failed: <Ax, u> {ax_u} vs <x, A^T u> {x_atu}")
    print("finite-difference check passed")
    return {"forward_launches": {k: mid[k] - before[k] for k in mid if mid[k] > before[k]},
            "adjoint_launches": {k: after[k] - mid[k] for k in mid if after[k] > mid[k]},
            "fd": lhs, "vjp": rhs, "adjoint_lhs": ax_u, "adjoint_rhs": x_atu}


def run_inspect(args, img):
    """Route / plan / cost report (no execution) and, with ``--dump-hlo``,
    what the call ran on the card."""
    from .utils.inspect import compiled_text, kernel_report

    w, h = tuple(args.size) if args.size else (320, 196)
    shape = (args.batch, *img.shape)
    # plans for the card where the call would run on one (its SM count where
    # there is one, else the H100's, which the report then says it assumed)
    on_card = torch.device(args.device).type == "cuda"
    rep = kernel_report(shape, (h, w), mode=args.mode, backend=args.backend,
                        device=None if on_card else args.device)
    print(rep)
    if args.dump_hlo:
        from .ops.resize import resize

        if not torch.cuda.is_available():
            raise RuntimeError("--dump-hlo shows what ran on a CUDA card; this machine "
                               "has none (--inspect needs no device)")
        x = torch.from_numpy(np.stack([img] * args.batch)).to(_device(args))
        txt = compiled_text(
            lambda t: resize(t, (h, w), method=args.mode, backend=args.backend), x)
        with open(args.dump_hlo, "w") as f:
            f.write(txt)
        print(f"kernels, ptxas lines and SASS ({len(txt)} chars) written to {args.dump_hlo}")
    return rep


def main(argv=None):
    """Run the CLI on ``argv``; returns what the branch measured (the
    report, the rows, the trace path or the gradient check)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.debug:
        os.environ["IA_TPU_DEBUG"] = "1"
    if args.precision:
        os.environ["IA_TPU_PRECISION"] = args.precision
    if args.digits:
        os.environ["IA_TPU_PIL_DIGITS"] = str(args.digits)
    img = _load_image(args.image)
    if args.backend == "pil_exact" and (args.profile or args.backward or args.bench):
        parser.error(
            "--backend pil_exact supports the accuracy run and --dump-hlo only "
            "(it is a uint8 oracle pipeline, not a float kernel backend)"
        )
    if args.inspect or args.dump_hlo:
        return run_inspect(args, img)
    dev = _device(args)
    if args.bench:
        return run_bench(args, img, dev)
    if args.profile:
        return run_profile(args, img, dev)
    if args.backward:
        return run_backward(args, img, dev)
    return run_accuracy(args, img, dev)


if __name__ == "__main__":
    main()

"""Device time of whole windowed crop calls for one checkout of the port,
read with this checkout's timer (``utils/timing.device_time_per_call``,
which requires every kernel record of every call).

    python3 tools/time_crop_calls.py [--root DIR] [--label NAME] [--iters N]

``--root`` is the root of the checkout whose ``interpolate_antialiasing_tpu_torch``
is imported (default: this one); the timer is this checkout's, loaded
into the other's package, so two commits are read by the same clock.  To
compare them on one card, unpack the other with ``git archive`` into a
git-ignored directory and run, in one command,

    for r in OLD . . OLD; do python3 tools/time_crop_calls.py --root $r; done

Readings (ms of device time per call, every kernel of the call, and per
call of the table kernel and of the two crop passes, and per launch of
each pass alone, integer variant; the host's microseconds to check, plan
and enqueue a call, ``host_us``, the least of five means of 20 calls (what
other work on the host adds only raises it); and, where the checkout has
it, an empty kernel's launch at the table kernel's grid,
``launch_floor_ms``, a reference point beside the table kernel's bytes
bound): ``crop_and_resize`` on the whole crop calls that
``chip_smoke.time_train_kernels`` times, with this checkout's shapes and
boxes from ``chip_smoke.py``: the train shape (``TRAIN_B64``,
benchmarks/run_all.py's boxes, within the image), the RandomResizedCrop
of 4K frames (``CROP_4K``, max_box_frac from ``box_fracs``), and, where
the checkout serves boxes wider than the image, the train shape with
zoom-out boxes (``_zoom_out_boxes``: rows past the tables' tap bound).
A checkout that does not serve them is not asked: its table kernel traps
on such a box and leaves the process without a card.  Prints one JSON
line with the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    """The module at ``path`` of this checkout under ``name`` (its imports of
    the package resolve in the root's)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import interpolate_antialiasing_tpu_torch as iat
    from interpolate_antialiasing_tpu_torch.ops import crop_cuda as cc
    from interpolate_antialiasing_tpu_torch.ops.crop import box_fracs, sample_boxes

    if not torch.cuda.is_available():
        raise SystemExit("time_crop_calls: needs a CUDA card")
    # this checkout's timer inside the root's package (its relative imports
    # resolve there), and this checkout's cases
    timer = _load("interpolate_antialiasing_tpu_torch.utils._timer",
                  HERE / "interpolate_antialiasing_tpu_torch" / "utils" / "timing.py")
    smoke = _load("_chip_smoke", HERE / "chip_smoke.py")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(83)
    serves_wide = hasattr(cc, "_row_weights")
    (b64, size), (k4, _) = smoke.TRAIN_B64, smoke.CROP_4K
    cases = [("b64", b64, smoke._run_all_boxes(b64[0]), 1.0),
             ("4k rrc", k4, sample_boxes(torch.Generator().manual_seed(1), k4[0], *k4[2:]),
              box_fracs(*k4[2:]))]
    if serves_wide:
        cases.append(("b64 zoom-out", b64, smoke._zoom_out_boxes(b64[0]), 1.0))
    out = {"root": args.root, "label": args.label or args.root, "card": card.strip(),
           "serves_zoom_out": serves_wide}
    for name, shape, boxes, frac in cases:
        x = (torch.rand(shape, device=dev, generator=g) * 255).to(torch.uint8)
        b = torch.as_tensor(boxes, dtype=torch.float32).to(dev)

        def call():
            return iat.crop_and_resize(x, b, size, max_box_frac=frac)

        out[name] = {
            "call_ms": timer.device_time_per_call(call, iters=args.iters),
            "crop_tables_ms": timer.device_time_per_call(call, iters=args.iters,
                                                         match="crop_tables_kernel"),
            "crop_passes_ms": 2 * timer.device_time_per_call(call, iters=args.iters,
                                                             match="resample_axis_kernel"),
            "host_us": min(timer.host_us(call, iters=20) for _ in range(5)),
        }
        if hasattr(cc, "_table_plan"):  # a checkout with the group-per-row kernel
            axes = tuple(a for a, _ in cc._table_geometry(shape[2], shape[3], *size,
                                                          "bilinear", True, cc._fracs(frac),
                                                          "pil_int8"))
            plan = cc._table_plan(axes, shape[0], torch.cuda.get_device_properties(dev)
                                  .multi_processor_count)
            blocks = sum(cc._table_blocks(shape[0], axes, plan))
            out[name]["table_grid"] = [blocks, cc._TABLE_THREADS, plan]
            out[name]["launch_floor_ms"] = timer.launch_floor_ms(blocks, cc._TABLE_THREADS,
                                                                 iters=args.iters)
        # each pass alone (default precision), launched as the call launches it
        tab_h, tab_w, pb_h, pb_w = cc._windowed_tables(x, b, size, "bilinear", True, frac,
                                                       "pil_int8")
        N, C, H, W = shape
        inter = torch.empty((N, C, size[0], W), dtype=torch.uint8, device=dev)
        y = torch.empty((N, C, *size), dtype=torch.uint8, device=dev)
        for key, run in (
                ("h_pass_ms", lambda: cc._launch(x, inter, tab_h, N, C, H, W, size[0], pb_h)),
                ("w_pass_ms", lambda: cc._launch(inter, y, tab_w, N, C * size[0], W, 1,
                                                 size[1], pb_w))):
            out[name][key] = timer.device_time_per_call(run, iters=args.iters,
                                                        match="resample_axis_kernel")
        del x
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

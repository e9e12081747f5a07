"""Device time of the windowed crop's table kernel (``csrc/crop_tables.cu``)
under every plan: one thread per row, and G = 8, 16 and 32 lanes per row,
beside the plan's own choice (``crop_cuda._table_plan``), alone and inside
the crop call, with an empty kernel's launch at each grid.

    python3 tools/sweep_table_lanes.py [--iters N]

Cases, with this checkout's shapes and boxes from ``chip_smoke.py``: the
train batch (``TRAIN_B64``, benchmarks/run_all.py's boxes), its first 8
images, the same batch with zoom-out boxes (``_zoom_out_boxes``), the
RandomResizedCrop of 4K frames (``CROP_4K``), and 64 such frames.  They
put a train batch's narrow rows (10 and 15 taps) and 4K's wide ones (26
and 41) each on a grid that fills the card one thread per row and on one
that does not.  For each case and plan (forced on both axes), the integer
tables are held to the plain build bit for bit on the card, then timed in
ms of device time (torch.profiler's kernel records,
``utils/timing.device_time_per_call``): ``ms`` per launch back to back,
``in_call_ms`` per launch inside ``crop_and_resize`` (after the previous
call's crop passes) and ``call_ms`` the whole call, with the launch's
blocks and the device time of an empty kernel at the same grid
(``launch_floor_ms``).  Prints one JSON line with the card's name and
power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    import chip_smoke as smoke
    import interpolate_antialiasing_tpu_torch as iat
    from interpolate_antialiasing_tpu_torch.ops import crop_cuda as cc
    from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
    from interpolate_antialiasing_tpu_torch.ops.crop import box_fracs, sample_boxes
    from interpolate_antialiasing_tpu_torch.utils.timing import (device_time_per_call,
                                                                launch_floor_ms)

    if not torch.cuda.is_available():
        raise SystemExit("sweep_table_lanes: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(83)
    (b64, size), (k4, size4k) = smoke.TRAIN_B64, smoke.CROP_4K
    k64 = (64, *k4[1:])

    def rrc(n):
        return sample_boxes(torch.Generator().manual_seed(1), n, *k4[2:]).numpy()

    cases = [("b64", b64, size, smoke._run_all_boxes(b64[0]), 1.0),
             ("b8", (8, *b64[1:]), size, smoke._run_all_boxes(b64[0])[:8], 1.0),
             ("b64 zoom-out", b64, size, smoke._zoom_out_boxes(b64[0]), 1.0),
             ("4k rrc", k4, size4k, rrc(k4[0]), box_fracs(*k4[2:])),
             ("4k b64 rrc", k64, size4k, rrc(k64[0]), box_fracs(*k4[2:]))]
    out = {"card": card.strip(), "threads": cc._TABLE_THREADS,
           "n_sm": cr._n_sm(dev)}
    real = cc._table_plan
    for name, shape, ohw, boxes, frac in cases:
        N = shape[0]
        b = torch.as_tensor(np.asarray(boxes, np.float32)).to(dev).contiguous()
        axes = tuple(a for a, _ in cc._table_geometry(shape[2], shape[3], *ohw, "bilinear",
                                                      True, cc._fracs(frac), "pil_int8"))
        want = cc._windowed_tables_plain(b, "bilinear", True, axes)
        x = (torch.rand(shape, device=dev, generator=g) * 255).to(torch.uint8)
        own = real(axes, N, cr._n_sm(dev))
        rows = {}
        for lanes in (None, 1, *cc._TABLE_LANES):
            plan = own if lanes is None else (lanes, lanes)
            cc._table_plan = lambda *_, p=plan: p
            try:
                got = cc._windowed_tables_cuda(b, "bilinear", True, axes)
                for gt, w in zip(got, want):
                    for u, v in zip(gt, w):
                        if not torch.equal(u, v):
                            raise SystemExit(f"sweep_table_lanes {name} G={plan}: "
                                             "kernel != plain")
                blocks = sum(cc._table_blocks(N, axes, plan))

                def call():
                    return iat.crop_and_resize(x, b, ohw, max_box_frac=frac)

                rows["plan" if lanes is None else f"G={lanes}"] = {
                    "lanes": list(plan), "blocks": blocks,
                    "ms": device_time_per_call(
                        lambda: cc._windowed_tables_cuda(b, "bilinear", True, axes),
                        iters=args.iters, match="crop_tables_kernel"),
                    "in_call_ms": device_time_per_call(call, iters=args.iters,
                                                       match="crop_tables_kernel"),
                    "call_ms": device_time_per_call(call, iters=args.iters),
                    "launch_floor_ms": launch_floor_ms(blocks, cc._TABLE_THREADS,
                                                       iters=args.iters)}
            finally:
                cc._table_plan = real
        out[name] = {"shape": list(shape), "size": list(ohw), "span": [a.span for a in axes],
                     "tap_bound": [a.T for a in axes], "window": [a.k for a in axes], **rows}
        del x
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

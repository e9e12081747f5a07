"""``VideoDownscaler`` (bfloat16 frames, float32 tables and sums, one
rounding to bfloat16: kernel A on the card, its plain version on the CPU)
against the float64 reference of the benchmark's video cell
(``perfbench/reference/video.py``), under that cell's ``bf16_ulps``
limits; the cell's two controls read over a limit; and the reference
against aten's antialiased bilinear, which implements the same
definition."""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from interpolate_antialiasing_tpu_torch.models import VideoDownscaler
from perfbench.checks import bf16_ulps
from perfbench.entries import video_downscale
from perfbench.reference import video

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench/configs/video_uhd_hd_bf16.json").read_text())
LIMITS = json.loads((ROOT / "perfbench/traffic/video_bf16.b64.json").read_text())["check"]["limits"]

# an exact 2x, the small cut of the benchmark's cell, a tenth of the cell's frame
CASES = {"2x": ((2, 3, 64, 96), (32, 48)), "cut": ((2, 3, 60, 124), (28, 28)),
         "tenth": ((1, 3, 216, 384), (108, 192))}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _frames(shape, seed, device="cpu"):
    """The cell's frames: 8-bit levels / 255 in float32, rounded once to
    bfloat16."""
    g = torch.Generator(device=device).manual_seed(seed)
    levels = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8, device=device)
    return (levels.to(torch.float32) / 255).to(torch.bfloat16)


def _within(reading):
    return all(reading[k] <= LIMITS[k] for k in bf16_ulps.NUMBERS)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_video_downscaler_is_within_the_cells_limits(case, seed):
    shape, ohw = CASES[case]
    x = _frames(shape, seed)
    y = VideoDownscaler(ohw)(x)
    reading = bf16_ulps.compare(y, video.downscale(x, *ohw))
    assert _within(reading), reading


# the small cut's controls are read by the benchmark's own control test
@pytest.mark.parametrize("case", ["2x", "tenth"])
def test_each_control_of_the_cell_reads_over_a_limit(case):
    shape, ohw = CASES[case]
    config = dict(CONFIG, image={"shape": list(shape[1:]), "dtype": "bfloat16"},
                  constructor=dict(CONFIG["constructor"], size=list(ohw)))
    entry = video_downscale.make(config, {"batch": shape[0], "pool": 1}, 11, "cpu")
    ref = entry.reference(0)
    assert _within(bf16_ulps.compare(entry.call(0), ref))
    controls = entry.controls()
    assert sorted(controls) == ["bf16_intermediate", "bf16_weights"]
    for name, fn in controls.items():
        reading = bf16_ulps.compare(fn(0), ref)
        assert not _within(reading), (name, reading)


@pytest.mark.parametrize("shape,ohw", [((2, 3, 64, 96), (32, 48)), ((2, 3, 60, 124), (28, 28)),
                                       ((1, 2, 37, 53), (11, 50)), ((1, 1, 10, 12), (30, 7))])
def test_the_reference_is_atens_antialiased_bilinear(shape, ohw):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    want = F.interpolate(x, ohw, mode="bilinear", antialias=True)
    assert float((video.downscale(x, *ohw) - want).abs().max()) <= 1e-12


@pytest.mark.cuda
def test_the_cells_frames_on_the_card():
    """Four of the cell's frames, 2160 x 3840 -> 1080 x 1920, through kernel
    A, against the reference computed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr

    x = _frames((4, 3, 2160, 3840), 2**31 + 19, "cuda")
    before = cr.launches_2d
    y = VideoDownscaler((1080, 1920))(x)
    assert cr.launches_2d == before + 1
    reading = bf16_ulps.compare(y, video.downscale(x, 1080, 1920))
    assert _within(reading), reading

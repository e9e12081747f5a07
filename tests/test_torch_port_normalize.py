"""The pipelines' normalisation route (``ops/normalize.py``) on the CPU: the
plain expression against the pipelines' own expression, the arguments a
card call hands ``native.launch`` (a fake library, as in
tests/test_torch_port_axis.py), what the card route casts before or after
the kernel and what it refuses, and the address arithmetic of
``csrc/normalize.cu``'s uint8 loads.  The kernel itself runs on the card
only: tests/test_torch_port_cuda.py (``-k normalize``) and
``chip_smoke.py``'s ``check_normalize_kernel``."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from interpolate_antialiasing_tpu_torch import native
from interpolate_antialiasing_tpu_torch.models import ImageNetEvalPipeline, ImageNetTrainPipeline
from interpolate_antialiasing_tpu_torch.ops import normalize as nz

F32, BF16, U8 = torch.float32, torch.bfloat16, torch.uint8
MEAN = torch.tensor([0.485, 0.456, 0.406, 0.5], dtype=F32)
STD = torch.tensor([0.229, 0.224, 0.225, 0.25], dtype=F32)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stats(C):
    return MEAN[:C].reshape(1, C, 1, 1).clone(), STD[:C].reshape(1, C, 1, 1).clone()


def _levels(shape, dtype=U8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, shape, generator=g, dtype=torch.int32).to(U8)
    return x if dtype == U8 else (x.float() + torch.rand(shape, generator=g) - 0.5).to(dtype)


def _expression(y, mean, std, dtype):
    """The pipelines' normalisation as ``models/preprocess.py`` wrote it
    before it had a route of its own."""
    y = y.to(torch.float32) * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    return ((y - mean.to(y.device)) / std.to(y.device)).to(dtype)


def _eval_view(x):
    """The eval pipeline's centre crop of a Resize(26) output: rows of 55
    (odd) from column 16, 22 x 22."""
    return x[..., 2:24, 16:38]


# (name, input, output dtype): what the kernel takes
TAKEN = {
    "u8 contiguous": (lambda: _levels((2, 3, 22, 22)), F32),
    "u8 eval view": (lambda: _eval_view(_levels((2, 3, 26, 55))), F32),
    "u8 bf16 out": (lambda: _levels((2, 3, 9, 12)), BF16),
    "f32 in": (lambda: _levels((2, 3, 9, 12), F32), F32),
    "f32 eval view bf16 out": (lambda: _eval_view(_levels((1, 3, 26, 55), F32)), BF16),
    "c1": (lambda: _levels((3, 1, 5, 7)), F32),
    "c4 width 5": (lambda: _levels((2, 4, 3, 5)), F32),
    "width 1": (lambda: _levels((2, 3, 4, 1)), F32),
    "width 261 view, two passes": (lambda: _levels((1, 2, 3, 270))[..., 5:266], BF16),
    "width 300 f32, two passes": (lambda: _levels((1, 2, 3, 300), F32), F32),
    "empty batch": (lambda: _levels((0, 3, 4, 8)), F32),
    "misaligned base": (lambda: _levels((2, 3, 6, 17)).flatten()[3:3 + 2 * 3 * 6 * 13].reshape(
        2, 3, 6, 13), F32),
}


@pytest.mark.parametrize("dtype", [F32, BF16, torch.float16, torch.float64])
@pytest.mark.parametrize("name", sorted(TAKEN))
def test_the_plain_twin_is_the_pipelines_expression(name, dtype):
    y = TAKEN[name][0]()
    mean, std = _stats(y.shape[1])
    got = nz._normalize_plain(y, mean, std, dtype)
    assert got.dtype == dtype and torch.equal(got, _expression(y, mean, std, dtype))


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.fixture()
def fake_lib(monkeypatch):
    """``native.build`` gives a library that records its calls, the device
    context does nothing and the stream handle is 7: a launch runs without
    a card, its counts from 0."""
    lib = _FakeLib()
    monkeypatch.setattr(native, "build", lambda: lib)
    monkeypatch.setattr(native, "stream", lambda dev: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(native, "launches", dict.fromkeys(native.KERNELS, 0))
    return lib


@pytest.mark.parametrize("name", sorted(TAKEN))
def test_a_kernel_call_hands_the_launch_its_strides_pointers_and_dtypes(fake_lib, name):
    y, dtype = TAKEN[name][0](), TAKEN[name][1]
    mean, std = _stats(y.shape[1])
    out = nz._normalize_cuda(y, mean, std, dtype)
    assert out.shape == y.shape and out.dtype == dtype and out.is_contiguous()
    N, C, H, W = y.shape
    if out.numel() == 0:
        assert fake_lib.calls == [] and native.launches["normalize"] == 0
        return
    blocks = -(-N * C * H // 8)  # one warp per row
    assert fake_lib.calls == [("ia_normalize", (
        y.data_ptr(), out.data_ptr(), native.DTYPES[y.dtype], native.DTYPES[dtype], N, C, H, W,
        *y.stride()[:3], mean.data_ptr(), std.data_ptr(), nz._SCALE, blocks, 7))]
    argtypes = native._SIGNATURES["ia_normalize"][1]
    assert len(argtypes) == len(fake_lib.calls[0][1]) and argtypes[-3] is ctypes.c_float
    assert native.launches == dict(dict.fromkeys(native.KERNELS, 0), normalize=1)


def test_the_eval_view_reaches_the_launch_at_its_offset(fake_lib):
    """The centre crop's first element lies 2 rows and 16 columns into the
    resized batch, whose rows are 55 wide: the kernel gets that address and
    the batch's strides, not a copy."""
    x = _levels((2, 3, 26, 55))
    nz._normalize_cuda(_eval_view(x), *_stats(3), F32)
    args = fake_lib.calls[0][1]
    assert args[0] == x.data_ptr() + 2 * 55 + 16 and args[8:11] == (3 * 26 * 55, 26 * 55, 55)


def test_the_kernels_scale_is_the_plain_expressions_float32():
    assert nz._SCALE == float(np.float32(1.0 / 255.0))
    assert ctypes.c_float(nz._SCALE).value == nz._SCALE


@pytest.mark.parametrize("dtype", [F32, BF16, torch.float16])
def test_on_the_cpu_the_route_runs_the_plain_expression(fake_lib, dtype):
    y = _eval_view(_levels((2, 3, 26, 55)))
    mean, std = _stats(3)
    assert torch.equal(nz.normalize(y, mean, std, dtype), _expression(y, mean, std, dtype))
    assert fake_lib.calls == [] and native.launches["normalize"] == 0


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_pipelines_normalise_as_before_on_the_cpu(dtype):
    x = _levels((2, 3, 44, 90), seed=3)
    pipe = ImageNetEvalPipeline(size=(22, 22), short_side=26, dtype=dtype)
    r = pipe._resize(x, (26, 53))[..., 2:24, 16:38]
    assert torch.equal(pipe(x), _expression(r, pipe.mean, pipe.std, dtype))
    train = ImageNetTrainPipeline(size=(28, 28), dtype=dtype)
    boxes, flip = torch.tensor([[0.1, 0.05, 0.9, 0.8], [0.0, 0.2, 1.0, 0.7]]), None
    from interpolate_antialiasing_tpu_torch.ops.crop import box_fracs, crop_and_resize

    c = crop_and_resize(x, boxes, (28, 28), max_box_frac=box_fracs(44, 90, train.scale,
                                                                   train.ratio))
    assert torch.equal(train.apply(x, boxes, flip), _expression(c, train.mean, train.std, dtype))


def _cast_cases():
    y = _levels((2, 3, 8, 12))
    return {  # (input, output dtype, dtype the kernel reads, dtype it writes)
        "f16 out": (y, torch.float16, U8, F32),
        "f64 out": (y, torch.float64, U8, F32),
        "f64 in": (y.double(), F32, F32, F32),
        "f16 in": (y.half(), BF16, F32, BF16),
        "bf16 in": (y.to(BF16), F32, F32, F32),
        "last axis strided": (_levels((2, 3, 8, 24))[..., ::2], F32, U8, F32),
        "channels last": (y.to(memory_format=torch.channels_last), BF16, U8, BF16),
    }


@pytest.mark.parametrize("name", sorted(_cast_cases()))
def test_the_card_route_casts_what_the_kernel_does_not_take(fake_lib, name):
    """The plain expression's own casts, around one launch: an input that
    is neither uint8 nor float32 is cast to float32 first, one whose last
    axis is not unit-stride is made contiguous, and an output that is
    neither float32 nor bfloat16 is written as float32 and then cast."""
    y, dtype, read, written = _cast_cases()[name]
    out = nz._normalize_cuda(y, *_stats(3), dtype)
    assert out.shape == y.shape and out.dtype == dtype and out.is_contiguous()
    (entry, args), = fake_lib.calls
    assert entry == "ia_normalize" and args[2:4] == (native.DTYPES[read], native.DTYPES[written])
    assert args[8:11] == torch.empty(y.shape).stride()[:3]
    assert native.launches["normalize"] == 1


def _refused():
    y = _levels((2, 3, 8, 12))
    m, s = _stats(3)
    return {
        "3-D": (y[0], m, s, r"\[N, C, H, W\]"),
        "mean of 2": (y, m[:, :2], s, "per channel"),
        "scalar std": (y, m, s[:, :1], "per channel"),
        "mean over W": (y, m.reshape(3), s, "per channel"),
        "f64 mean": (y, m.double(), s, "per channel"),
        "input records a gradient": (_levels((2, 3, 8, 12), F32).requires_grad_(), m, s,
                                     "no backward"),
        "mean records a gradient": (y, m.clone().requires_grad_(), s, "no backward"),
    }


@pytest.mark.parametrize("name", sorted(_refused()))
def test_the_card_route_refuses_what_no_pipeline_sends(fake_lib, name):
    y, m, s, why = _refused()[name]
    with pytest.raises(ValueError, match=why):
        nz._normalize_cuda(y, m, s, F32)
    assert fake_lib.calls == [] and native.launches["normalize"] == 0


def test_without_grad_mode_a_recorded_input_is_taken(fake_lib):
    y = _levels((2, 3, 8, 12), F32).requires_grad_()
    with torch.no_grad():
        nz._normalize_cuda(y, *_stats(3), F32)
    assert native.launches["normalize"] == 1


def test_a_strided_mean_reaches_the_kernel_contiguous(fake_lib):
    """One value broadcast to the three channels is one value per channel:
    the kernel gets a contiguous copy of it."""
    y = _levels((2, 3, 8, 12))
    m, s = _stats(3)
    m = m[:, :1].expand(1, 3, 1, 1)
    nz._normalize_cuda(y, m, s, F32)
    (_, args), = fake_lib.calls
    assert args[11] != m.data_ptr() and args[12] == s.data_ptr()


def _funnel_r(lo: int, hi: int, shift: int) -> int:
    """``__funnelshift_r(lo, hi, shift)``: the low 32 bits of hi:lo >> shift."""
    return ((hi << 32 | lo) >> (shift & 31)) & 0xFFFFFFFF


@pytest.mark.parametrize("a", range(8))
def test_each_word_a_uint8_group_reads_holds_a_byte_of_it(a):
    """``load`` of 8 uint8 at byte address ``a`` in csrc/normalize.cu: one
    8-byte load where a % 8 == 0, two words where a % 4 == 0, else the three
    aligned words from a - a % 4 joined by funnel shifts.  Every load is
    aligned and holds a byte of [a, a + 8), so with allocations aligned to 4
    bytes no view reads outside its storage; the joined words hold the
    group's bytes in order (little-endian)."""
    mem = bytes(range(1, 25))
    k = a & 3
    if a % 8 == 0:
        loads = [(a, 8)]
    elif k == 0:
        loads = [(a, 4), (a + 4, 4)]
    else:
        loads = [(a - k + 4 * i, 4) for i in range(3)]
    for at, size in loads:
        assert at % size == 0 and at < a + 8 and at + size > a
    if k and a % 8:
        q = [int.from_bytes(mem[at:at + 4], "little") for at, _ in loads]
        w = [_funnel_r(q[0], q[1], 8 * k), _funnel_r(q[1], q[2], 8 * k)]
    else:
        w = [int.from_bytes(mem[a:a + 4], "little"), int.from_bytes(mem[a + 4:a + 8], "little")]
    assert b"".join(x.to_bytes(4, "little") for x in w) == mem[a:a + 8]

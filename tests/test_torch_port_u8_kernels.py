"""Host side of the two uint8 kernels redesigned on kernels A and B: the
Pillow two-pass kernel's plan (kernel A's over Pillow's int32 tables, with
a one-byte intermediate) and its two-pass route where no tile fits, and the
windowed crop's tables trimmed to a static tap bound and its staged windows.

These run on the CPU: the plans and tables are host or plain-PyTorch code,
and each bound the kernels trap on (a tap outside a staged window) is
checked here over extreme inputs, not merely observed on the card.  The
bytes are held to the plain versions, which tests/test_torch_port_pil_exact.py
and tests/test_torch_port_crop.py hold to the JAX package and to Pillow.
"""


import numpy as np
import pytest
import torch

from interpolate_antialiasing_tpu_torch.ops import crop_cuda as cc
from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
from interpolate_antialiasing_tpu_torch.ops import plans
from interpolate_antialiasing_tpu_torch.ops.crop import box_fracs, sample_boxes
from interpolate_antialiasing_tpu_torch.ops.filters import get_filter


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# The Pillow two-pass kernel: kernel A's plan over Pillow's tables
# ---------------------------------------------------------------------------

# (planes, H, W, OH, OW, mode): the bench batch, the 4K -> HD frame, an
# upsample, a heavy lanczos3 downscale, one-row and one-column outputs
PIL_SHAPES = [
    (192, 438, 906, 196, 320, "bilinear"),
    (3, 2160, 3840, 1080, 1920, "bilinear"),
    (2, 31, 72, 90, 150, "bicubic"),
    (2, 600, 700, 20, 30, "lanczos3"),
    (2, 40, 60, 1, 30, "hamming"),
    (2, 40, 60, 20, 1, "box"),
]


@pytest.mark.parametrize("planes,H,W,OH,OW,mode", PIL_SHAPES,
                         ids=[f"{s[1]}x{s[2]}-{s[3]}x{s[4]}-{s[5]}" for s in PIL_SHAPES])
def test_pil_plan_candidates_are_the_kernel_layout_and_hold_every_tap(planes, H, W, OH, OW,
                                                                      mode):
    """Every tile the plan considers: its shared bytes are the kernel's
    layout for one-byte elements and intermediate, within a block's budget,
    and every tap of every output lies in its tile's row window and column
    span (the kernel traps otherwise); the plan is one of them."""
    tw, th = pe._int_tables(W, OW, mode), pe._int_tables(H, OH, mode)
    nw, nh = tw[1].shape[1], th[1].shape[1]
    cands = list(plans._rows_candidates(th[0], nh, H, tw[0], nw, W, 1, planes, plans.H100_SMS,
                                        inter_size=1))
    assert cands
    for _, p in cands:
        assert p.smem == plans._smem_bytes(p.tile_r, p.tile_c, p.rows_cap, p.cols_cap, p.chunk,
                                           nw, nh, 1, 1) <= plans._SMEM_BUDGET
        assert p.blocks == planes * -(-OH // p.tile_r) * -(-OW // p.tile_c)
        for (xmin, wb), n_in, tile, cap in ((th, H, p.tile_r, p.rows_cap),
                                            (tw, W, p.tile_c, p.cols_cap)):
            taps = np.clip(xmin.astype(np.int64)[:, None] + np.arange(wb.shape[1]), 0, n_in - 1)
            for t in range(-(-len(xmin) // tile)):
                rows = taps[t * tile:(t + 1) * tile]
                assert rows.max() - rows.min() + 1 <= cap
    plan = plans.plan_pil_2pass(tw, th, planes, H, W)
    assert plan in [p for _, p in cands]


def test_pil_plan_keeps_the_float_plan_for_four_byte_elements():
    """The plan's rule is kernel A's: with float32 elements and intermediate
    it is the float kernels' plan of the same tables."""
    from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec

    sh, sw = make_axis_spec(438, 196), make_axis_spec(906, 320)
    th, tw = pe._int_tables(438, 196, "bilinear"), pe._int_tables(906, 320, "bilinear")
    want = plans.plan2d(sh, sw, 4, 3, plans.H100_SMS)
    got = plans.plan_rows(th[0], th[1].shape[1], 438, tw[0], tw[1].shape[1], 906, 4, 3,
                          plans.H100_SMS)
    assert got == want


def test_pil_plan_takes_70000_planes_in_one_launch():
    """Kernel A puts every block on gridDim.x: the 65,535-plane chunks of
    the first version are gone; one launch holds 70,000 planes."""
    from interpolate_antialiasing_tpu_torch import native

    tw, th = pe._int_tables(8, 5, "bilinear"), pe._int_tables(8, 4, "bilinear")
    plan = plans.plan_pil_2pass(tw, th, 70000, 8, 8)
    per_plane = -(-4 // plan.tile_r) * -(-5 // plan.tile_c)
    assert plan.blocks == 70000 * per_plane <= native.GRID_LIMIT
    assert native.plane_chunks(70000, native.GRID_LIMIT // per_plane) == [(0, 70000)]


def test_pil_plan_is_none_only_where_no_tile_fits():
    """None exactly where the smallest tile's layout passes the budget."""
    small = pe._int_tables(64, 32, "bilinear")
    for n_in, ok in ((2000, True), (20000, False)):
        th = pe._int_tables(n_in, 10, "lanczos3")
        plan = plans.plan_pil_2pass(small, th, 1, n_in, 64)
        rows = plans.window(th[0], th[1].shape[1], n_in, 1)
        smallest = plans._smem_bytes(1, 16, rows,
                                     plans.window(small[0], small[1].shape[1], 64, 16), 1,
                                     small[1].shape[1], th[1].shape[1], 1, 1)
        assert (plan is not None) == ok == (smallest <= plans._SMEM_BUDGET)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "lanczos3", "box", "hamming"])
@pytest.mark.parametrize("pb", [22, 14])
def test_pil_two_axis_passes_equal_the_two_pass_plain(mode, pb):
    """The route where no tile fits (two pil_resample_axis passes, W then H)
    gives the two-pass kernel's bytes."""
    x3 = torch.from_numpy(_u8((3, 57, 83), 3))
    tw, th = pe._int_tables(83, 31, mode, pb=pb), pe._int_tables(57, 24, mode, pb=pb)
    np.testing.assert_array_equal(pe._resample_2pass_axes(x3, tw, th, pb).numpy(),
                                  pe._resample_2pass_plain(x3, tw, th, pb).numpy())


def test_pil_plan_is_cached_per_table():
    tw, th = pe._int_tables(906, 320, "bilinear"), pe._int_tables(438, 196, "bilinear")
    before = plans._plan_2pass_keyed.cache_info().hits
    plan = plans.plan_pil_2pass(tw, th, 192, 438, 906)
    assert plans.plan_pil_2pass(tw, th, 192, 438, 906) is plan
    assert plans._plan_2pass_keyed.cache_info().hits > before


# ---------------------------------------------------------------------------
# The windowed crop: tables at the tap bound, windows of the static geometry
# ---------------------------------------------------------------------------


def _run_all_boxes(n, seed=0):
    """benchmarks/run_all.py's crop boxes: corners uniform in [0, 0.35) and
    [0.65, 1)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.0, 0.35, (n, 2)), rng.uniform(0.65, 1.0, (n, 2))],
                          axis=1).astype(np.float32)


def _edge_boxes():
    """Full image, each edge touched, sub-pixel boxes in the middle and at
    each corner, one-pixel boxes, thin strips along each axis."""
    return np.array([
        [0.0, 0.0, 1.0, 1.0], [0.0, 0.3, 0.5, 0.7], [0.5, 0.3, 1.0, 0.7],
        [0.3, 0.0, 0.7, 0.5], [0.3, 0.5, 0.7, 1.0], [0.47, 0.55, 0.4701, 0.5502],
        [0.0, 0.0, 1e-4, 1e-4], [0.9999, 0.9999, 1.0, 1.0], [0.0, 0.9999, 1e-4, 1.0],
        [0.2, 0.2, 0.2 + 1 / 64, 0.2 + 1 / 128], [0.0, 0.0, 1.0, 0.01],
        [0.0, 0.0, 0.01, 1.0], [0.6, 0.0, 1.0, 1.0], [0.0, 0.6, 1.0, 1.0],
    ], np.float32)


def _shifted_boxes(n, seed):
    """Boxes no wider than the image that reach past its edges."""
    rng = np.random.default_rng(seed)
    span = rng.uniform(0.05, 1.0, (n, 2))
    lo = rng.uniform(-0.5, 1.0, (n, 2))
    return np.concatenate([lo, lo + span], axis=1).astype(np.float32)


# (name, x shape, (oh, ow), method, max_box_frac, boxes)
def _crop_cases():
    gen = torch.Generator().manual_seed(11)
    yield ("b64 run_all", (64, 1, 438, 906), (224, 224), "bilinear", 1.0, _run_all_boxes(64))
    yield ("rrc draws", (48, 1, 300, 520), (96, 112), "bilinear",
           box_fracs(300, 520), sample_boxes(gen, 48, 300, 520).numpy())
    yield ("rrc small scale", (48, 1, 300, 520), (96, 112), "hamming",
           box_fracs(300, 520, (0.05, 0.2)), sample_boxes(gen, 48, 300, 520, (0.05, 0.2)).numpy())
    for frac in (1.0, 0.45):
        yield (f"edges frac {frac}", (14, 1, 128, 256), (32, 48), "bilinear", frac,
               _edge_boxes())
        yield (f"edges box frac {frac}", (14, 1, 97, 211), (40, 150), "box", frac,
               _edge_boxes())
        yield (f"shifted frac {frac}", (32, 1, 160, 200), (140, 60), "triangle", frac,
               _shifted_boxes(32, 5))
        yield (f"4k-like frac {frac}", (6, 1, 1080, 1920), (224, 224), "bilinear", frac,
               np.concatenate([_edge_boxes()[:3], _run_all_boxes(3, 1)]))


CROP_CASES = list(_crop_cases())


def _tables(name, precision):
    _, shape, ohw, method, frac, boxes = next(c for c in CROP_CASES if c[0] == name)
    x = torch.zeros(shape, dtype=torch.uint8)
    return x, cc._windowed_tables(x, torch.from_numpy(boxes), ohw, method, True, frac,
                                  precision)


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("name", [c[0] for c in CROP_CASES])
def test_crop_every_row_fits_the_tap_bound(name, precision):
    """cnt <= T for every row of both passes: RandomResizedCrop draws,
    run_all's boxes, sub-pixel boxes, boxes touching each edge, boxes past
    the edges, for max_box_frac 1.0 and 0.45 (a box wider than 0.45 renormalises
    over its truncated window)."""
    _, (tab_h, tab_w, _, _) = _tables(name, precision)
    for tab in (tab_h, tab_w):
        T = tab.w.shape[-1]
        assert int(tab.cnt.max()) <= T
        assert not tab.w[torch.arange(T) >= tab.cnt[..., None]].any()  # zero past cnt


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("name", ["b64 run_all", "edges frac 0.45", "shifted frac 1.0"])
def test_crop_trimmed_tables_are_the_first_T_columns(name, precision):
    """The trimmed tables are the first T columns of the window-wide ones,
    and those have nothing but zeros past T; the plain version gives the
    same bytes over both."""
    _, shape, ohw, method, frac, boxes = next(c for c in CROP_CASES if c[0] == name)
    x = torch.from_numpy(_u8(shape, 9))
    N, C, H, W = shape
    support = get_filter(method).support
    _, Hp, k_h, W2, k_w = cc._geom(H, W, *ohw, support, True, frac)
    fh, fw = cc._fracs(frac)
    b = torch.from_numpy(boxes)
    wide = []
    for axis, (lo, hi, n_in, n_out, k, limit, align, f) in enumerate((
            (b[:, 0] * H, b[:, 2] * H, H, ohw[0], k_h, Hp, 32, fh),
            (b[:, 1] * W, b[:, 3] * W, W, ohw[1], k_w, W2, 128, fw))):
        starts, band = cc._windowed_band(lo, hi, n_in, n_out, k, limit, align, method, True)
        pb = cc._digit_plan(limit, n_out, support, True, f)[0]
        if precision == "pil_int8":
            band = cc._digitize_band(band, pb)
        else:
            pb = None
        T = cc._tap_bound(n_in, n_out, support, True, k)
        full = cc._compact(starts, band, n_out, k)
        trim = cc._compact(starts, band, n_out, T)
        assert torch.equal(trim[0], full[0]) and torch.equal(trim[1], full[1])
        assert torch.equal(trim[2], full[2][..., :T])
        assert not full[2][..., T:].any()
        rows = cc._Rows(b, axis, cc._Axis(n_in, n_out, k, limit, align, k, pb), method, True)
        wide.append((cc._Table(*full, (), rows), pb))
    (tab_h, pb_h), (tab_w, pb_w) = wide
    got = cc.crop_and_resize_windowed(x, b, ohw, method=method, max_box_frac=frac,
                                      precision=precision)
    assert torch.equal(got, cc._crop_resample_plain(x, tab_h, tab_w, pb_h, pb_w))


def test_crop_box_wider_than_the_image_matches_jax():
    """A box wider than the image needs more than T taps per row: the
    tables keep each row's true count, and the crop gives the JAX package's
    windowed bytes."""
    import jax.numpy as jnp

    from interpolate_antialiasing_tpu.ops import crop_pallas as jcp

    x = _u8((1, 1, 128, 256), 13)
    boxes = np.array([[-1.0, -1.5, 2.0, 2.5]], np.float32)
    tab_h, tab_w, _, _ = cc._windowed_tables(torch.from_numpy(x), torch.from_numpy(boxes),
                                             (16, 16), "bilinear", True, 0.5, "pil_int8")
    for tab in (tab_h, tab_w):
        assert int(tab.cnt.max()) > tab.w.shape[-1]
    want = np.asarray(jcp.crop_and_resize_windowed(jnp.asarray(x), jnp.asarray(boxes),
                                                   (16, 16), max_box_frac=0.5))
    got = cc.crop_and_resize_windowed(torch.from_numpy(x), torch.from_numpy(boxes), (16, 16),
                                      max_box_frac=0.5)
    assert np.array_equal(got.numpy(), want)


def _tile_windows(first, cnt, n_in, tile_o, win, T):
    """Each tile's first staged row as the crop kernel's block finds it for
    its one-window path: the least first tap of its outputs, clamped to the
    axis, or -1 (the block walks the tile in chunks: :func:`_tile_chunks`)
    where its taps, T from each first tap, span more than ``win`` rows, or
    where one of its rows counts more than T taps (a box wider than the
    image)."""
    N, n_out = first.shape
    n_to = -(-n_out // tile_o)

    def tiles(t):
        return torch.cat([t, t[:, -1:].expand(N, n_to * tile_o - n_out)], dim=1).long().view(
            N, n_to, tile_o)

    f = tiles(first)
    lo = f.clamp(0, n_in - 1).amin(2)
    hi = (f + T - 1).clamp(0, n_in - 1).amax(2)
    wide = (tiles(cnt) > T).any(2)
    return torch.where((hi - lo < win) & ~wide, lo, -1)


def _chunks(first, cnt, n_in, tile_o, win, T):
    """The chunks of one tile past the one-window path, as the crop
    kernel's block walks them (resample_axis.cuh::crop_tile_chunked), for
    its outputs' first taps and true counts: ``[(c0, n, lo, hi, cm)]``, a
    chunk of ``n`` outputs from ``c0`` staging rows ``[lo, hi]`` and
    ``cm`` weights per output, or ``(c0, 1, None, None, cnt)`` for a row
    alone that reads device memory.  From the tile's size, each chunk is
    halved from the last one's until its window (least clamped first tap
    to greatest clamped ``first + max(cnt, 1) - 1``) spans at most ``win``
    rows and its ``n * cm`` weights fit the ``tile_o * (T - 1)`` slots that
    the tile's totals leave."""
    no, slots = len(first), tile_o * (T - 1)
    f, c = np.asarray(first, np.int64), np.asarray(cnt, np.int64)
    lo_t = np.clip(f, 0, n_in - 1)
    hi_t = np.clip(f + np.maximum(c, 1) - 1, 0, n_in - 1)
    out, c0, ch = [], 0, no
    while c0 < no:
        while True:
            n = min(ch, no - c0)
            lo, hi = int(lo_t[c0:c0 + n].min()), int(hi_t[c0:c0 + n].max())
            cm = max(1, int(c[c0:c0 + n].max()))
            fits = hi - lo < win and n * cm <= slots
            if fits or n == 1:
                break
            ch = n // 2
        out.append((c0, n, lo, hi, cm) if fits else (c0, 1, None, None, int(c[c0])))
        c0 += n
    return out


def _tile_chunks(first, cnt, n_in, tile_o, win, T):
    """Every tile of every image as the crop kernel's block serves it:
    ``{(image, tile): chunks}`` (:func:`_chunks`) for the tiles that leave
    the one-window path (:func:`_tile_windows` -1); those that stay are not
    listed."""
    r0 = _tile_windows(first, cnt, n_in, tile_o, win, T)
    out = {}
    for n, t in (r0 < 0).nonzero().tolist():
        o0 = t * tile_o
        out[(n, t)] = _chunks(first[n, o0:o0 + tile_o], cnt[n, o0:o0 + tile_o], n_in, tile_o,
                              win, T)
    return out


def _check_chunks(tab, n_in, tile_o, win):
    """Every staged chunk of every tile that leaves the one-window path
    holds its taps: each output's taps ``clamp(first + k, 0, last)`` for ``k
    < cm`` (``last`` its clamped ``first + max(cnt, 1) - 1``; they equal
    ``clamp(first + k, 0, n_in - 1)`` for ``k < cnt``) lie in the chunk's
    ``hi - lo + 1 <= win`` rows from ``lo``, and its weights fit the
    slots.  Returns the chunked tiles and the rows that read device
    memory."""
    T = tab.w.shape[-1]
    tiles = _tile_chunks(tab.first, tab.cnt, n_in, tile_o, win, T)
    direct = 0
    for (n, t), chunks in tiles.items():
        assert sum(ch[1] for ch in chunks) == min(tile_o, tab.first.shape[1] - t * tile_o)
        for c0, m, lo, hi, cm in chunks:
            o = t * tile_o + c0
            if lo is None:
                direct += 1
                continue
            assert hi - lo < win and m * cm <= tile_o * (T - 1)
            f = tab.first[n, o:o + m].long()
            c = tab.cnt[n, o:o + m].long()
            assert int(c.max()) <= cm
            last = (f + c.clamp(min=1) - 1).clamp(0, n_in - 1)
            k = torch.arange(cm)
            taps = torch.minimum((f[:, None] + k).clamp(min=0), last[:, None])
            assert int(taps.min()) >= lo and int(taps.max()) <= hi
            true = (f[:, None] + k).clamp(0, n_in - 1)
            counted = k < c[:, None]
            assert torch.equal(taps[counted], true[counted])
    return tiles, direct


@pytest.mark.parametrize("name", [c[0] for c in CROP_CASES])
def test_crop_windows_hold_every_tap(name):
    """For every (tile_o, win) the crop plan considers, both passes, with
    each tile's first row as the kernel's block finds it: every tap (first
    + j, j < T, clamped to the axis) of every output of a staged tile lies
    in [r0, r0 + min(win, n_in - r0)); boxes within max_box_frac read no
    tile from device memory.  The plan is one of those tiles."""
    _, shape, ohw, method, frac, boxes = next(c for c in CROP_CASES if c[0] == name)
    _, (tab_h, tab_w, _, _) = _tables(name, "pil_int8")
    N, C, H, W = shape
    b = torch.from_numpy(boxes)

    def within(lo, hi, f):  # every box inside the image and the bound
        return bool(((hi - lo <= f) & (lo >= 0) & (hi <= 1)).all())

    fh, fw = cc._fracs(frac)
    for tab, n_in, n_out, R, inner, inb in (
            (tab_h, H, ohw[0], C, W, within(b[:, 0], b[:, 2], fh)),
            (tab_w, W, ohw[1], C * ohw[0], 1, within(b[:, 1], b[:, 3], fw))):
        T = tab.w.shape[-1]
        taps = (tab.first.long()[..., None] + torch.arange(T)).clamp(0, n_in - 1)
        lo, hi = taps.amin(-1), taps.amax(-1)
        for tile_o, win in tab.wins:
            r0 = _tile_windows(tab.first, tab.cnt, n_in, tile_o, win, T)
            n_to = -(-n_out // tile_o)
            assert r0.shape == (N, n_to)
            r0 = r0.repeat_interleave(tile_o, dim=1)[:, :n_out]
            staged = r0 >= 0
            rows = torch.clamp(n_in - r0, max=win)
            assert bool((lo >= r0)[staged].all()) and bool((hi < r0 + rows)[staged].all())
            if inb:
                assert bool(staged.all()), (tile_o, win)
        plan = cc._crop_plan(tab.wins, n_in, n_out, T, N, R, inner, plans.H100_SMS, True, 1)
        if plan is not None:
            assert (plan.tile_o, plan.win) in tab.wins


def test_crop_boxes_past_the_bound_read_device_memory():
    """A box wider than max_box_frac (it renormalises over its truncated
    window) can need more rows than a tile's window: such tiles leave the
    one-window path (they read device memory until the kernel staged them
    in chunks) and are walked in chunks, each of which stages every tap of
    its outputs; none of their rows reads device memory."""
    _, (tab_h, tab_w, _, _) = _tables("edges frac 0.45", "pil_int8")
    marked = 0
    for tab, n_in in ((tab_h, 128), (tab_w, 256)):
        for tile_o, win in tab.wins:
            if win < n_in:
                marked += int((_tile_windows(tab.first, tab.cnt, n_in, tile_o, win,
                                             tab.w.shape[-1]) < 0).sum())
                tiles, direct = _check_chunks(tab, n_in, tile_o, win)
                assert direct == 0 or tile_o == 1, (tile_o, win)
    assert marked > 0


# boxes wider than the image beside boxes within it (images 1 and 4), at
# the train crop's shape
WIDE_BOXES = [[-0.2, -0.2, 1.2, 1.2], [0.1, 0.2, 0.8, 0.9], [0.0, 0.0, 1.3, 1.0],
              [0.0, 0.0, 1.0, 1.3], [0.05, 0.1, 0.7, 0.95]]


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_tiles_with_wide_rows_stage_in_chunks(precision):
    """Boxes wider than the image beside boxes within it, at the train
    crop's shape: for every (tile_o, win) the crop plan considers, a tile
    that holds a row with more than T taps leaves the one-window path and
    is staged in chunks, each of which holds every tap of its outputs in
    its window and its weights in the tile's slots; the images of boxes
    within the image keep one window per tile; no tile of two outputs or
    more reads device memory (a tile of one output has T - 1 slots, fewer
    than a wide row's taps)."""
    boxes = torch.tensor(WIDE_BOXES)
    N, C, H, W = 5, 1, 438, 906
    x = torch.zeros((N, C, H, W), dtype=torch.uint8)
    tab_h, tab_w, _, _ = cc._windowed_tables(x, boxes, (224, 224), "bilinear", True, 1.0,
                                             precision)
    inside = torch.tensor([False, True, False, False, True])
    for tab, n_in, n_out in ((tab_h, H, 224), (tab_w, W, 224)):
        T = tab.w.shape[-1]
        wide = tab.cnt > T
        assert bool(wide.any()) and not bool(wide[inside].any())
        for tile_o, win in tab.wins:
            r0 = _tile_windows(tab.first, tab.cnt, n_in, tile_o, win, T)
            tile_wide = torch.nn.functional.pad(wide.float(), (0, -n_out % tile_o))
            tile_wide = tile_wide.view(N, -1, tile_o).amax(2).bool()
            assert bool((r0[tile_wide] < 0).all())
            assert bool((r0[inside] >= 0).all())
            tiles, direct = _check_chunks(tab, n_in, tile_o, win)
            assert set(tiles) == {tuple(i) for i in (r0 < 0).nonzero().tolist()}
            assert direct == 0 or tile_o == 1, (tile_o, win, direct)


def test_crop_b64_zoom_out_reads_no_device_memory():
    """chip_smoke's b64 zoom-out boxes (every image's rows past T on both
    axes) at the train shape: with the plan's tile and with every tile of
    two outputs or more the plan considers, every tile that leaves the
    one-window path is staged in chunks that hold their taps; none of its
    rows reads device memory."""
    from chip_smoke import TRAIN_B64, _zoom_out_boxes

    (N, C, H, W), ohw = TRAIN_B64
    x = torch.zeros((N, 1, H, W), dtype=torch.uint8)
    boxes = torch.from_numpy(_zoom_out_boxes(N))
    tab_h, tab_w, _, _ = cc._windowed_tables(x, boxes, ohw, "bilinear", True, 1.0, "pil_int8")
    for tab, n_in, n_out, R, inner in ((tab_h, H, ohw[0], C, W), (tab_w, W, ohw[1], C * ohw[0],
                                                                  1)):
        T = tab.w.shape[-1]
        assert bool((tab.cnt > T).any())
        plan = cc._crop_plan(tab.wins, n_in, n_out, T, N, R, inner, plans.H100_SMS, True, 1)
        tiles, direct = _check_chunks(tab, n_in, plan.tile_o, plan.win)
        assert tiles and direct == 0
        for tile_o, win in tab.wins:
            if tile_o > 1:
                assert _check_chunks(tab, n_in, tile_o, win)[1] == 0, (tile_o, win)


def test_crop_row_past_every_chunk_reads_device_memory():
    """A box ten times the image on a quarter bound: a row counts more
    taps than a tile's window holds, so even a chunk of that one output
    cannot be staged, and it alone reads device memory; the other rows of
    its tile are still staged in chunks."""
    x = torch.zeros((2, 1, 150, 260), dtype=torch.uint8)
    boxes = torch.tensor([[-4.5, -4.5, 5.5, 5.5], [-0.2, -0.2, 1.2, 1.2]])
    tab_h, tab_w, _, _ = cc._windowed_tables(x, boxes, (16, 16), "bilinear", True, 0.25,
                                             "pil_int8")
    for tab, n_in in ((tab_h, 150), (tab_w, 260)):
        T = tab.w.shape[-1]
        tile_o, win = tab.wins[-1]
        assert int(tab.cnt.max()) > win
        tiles, direct = _check_chunks(tab, n_in, tile_o, win)
        assert direct > 0
        assert any(lo is not None for chunks in tiles.values() for _, _, lo, _, _ in chunks)


def test_crop_plan_cuts_tiles_at_image_edges():
    """Per-image tables: a block's planes lie in one image, so the W pass's
    tiles along its C * OH rows are counted per image, and the shared
    bytes are the kernel's layout."""
    N, C, OH, W, OW, T = 64, 3, 224, 906, 224, 10
    R = C * OH
    wins = cc._crop_windows(W, OW, T, 1.0, 1.0, True)
    plan = cc._crop_plan(wins, W, OW, T, N, R, 1, plans.H100_SMS, True, 1)
    assert plan is not None
    assert plan.blocks == N * -(-R // plan.tile_j) * -(-OW // plan.tile_o)
    assert plan.smem == plans._axis_smem_bytes(plan.tile_j, plan.tile_o, plan.tile_i, plan.win,
                                               T, 1, W, 1)
    for _, p in plans.axis_tiles(wins, OW, T, W, N * R, 1, 1, plans.H100_SMS, True, per_img=R):
        assert p.blocks == N * -(-R // p.tile_j) * -(-OW // p.tile_o) * -(-1 // p.tile_i)
    # no tile takes more planes than an image's C: the H pass's tiles
    wins_h = cc._crop_windows(438, 224, 5, 1.0, 1.0, True)
    assert max(p.tile_j for _, p in plans.axis_tiles(wins_h, 224, 5, 438, N * C, W, 1,
                                                     plans.H100_SMS, True, per_img=C)) <= C
    # a small pass runs the unstaged body, as kernel B's plan decides
    assert cc._crop_plan(wins, W, OW, T, 1, 3, 1, plans.H100_SMS, True, 1) is None


def test_crop_plan_is_kernel_b_plan_for_one_image():
    """With one image and the windows of first taps, the crop's tiles are
    kernel B's own: the same model over the same (tile_o, win) pairs."""
    first = np.sort(np.random.default_rng(2).integers(0, 800, 224)).astype(np.int64)
    wins = tuple((t, plans.window(first, 9, 906, t)) for t in plans.AXIS_TILE_O)
    a = list(plans.axis_tiles(wins, 224, 9, 906, 672, 1, 1, plans.H100_SMS, True, per_img=672))
    b = list(plans._axis_candidates(first, 9, 906, 672, 1, 1, plans.H100_SMS, True))
    assert a == b

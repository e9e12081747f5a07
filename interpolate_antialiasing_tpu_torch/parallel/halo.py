"""Spatially-sharded resize with a halo exchange over ``torch.distributed``
(the port of ``interpolate_antialiasing_tpu.parallel.halo``).

When one image's H axis is sharded over the ranks of a mesh axis, each rank
needs ``halo`` neighbouring input rows to produce its local output rows;
``halo`` is derived exactly from the weight tables (window extents), the
reference's ``interp_size = ceil(support*scale)*2+1`` reasoning.

Communication is one ring step in each direction (:class:`_RingExtend`: two
neighbour exchanges in one ``batch_isend_irecv``), not an all-gather: bytes
moved per rank are ``halo * W`` instead of ``H * W``.  Nothing else in a
sharded call communicates.

Where the JAX package runs one ``shard_map`` program whose devices select
their shard's tables with ``lax.axis_index``, each rank here runs its own
shard's body (:func:`_shard_h_float`, :func:`_shard_h_int`) with its own
tables, on the card:

  * the float H pass is kernel B (``csrc/resample_axis.cu``) over the shard's
    compact tables of ``plan.Wl[d]`` (:func:`_shard_tables`), and over those
    of ``Wl[d]^T`` backward — the JAX package's ``banded_pass_mid_dynamic``
    and ``halo_local_contract_p``;
  * the byte-exact route's passes run the ``pil_resample_axis`` kernel
    (``csrc/pil_resample_axis.cu``) over Pillow's integer tables — the JAX
    package's ``digit_pass_mid_dynamic``.  Its int8 digit tables
    (``_digit_halo_tables``) and the identity-table W pass are the TPU
    matrix unit's layout and are not ported.

Inputs are ``DTensor``s sharded ``Shard(h_axis)`` over ``mesh[axis]`` (the
counterpart of a jax.Array placed with ``P(..., "sp", ...)``), or plain
tensors that every rank holds whole (the JAX package's callers may pass the
logical array).  ``torch.chunk``'s ceil blocks start where the JAX package's
ceil-padded blocks do; each rank pads its block to ``plan.hl`` rows, and the
output ``DTensor`` carries ``ol``-row shards with the last one cut.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.weights import _round_up, compact_tables, compute_tables, make_axis_spec
from .sharding import _as_dtensor, _axis_group, _block

__all__ = ["halo_resize_h", "plan_halo", "plan_halo_banded", "resize_sharded",
           "resize_sharded_pil_exact"]


# ---------------------------------------------------------------------------
# Host plans (copied expression for expression from the JAX package)
# ---------------------------------------------------------------------------


@functools.cache
def plan_halo(in_size: int, out_size: int, mode: str, antialias: bool, n_shards: int):
    """Static plan: halo row count + per-shard local weight matrices.

    Returns ``(halo, Wl)`` with ``Wl[d] in [out_local, in_local + 2*halo]``
    mapping the extended local rows (wrap-around halo rows carry zero
    weight at the global edges, so ring garbage never contributes).
    """
    if in_size % n_shards or out_size % n_shards:
        raise ValueError(
            f"H sizes must divide the mesh axis: {in_size}->{out_size} over {n_shards}"
        )
    spec = make_axis_spec(in_size, out_size, mode, antialias)
    xmin, size, w = compute_tables(spec, dtype=np.float64)
    hl, ol = in_size // n_shards, out_size // n_shards
    halo = 0
    for d in range(n_shards):
        o0, o1 = d * ol, (d + 1) * ol
        lo = int(xmin[o0])
        hi = int(xmin[o1 - 1] + size[o1 - 1])
        halo = max(halo, d * hl - lo, hi - (d + 1) * hl)
    halo = max(halo, 0)
    if halo > hl:
        raise ValueError(
            f"halo ({halo} rows) exceeds the local shard height ({hl}): the "
            f"one-hop neighbour exchange cannot serve it — use fewer shards "
            f"or a smaller filter (mode={mode!r}, {in_size}->{out_size} over "
            f"{n_shards})"
        )

    Wl = np.zeros((n_shards, ol, hl + 2 * halo), dtype=np.float64)
    for d in range(n_shards):
        base = d * hl - halo  # global row index of extended-local row 0
        for o in range(d * ol, (d + 1) * ol):
            for j in range(int(size[o])):
                col = int(xmin[o]) + j - base
                assert 0 <= col < hl + 2 * halo, "halo underestimated"
                Wl[d, o - d * ol, col] = w[o, j]
    Wl.setflags(write=False)  # cached: callers must not mutate
    return halo, Wl


@dataclasses.dataclass(frozen=True, eq=False)
class HaloPlan:
    """Static plan for a sharded H pass with uniform per-shard band geometry.

    ``starts[d, t]`` / ``bands[d, t, k, u]`` give shard ``d``'s banded tiles
    in the *extended-local* frame (``ext_pad`` rows = local block + halos,
    padded to the TPU's 8-row DMA alignment), the JAX package's layout, kept
    so that the plans can be held equal element for element; ``Wl[d]`` is
    the dense equivalent, whose compact tables the card's kernel reads
    (:func:`_shard_tables`).  One object per plan (:func:`plan_halo_banded`
    is cached), compared and hashed by identity.
    """

    halo: int
    hl: int  # local input rows per shard (ceil)
    ol: int  # local output rows per shard (ceil)
    ext: int  # hl + 2*halo
    ext_pad: int
    k_in: int
    n_tiles: int
    starts: np.ndarray  # [n_shards, n_tiles] int32, multiples of 8
    bands: np.ndarray  # [n_shards, n_tiles, k_in, 128] float32
    Wl: np.ndarray  # [n_shards, ol, ext_pad] float64


@functools.cache
def plan_halo_banded(
    in_size: int,
    out_size: int,
    mode: str,
    antialias: bool,
    n_shards: int,
    tile: int = 128,
    align: int = 8,
) -> HaloPlan:
    """Banded v2 of :func:`plan_halo`: non-divisible sizes allowed (shards
    use ceil-sized blocks; the caller pads the global H to ``n*hl`` rows and
    slices the output back to ``out_size``), and the weights come as
    tile-compacted bands with shard-uniform geometry.
    """
    spec = make_axis_spec(in_size, out_size, mode, antialias)
    xmin, size, w = compute_tables(spec, dtype=np.float64)
    n = n_shards
    hl = -(-in_size // n)
    ol = -(-out_size // n)
    halo = 0
    for d in range(n):
        o0, o1 = d * ol, min((d + 1) * ol, out_size)
        if o0 >= o1:
            continue
        lo = int(xmin[o0])
        hi = int(xmin[o1 - 1] + size[o1 - 1])
        halo = max(halo, d * hl - lo, hi - (d + 1) * hl)
    halo = max(halo, 0)
    if halo > hl:
        raise ValueError(
            f"halo ({halo} rows) exceeds the local shard height ({hl}): the "
            f"one-hop neighbour exchange cannot serve it — use fewer shards "
            f"or a smaller filter (mode={mode!r}, {in_size}->{out_size} over "
            f"{n_shards})"
        )
    ext = hl + 2 * halo
    ext_pad = _round_up(ext, align)
    n_tiles = -(-ol // tile)

    # Per-(shard, tile) window bounds in the extended-local frame, then a
    # single k_in wide enough for every tile of every shard.
    los = np.zeros((n, n_tiles), dtype=np.int64)
    his = np.ones((n, n_tiles), dtype=np.int64)
    for d in range(n):
        base = d * hl - halo  # global row of extended-local row 0
        for t in range(n_tiles):
            o0 = d * ol + t * tile
            o1 = min(o0 + tile, min((d + 1) * ol, out_size))
            if o0 >= o1:
                los[d, t], his[d, t] = 0, 1
                continue
            los[d, t] = (int(xmin[o0]) - base) // align * align
            his[d, t] = int(xmin[o1 - 1] + size[o1 - 1]) - base
    k_in = min(_round_up(int((his - los).max()), align), ext_pad)

    starts = np.zeros((n, n_tiles), dtype=np.int32)
    bands = np.zeros((n, n_tiles, k_in, tile), dtype=np.float64)
    Wl = np.zeros((n, ol, ext_pad), dtype=np.float64)
    for d in range(n):
        base = d * hl - halo
        for t in range(n_tiles):
            s = max(0, min(int(los[d, t]), ext_pad - k_in))
            starts[d, t] = s
            o0 = d * ol + t * tile
            o1 = min(o0 + tile, min((d + 1) * ol, out_size))
            for o in range(o0, o1):
                for j in range(int(size[o])):
                    col = int(xmin[o]) + j - base
                    assert 0 <= col < ext, "halo underestimated"
                    assert 0 <= col - s < k_in, "window underestimated"
                    bands[d, t, col - s, o - o0] = w[o, j]
                    Wl[d, o - d * ol, col] = w[o, j]
    bands = bands.astype(np.float32)
    for a in (starts, bands, Wl):
        a.setflags(write=False)  # cached: callers must not mutate
    return HaloPlan(
        halo=halo, hl=hl, ol=ol, ext=ext, ext_pad=ext_pad, k_in=k_in,
        n_tiles=n_tiles, starts=starts, bands=bands, Wl=Wl,
    )


@functools.cache
def _int_halo_tables(in_h: int, oh: int, mode: str, n: int):
    """Per-shard banded integer vertical tables on the halo plan's
    extended-local frame: ``(plan, starts[n, ol] int32,
    Wsh[n, ol, ntaps] int32)``.

    Built from :func:`..ops.pil_exact._int_tables` (the exact
    normalize_coeffs_8bpc integers in banded form) shifted into each
    shard's frame — valid because the integer weights' support is never
    wider than the float support they quantise (zeros round to zero), so
    the float-derived halo bound covers them.  Ceil-padding rows beyond
    ``oh`` keep start 0 and all-zero weights; wrap-around halo rows are
    reachable only through zero weights.  Size tracks the filter
    support, never the image."""
    from ..ops.pil_exact import _int_tables

    plan = plan_halo_banded(in_h, oh, mode, True, n)
    xmin, Wb = _int_tables(in_h, oh, mode)
    ntaps = Wb.shape[1]
    starts = np.zeros((n, plan.ol), np.int32)
    Wsh = np.zeros((n, plan.ol, ntaps), np.int32)
    for d in range(n):
        base = d * plan.hl - plan.halo
        o0, o1 = d * plan.ol, min((d + 1) * plan.ol, oh)
        for o in range(o0, o1):
            # the plan's halo bound is derived from these same xmin
            # windows, so every start lands inside the extended block
            s = int(xmin[o]) - base
            assert 0 <= s < plan.ext, "halo bound violated for int weights"
            starts[d, o - o0] = s
            Wsh[d, o - o0] = Wb[o]
    for a in (starts, Wsh):
        a.setflags(write=False)
    return plan, starts, Wsh


@functools.cache
def _shard_tables(plan: HaloPlan, d: int):
    """Shard ``d``'s float H pass as ``(tables of Wl[d], tables of
    Wl[d]^T)``: the compact tables (:func:`..ops.weights.compact_tables`,
    ``in_size = ext_pad``, ``out_size = ol``) that kernel B reads forward,
    and those of the transpose it reads backward.  Each row starts at its
    first nonzero column, so wrap-around halo rows are never read; cached
    per plan and shard."""
    return compact_tables(plan.Wl[d]), compact_tables(np.ascontiguousarray(plan.Wl[d].T))


# ---------------------------------------------------------------------------
# The ring: two neighbour exchanges, differentiable both ways
# ---------------------------------------------------------------------------

# P2P tags of the two directions, so that with two ranks (both neighbours on
# one peer) each receive matches its own send
_TAG_DOWN, _TAG_UP = 1, 2


def _ring_shift(down: torch.Tensor, up: torch.Tensor, group):
    """Send ``down`` to the next rank of ``group`` and ``up`` to the
    previous one (a ring); return ``(from_prev, from_next)``: what the
    previous rank sent down and what the next rank sent up.  One
    ``batch_isend_irecv`` of two sends and two receives."""
    n, d = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (d + 1) % n)
    prv = dist.get_global_rank(group, (d - 1) % n)
    down, up = down.contiguous(), up.contiguous()
    from_prev = torch.empty(down.shape, dtype=down.dtype, device=down.device)
    from_next = torch.empty(up.shape, dtype=up.dtype, device=up.device)
    ops = [dist.P2POp(dist.isend, down, nxt, group, tag=_TAG_DOWN),
           dist.P2POp(dist.isend, up, prv, group, tag=_TAG_UP),
           dist.P2POp(dist.irecv, from_prev, prv, group, tag=_TAG_DOWN),
           dist.P2POp(dist.irecv, from_next, nxt, group, tag=_TAG_UP)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def _extend(xl: torch.Tensor, halo: int, h_axis: int, group) -> torch.Tensor:
    """``[previous rank's last halo rows | xl | next rank's first halo
    rows]`` along ``h_axis``.  The wrap-around rows the first and last rank
    receive are garbage by construction: the consuming contraction gives
    them zero weight."""
    hl = xl.shape[h_axis]
    top, bot = _ring_shift(xl.narrow(h_axis, hl - halo, halo),
                           xl.narrow(h_axis, 0, halo), group)
    return torch.cat([top, xl, bot], h_axis)


def _fold(g: torch.Tensor, halo: int, h_axis: int, group) -> torch.Tensor:
    """The adjoint of :func:`_extend`: the halo rows' gradients go back to
    the ranks they came from and are added into those ranks' edge rows (the
    transpose of ``ppermute`` plus ``concat``)."""
    hl = g.shape[h_axis] - 2 * halo
    from_prev, from_next = _ring_shift(g.narrow(h_axis, halo + hl, halo),
                                       g.narrow(h_axis, 0, halo), group)
    dx = g.narrow(h_axis, halo, hl).clone()
    dx.narrow(h_axis, 0, halo).add_(from_prev)
    dx.narrow(h_axis, hl - halo, halo).add_(from_next)
    return dx


class _RingExtend(torch.autograd.Function):
    """:func:`_extend`; args ``(xl, halo, h_axis, group)``.  Backward is
    :class:`_RingFold`, forward mode the exchange of the tangent."""

    @staticmethod
    def forward(xl, halo, h_axis, group):
        return _extend(xl, halo, h_axis, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.halo, ctx.h_axis, ctx.group = inputs

    @staticmethod
    def backward(ctx, g):
        return _RingFold.apply(g, ctx.halo, ctx.h_axis, ctx.group), None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _extend(t, ctx.halo, ctx.h_axis, ctx.group)


class _RingFold(torch.autograd.Function):
    """:func:`_fold`, the adjoint of :class:`_RingExtend`."""

    @staticmethod
    def forward(g, halo, h_axis, group):
        return _fold(g, halo, h_axis, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.halo, ctx.h_axis, ctx.group = inputs

    @staticmethod
    def backward(ctx, gg):
        return _RingExtend.apply(gg, ctx.halo, ctx.h_axis, ctx.group), None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _fold(t, ctx.halo, ctx.h_axis, ctx.group)


def _ring_halo_extend(xl: torch.Tensor, halo: int, h_axis: int, group) -> torch.Tensor:
    """The ring exchange of one rank's block; with ``halo == 0`` (one
    shard, or windows that never cross a block edge) nothing is sent."""
    if halo <= 0:
        return xl
    return _RingExtend.apply(xl, halo, h_axis, group)


# ---------------------------------------------------------------------------
# Shard-local bodies (no process group needed)
# ---------------------------------------------------------------------------


def _pad_axis(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``n`` zero rows appended along ``axis`` (differentiable)."""
    if n <= 0:
        return x
    return F.pad(x, [0, 0] * (x.ndim - 1 - axis) + [0, n])


def _shard_h_float(ext: torch.Tensor, plan: HaloPlan, d: int, h_axis: int,
                   backend: str = "auto") -> torch.Tensor:
    """Shard ``d``'s float H contraction: its extended block (``plan.ext``
    rows along ``h_axis``) -> its ``plan.ol`` output rows.  Differentiable:
    kernel B over the shard's tables forward and over those of the
    transpose backward (``backend='auto'``; on a CPU tensor their plain
    version), or the dense product of ``Wl[d]`` (``backend='dense'``,
    float64, the JAX package's einsum route)."""
    from ..ops.resize import _apply_axis_diff

    ext = _pad_axis(ext, h_axis, plan.ext_pad - ext.shape[h_axis])
    return _apply_axis_diff(ext, _shard_tables(plan, d), h_axis, backend)


def _shard_h_int(ext: torch.Tensor, tables, d: int, h_axis: int,
                 use_kernels: bool = True) -> torch.Tensor:
    """Shard ``d``'s byte-exact H pass over :func:`_int_halo_tables`'s
    ``tables``: the uint8 extended block -> ``plan.ol`` uint8 rows, on the
    ``pil_resample_axis`` kernel (its plain version on a CPU tensor), or on
    the gather route (``use_kernels=False``)."""
    from ..ops import pil_exact as pe

    _, starts, Wsh = tables
    if use_kernels:
        return pe._resample_axis(ext, (starts[d], Wsh[d]), h_axis)
    y = pe._pass_last_int_banded(ext.movedim(h_axis, -1), pe._on(starts[d], ext.device),
                                 pe._on(Wsh[d], ext.device))
    return y.movedim(-1, h_axis)


def _pil_w_pass(x: torch.Tensor, tables, w_axis: int, use_kernels: bool) -> torch.Tensor:
    """The byte-exact route's shard-local W pass (Pillow's horizontal pass,
    uint8 in and out)."""
    from ..ops import pil_exact as pe

    if use_kernels:
        return pe._resample_axis(x, tables, w_axis)
    y = pe._pass_last_int_banded(x.movedim(w_axis, -1), pe._on(tables[0], x.device),
                                 pe._on(tables[1], x.device))
    return y.movedim(-1, w_axis)


def _extended_blocks(xp: torch.Tensor, plan: HaloPlan, n: int,
                     h_axis: int) -> list[torch.Tensor]:
    """Every shard's extended block from the whole tensor padded to ``n *
    plan.hl`` rows along ``h_axis``, exactly as the ring delivers it (the
    first and last shards get the wrapped-around rows): a rehearsal of the
    exchange without a process group, for checks of the shard bodies.
    Differentiable; its backward is the ring's fold."""
    hl, halo = plan.hl, plan.halo
    blocks = xp.split(hl, h_axis)
    if halo <= 0:
        return list(blocks)
    return [torch.cat([blocks[(d - 1) % n].narrow(h_axis, hl - halo, halo), blocks[d],
                       blocks[(d + 1) % n].narrow(h_axis, 0, halo)], h_axis)
            for d in range(n)]


def _own_rows(y: torch.Tensor, h_axis: int, out_size: int, ol: int, d: int) -> torch.Tensor:
    """Shard ``d``'s rows of a ceil-padded output: ``ol``, the last shards
    fewer (or none)."""
    return y.narrow(h_axis, 0, min(ol, max(out_size - d * ol, 0)))


# ---------------------------------------------------------------------------
# DTensor in, DTensor out
# ---------------------------------------------------------------------------


def _local_input(x, mesh, axis: str, h_axis: int):
    """``(this rank's block of h_axis, global shape, placements)``.  ``x`` is
    a DTensor sharded ``Shard(h_axis)`` over ``mesh[axis]`` or a plain tensor
    every rank holds whole (each takes its ``torch.chunk`` block here)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    i, n, d, _ = _axis_group(mesh, axis)
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("x lives on another device mesh")
        placements = tuple(x.placements)
        if placements[i] != Shard(h_axis):
            raise ValueError(f"x must be sharded Shard({h_axis}) over mesh axis "
                             f"{axis!r}, got {placements[i]}")
        return x.to_local(), tuple(x.shape), placements
    placements = [Replicate()] * mesh.ndim
    placements[i] = Shard(h_axis)
    return _block(x, h_axis, n, d), tuple(x.shape), tuple(placements)


def halo_resize_h(
    x,
    out_h: int,
    mesh,
    axis: str = "sp",
    mode: str = "bilinear",
    antialias: bool = True,
    h_axis: int = -2,
    use_pallas: bool | None = None,
):
    """Resize the (sharded) ``h_axis`` of ``x`` to ``out_h``.

    ``x`` is a DTensor sharded along ``h_axis`` over mesh axis ``axis`` (or
    a plain tensor every rank holds whole); the output is a DTensor with the
    same sharding.  Sizes need NOT divide the mesh axis: shards use
    ceil-sized blocks (each rank pads its block to ``hl`` rows — pad rows
    carry zero weight).  The local contraction runs kernel B over the
    shard's tables (``use_pallas`` None or True; on CPU tensors its plain
    version) or the dense product (``use_pallas=False``).  Integer inputs
    resample in float32 and return it, as the JAX package's do.  Only the H
    pass happens here — see :func:`resize_sharded` for the full 2-D
    pipeline.
    """
    h_axis = h_axis % x.ndim
    _, n, d, group = _axis_group(mesh, axis)
    xl, shape, placements = _local_input(x, mesh, axis, h_axis)
    plan = plan_halo_banded(shape[h_axis], out_h, mode, antialias, n)
    cdtype = xl.dtype if xl.is_floating_point() else torch.float32
    xl = _pad_axis(xl.to(cdtype), h_axis, plan.hl - xl.shape[h_axis])
    ext = _ring_halo_extend(xl, plan.halo, h_axis, group)
    y = _shard_h_float(ext, plan, d, h_axis, "dense" if use_pallas is False else "auto")
    out_shape = list(shape)
    out_shape[h_axis] = out_h
    return _as_dtensor(_own_rows(y, h_axis, out_h, plan.ol, d), mesh, placements, out_shape)


def _resize_sharded_block(xl: torch.Tensor, in_shape, size, mesh, axis: str, mode: str,
                          antialias: bool, h_axis: int, w_axis: int,
                          use_pallas: bool | None) -> torch.Tensor:
    """:func:`resize_sharded` on this rank's block ``xl`` of a tensor of
    global shape ``in_shape``: this rank's output rows, as a plain tensor
    (differentiable in both modes)."""
    from ..ops.resize import _apply_axis_diff

    oh, ow = int(size[0]), int(size[1])
    _, n, d, group = _axis_group(mesh, axis)
    plan = plan_halo_banded(in_shape[h_axis], oh, mode, antialias, n)
    spec_w = make_axis_spec(in_shape[w_axis], ow, mode, antialias)
    in_dtype = xl.dtype
    cdtype = in_dtype if in_dtype.is_floating_point else torch.float32
    xl = _pad_axis(xl.to(cdtype), h_axis, plan.hl - xl.shape[h_axis])
    # W pass, fully local: the differentiable per-axis op (kernel B)
    yl = _apply_axis_diff(xl, spec_w, w_axis, "auto")
    ext = _ring_halo_extend(yl, plan.halo, h_axis, group)
    y = _shard_h_float(ext, plan, d, h_axis, "dense" if use_pallas is False else "auto")
    y = _own_rows(y, h_axis, oh, plan.ol, d)
    if in_dtype == torch.uint8:
        y = torch.floor(y + 0.5).clamp_(0.0, 255.0).to(torch.uint8)
    return y


def resize_sharded(
    x,
    size,
    mesh,
    axis: str = "sp",
    mode: str = "bilinear",
    antialias: bool = True,
    data_format: str | None = None,
    use_pallas: bool | None = None,
):
    """Full separable 2-D resize of an image whose H axis is sharded over
    ``mesh[axis]`` — for giant images that do not fit (or should not sit on)
    one device.

    Per rank: the W pass runs fully locally (the W axis is unsharded), then
    the H pass does the ring halo exchange and the shard's local
    contraction.  Sizes need not divide the mesh axis.  uint8 inputs are
    resampled in float32 and rounded back PIL-style (``floor(v + 0.5)``,
    clamped).

    Differentiable for float inputs: the W pass is the differentiable
    per-axis op, the exchange is :class:`_RingExtend` (its backward sends
    the halo rows' gradients back and adds them into the neighbours' edge
    rows), and the local H contraction is kernel B over the shard's tables
    with its exact adjoint over ``Wl[d]^T``, so ``torch.autograd.grad``
    through the whole chain equals the unsharded gradient.  Forward mode
    runs on the rank's block (:func:`_resize_sharded_block`):
    ``DTensor.from_local`` has no forward-mode rule.
    """
    from ..ops.resize import _axes_for

    h_axis, w_axis = _axes_for(x, data_format)
    h_axis, w_axis = h_axis % x.ndim, w_axis % x.ndim
    xl, shape, placements = _local_input(x, mesh, axis, h_axis)
    y = _resize_sharded_block(xl, shape, size, mesh, axis, mode, antialias, h_axis,
                              w_axis, use_pallas)
    out_shape = list(shape)
    out_shape[h_axis], out_shape[w_axis] = int(size[0]), int(size[1])
    return _as_dtensor(y, mesh, placements, out_shape)


def resize_sharded_pil_exact(
    x,
    size,
    mesh,
    axis: str = "sp",
    mode: str = "bilinear",
    data_format: str | None = None,
    use_tpu_kernels: bool | None = None,
):
    """Byte-exact (``PIL.Image.resize`` equality) 2-D resize of a uint8
    image whose H axis is sharded over ``mesh[axis]`` — the sharded twin of
    ``backend="pil_exact"`` for giant images that live on several devices.

    :func:`resize_sharded` resamples uint8 in float32 and re-rounds; this
    route reproduces Pillow's arithmetic exactly: the W pass runs
    shard-locally in Pillow's int32 fixed point and quantises to the uint8
    lattice (the very intermediate ImagingResample materialises between its
    passes), those uint8 rows make the ring halo exchange (a quarter of the
    float halo bytes), and the H pass contracts each shard's extended block
    against its slice of the banded integer vertical tables.  Every step
    equals Pillow's, so the sharded result is byte-identical to
    single-device ``resize_pil_exact``.  Both passes are banded: no dense
    ``[out, in]`` matrix is built.

    Two byte-identical routes, as in the JAX package: the kernels (the
    default: both passes on the ``pil_resample_axis`` kernel on a CUDA
    tensor, which raises if its build or launch fails, and its plain version
    on a CPU tensor), and the plain gather route (``use_tpu_kernels=False``
    or ``IA_TPU_SHARDED_PIL_PALLAS=0``).  Every layout runs the kernels
    (NHWC through the kernel's ``[outer, n, inner]`` view).
    """
    from ..ops.pil_exact import _int_tables
    from ..ops.resize import _axes_for

    if x.dtype != torch.uint8:
        raise TypeError(f"pil_exact sharded path is uint8-only, got {x.dtype}")
    oh, ow = int(size[0]), int(size[1])
    h_axis, w_axis = _axes_for(x, data_format)
    h_axis, w_axis = h_axis % x.ndim, w_axis % x.ndim
    in_h = x.shape[h_axis]
    _, n, d, group = _axis_group(mesh, axis)
    tables = _int_halo_tables(in_h, oh, mode, n)
    plan = tables[0]
    tables_w = _int_tables(x.shape[w_axis], ow, mode)
    if use_tpu_kernels is None:
        use_tpu_kernels = os.environ.get("IA_TPU_SHARDED_PIL_PALLAS") != "0"
    xl, shape, placements = _local_input(x, mesh, axis, h_axis)
    xl = _pad_axis(xl, h_axis, plan.hl - xl.shape[h_axis])
    yw = _pil_w_pass(xl, tables_w, w_axis, bool(use_tpu_kernels))
    ext = _ring_halo_extend(yw, plan.halo, h_axis, group)
    y = _shard_h_int(ext, tables, d, h_axis, bool(use_tpu_kernels))
    out_shape = list(shape)
    out_shape[h_axis], out_shape[w_axis] = oh, ow
    return _as_dtensor(_own_rows(y, h_axis, oh, plan.ol, d), mesh, placements,
                          out_shape)

"""The banded separable resize as differentiable PyTorch ops (the port of
``interpolate_antialiasing_tpu.ops.primitive``).

The JAX package registers two linear primitives, one 1-D pass along an axis
and the separable two-pass over a ``(h_axis, w_axis)`` plane, each with
``ad.deflinear2`` (its jvp is the op on the tangent, its transpose the exact
adjoint) and a batching rule.  Here each is a pair of
``torch.autograd.Function``s, **forward and adjoint**, whose backward is the
other's ``apply``:

  * ``_AxisPass``  (``W`` along ``axis``)     <-> ``_AxisAdjoint`` (``W^T``);
  * ``_PlanePass`` (``W_h``, ``W_w``)         <-> ``_PlaneAdjoint``.

Because each backward is itself a differentiable op, double backward and
``gradgradcheck`` work.  Each Function also has a ``jvp`` (forward mode:
the op on the tangent) and a ``vmap`` rule that moves the vmapped dimension
to the front and shifts the axes, so ``torch.func.vmap``, ``jvp``, ``grad``
and their compositions work; a ctypes kernel launch cannot be traced by
``generate_vmap_rule``.

Which kernel runs is :mod:`.resize`'s routing: :func:`.resize._apply_axis`
and :func:`.resize._resize_plane_impl` forward, :func:`.resize._transpose_axis`
and :func:`.resize._plane_adjoint` backward.  uint8 is never differentiated:
the ops take floating tensors only.
"""

from __future__ import annotations

import torch

from .resize import Pass, _apply_axis, _plane_adjoint, _resize_plane_impl, _transpose_axis
from .weights import AxisSpec

__all__ = ["apply_axis", "apply_plane"]


def _require_float(x: torch.Tensor, name: str) -> None:
    if not x.is_floating_point():
        raise TypeError(
            f"{name} operates on floating dtypes (got {x.dtype}); cast first "
            "— the public resize() handles uint8 round-tripping"
        )


# ---------------------------------------------------------------------------
# 1-D axis pass
# ---------------------------------------------------------------------------


class _AxisPass(torch.autograd.Function):
    """``W`` along ``axis``; args ``(x, spec, axis, backend)``, ``spec`` an
    :class:`AxisSpec` or ``(tables of W, tables of W^T)``."""

    @staticmethod
    def forward(x, spec, axis, backend):
        return _apply_axis(x, spec, axis, backend)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.spec, ctx.axis, ctx.backend = inputs

    @staticmethod
    def backward(ctx, g):
        return _AxisAdjoint.apply(g, ctx.spec, ctx.axis, ctx.backend), None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _AxisPass.apply(t, ctx.spec, ctx.axis, ctx.backend)

    @staticmethod
    def vmap(info, in_dims, x, spec, axis, backend):
        if in_dims[0] is None:
            return _AxisPass.apply(x, spec, axis, backend), None
        return _AxisPass.apply(x.movedim(in_dims[0], 0), spec, axis + 1, backend), 0


class _AxisAdjoint(torch.autograd.Function):
    """``W^T`` along ``axis``; args ``(g, spec, axis, backend)``."""

    @staticmethod
    def forward(g, spec, axis, backend):
        return _transpose_axis(g, spec, axis, backend)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.spec, ctx.axis, ctx.backend = inputs

    @staticmethod
    def backward(ctx, gg):
        return _AxisPass.apply(gg, ctx.spec, ctx.axis, ctx.backend), None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _AxisAdjoint.apply(t, ctx.spec, ctx.axis, ctx.backend)

    @staticmethod
    def vmap(info, in_dims, g, spec, axis, backend):
        if in_dims[0] is None:
            return _AxisAdjoint.apply(g, spec, axis, backend), None
        return _AxisAdjoint.apply(g.movedim(in_dims[0], 0), spec, axis + 1, backend), 0


def apply_axis(x: torch.Tensor, spec: Pass, axis: int,
               backend: str) -> torch.Tensor:
    """The differentiable 1-D pass (axis normalised to a non-negative
    index).  ``spec`` is an :class:`AxisSpec`, or a pass's ``Tables`` with
    its adjoint's, ``(tables of W, tables of W^T)``: the sharded H pass
    runs each shard's local matrix that way, kernel B forward and over
    ``W^T`` backward (the port of the JAX package's
    ``halo_local_contract_p``)."""
    _require_float(x, "aa_resize_axis")
    in_size = spec[0].in_size if isinstance(spec, tuple) else spec.in_size
    if x.shape[axis] != in_size:
        raise ValueError(f"aa_resize_axis: axis {axis} has size {x.shape[axis]}, "
                         f"spec expects {in_size}")
    return _AxisPass.apply(x, spec, axis % x.ndim, backend)


# ---------------------------------------------------------------------------
# Separable 2-D plane pass (one op, so the two-pass kernel and its one-launch
# adjoint stay reachable)
# ---------------------------------------------------------------------------


class _PlanePass(torch.autograd.Function):
    """``W_w`` then ``W_h``; args ``(x, spec_h, spec_w, h_axis, w_axis,
    backend)``."""

    @staticmethod
    def forward(x, spec_h, spec_w, h_axis, w_axis, backend):
        return _resize_plane_impl(x, spec_h, spec_w, h_axis, w_axis, backend)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return (_PlaneAdjoint.apply(g, *ctx.args),) + (None,) * 5

    @staticmethod
    def jvp(ctx, t, *_):
        return _PlanePass.apply(t, *ctx.args)

    @staticmethod
    def vmap(info, in_dims, x, spec_h, spec_w, h_axis, w_axis, backend):
        if in_dims[0] is None:
            return _PlanePass.apply(x, spec_h, spec_w, h_axis, w_axis, backend), None
        return _PlanePass.apply(x.movedim(in_dims[0], 0), spec_h, spec_w,
                                h_axis + 1, w_axis + 1, backend), 0


class _PlaneAdjoint(torch.autograd.Function):
    """``W_h^T`` and ``W_w^T``; args as :class:`_PlanePass`."""

    @staticmethod
    def forward(g, spec_h, spec_w, h_axis, w_axis, backend):
        return _plane_adjoint(g, spec_h, spec_w, h_axis, w_axis, backend)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, gg):
        return (_PlanePass.apply(gg, *ctx.args),) + (None,) * 5

    @staticmethod
    def jvp(ctx, t, *_):
        return _PlaneAdjoint.apply(t, *ctx.args)

    @staticmethod
    def vmap(info, in_dims, g, spec_h, spec_w, h_axis, w_axis, backend):
        if in_dims[0] is None:
            return _PlaneAdjoint.apply(g, spec_h, spec_w, h_axis, w_axis, backend), None
        return _PlaneAdjoint.apply(g.movedim(in_dims[0], 0), spec_h, spec_w,
                                   h_axis + 1, w_axis + 1, backend), 0


def apply_plane(x: torch.Tensor, spec_h: AxisSpec, spec_w: AxisSpec,
                h_axis: int, w_axis: int, backend: str) -> torch.Tensor:
    """The differentiable plane op (axes normalised to non-negative
    indices)."""
    _require_float(x, "aa_resize_plane")
    for ax, spec in ((h_axis, spec_h), (w_axis, spec_w)):
        if x.shape[ax] != spec.in_size:
            raise ValueError(f"aa_resize_plane: axis {ax} has size {x.shape[ax]}, "
                             f"spec expects {spec.in_size}")
    return _PlanePass.apply(x, spec_h, spec_w, h_axis % x.ndim, w_axis % x.ndim,
                            backend)

"""A small trainable model whose input stage is the differentiable AA resize
(the port of ``interpolate_antialiasing_tpu.models.train``).

It exercises the training path end to end: the resize's forward kernel, its
adjoint where the images require grad, two convolutions, and an SGD step
with momentum.  ``ResizeConvNet`` is the model as an ``nn.Module``;
``init_params`` / ``forward`` / ``loss_fn`` / ``make_train_step`` keep the
JAX package's functional surface over a dict of tensors in its layouts
(convolutions OIHW, which is ``Conv2d``'s weight layout; ``head`` is
``[2*width, num_classes]``, applied as ``x @ head + bias``), so
:func:`params_from_jax` copies JAX parameters over unchanged.

With a ``DeviceMesh`` (``make_train_step(mesh)``, ``Trainer(mesh=...)``)
the step is the JAX package's sharded one, run by every rank: each takes its
block of the batch over the ``data`` axis; with an ``sp`` axis the resize is
``parallel.resize_sharded`` over the H shards of that axis's ranks, whose
results are gathered (differentiably) before the convolutions; the loss is
the global mean and the gradients are all-reduced over the ``data`` axis.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_plane

__all__ = ["init_params", "forward", "loss_fn", "make_train_step", "Trainer",
           "ResizeConvNet", "params_from_jax"]

MOMENTUM = 0.9


def init_params(generator: torch.Generator | None = None, num_classes: int = 10,
                width: int = 16) -> dict[str, torch.Tensor]:
    """Random parameters in the JAX package's shapes: normal * 0.1 weights,
    zero bias.  ``torch.Generator`` takes the place of the PRNG key; the
    numbers differ from ``jax.random``'s (:func:`params_from_jax` carries
    the JAX package's own)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * 0.1

    return {
        "conv1": normal(width, 3, 3, 3),
        "conv2": normal(2 * width, width, 3, 3),
        "head": normal(2 * width, num_classes),
        "bias": torch.zeros((num_classes,), dtype=torch.float32),
    }


def _sharded_resize(images: torch.Tensor, resize_to, mesh, spatial_axis: str):
    """This rank's images (whole along H) resized by ``resize_sharded`` over
    the ranks of ``mesh[spatial_axis]``, each resizing its H shard, then
    gathered back to whole images by a differentiable all-gather."""
    from torch.distributed.nn.functional import all_gather

    from ..parallel.halo import _pad_axis, _resize_sharded_block
    from ..parallel.sharding import _axis_group, _block

    sub = mesh[spatial_axis]
    _, n, d, group = _axis_group(sub, spatial_axis)
    y = _resize_sharded_block(_block(images, 2, n, d), images.shape, resize_to, sub,
                              spatial_axis, "bilinear", True, 2, 3, None)
    ol = -(-resize_to[0] // n)
    with warnings.catch_warnings():
        # newer releases mark this public differentiable all-gather deprecated
        # in favour of a private module; it stays the documented one
        warnings.simplefilter("ignore", FutureWarning)
        parts = all_gather(_pad_axis(y, 2, ol - y.shape[2]), group=group)
    return torch.cat(parts, 2).narrow(2, 0, resize_to[0])


def forward(params: dict[str, torch.Tensor], images: torch.Tensor,
            resize_to: tuple[int, int] = (64, 64), spatial_axis: str | None = None,
            mesh=None) -> torch.Tensor:
    """images: float NCHW of any size -> logits.  The first stage is the
    antialiased resize (differentiable: its backward is the adjoint).  With
    a ``mesh`` and a ``spatial_axis``, ``images`` is this rank's block of
    the batch and the resize is sharded over H (:func:`_sharded_resize`)."""
    if spatial_axis is not None and mesh is not None:
        x = _sharded_resize(images, tuple(resize_to), mesh, spatial_axis)
    else:
        x = resize_plane(images, resize_to, h_axis=2, w_axis=3, mode="bilinear")
    x = F.relu(F.conv2d(x, params["conv1"], padding=1))  # SAME, stride 1
    x = F.relu(F.conv2d(x, params["conv2"], padding=1))
    x = x.mean(dim=(2, 3))  # [N, C]
    return x @ params["head"] + params["bias"]


def loss_fn(params, images, labels, resize_to=(64, 64), spatial_axis=None,
            mesh=None) -> torch.Tensor:
    """Mean cross-entropy of the logits against integer ``labels`` (over
    this rank's images, with a mesh)."""
    logp = torch.log_softmax(forward(params, images, resize_to, spatial_axis, mesh),
                             dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def _sgd_momentum(params: dict, momentum: dict, grads: dict, lr: float) -> None:
    """``m = 0.9 m + g``, ``p = p - lr m``, in place, op for op as the JAX
    package's step (``torch.optim.SGD`` folds ``lr`` into other places)."""
    with torch.no_grad():
        for k in params:
            momentum[k].mul_(MOMENTUM).add_(grads[k])
            params[k].sub_(lr * momentum[k])


def _mesh_axes(mesh, data_axis: str, spatial_axis: str | None):
    """The mesh's data axis (required) and its spatial axis, or None where
    the mesh has none (a plain data-parallel mesh works as is)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if data_axis not in names:
        raise ValueError(f"mesh has no data axis {data_axis!r} (axes {names})")
    return spatial_axis if spatial_axis in names else None


def _data_block(t: torch.Tensor, mesh, data_axis: str) -> torch.Tensor:
    """This rank's block of the batch: a DTensor's local block (as
    ``parallel.shard_batch`` places it), or ``torch.chunk``'s block of a
    tensor every rank holds whole."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import _batch_block

    if isinstance(t, DTensor):
        return t.to_local()
    return _batch_block(t, mesh, data_axis)[0]


def make_train_step(mesh=None, data_axis: str = "data", spatial_axis: str | None = "sp",
                    resize_to: tuple[int, int] = (64, 64), lr: float = 1e-2):
    """An SGD-with-momentum step over parameter dicts:
    ``step(params, momentum, images, labels) -> loss``, updating ``params``
    and ``momentum`` in place (the JAX package's step returns new dicts).

    With a ``DeviceMesh`` every rank calls the step with the same
    parameters and the whole batch (or a DTensor sharded over
    ``data_axis``): it trains on its block of the batch, the resize sharded
    over ``spatial_axis`` where the mesh has one; the loss returned is the
    global mean and the gradients are all-reduced over ``data_axis``, so
    every rank applies the same update."""
    if mesh is not None:
        spatial_axis = _mesh_axes(mesh, data_axis, spatial_axis)

    def step(params, momentum, images, labels):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        if mesh is None:
            loss = loss_fn(leaves, images, labels, resize_to)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            _sgd_momentum(params, momentum, dict(zip(leaves, grads)), lr)
            return loss.detach()
        x = _data_block(images, mesh, data_axis)
        y = _data_block(labels, mesh, data_axis)
        logp = torch.log_softmax(forward(leaves, x, resize_to, spatial_axis, mesh), dim=-1)
        # this rank's share of the global mean
        loss = -logp.gather(1, y.long()[:, None]).sum() / images.shape[0]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        flat = torch.cat([loss.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat, group=mesh.get_group(data_axis))
        parts = flat[1:].split([g.numel() for g in grads])
        _sgd_momentum(params, momentum, {k: p.view_as(g) for k, p, g in
                                         zip(leaves, parts, grads)}, lr)
        return flat[0]

    return step


class ResizeConvNet(nn.Module):
    """The model as a module: resize to ``resize_to``, conv3x3(3 -> width),
    ReLU, conv3x3(width -> 2*width), ReLU, spatial mean, linear head."""

    def __init__(self, num_classes: int = 10, width: int = 16,
                 resize_to: tuple[int, int] = (64, 64),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.resize_to = tuple(resize_to)
        p = init_params(generator, num_classes, width)
        self.conv1 = nn.Conv2d(3, width, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(width, 2 * width, 3, padding=1, bias=False)
        self.head = nn.Parameter(p["head"])
        self.bias = nn.Parameter(p["bias"])
        with torch.no_grad():
            self.conv1.weight.copy_(p["conv1"])
            self.conv2.weight.copy_(p["conv2"])

    def params(self) -> dict[str, torch.Tensor]:
        """The parameters under the JAX package's names (shared storage)."""
        return {"conv1": self.conv1.weight, "conv2": self.conv2.weight,
                "head": self.head, "bias": self.bias}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), images, self.resize_to)


def params_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX package's ``init_params`` dict (numpy arrays) as a
    :class:`ResizeConvNet` ``state_dict``.  Layouts agree, so nothing is
    transposed."""
    names = {"conv1": "conv1.weight", "conv2": "conv2.weight", "head": "head",
             "bias": "bias"}
    return {names[k]: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in params.items()}


class Trainer:
    """Minimal training loop: a :class:`ResizeConvNet` and its momentum,
    stepped by :func:`make_train_step`'s update.  ``state_dict`` (for
    example from :func:`params_from_jax`) replaces the random init.  The
    model lives on the CUDA card unless ``device`` says otherwise (with no
    card, ``device=None`` raises); with a ``mesh`` (a ``DeviceMesh``), on the
    mesh's device type, every rank stepping its block of the batch."""

    def __init__(self, mesh=None, resize_to=(64, 64), num_classes=10, seed=0,
                 state_dict: dict | None = None,
                 device: torch.device | str | None = None,
                 data_axis: str = "data", spatial_axis: str | None = "sp"):
        self.mesh = mesh
        self.resize_to = tuple(resize_to)
        if mesh is not None:
            spatial_axis = _mesh_axes(mesh, data_axis, spatial_axis)
            if device is None:
                device = "cpu" if mesh.device_type == "cpu" else torch.device(
                    mesh.device_type, torch.cuda.current_device())
        elif device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Trainer runs on the CUDA card by default and none is available; "
                    "pass device='cpu' to train on the CPU")
            device = torch.device("cuda", torch.cuda.current_device())
        gen = torch.Generator().manual_seed(seed)
        self.model = ResizeConvNet(num_classes, resize_to=self.resize_to,
                                   generator=gen)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(device)
        self.momentum = {k: torch.zeros_like(p)
                         for k, p in self.model.params().items()}
        self.step_fn = make_train_step(mesh, data_axis=data_axis,
                                       spatial_axis=spatial_axis,
                                       resize_to=self.resize_to)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self.model.params()

    def step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return self.step_fn(self.params, self.momentum, images, labels)

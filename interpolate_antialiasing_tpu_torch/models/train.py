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

The JAX package shards this step over a device mesh (batch data-parallel,
spatial H sharding); the port runs one device, and a ``mesh`` raises
NotImplementedError (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_plane

__all__ = ["init_params", "forward", "loss_fn", "make_train_step", "Trainer",
           "ResizeConvNet", "params_from_jax"]

MOMENTUM = 0.9


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the sharded train step (mesh=...) is not ported yet: the port "
            "runs one device (ROADMAP queue 1 item 9)")


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


def forward(params: dict[str, torch.Tensor], images: torch.Tensor,
            resize_to: tuple[int, int] = (64, 64), mesh=None) -> torch.Tensor:
    """images: float NCHW of any size -> logits.  The first stage is the
    antialiased resize (differentiable: its backward is the adjoint)."""
    _no_mesh(mesh)
    x = resize_plane(images, resize_to, h_axis=2, w_axis=3, mode="bilinear")
    x = F.relu(F.conv2d(x, params["conv1"], padding=1))  # SAME, stride 1
    x = F.relu(F.conv2d(x, params["conv2"], padding=1))
    x = x.mean(dim=(2, 3))  # [N, C]
    return x @ params["head"] + params["bias"]


def loss_fn(params, images, labels, resize_to=(64, 64), mesh=None) -> torch.Tensor:
    """Mean cross-entropy of the logits against integer ``labels``."""
    logp = torch.log_softmax(forward(params, images, resize_to, mesh), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def _sgd_momentum(params: dict, momentum: dict, grads: dict, lr: float) -> None:
    """``m = 0.9 m + g``, ``p = p - lr m``, in place, op for op as the JAX
    package's step (``torch.optim.SGD`` folds ``lr`` into other places)."""
    with torch.no_grad():
        for k in params:
            momentum[k].mul_(MOMENTUM).add_(grads[k])
            params[k].sub_(lr * momentum[k])


def make_train_step(mesh=None, resize_to: tuple[int, int] = (64, 64),
                    lr: float = 1e-2):
    """An SGD-with-momentum step over parameter dicts:
    ``step(params, momentum, images, labels) -> loss``, updating ``params``
    and ``momentum`` in place (the JAX package's step returns new dicts)."""
    _no_mesh(mesh)

    def step(params, momentum, images, labels):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = loss_fn(leaves, images, labels, resize_to)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        _sgd_momentum(params, momentum, dict(zip(leaves, grads)), lr)
        return loss.detach()

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
    example from :func:`params_from_jax`) replaces the random init;
    ``device`` places the model."""

    def __init__(self, mesh=None, resize_to=(64, 64), num_classes=10, seed=0,
                 state_dict: dict | None = None,
                 device: torch.device | str | None = None):
        _no_mesh(mesh)
        self.resize_to = tuple(resize_to)
        gen = torch.Generator().manual_seed(seed)
        self.model = ResizeConvNet(num_classes, resize_to=self.resize_to,
                                   generator=gen)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(device)
        self.momentum = {k: torch.zeros_like(p)
                         for k, p in self.model.params().items()}
        self.step_fn = make_train_step(None, resize_to=self.resize_to)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self.model.params()

    def step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return self.step_fn(self.params, self.momentum, images, labels)

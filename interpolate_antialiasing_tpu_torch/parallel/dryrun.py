"""Multi-rank dry run of the sharded paths on CPU processes (the port of
``__graft_entry__.dryrun_multichip``), and the process-group launcher it and
the tests use.

:func:`run_group` spawns ``n`` processes, each one rank of a gloo process
group rendezvoused through a ``FileStore`` in a directory the caller gives
(no TCP port, no network), with one torch thread each; it kills every child
that outlives its time limit, so a hang costs one call and not a suite.
"""

from __future__ import annotations

import os
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["dryrun_multichip", "run_group"]

# a rank that waits longer than this in an exchange or a collective raises
GROUP_TIMEOUT = timedelta(seconds=60)


def _rank_main(rank: int, fn, n: int, store_dir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=GROUP_TIMEOUT)
    try:
        fn(rank, n, *args)
    finally:
        dist.destroy_process_group()


def run_group(fn, n: int, store_dir: str, *args, timeout: float = 240.0) -> None:
    """Run ``fn(rank, n, *args)`` in ``n`` spawned processes that form one
    gloo process group (the default group) over a ``FileStore`` in
    ``store_dir``.  ``fn`` must be a module-level function.  Raises the first
    child's exception; kills every child and raises TimeoutError after
    ``timeout`` seconds."""
    ctx = mp.start_processes(_rank_main, args=(fn, n, store_dir, args), nprocs=n,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"process group of {n} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _dryrun_rank(rank: int, n_devices: int) -> None:
    from torch.distributed.tensor import DTensor

    from ..models.train import init_params, make_train_step
    from .halo import resize_sharded, resize_sharded_pil_exact
    from .sharding import make_mesh

    # two mesh axes when possible: dp x sp
    if n_devices % 2 == 0 and n_devices > 1:
        shape = (2, n_devices // 2)
    else:
        shape = (1, n_devices)
    mesh = make_mesh(shape, ("data", "sp"), device_type="cpu")

    # a 256-row plane per rank of the sp axis exercises real partition sizes
    step = make_train_step(mesh, resize_to=(64, 48))
    params = init_params(torch.Generator().manual_seed(0))
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    rng = np.random.default_rng(0)
    batch = max(2, 2 * shape[0])
    h = 256 * shape[1]  # divisible by the sp axis for even H sharding
    imgs = torch.from_numpy(rng.random((batch, 3, h, 768)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, size=batch))
    loss = step(params, mom, imgs, labels)
    assert np.isfinite(float(loss)), "training step produced non-finite loss"

    # the explicit sharded resize: ring halo exchange with NON-divisible sizes
    n_sp = shape[1]
    giant = torch.from_numpy(rng.random((1, 3, 256 * n_sp + 3, 768)).astype(np.float32))
    out = (128 * n_sp + 1, 384)
    y = resize_sharded(giant, out, mesh, axis="sp")
    assert isinstance(y, DTensor) and tuple(y.shape) == (1, 3, *out) and bool(
        torch.isfinite(y.to_local()).all()), "sharded resize produced bad output"

    # ... and its reverse-mode gradient (each rank holds its block's)
    v = giant.clone().requires_grad_()
    yl = resize_sharded(v, out, mesh, axis="sp").to_local()
    g, = torch.autograd.grad((yl ** 2).sum(), v)
    assert g.shape == giant.shape and bool(torch.isfinite(g).all()), (
        "sharded resize gradient produced bad output")

    # ... and the byte-exact uint8 route, on its kernels and on the gather
    # route, byte-equal
    giant_u8 = torch.from_numpy((rng.random((3, 250 * n_sp, 640)) * 255).astype(np.uint8))
    yb = resize_sharded_pil_exact(giant_u8, (100 * n_sp, 320), mesh, axis="sp",
                                  use_tpu_kernels=False)
    assert tuple(yb.shape) == (3, 100 * n_sp, 320) and yb.dtype == torch.uint8, (
        "sharded pil_exact resize produced bad output")
    yb2 = resize_sharded_pil_exact(giant_u8, (100 * n_sp, 320), mesh, axis="sp",
                                   use_tpu_kernels=True)
    assert torch.equal(yb2.to_local(), yb.to_local()), (
        "kernel route of the sharded pil_exact resize diverged from the gather route")


def dryrun_multichip(n_devices: int) -> None:
    """Run ONE full training step over an ``n_devices``-rank mesh, then the
    explicit sharded resize, its gradient and the byte-exact route, as the
    JAX package's dry run does.

    Mesh: ``(2, n/2)`` data-parallel x spatial (H) axes ``("data", "sp")``
    where ``n`` is even, else ``(1, n)``; each rank trains on its block of
    the batch with its H shard resized through the halo ring, and the
    gradients are all-reduced.  The ranks are ``n`` spawned CPU processes of
    one gloo group (each must see one process group of its own), so the dry
    run needs no card and no network.
    """
    with tempfile.TemporaryDirectory() as tmp:
        run_group(_dryrun_rank, n_devices, tmp)

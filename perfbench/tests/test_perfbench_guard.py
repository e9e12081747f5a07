"""No part of the benchmark loads JAX or the JAX package."""

from __future__ import annotations

import subprocess
import sys

import small_cells
from perfbench.harness import guard


def test_forbidden_names_are_compared_whole():
    names = ["interpolate_antialiasing_tpu_torch", "interpolate_antialiasing_tpu_torch.ops.crop",
             "interpolate_antialiasing_tpu", "interpolate_antialiasing_tpu.ops.pil_exact",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "jaxtyping", "jax_utils",
             "torch", "numpy"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "interpolate_antialiasing_tpu", "interpolate_antialiasing_tpu.ops.pil_exact",
        "jax", "jax.numpy", "jaxlib.xla_client"]


_DRIVE = """
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import small_cells
from perfbench import run
from perfbench.harness import guard
bench = small_cells.bench()
for name in {{c["name"]: 0 for c in bench["end_to_end"] + bench["per_layer"]}}:
    run.load("metrics", name)
for w in small_cells.CELLS:
    config, traffic = small_cells.small(w, batch=2, pool=1)
    run.run_cell(bench, w, config, traffic, 5, 0.05, True, "cpu", time.perf_counter())
print("FOUND", guard.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this one has the JAX package loaded by the
    repository's conftest): the harness, every metric reader and a traced
    run of every cell through its adapter, on the CPU."""
    code = _DRIVE.format(root=str(small_cells.ROOT), tests=str(small_cells.ROOT / "perfbench"
                                                                / "tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=small_cells.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "FOUND []"

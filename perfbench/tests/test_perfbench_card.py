"""One short run of each cell on the card (marked ``cuda``; skips where
there is none): ``python -m pytest --noconftest -m cuda
perfbench/tests/test_perfbench_card.py``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import small_cells


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", small_cells.CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_on_the_card_is_correct(card, workload, traced):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                        "--seed", "2147483659", "--seconds", "1", "--trace", str(traced)],
                       capture_output=True, text=True, timeout=1500, cwd=small_cells.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
    assert p.stderr.strip().splitlines()[-1].startswith("check ")

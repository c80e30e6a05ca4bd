"""On the card: a short run of each cell through ``run.py`` comes out
correct, on the card's engine (``python -m pytest qzbench/tests -m
cuda`` on a machine with cards)."""

import json
import subprocess
import sys

import pytest

from qzbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell, card):
    import torch
    chips = harness.load_cell(cell).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    out = subprocess.run(
        [sys.executable, "qzbench/run.py", "--workload", cell, "--seed",
         str(2**32 + 15), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == chips

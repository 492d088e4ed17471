"""The control of each one-card cell and the planted lookup faults, on the
card at the cell's own size: the reference computed in the nearest
precision below the configuration's (float8 products, `fp8_round`) in the
program's place, and the program with its lookup broken
(`program.lookup_fault`), must each come out not correct under the cell's
limits.  Marked `cuda`: it skips without a card.  On the card:

    python3 -m pytest -q -p no:cacheprovider stereo_bench/tests/test_bench_control.py
"""

import json
import time
from pathlib import Path

import pytest
import torch

from stereo_bench import check
from stereo_bench.cell import generator, load_cell
from stereo_bench.window import SetupClock

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
SEEDS = (2 ** 31 + 71, 72, 73)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control and the faults run at the cell's own size")


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(card, workload, seed):
    cell = load_cell(BENCH, workload)
    numbers = generator(cell).control(cell, seed)[0]
    assert not check.judge(numbers, cell.limits)[0], numbers


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["level"])
def test_a_lookup_fault_is_not_correct(card, workload, fault):
    from stereo_bench import program

    cell = load_cell(BENCH, workload)
    with program.lookup_fault(fault):
        run = generator(cell).run(cell, 2 ** 31 + 74, 2.0, False, SetupClock(time.perf_counter()))
    assert not run["correct"], run["numbers"]

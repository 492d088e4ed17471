"""The rest of a run, driven on the CPU at a toy size, with the timed path
broken underneath: `correct` has to come out false, under each cell's own
limits.  (The card's own share of a run, the check that there is a card,
is what is skipped.)  The planted lookup faults are read at the cells' own
size on the card (`test_bench_control.py`); here they are shown to reach
the answer."""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from stereo_bench import program
from stereo_bench.cell import generator, load_cell
from stereo_bench.window import SetupClock

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
EVAL = [w["name"] for w in BENCH["workloads"] if load_cell(BENCH, w["name"]).traffic["kind"] == "eval_ticks"]


def _toy_eval(workload):
    cell = load_cell(BENCH, workload)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, batch=2, height=64, width=128, iters=2,
                                                  distinct_ticks=2, warmup_ticks=1, checked_ticks=2))


def _run(cell, seconds=0.2):
    torch.manual_seed(0)
    return generator(cell).run(cell, 2 ** 31 + 9, seconds, False, SetupClock(time.perf_counter()), device="cpu")


@pytest.mark.parametrize("workload", EVAL)
def test_a_sound_eval_run_is_correct(workload):
    assert _run(_toy_eval(workload))["correct"]


@pytest.mark.parametrize("workload", EVAL)
def test_an_answer_altered_where_it_is_produced_is_not_correct(workload, monkeypatch):
    made = program.make_eval_step

    def altered(*args, **kwargs):
        step = made(*args, **kwargs)

        def broken(left, right, coords, scale):
            out = step(left, right, coords, scale).clone()
            out[0] += 10.0  # one pair's disparity 10 px off
            return out
        return broken

    monkeypatch.setattr(program, "make_eval_step", altered)
    assert not _run(_toy_eval(workload))["correct"]


@pytest.mark.parametrize("fault", program.LOOKUP_FAULTS)
@pytest.mark.parametrize("workload", EVAL)
def test_a_planted_lookup_fault_reaches_the_answer(workload, fault):
    """The fault goes through the program's lookup and moves the disparity
    the check reads (one tick, the same on both sides), and is lifted on
    leaving."""
    cell = dataclasses.replace(_toy_eval(workload), limits={})
    cell.traffic["checked_ticks"] = 1
    sound = _run(cell, seconds=0.001)["numbers"]["mean_abs_px"]
    before = program.ops_lookup.gather_pyramid_aligned
    with program.lookup_fault(fault):
        broken = _run(cell, seconds=0.001)["numbers"]["mean_abs_px"]
    assert abs(broken - sound) > 0.1 * sound, (sound, broken)
    assert program.ops_lookup.gather_pyramid_aligned is before

"""The frozen reference against the program on the CPU at a toy size, with
the program in float32 (its own precision option), so that what is left is
the two implementations: eval ticks of both models through the benchmark's
own generator, decoded densely, on an output grid at another scale, and at
seeded queries; and the reference's FLOP count against the program's
`utils/profiling.flops_estimate`."""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from stereo_bench.cell import generator, load_cell, reference_module
from stereo_bench.window import SetupClock
from stereo_bench.reference.flops import eval_flops

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _first(kind):
    return next(w["name"] for w in BENCH["workloads"] if load_cell(BENCH, w["name"]).traffic["kind"] == kind)


def _toy(workload, config, **mix):
    cell = load_cell(BENCH, workload)
    cfg = json.loads((ROOT / "stereo_bench" / "configs" / f"{config}.json").read_text())
    cfg["model"]["compute_dtype"] = "float32"
    traffic = dict(cell.traffic, **mix)
    return dataclasses.replace(cell, config=cfg, traffic=traffic, limits={})


@pytest.mark.parametrize("decode", [{}, {"scale": 2.0, "queries": "grid"}, {"scale": 1.5, "queries": 700}],
                         ids=["dense", "grid_x2", "queries"])
@pytest.mark.parametrize("config", ["igev", "raft"])
def test_eval_ticks_agree_in_float32(config, decode):
    torch.manual_seed(0)
    cell = _toy(_first("eval_ticks"), config, batch=2, height=64, width=128, iters=3, distinct_ticks=2,
                warmup_ticks=1, checked_ticks=2, **decode)
    run = generator(cell).run(cell, 2 ** 31 + 5, 0.1, False, SetupClock(time.perf_counter()), device="cpu")
    assert run["numbers"]["max_abs_px"] < 1e-2 and run["numbers"]["mean_abs_px"] < 1e-3, run["numbers"]
    assert run["numbers"]["ref_mean_px"] > 1.0


def test_flop_count_equals_the_programs_estimate():
    from anystereo_tpu_torch.config import ModelConfig
    from anystereo_tpu_torch.nn.model import AnyStereo
    from anystereo_tpu_torch.utils.profiling import flops_estimate

    cfg = json.loads((ROOT / "stereo_bench" / "configs" / "igev.json").read_text())
    model = AnyStereo(ModelConfig(compute_dtype="float32")).eval()
    img = torch.rand(1, 64, 128, 3) * 255
    with torch.no_grad():
        port = flops_estimate(lambda: model(img, img, iters=2))
    assert eval_flops(reference_module(cfg), cfg["model"], 1, 64, 128, 2) == port

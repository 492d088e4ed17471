"""`BENCHMARK.json` against its contract's form, each cell resolving to its
files, and a cell, configuration, mix and metric added as new files alone."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from stereo_bench.cell import load_cell, metric_reader, reports

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["stereo_bench"]
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contracts_keys_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            assert text is None or (1 <= len(text) <= 200 and "\n" not in text and "\t" not in text)


def test_bounds_and_sources():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])


def test_configs_name_their_files_and_keep_published_widths():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("stereo_bench/configs/")
        data = json.loads(path.read_text())
        assert data["reduced"] == c["reduced"] == []
        assert (ROOT / "stereo_bench" / "reference" / f"{data['reference']}.py").is_file()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = load_cell(BENCH, workload)
    assert cell.chips in (1, 4) and cell.limits
    assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(metric_reader(m["name"]))
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            cell_e2e = [e["name"] for e in load_cell(BENCH, w).end_to_end]
            assert m["moves"] in cell_e2e, (m["name"], w)


TOY_KIND = '''"""A throwaway kind of traffic: ticks of a seeded matrix product."""
import time

import torch


def run(cell, seed, seconds, trace, clock, device="cuda"):
    tr = cell.traffic
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((tr["n"], tr["n"]), generator=gen, device=device, dtype=torch.float64)
    clock.mark("inputs_s")
    ticks, t_start = [], time.perf_counter()
    while time.perf_counter() - t_start < seconds or not ticks:
        t0 = time.perf_counter()
        out = (a @ a).cpu()
        ticks.append((t0, time.perf_counter(), 1))
    gap = float((out - (a.cpu() @ a.cpu())).abs().max())
    ok = gap <= cell.limits["max_gap"]
    return {"ticks": ticks, "attempted": len(ticks), "failed": 0 if ok else 1, "peak_bytes": a.numel() * 8,
            "correct": ok, "checks": {"max_gap": {"value": gap, "limit": cell.limits["max_gap"]}}}


def control(cell, seed, device="cuda"):
    return {"max_gap": 0.0}, None
'''


def _copy(tmp_path):
    root = tmp_path / "stereo_bench"
    for sub in ("configs", "traffic", "limits", "metrics", "generators"):
        shutil.copytree(ROOT / "stereo_bench" / sub, root / sub)
    return root


def _files():
    return {p: p.read_bytes() for p in (ROOT / "stereo_bench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _add_cell(bench, name, config, traffic, moves=("pairs_per_s", "pair_p95_ms")):
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "throwaway"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] in moves:
            m["workloads"].append(name)


def _run(cell, seconds=0.2):
    from stereo_bench.cell import generator
    from stereo_bench.window import SetupClock

    torch.manual_seed(0)
    return generator(cell).run(cell, 2 ** 31 + 7, seconds, False, SetupClock(time.perf_counter()), device="cpu")


def test_a_cell_configuration_mix_and_metric_added_as_files_alone(tmp_path):
    """A throwaway configuration, mix, limits and per-layer metric, each a
    new file beside copies of the benchmark's own, resolve and run (on the
    CPU, at a toy size) with no file of the benchmark edited."""
    root = _copy(tmp_path)
    before = _files()
    (root / "configs" / "igev_toy.json").write_text((root / "configs" / "igev.json").read_text())
    eval_mix = next(json.loads(p.read_text()) for p in sorted((root / "traffic").glob("*.json"))
                    if json.loads(p.read_text())["kind"] == "eval_ticks")
    mix = dict(eval_mix,
               batch=1, height=64, width=128, iters=1, distinct_ticks=2, warmup_ticks=1, checked_ticks=1)
    (root / "traffic" / "toy_ticks.json").write_text(json.dumps(mix))
    (root / "limits" / "igev_toy.toy_ticks.json").write_text(json.dumps({"mean_abs_px": 5.0}))
    (root / "metrics" / "ticks_seen.toy.py").write_text("def read(run):\n    return len(run['ticks'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "igev_toy", "source": "x", "file": "stereo_bench/configs/igev_toy.json",
                             "reduced": [], "why": "throwaway"})
    _add_cell(bench, "igev_toy.toy_ticks", "igev_toy", "toy_ticks")
    bench["per_layer"].append({"name": "ticks_seen.toy", "unit": "ticks", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "pairs_per_s",
                               "workloads": ["igev_toy.toy_ticks"]})
    cell = load_cell(bench, "igev_toy.toy_ticks", root=root)
    assert [m["name"] for m in cell.per_layer] == ["ticks_seen.toy"]
    run = _run(cell)
    assert run["correct"] and metric_reader("ticks_seen.toy", root=root)(run) == len(run["ticks"]) >= 1
    assert before == _files()


def test_a_scaled_eval_mix_added_as_a_file_alone(tmp_path):
    """A mix of the eval kind that decodes at twice the input's size, on an
    output grid: a data file and a limits file, no code."""
    root = _copy(tmp_path)
    before = _files()
    eval_mix = next(json.loads(p.read_text()) for p in sorted((root / "traffic").glob("*.json"))
                    if json.loads(p.read_text())["kind"] == "eval_ticks")
    mix = dict(eval_mix, batch=2, height=64, width=128, iters=2, distinct_ticks=2, warmup_ticks=1,
               checked_ticks=1, scale=2.0, queries="grid")
    (root / "traffic" / "x2_toy.json").write_text(json.dumps(mix))
    (root / "limits" / "raft.x2_toy.json").write_text(json.dumps({"mean_abs_px": 5.0}))
    bench = json.loads(json.dumps(BENCH))
    _add_cell(bench, "raft.x2_toy", "raft", "x2_toy")
    cell = load_cell(bench, "raft.x2_toy", root=root)
    run = _run(cell)
    assert run["correct"] and run["attempted"] == 2 * len(run["ticks"])
    assert run["readings"][0]["ref_mean_px"] > 1.0
    assert before == _files()


def test_a_new_kind_of_traffic_added_as_files_alone(tmp_path):
    """A kind the benchmark has no generator for: its generator, a mix, a
    limits file and a configuration entry, all new files, run through the
    same lookup `stereo_bench.run` makes, and its end-to-end metrics read."""
    root = _copy(tmp_path)
    before = _files()
    (root / "generators" / "toy_matmul.py").write_text(TOY_KIND)
    (root / "traffic" / "matmul.json").write_text(json.dumps({"kind": "toy_matmul", "n": 64}))
    (root / "limits" / "igev.matmul.json").write_text(json.dumps({"max_gap": 1e-9}))
    bench = json.loads(json.dumps(BENCH))
    _add_cell(bench, "igev.matmul", "igev", "matmul")
    cell = load_cell(bench, "igev.matmul", root=root)
    run = _run(cell, seconds=0.05)
    run["setup_s"] = 1.0
    assert run["correct"] and run["attempted"] == len(run["ticks"]) >= 1
    for m in cell.end_to_end:
        assert metric_reader(m["name"], root=root)(run) > 0
    assert before == _files()


def test_a_metric_without_workloads_follows_the_end_to_end_metric_it_moves():
    m = {"name": "x", "moves": "pairs_per_s"}
    assert reports(m, "any", ["pairs_per_s", "setup_s"]) and not reports(m, "any", ["train_samples_per_s"])
    assert reports({"name": "setup_s"}, "any", [])

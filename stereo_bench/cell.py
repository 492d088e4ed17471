"""A cell of `BENCHMARK.json` and the files it is made of, found by name:

- `stereo_bench/configs/<config>.json`: the model configuration (the
  program's `ModelConfig` fields under "model", the lookup flavour, the
  source, what was cut and assumed, the deployment it stands for, and the
  module of `stereo_bench/reference/` that computes it);
- `stereo_bench/traffic/<traffic>.json`: the traffic mix, parameters that
  the generator of its "kind" reads;
- `stereo_bench/generators/<kind>.py`: the generator of a kind of traffic,
  with `run(cell, seed, seconds, trace, clock, device="cuda")`, which
  builds the program and its inputs from the seed, warms up, drives the
  window, judges what the timed path produced and returns the run's
  numbers: `ticks` [(dispatch s, done s, units)], `attempted`, `failed`,
  `peak_bytes`, `correct`, `checks` ({name: {"value", "limit"}}), with
  `trace` a `record` for the per-layer readers (or None in a process that
  does not report, such as a rank other than 0); and `control(cell, seed)`,
  the control's (worst numbers, readings);
- `stereo_bench/limits/<workload>.json`: the limit of each number that
  decides `correct`;
- `stereo_bench/metrics/<metric>.py`: one reader a per-layer metric, with
  `read(record) -> float | None`.

Adding a configuration, a mix, a kind of traffic, a cell or a metric adds
files and entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the entries this cell reports with --trace 0
    per_layer: List[dict]  # the entries this cell reports with --trace 1
    root: Path = HERE  # the folder its files were found in


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str, end_to_end_here: List[str]) -> bool:
    """Whether a metric is reported in this cell: a `workloads` list names
    the cells; without one, a per-layer metric goes with every cell that
    reports the end-to-end metric it moves, an end-to-end one with every
    cell."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end_here


def load_cell(bench: dict, workload: str, root: Path = HERE) -> Cell:
    """The cell named `workload` of the parsed `BENCHMARK.json`; raises
    `KeyError` for a name it does not hold."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if reports(m, workload, names)]
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config_name=entry["config"], config=_load_json(root / "configs" / f"{entry['config']}.json"),
        traffic_name=entry["traffic"], traffic=_load_json(root / "traffic" / f"{entry['traffic']}.json"),
        limits=_load_json(root / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=per_layer, root=root)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(cell: Cell):
    """The module `generators/<kind>.py` of the cell's mix, loaded by path."""
    kind = cell.traffic["kind"]
    return _load_module(cell.root / "generators" / f"{kind}.py", f"stereo_bench_generator_{kind}")


def reference_module(config: dict):
    """The module of `stereo_bench/reference/` that computes a configuration
    (its "reference" key): `build(model, quant=None)`, `param_kinds`,
    `fan_in`, `set_plain_float32`, `fp8_round`."""
    return importlib.import_module(f"stereo_bench.reference.{config['reference']}")


def metric_reader(name: str, root: Path = HERE) -> Callable[[dict], object]:
    """`read` of `metrics/<name>.py`, loaded by path (a metric's name holds
    dots)."""
    return _load_module(root / "metrics" / f"{name}.py", f"stereo_bench_metric_{name.replace('.', '_')}").read

"""One run of one benchmark cell on the cards of this machine.

    python3 -m stereo_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`.  Prints set-up
parts and the correctness check's numbers on standard error (the numbers
compared, each beside its limit, last) and, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` `breakdown`, and `checks`.  Exits 2 without
enough CUDA cards, 3 if the process holds JAX or the JAX package once the
window has closed; either way it prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "anystereo_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    each compared whole (`anystereo_tpu_torch` is not `anystereo_tpu`)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def _caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own CUDA libraries go to `build/kernels/` beside it)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")


def result_line(cell, run: dict, trace: bool, device: dict) -> dict:
    from stereo_bench.cell import metric_reader

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": bool(run["correct"]), "attempted": int(run["attempted"]), "failed": int(run["failed"]),
            "metrics": metrics, "device": device}
    if trace:
        rec = run["record"]
        line["device"] = dict(device, busy_s=rec["busy_s"], window_s=rec["traced_s"])
        line["breakdown"] = {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}
    line["checks"] = run["checks"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    from stereo_bench.cell import load_cell

    cell = load_cell(bench, args.workload)
    _caches(root)
    from stereo_bench.window import SetupClock

    clock = SetupClock(T0)
    import torch

    clock.mark("torch_import_s")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from stereo_bench import window
    from stereo_bench.cell import generator

    run = generator(cell).run(cell, args.seed, args.seconds, bool(args.trace), clock)
    if run is None:  # a process that does not report (a rank other than 0): the one that does reports
        return 0
    run["setup_s"] = clock.total
    log(f"[setup] {clock.total:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in clock.parts.items()))
    spans = sorted(1e3 * (done - start) for start, done, _ in run["ticks"])
    log(f"[window] {len(spans)} ticks in {window.window_seconds(run['ticks']):.3f} s; tick ms min {spans[0]:.1f} "
        f"quartiles {' '.join(f'{q:.1f}' for q in statistics.quantiles(spans, n=4)) if len(spans) > 1 else '-'} "
        f"max {spans[-1]:.1f}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(run["peak_bytes"])}
    line = result_line(cell, run, bool(args.trace), device)
    if args.trace:
        log(f"[card] {run['record']['card']}")
    found = forbidden_modules()
    if found:
        log(f"the process holds {found}: nothing a run executes may load JAX or the JAX package")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

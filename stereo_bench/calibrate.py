"""The readings a cell's limits are set from, in one process on the card:

- the program: for each seed, a short window at the cell's own load and its
  check as a run makes it (the same sampled ticks against the fp32
  reference), with no limit applied;
- the control: for each control seed, the reference computed in the nearest
  precision below the configuration's (bf16 products: float8 e4m3 operands,
  `fp8_round`) in the program's place, against the fp32 reference (the
  generator's `control`);
- planted lookup faults (`program.lookup_fault`: "shift", "level"): the
  program with the fault, checked as a run checks it;
- the witness: the program with its compute dtype set to float32, checked
  as a run checks it (where the bf16 program's gap is large, this shows
  whether it is the precision).

    python3 -m stereo_bench.calibrate --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 \\
        [--shift-seeds ...] [--level-seeds ...] [--witness-seeds ...] [--seconds 3]

Each reading is one JSON line on standard output and in
`chiprun_out/calibrate_<cell>.jsonl`.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--shift-seeds", default="")
    p.add_argument("--level-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from stereo_bench.cell import generator, load_cell

    with open("BENCHMARK.json") as f:
        cell = load_cell(json.load(f), args.workload)
    cell.limits = {}
    import torch

    from stereo_bench import program
    from stereo_bench.window import SetupClock

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    gen = generator(cell)
    os.makedirs("chiprun_out", exist_ok=True)
    out = Path("chiprun_out") / f"calibrate_{cell.name}.jsonl"

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    plan = ([("program", s) for s in seeds(args.seeds)] + [("control", s) for s in seeds(args.control_seeds)]
            + [("fault_shift", s) for s in seeds(args.shift_seeds)]
            + [("fault_level", s) for s in seeds(args.level_seeds)]
            + [("witness_fp32", s) for s in seeds(args.witness_seeds)])
    with open(out, "a") as f:
        for kind, seed in plan:
            t = time.perf_counter()
            if kind == "control":
                numbers, readings = gen.control(cell, seed)
            else:
                c, fault = cell, contextlib.nullcontext()
                if kind == "witness_fp32":
                    c = dataclasses.replace(cell, config=dict(cell.config, model=dict(
                        cell.config["model"], compute_dtype="float32")))
                elif kind.startswith("fault_"):
                    fault = program.lookup_fault(kind[len("fault_"):])
                with fault:
                    run = gen.run(c, seed, args.seconds, False, SetupClock(t))
                numbers, readings = run["numbers"], run["readings"]
            line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed, "numbers": numbers,
                               "readings": readings, "seconds": time.perf_counter() - t})
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What a run loads, by top-level module name compared whole: never JAX,
flax or the JAX package (`anystereo_tpu`; the port `anystereo_tpu_torch`
shares its prefix and is allowed), and the reference nothing of the
program."""

import json
import subprocess
import sys
from pathlib import Path

from stereo_bench.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax_and_not_the_jax_package():
    metrics = sorted(p.stem for p in (ROOT / "stereo_bench" / "metrics").glob("*.py") if not p.stem.startswith("_"))
    kinds = sorted(p.stem for p in (ROOT / "stereo_bench" / "generators").glob("*.py"))
    code = ("import stereo_bench.run, stereo_bench.harness, stereo_bench.calibrate, stereo_bench.program\n"
            "from stereo_bench.cell import Cell, generator, metric_reader\n"
            f"for m in {metrics!r}: metric_reader(m)\n"
            f"for k in {kinds!r}: generator(Cell(*['x', 1, 'x', {{}}, 'x', {{'kind': k}}, {{}}, [], []]))\n")
    names = _loaded(code)
    assert "anystereo_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "anystereo_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    names = _loaded("import stereo_bench.reference.anystereo, stereo_bench.reference.flops, "
                    "stereo_bench.weights, stereo_bench.scenes, stereo_bench.check")
    assert not names & {"anystereo_tpu_torch", "anystereo_tpu", "jax", "jaxlib", "flax"}


def test_names_are_compared_whole():
    assert forbidden_modules(["anystereo_tpu_torch", "anystereo_tpu_torch.nn.model", "jaxtyping"]) == []
    assert forbidden_modules(["anystereo_tpu.ops", "jax._src.core", "flax", "torch"]) == ["anystereo_tpu", "flax", "jax"]

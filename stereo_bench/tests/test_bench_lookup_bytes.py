"""The aligned lookup's least bytes against the kernel table's bound column
(PERF.md: B1 forward at the IGEV eval shape 7.99 + 1.06 us and the
training shape 1.71 + 0.22, at 3.35 TB/s), and the roofline share the
harness can print."""

import importlib.util
from pathlib import Path

import pytest
import torch

from stereo_bench.peaks import H100_PEAK

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _load(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


lb = _load("_lookup_bytes")


def _us(nbytes):
    return nbytes / H100_PEAK["hbm_bytes_per_s"] * 1e6


@pytest.mark.parametrize("rows,length,table_us", [
    (96 * 312 * 8, 48, 7.99),  # IGEV eval GEV: 96x312 cells, 8 groups, D 48
    (96 * 312, 312, 1.06),  # IGEV eval correlation
    (2 * 40 * 80 * 8, 48, 1.71),  # training GEV
    (2 * 40 * 80, 80, 0.22),  # training correlation
])
def test_forward_bytes_give_the_tables_bound(rows, length, table_us):
    # the table's positions: uniform over the row, bf16 out, 2 levels
    x = torch.rand(rows, generator=torch.Generator().manual_seed(0)) * length
    assert _us(lb.forward_bytes(x, length, 2, 9, 2)) == pytest.approx(table_us, abs=0.006)


def test_a_group_repeat_counts_each_groups_row():
    x = torch.rand(500, generator=torch.Generator().manual_seed(1)) * 48
    assert lb.forward_bytes(x, 48, 2, 9, 2, repeat=8) == lb.forward_bytes(x.repeat_interleave(8), 48, 2, 9, 2)


def test_windows_in_the_interior_and_far_outside():
    # inside, the coarsest level's 10 cells of 2 entries cover the finer window
    assert lb.window_entries(torch.tensor([24.3]), 48, 2, 9) == 20
    assert lb.window_entries(torch.tensor([100.0]), 312, 4, 9) == 80
    # past the clamp every tap is zero: nothing is read
    assert lb.window_entries(torch.tensor([-500.0, 1e6]), 48, 2, 9) == 0


def _lookups(disp, shapes):
    return [[(disp, shapes)] * 3]


def test_every_share_is_at_most_100_when_the_time_is_the_bound():
    fwd = _load("lookup_roofline_pct.eval")
    gen = torch.Generator().manual_seed(2)
    for shapes, (b, h, w) in (({"corr": 80, "geo": (8, 48), "levels": 2, "radius": 4}, (2, 40, 80)),
                              ({"corr": 312, "geo": None, "levels": 4, "radius": 4}, (1, 12, 312))):
        disp = torch.rand((b, h, w), generator=gen) * 60 - 5
        lookups = _lookups(disp, shapes)
        nbytes = fwd.forward_bytes(lookups, 2)
        bound_s = nbytes / H100_PEAK["hbm_bytes_per_s"]
        kernels = {"void pyr_aligned_fwd<bf16>": [bound_s * 1e3, 3 * (1 + (shapes["geo"] is not None))]}
        rec = {"kernels": kernels, "launches": {"lookup_fwd": kernels["void pyr_aligned_fwd<bf16>"][1]},
               "lookups": lookups, "compute_itemsize": 2}
        assert fwd.read({"record": rec}) == pytest.approx(100.0)
        # any longer time reads lower
        rec["kernels"] = {k: [1.25 * ms, n] for k, (ms, n) in kernels.items()}
        assert fwd.read({"record": rec}) == pytest.approx(80.0)


def test_a_launch_count_that_disagrees_reads_nothing():
    fwd = _load("lookup_roofline_pct.eval")
    rec = {"kernels": {"pyr_aligned_fwd": [1.0, 3]}, "launches": {"lookup_fwd": 4},
           "lookups": [[None]], "compute_itemsize": 2}
    assert fwd.read({"record": rec}) is None

"""The aligned lookup's share of its roofline over the traced stretch: the
least bytes its forward calls had to move (`_lookup_bytes.py`, from each
call's positions and shapes) over the device time of its kernels, over the
card's 3.35 TB/s.  The kernels are those whose names hold the part the
program's wrapper is paired with, and their count must equal the wrapper's
launches in the stretch; None where the lookups were not seen or another
flavour ran."""

import importlib.util
from pathlib import Path

import torch

from stereo_bench.peaks import H100_PEAK, share_pct
from stereo_bench.trace import kernel_ms

_spec = importlib.util.spec_from_file_location("stereo_bench_lookup_bytes", Path(__file__).with_name("_lookup_bytes.py"))
lookup_bytes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lookup_bytes)

FWD_PART = "pyr_aligned_fwd"
BWD_PART = "pyr_aligned_bwd"


def forward_bytes(lookups, itemsize):
    """Bytes of every forward call the traced ticks made: a GEV call (a
    position a pixel, `groups` rows each) and a correlation call a lookup."""
    total = 0
    for tick in lookups:
        for seen in tick:
            if seen is None:
                return None
            disp, shapes = seen
            b, h, w = disp.shape
            taps = 2 * shapes["radius"] + 1
            if shapes["geo"] is not None:
                groups, depth = shapes["geo"]
                total += lookup_bytes.forward_bytes(disp.reshape(-1), depth, shapes["levels"], taps, itemsize,
                                                    repeat=groups)
            cx = torch.arange(w, device=disp.device, dtype=torch.float32) - disp
            total += lookup_bytes.forward_bytes(cx.reshape(-1), shapes["corr"], shapes["levels"], taps, itemsize)
    return total


def read(run):
    rec = run["record"]
    ms, n = kernel_ms(rec["kernels"], FWD_PART)
    if n == 0 or n != rec["launches"]["lookup_fwd"] or not rec["lookups"]:
        return None
    nbytes = forward_bytes(rec["lookups"], rec["compute_itemsize"])
    return None if nbytes is None else share_pct(nbytes, ms / 1e3, H100_PEAK["hbm_bytes_per_s"])

"""The comparison that decides `correct`: numbers that measure how far what
the timed path produced lies from the plain reference's answer, each held to
the limit that `stereo_bench/limits/<workload>.json` gives it.  PERF.md
records the readings each limit was set from."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def disparity_gaps(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """Gaps of one disparity map (dense, or at its queries) from the
    reference's, in pixels: the mean, median, 99th percentile and largest
    |difference|, each a number a cell's limits may name (both cells name
    the 99th percentile: it separates the program from its control by the
    most, PERF.md); a non-finite output reads inf.  `ref_mean_px`, the
    reference's mean |disparity|, is for the record."""
    prog, ref = prog.double(), ref.double()
    scale = float(ref.abs().mean())
    if not bool(torch.isfinite(prog).all()):
        return {"mean_abs_px": float("inf"), "median_abs_px": float("inf"), "p99_abs_px": float("inf"),
                "max_abs_px": float("inf"), "ref_mean_px": scale}
    d = (prog - ref).abs().reshape(-1)
    q = torch.quantile(d.float()[:: max(d.numel() // 1_000_000, 1)], torch.tensor([0.5, 0.99]))
    return {"mean_abs_px": float(d.mean()), "median_abs_px": float(q[0]), "p99_abs_px": float(q[1]),
            "max_abs_px": float(d.max()), "ref_mean_px": scale}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the answers compared."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number is within its limit when it is at most the limit."""
    checks = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks

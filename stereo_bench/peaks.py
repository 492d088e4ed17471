"""Ceilings of one NVIDIA H100 SXM at its 700 W power limit (NVIDIA's data
sheet, dense, no sparsity), copied from the program's
`utils/profiling.H100_PEAK`.  A card set below 700 W reaches less, so every
share is printed beside the card's power limit."""

H100_PEAK = {
    "bf16_flops": 989e12,  # tensor cores, fp32 accumulate
    "tf32_flops": 495e12,  # tensor cores
    "f32_flops": 67e12,  # outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}


def share_pct(amount: float, seconds: float, peak: float) -> float:
    """Achieved rate over the peak, in percent."""
    return 100.0 * amount / seconds / peak

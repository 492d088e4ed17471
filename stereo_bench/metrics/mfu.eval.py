"""FLOPs of a tick (the reference's count at the cell's shapes) over the
window's seconds a tick outside the traced stretch, as a share of the card's
bf16 peak (989 TFLOP/s a card at 700 W, times the cards; the card's power limit is printed beside
it)."""

from stereo_bench.peaks import H100_PEAK, share_pct


def read(run):
    rec = run["record"]
    if not rec["untraced_ticks"]:
        return None
    return share_pct(rec["flops_per_tick"] * rec["untraced_ticks"], rec["untraced_s"],
                     H100_PEAK["bf16_flops"] * rec["chips"])

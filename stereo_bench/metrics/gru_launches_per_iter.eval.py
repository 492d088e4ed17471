"""Host CUDA launch calls (runtime and driver: kernels, copies, sets) inside
the program's `gru` spans on the device trace's clock, over the `gru` spans
of the traced stretch; None where the record has no spans."""


def read(run):
    spans = run["record"].get("spans")
    gru = [r for r in spans["spans"] if r["name"] == "gru"] if spans else []
    return sum(r["launch_calls"] for r in gru) / len(gru) if gru else None

"""`torch.cuda.max_memory_allocated()` over set-up and window, in GiB (the
largest rank's, on more than one)."""


def read(run):
    return run["peak_bytes"] / 2 ** 30

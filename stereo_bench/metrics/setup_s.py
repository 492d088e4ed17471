"""Process start to the first timed dispatch (host clock): imports, the
kernel build or its cache, weights and inputs from the seed, warm-up."""


def read(run):
    return run["setup_s"]

"""setup_s: seconds from the start of the process to the first timed call:
imports, the kernels' build on a checkout's first run and their load,
weights, traffic, warm-up (host clock)."""


def read(run):
    return run.setup_s

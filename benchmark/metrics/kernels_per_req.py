"""kernels_per_req: the host's kernel launches in the traced stretch (the
profiler's CUDA runtime launch records), per request served in it."""


def read(run):
    if run.trace is None or not run.stretch["count"]:
        return None
    return run.trace.launches / run.stretch["count"]

"""syncs_per_req: the program's "sync" counter (each point where the host
waits for the card to drain: a readback, a copy of host memory to the
card, a tensor read as a Python value) per request of the traced stretch
(the benchmark's "bench.request" spans).

Read from the program's own record (``utils/profiling.records()``), which
holds only the traced stretch.  None where nothing was traced, or where
the program has no such record or recorded no span."""


def read(run):
    if run.trace is None:
        return None
    n = run.trace.spans.get("bench.request", 0)
    try:
        from misonet_tpu_torch.utils import profiling

        rec = profiling.records()
    except (ImportError, AttributeError):
        return None
    if not n or not rec["spans"]:
        return None
    return rec["counts"].get("sync", 0) / n

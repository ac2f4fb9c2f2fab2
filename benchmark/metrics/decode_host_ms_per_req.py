"""decode_host_ms_per_req: host milliseconds in the program's "miso1.decode"
span (``misonet_tpu_torch/inference/separate.py``: the shift stack, the
batch-6 forward's launches and the alignment) per request of the traced
stretch (the benchmark's "bench.request" spans).

Read from the program's own span record (``utils/profiling.records()``),
which holds only the traced stretch: the record fills only while a
profiler runs.  None where nothing was traced, or where the program has no
such record or ran no decode."""


def read(run):
    if run.trace is None:
        return None
    n = run.trace.spans.get("bench.request", 0)
    try:
        from misonet_tpu_torch.utils import profiling

        spans = profiling.records()["spans"]
    except (ImportError, AttributeError):
        return None
    got = [s.end_ns - s.start_ns for s in spans if s.name == "miso1.decode"]
    return 1e-6 * sum(got) / n if n and got else None

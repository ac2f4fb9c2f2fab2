"""decode_idle_ms_per_req: milliseconds the card idles while the program's
innermost open span is "miso1.decode", per request of the traced stretch
(the benchmark's "bench.request" spans).

The program's spans (``utils/profiling.records()``, stamped on the
profiler's clock) of the thread that ran the stretch, which is the thread
reading the metrics, are laid against the trace's device kernels
(``utils/profiling.idle_by_span``): a gap of at least 20 us between the
union of the kernels' intervals (the trace's own floor) is put down to the
innermost span open when it begins.  Copies and fills are not kernels, so
a copy counts as idle.  None where nothing was traced, or where the
program has no such record or ran no decode."""

import threading


def read(run):
    if run.trace is None:
        return None
    n = run.trace.spans.get("bench.request", 0)
    try:
        from misonet_tpu_torch.utils import profiling

        spans = profiling.records()["spans"]
        idle_by_span = profiling.idle_by_span
    except (ImportError, AttributeError):
        return None
    mine = [s for s in spans if s.thread == threading.get_ident()]
    if not n or not any(s.name == "miso1.decode" for s in mine):
        return None
    idle = idle_by_span(run.trace.kernels, mine)
    return 1e3 * idle.get("miso1.decode", 0.0) / n

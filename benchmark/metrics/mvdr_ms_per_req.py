"""mvdr_ms_per_req: device milliseconds under the program's "mvdr.scm" and
"mvdr.weights" ranges in the traced stretch, per request whose ranges the
profiler recorded (the benchmark's "bench.request" spans)."""

RANGES = ("mvdr.scm", "mvdr.weights")


def read(run):
    if run.trace is None:
        return None
    n = run.trace.spans.get("bench.request", 0)
    t = run.trace.range_seconds(RANGES)
    return 1e3 * t / n if n and t is not None else None

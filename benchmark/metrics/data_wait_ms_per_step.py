"""data_wait_ms_per_step: host milliseconds in the program's "h2d" spans
(``train/steps.py``: the step's batch copied to the card, which waits for
the card to drain first) per step of the traced stretch.

Read from the program's own span record (``utils/profiling.records()``),
which holds only the traced stretch.  None where nothing was traced, or
where the program has no such record or copied nothing."""


def read(run):
    if run.trace is None or not run.stretch["count"]:
        return None
    try:
        from misonet_tpu_torch.utils import profiling

        spans = profiling.records()["spans"]
    except (ImportError, AttributeError):
        return None
    got = [s.end_ns - s.start_ns for s in spans if s.name == "h2d"]
    return 1e-6 * sum(got) / run.stretch["count"] if got else None

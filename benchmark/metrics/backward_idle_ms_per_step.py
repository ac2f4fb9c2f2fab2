"""backward_idle_ms_per_step: milliseconds the card idles while the
program's innermost open span is "train.backward" (``loss.backward()`` in
``train/steps.py``), per step of the traced stretch.

The program's spans (``utils/profiling.records()``, stamped on the
profiler's clock) of the thread that ran the stretch, which is the thread
reading the metrics, are laid against the trace's device kernels
(``utils/profiling.idle_by_span``): a gap of at least 20 us between the
union of the kernels' intervals (the trace's own floor) is put down to the
innermost span open when it begins.  Copies and fills are not kernels, so
a copy counts as idle.  None where nothing was traced, or where the
program has no such record or ran no backward."""

import threading


def read(run):
    if run.trace is None or not run.stretch["count"]:
        return None
    try:
        from misonet_tpu_torch.utils import profiling

        spans = profiling.records()["spans"]
        idle_by_span = profiling.idle_by_span
    except (ImportError, AttributeError):
        return None
    mine = [s for s in spans if s.thread == threading.get_ident()]
    if not any(s.name == "train.backward" for s in mine):
        return None
    idle = idle_by_span(run.trace.kernels, mine)
    return 1e3 * idle.get("train.backward", 0.0) / run.stretch["count"]

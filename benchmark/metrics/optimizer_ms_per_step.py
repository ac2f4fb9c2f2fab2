"""optimizer_ms_per_step: device milliseconds under the program's
"train.optimizer" span (``train/state.py::Optimizer.update``: the global
norm, the NaN guard, the clip and the inner optimizer's step) per step of
the traced stretch.  None where nothing was traced or the stretch ran no
such span."""


def read(run):
    if run.trace is None or not run.stretch["count"]:
        return None
    t = run.trace.range_seconds(("train.optimizer",))
    return 1e3 * t / run.stretch["count"] if t is not None else None

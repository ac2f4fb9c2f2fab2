"""train_step_ms: the window's wall time, which ends in a synchronize, over
the optimizer steps completed in it (host clock)."""


def read(run):
    w = run.window
    return 1e3 * w["seconds"] / w["steps"] if w.get("steps") else None

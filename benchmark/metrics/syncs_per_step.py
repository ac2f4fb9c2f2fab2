"""syncs_per_step: the program's "sync" counter (each point where the host
waits for the card to drain: the batch's copy to the card, the NaN guard's
and the clip's reads of a tensor as a Python value) per step of the traced
stretch.

Read from the program's own record (``utils/profiling.records()``), which
holds only the traced stretch.  None where nothing was traced, or where
the program has no such record or recorded no span."""


def read(run):
    if run.trace is None or not run.stretch["count"]:
        return None
    try:
        from misonet_tpu_torch.utils import profiling

        rec = profiling.records()
    except (ImportError, AttributeError):
        return None
    if not rec["spans"]:
        return None
    return rec["counts"].get("sync", 0) / run.stretch["count"]

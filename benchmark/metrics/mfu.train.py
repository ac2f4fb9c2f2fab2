"""mfu.train: 3 x the forward FLOPs of the batch (``work.py``) per step, over
``train_step_ms``, as a share of the card's published peak in the
configuration's precision (``peaks.json``)."""


def read(run):
    w = run.window
    if not w.get("steps"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / run.peaks[run.cfg["precision"]]

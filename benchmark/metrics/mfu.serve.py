"""mfu.serve: the model FLOPs of the window's completed requests (their real
chunks; the bucket's padding is not counted; ``work.py``), over the
window's seconds, as a share of the card's published peak in the
configuration's precision (``peaks.json``)."""


def read(run):
    w = run.window
    if "audio_s" not in w or not w.get("flops"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / run.peaks[run.cfg["precision"]]

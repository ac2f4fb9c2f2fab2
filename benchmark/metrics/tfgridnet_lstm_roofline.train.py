"""tfgridnet_lstm_roofline.train: the least time the card could take for
TF-GridNet's BLSTMs in the traced stretch (their forward and backward FLOPs
and bytes, counted by ``work_tfgridnet.py`` over the stretch's passes,
against the configuration's peak and HBM bandwidth, ``peaks.json``), over
their device time: the kernels launched under the program's "tfgridnet.rnn"
spans (each BLSTM call of the forward) and "tfgridnet.rnn_bwd" spans (each
BLSTM's autograd node in the backward), in %.  None where nothing was
traced or the stretch ran no BLSTM forward and backward."""

from benchmark import work_tfgridnet

SPANS = ("tfgridnet.rnn", "tfgridnet.rnn_bwd")


def work_of(run) -> tuple[int, int]:
    passes = run.stretch["passes"]
    fwd = work_tfgridnet.of_passes(run.cfg, passes, "lstm")
    bwd = work_tfgridnet.of_passes(run.cfg, passes, "lstm", backward=True)
    return fwd[0] + bwd[0], fwd[1] + bwd[1]


def read(run):
    if run.trace is None or not all(s in run.trace.ranges for s in SPANS):
        return None
    t = run.trace.range_seconds(SPANS)
    if not t:
        return None
    flops, nbytes = work_of(run)
    p = run.peaks
    return 100.0 * max(flops / p[run.cfg["precision"]],
                       nbytes / p["hbm_bytes_per_s"]) / t

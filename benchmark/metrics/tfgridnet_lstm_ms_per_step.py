"""tfgridnet_lstm_ms_per_step: device milliseconds of TF-GridNet's BLSTMs
per step of the traced stretch: the kernels launched under the program's
"tfgridnet.rnn" spans (each BLSTM call of the forward, ``torch.lstm``) and
its "tfgridnet.rnn_bwd" spans (each BLSTM's autograd node in the backward).
None where nothing was traced or the stretch ran no BLSTM forward and
backward."""

SPANS = ("tfgridnet.rnn", "tfgridnet.rnn_bwd")


def read(run):
    if (run.trace is None or not run.stretch["count"]
            or not all(s in run.trace.ranges for s in SPANS)):
        return None
    return 1e3 * run.trace.range_seconds(SPANS) / run.stretch["count"]

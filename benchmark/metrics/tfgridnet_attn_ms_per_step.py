"""tfgridnet_attn_ms_per_step: device milliseconds under the program's
"tfgridnet.attn" spans (each GridNet block's cross-frame self-attention in
the forward: the Q, K and V projections, the scores, the softmax, the
heads' output and their projection) per step of the traced stretch.  None
where nothing was traced or the stretch ran no such span."""


def read(run):
    if run.trace is None or not run.stretch["count"]:
        return None
    t = run.trace.range_seconds(("tfgridnet.attn",))
    return 1e3 * t / run.stretch["count"] if t is not None else None

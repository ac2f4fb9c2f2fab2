"""stencil_bwd_roofline.train: the least time the card could take for the
backward of the fused U-Net convs in the traced stretch (a weight gradient
for each, an input gradient where one is needed; max of FLOPs over the
configuration's peak and bytes over HBM bandwidth, counted by ``work.py``
over the stretch's passes), over the device time of the kernels named
here, in %."""

from benchmark import trace, work

KERNELS = ("dgrad_tc_kernel", "wgrad_tc_kernel")
TRAILING = ("wgrad_reduce_kernel", "reduce_stats_kernel")
GROUPS = ("dense_stack", "stencil")   # the convs whose backward it runs


def work_of(run) -> tuple[int, int]:
    got = [work.of_passes(run.cfg, run.stretch["passes"], g, backward=True)
           for g in GROUPS]
    return sum(f for f, _ in got), sum(b for _, b in got)


def read(run):
    if run.trace is None:
        return None
    return trace.roofline(run, KERNELS, TRAILING, *work_of(run))

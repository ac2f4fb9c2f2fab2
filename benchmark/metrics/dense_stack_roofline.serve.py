"""dense_stack_roofline.serve: the least time the card could take for the
DenseBlocks' forward work in the traced stretch (max of FLOPs over the
configuration's peak and bytes over HBM bandwidth, counted by ``work.py``
from the blocks' shapes over the stretch's passes, the bucket's padded
chunks included, since the kernels are given them), over the device time
of the kernels named here, in %."""

from benchmark import trace, work

KERNELS = ("dense_stack_tc_kernel",)
TRAILING = ("reduce_stats_kernel",)   # its statistics' second pass


def work_of(run) -> tuple[int, int]:
    return work.of_passes(run.cfg, run.stretch["passes"], "dense_stack")


def read(run):
    if run.trace is None:
        return None
    return trace.roofline(run, KERNELS, TRAILING, *work_of(run))

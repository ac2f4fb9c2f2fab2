"""glue_ms_per_step: device milliseconds per step of the traced stretch in
kernels that are not the program's hand kernels (``HAND`` names them):
the PyTorch ops between the kernels."""

HAND = ("dense_stack_tc_kernel", "dense_stack_int8_tc_kernel",
        "quantize_rows_kernel", "stencil_tc_kernel", "dgrad_tc_kernel",
        "wgrad_tc_kernel", "wgrad_reduce_kernel", "reduce_stats_kernel",
        "pack_tf32_kernel", "mvdr_weights_kernel", "hermitian_solve_kernel")


def read(run):
    if run.trace is None or not run.stretch["count"]:
        return None
    glue = sum(dur for name, _, dur in run.trace.kernels
               if not any(h in name for h in HAND)) / 1e9
    return 1e3 * glue / run.stretch["count"]

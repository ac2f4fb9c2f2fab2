"""Hand-written CUDA kernels for Hopper (sources in ``misonet_tpu_torch/csrc``).

Each kernel module holds the wrapper that launches the kernel on CUDA
tensors, its plain PyTorch version (run for CPU tensors and used as the
reference on the card), and a plain-int launch counter per mode on the
wrapper: ``launches`` (float32 and the single-mode kernels) and
``launches_bf16`` (the bfloat16 modes of ``dense_stack``, ``dense_layer``,
``stencil`` and ``stencil_bwd``)."""

from misonet_tpu_torch.ops.kernels.dense_layer import dense_layer
from misonet_tpu_torch.ops.kernels.dense_stack import dense_stack
from misonet_tpu_torch.ops.kernels.dense_stack_int8 import dense_stack_int8
from misonet_tpu_torch.ops.kernels.hermitian_solve import hermitian_solve
from misonet_tpu_torch.ops.kernels.mvdr_weights import mvdr_weights
from misonet_tpu_torch.ops.kernels.stencil import stencil
from misonet_tpu_torch.ops.kernels.stencil_bwd import stencil_bwd

KERNELS = (dense_stack, stencil, stencil_bwd, hermitian_solve,
           dense_stack_int8, dense_layer, mvdr_weights)
# (name, wrapper, counter attribute) of every counted kernel mode
COUNTERS = tuple(
    (k.__name__ + suffix, k, "launches" + suffix)
    for k in KERNELS for suffix in ("", "_bf16")
    if hasattr(k, "launches" + suffix)
)


def reset_launch_counts() -> None:
    for _, k, attr in COUNTERS:
        setattr(k, attr, 0)


def launch_counts() -> dict[str, int]:
    """{mode name: launches}: ``dense_stack``, ``dense_stack_bf16``,
    ``stencil``, ``stencil_bf16``, ``stencil_bwd``, ``stencil_bwd_bf16``,
    ``hermitian_solve``, ``dense_stack_int8``, ``dense_layer``,
    ``dense_layer_bf16``, ``mvdr_weights``."""
    return {name: getattr(k, attr) for name, k, attr in COUNTERS}

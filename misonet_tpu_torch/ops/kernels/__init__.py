"""Hand-written CUDA kernels for Hopper (sources in ``misonet_tpu_torch/csrc``).

Each kernel module holds the wrapper that launches the kernel on CUDA
tensors, its plain PyTorch version (run for CPU tensors and used as the
reference on the card), and a plain-int launch counter on the wrapper."""

from misonet_tpu_torch.ops.kernels.dense_stack import dense_stack
from misonet_tpu_torch.ops.kernels.stencil import stencil
from misonet_tpu_torch.ops.kernels.stencil_bwd import stencil_bwd

KERNELS = (dense_stack, stencil, stencil_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}

"""Kernel 1: one input-grouped ("stacked") DenseBlock call.

Replaces misonet_tpu/ops/pallas/dense_stack.py::dense_stack_flat in its
float32 ("precise") and bfloat16 (precise=False) modes; its int8 decode mode
is ``ops/kernels/dense_stack_int8.py``.  For the newly available source
tensor(s) of a DenseBlock
it convolves their normalized values with the stacked 3x3 kernels of every
layer that consumes them, adds the incoming partial pre-activations,
finalizes the first ``n_fin`` rows (bias + ELU + per-(b, c) sum/sumsq) and
passes the remaining rows on as partials.  CUDA source:
``misonet_tpu_torch/csrc/dense_stack.cu`` (what bounds it on the H100 and
how the design answers that is written at the top of that file).

The mode follows the sources' dtype.  float32: every tensor float32.
bfloat16: the sources, ``acc_in``, ``w_stack`` and the outputs ``y`` and
``acc_out`` are bfloat16; ``bias``, ``scale``, ``mean`` and the sums stay
float32.  The bfloat16 mode rounds where the TPU kernel does: the
normalized input (its bf16 patch) and the weights are bfloat16, the
products are summed in float32, ``acc_out`` and ``y`` are rounded for the
store, and the statistics come from the float32 ``y``.  Both modes run
their products on the tensor cores and read ``w_stack`` packed by
``tc_pack.packed`` (cached per weight tensor and version): float32 as
three TF32 passes over split operands (its weight as two TF32 planes, one
``pack_tf32`` launch per weight version), bfloat16 as bf16 products.

``dense_stack`` launches the kernel for CUDA tensors (raising on anything
it does not take) and runs ``dense_stack_plain`` for CPU tensors.  Each
mode has its own launch counter: ``dense_stack.launches`` (float32) and
``dense_stack.launches_bf16``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from misonet_tpu_torch.ops.kernels import build, tc_pack

_P = ctypes.c_void_p
_I = ctypes.c_int


DTYPES = (torch.float32, torch.bfloat16)


def dense_stack_plain(xs, acc_in, w_stack, bias, scale, mean, n_fin):
    """Plain PyTorch version: same arguments and results as
    :func:`dense_stack`.  In the bfloat16 mode it runs float32 convs of the
    bfloat16-rounded normalized input and weights, so it rounds at the
    kernel's points (with TF32 off, only the order of the sums differs)."""
    dtype = xs[0].dtype
    x = torch.cat([x.float() for x in xs], dim=1)
    xn = ((x - mean[:, :, None, None]) * scale[:, :, None, None]).to(dtype)
    z = F.conv2d(xn.float(), w_stack.float(), padding=1)
    if acc_in is not None:
        z = z + acc_in.float()
    y = F.elu(z[:, :n_fin] + bias[None, :, None, None])
    acc_out = (z[:, n_fin:].to(dtype).contiguous() if z.shape[1] > n_fin
               else None)
    return y.to(dtype), y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3)), acc_out


def check_tensor(kernel, name, t, shape, device, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(
            f"{kernel}: {name} must be {dtype} on {device}, got "
            f"{t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def dense_stack(xs, acc_in, w_stack, bias, scale, mean, n_fin: int):
    """One stacked DenseBlock call.

    xs        1 or 2 raw source tensors [B, c_i, T, F] (logical concat)
    acc_in    [B, N, T, F] partial pre-activations, or None
    w_stack   [N, sum(c_i), 3, 3] stacked kernels of the consuming layers
              (the sources' dtype)
    bias      [n_fin] bias of the layer being finalized (float32)
    scale     [B, sum(c_i)] per-channel 1/sigma of the sources
    mean      [B, sum(c_i)] per-channel mean of the sources

    Returns (y [B, n_fin, T, F], sums [B, n_fin], sqs [B, n_fin],
    acc_out [B, N - n_fin, T, F] or None when N == n_fin)."""
    xs = tuple(xs)
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"dense_stack takes 1 or 2 sources, got {len(xs)}")
    device = xs[0].device
    if device.type == "cpu":
        return dense_stack_plain(xs, acc_in, w_stack, bias, scale, mean,
                                 n_fin)
    if device.type != "cuda":
        raise ValueError(f"dense_stack: unsupported device {device}")
    dtype = xs[0].dtype
    if dtype not in DTYPES:
        raise ValueError(f"dense_stack: sources must be float32 or bfloat16, "
                         f"got {dtype}")
    b, _, t, f = xs[0].shape
    widths = [int(x.shape[1]) for x in xs]
    c_tot = sum(widths)
    n = int(w_stack.shape[0])
    if not 0 < n_fin <= n:
        raise ValueError(f"dense_stack: n_fin={n_fin} outside (0, {n}]")

    def check(name, t_, shape, dt=dtype):
        check_tensor("dense_stack", name, t_, shape, device, dt)

    for i, x in enumerate(xs):
        check(f"xs[{i}]", x, (b, widths[i], t, f))
    check("w_stack", w_stack, (n, c_tot, 3, 3))
    check("bias", bias, (n_fin,), torch.float32)
    check("scale", scale, (b, c_tot), torch.float32)
    check("mean", mean, (b, c_tot), torch.float32)
    if acc_in is not None:
        check("acc_in", acc_in, (b, n, t, f))

    lib = library()
    bf16 = dtype == torch.bfloat16
    entry = lib.misonet_dense_stack_bf16 if bf16 else lib.misonet_dense_stack
    ntiles = pos_tiles(lib, bf16, t, f)
    y = torch.empty((b, n_fin, t, f), device=device, dtype=dtype)
    acc_out = (torch.empty((b, n - n_fin, t, f), device=device, dtype=dtype)
               if n > n_fin else None)
    part = torch.empty((2, b, n_fin, ntiles), device=device)
    sums = torch.empty((b, n_fin), device=device)
    sqs = torch.empty((b, n_fin), device=device)
    # the kernel reads its weights packed for its tensor cores
    wk = tc_pack.packed(w_stack, widths)
    x1 = xs[1].data_ptr() if len(xs) == 2 else None
    with torch.cuda.device(device):
        err = entry(
            xs[0].data_ptr(), widths[0], x1,
            widths[1] if len(xs) == 2 else 0,
            scale.data_ptr(), mean.data_ptr(), wk.data_ptr(),
            bias.data_ptr(),
            acc_in.data_ptr() if acc_in is not None else None,
            y.data_ptr(),
            acc_out.data_ptr() if acc_out is not None else None,
            part.data_ptr(), sums.data_ptr(), sqs.data_ptr(),
            b, t, f, n, n_fin, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"dense_stack kernel launch failed: CUDA error {err}")
    if bf16:
        build.count_launch(dense_stack, "launches_bf16")
    else:
        build.count_launch(dense_stack, "launches")
    return y, sums, sqs, acc_out


dense_stack.launches = 0
dense_stack.launches_bf16 = 0


def pos_tiles(lib, bf16: bool, t: int, f: int) -> int:
    """Position tiles of the kernel's T x F output plane in the mode
    (``misonet_dense_pos_tiles``), one statistics partial each per (batch,
    channel)."""
    return lib.misonet_dense_pos_tiles(t, f, int(bf16))


def library() -> ctypes.CDLL:
    lib = build.library()
    for entry in (lib.misonet_dense_stack, lib.misonet_dense_stack_bf16):
        entry.argtypes = [
            _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _P,
        ]
        entry.restype = _I
    lib.misonet_dense_pos_tiles.argtypes = [_I, _I, _I]
    lib.misonet_dense_pos_tiles.restype = _I
    return lib

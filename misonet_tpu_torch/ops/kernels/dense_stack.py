"""Kernel 1: one input-grouped ("stacked") DenseBlock call.

Replaces misonet_tpu/ops/pallas/dense_stack.py::dense_stack_flat (float32
"precise" mode).  For the newly available source tensor(s) of a DenseBlock
it convolves their normalized values with the stacked 3x3 kernels of every
layer that consumes them, adds the incoming partial pre-activations,
finalizes the first ``n_fin`` rows (bias + ELU + per-(b, c) sum/sumsq) and
passes the remaining rows on as partials.  CUDA source:
``misonet_tpu_torch/csrc/dense_stack.cu`` (what bounds it on the H100 and
how the design answers that is written at the top of that file).

``dense_stack`` launches the kernel for CUDA tensors (raising on anything
it does not take) and runs ``dense_stack_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from misonet_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def dense_stack_plain(xs, acc_in, w_stack, bias, scale, mean, n_fin):
    """Plain PyTorch version: same arguments and results as
    :func:`dense_stack`."""
    x = torch.cat(list(xs), dim=1)
    xn = (x - mean[:, :, None, None]) * scale[:, :, None, None]
    z = F.conv2d(xn, w_stack, padding=1)
    if acc_in is not None:
        z = z + acc_in
    y = F.elu(z[:, :n_fin] + bias[None, :, None, None])
    acc_out = z[:, n_fin:].contiguous() if z.shape[1] > n_fin else None
    return y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3)), acc_out


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(
            f"dense_stack: {name} must be float32 on {device}, got "
            f"{t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"dense_stack: {name} shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"dense_stack: {name} must be contiguous")


def dense_stack(xs, acc_in, w_stack, bias, scale, mean, n_fin: int):
    """One stacked DenseBlock call.

    xs        1 or 2 raw source tensors [B, c_i, T, F] (logical concat)
    acc_in    [B, N, T, F] partial pre-activations, or None
    w_stack   [N, sum(c_i), 3, 3] stacked kernels of the consuming layers
    bias      [n_fin] bias of the layer being finalized
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
    b, _, t, f = xs[0].shape
    widths = [int(x.shape[1]) for x in xs]
    c_tot = sum(widths)
    n = int(w_stack.shape[0])
    if not 0 < n_fin <= n:
        raise ValueError(f"dense_stack: n_fin={n_fin} outside (0, {n}]")
    for i, x in enumerate(xs):
        _check(f"xs[{i}]", x, (b, widths[i], t, f), device)
    _check("w_stack", w_stack, (n, c_tot, 3, 3), device)
    _check("bias", bias, (n_fin,), device)
    _check("scale", scale, (b, c_tot), device)
    _check("mean", mean, (b, c_tot), device)
    if acc_in is not None:
        _check("acc_in", acc_in, (b, n, t, f), device)

    lib = library()
    ntiles = -(-(t * f) // lib.misonet_pos_tile())
    y = torch.empty((b, n_fin, t, f), device=device)
    acc_out = (torch.empty((b, n - n_fin, t, f), device=device)
               if n > n_fin else None)
    part = torch.empty((2, b, n_fin, ntiles), device=device)
    sums = torch.empty((b, n_fin), device=device)
    sqs = torch.empty((b, n_fin), device=device)
    x1 = xs[1].data_ptr() if len(xs) == 2 else None
    with torch.cuda.device(device):
        err = lib.misonet_dense_stack(
            xs[0].data_ptr(), widths[0], x1,
            widths[1] if len(xs) == 2 else 0,
            scale.data_ptr(), mean.data_ptr(), w_stack.data_ptr(),
            bias.data_ptr(),
            acc_in.data_ptr() if acc_in is not None else None,
            y.data_ptr(),
            acc_out.data_ptr() if acc_out is not None else None,
            part.data_ptr(), sums.data_ptr(), sqs.data_ptr(),
            b, t, f, n, n_fin, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"dense_stack kernel launch failed: CUDA error {err}")
    dense_stack.launches += 1
    return y, sums, sqs, acc_out


dense_stack.launches = 0


def library() -> ctypes.CDLL:
    lib = build.library()
    lib.misonet_dense_stack.argtypes = [
        _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _P,
    ]
    lib.misonet_dense_stack.restype = _I
    lib.misonet_pos_tile.argtypes = []
    lib.misonet_pos_tile.restype = _I
    return lib

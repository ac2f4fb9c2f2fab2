"""Kernel 2.6: one whole DenseBlock layer over any number of raw sources.

Replaces misonet_tpu/ops/pallas/dense_flat.py::dense_layer_flat in its
float32 ("precise") and bfloat16 (precise=False) modes:

    y = ELU(conv3x3_SAME(normalize(concat(xs))) + bias)

with ``normalize(x) = (x - mean) * scale`` per (b, c), zero padding after
normalizing, and with ``want_stats`` the per-(b, c) sum and sum of squares
of y.  ``fuse_elu=False`` skips the ELU (the statistics are then of the
pre-ELU value).  The concat stays logical: each source is read in place.
No path of either package calls it (the DenseBlocks run the stacked
``dense_stack``); it has no autograd, as the JAX kernel has none.

CUDA source: ``misonet_tpu_torch/csrc/dense_stack.cu`` (entry points
``misonet_dense_layer`` and ``misonet_dense_layer_bf16``): the
``dense_stack`` kernel on the tensor cores (three TF32 passes in float32,
bf16 products in bf16, the weight packed by ``tc_pack.packed``) with no
partials in or out, every row finalized, up to ``MAX_SOURCES`` sources and
the two switches.

The mode follows the sources' dtype, as in ``dense_stack``: float32
throughout, or bfloat16 sources, weights and y with float32 bias, scale,
mean and sums; the bfloat16 mode rounds the centred normalized input
``bf16((x - mean) * scale)``, sums bf16 x bf16 products in float32, and
takes the statistics from the float32 y before it is rounded for the store.

``dense_layer`` launches the kernel for CUDA tensors (raising on anything
it does not take) and runs ``dense_layer_plain`` for CPU tensors.  Launch
counters: ``dense_layer.launches`` (float32) and
``dense_layer.launches_bf16``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from misonet_tpu_torch.ops.kernels import build, tc_pack
from misonet_tpu_torch.ops.kernels.dense_stack import (
    DTYPES, check_tensor, pos_tiles, library as dense_stack_library)

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_SOURCES = 8  # csrc/dense_stack.cu's MAX_SOURCES (it refuses more)


def dense_layer_plain(xs, w, bias, scale, mean, *, fuse_elu=True,
                      want_stats=True):
    """Plain PyTorch version: same arguments and results as
    :func:`dense_layer`.  In the bfloat16 mode it runs a float32 conv of the
    bfloat16-rounded normalized input and weights, so it rounds at the
    kernel's points (with TF32 off, only the order of the sums differs)."""
    dtype = xs[0].dtype
    x = torch.cat([x.float() for x in xs], dim=1)
    xn = ((x - mean[:, :, None, None]) * scale[:, :, None, None]).to(dtype)
    y = F.conv2d(xn.float(), w.float(), padding=1) + bias[None, :, None, None]
    if fuse_elu:
        y = F.elu(y)
    if not want_stats:
        return y.to(dtype), None, None
    return y.to(dtype), y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))


def dense_layer(xs, w, bias, scale, mean, *, fuse_elu: bool = True,
                want_stats: bool = True):
    """One DenseBlock layer.

    xs     1 to MAX_SOURCES raw source tensors [B, c_i, T, F] (logical
           concat), float32 or bfloat16
    w      [N, sum(c_i), 3, 3] the layer's kernel (the sources' dtype)
    bias   [N] float32
    scale  [B, sum(c_i)] per-channel 1/sigma of the sources (float32)
    mean   [B, sum(c_i)] per-channel mean of the sources (float32)

    Returns (y [B, N, T, F] in the sources' dtype, sums [B, N], sqs [B, N]),
    the sums float32, or None for both without ``want_stats``."""
    xs = tuple(xs)
    if not 1 <= len(xs) <= MAX_SOURCES:
        raise ValueError(f"dense_layer takes 1 to {MAX_SOURCES} sources, "
                         f"got {len(xs)}")
    device = xs[0].device
    if device.type == "cpu":
        return dense_layer_plain(xs, w, bias, scale, mean, fuse_elu=fuse_elu,
                                 want_stats=want_stats)
    if device.type != "cuda":
        raise ValueError(f"dense_layer: unsupported device {device}")
    dtype = xs[0].dtype
    if dtype not in DTYPES:
        raise ValueError(f"dense_layer: sources must be float32 or bfloat16, "
                         f"got {dtype}")
    b, _, t, f = xs[0].shape
    widths = [int(x.shape[1]) for x in xs]
    c_tot = sum(widths)
    n = int(w.shape[0])

    def check(name, t_, shape, dt=dtype):
        check_tensor("dense_layer", name, t_, shape, device, dt)

    for i, x in enumerate(xs):
        check(f"xs[{i}]", x, (b, widths[i], t, f))
    check("w", w, (n, c_tot, 3, 3))
    check("bias", bias, (n,), torch.float32)
    check("scale", scale, (b, c_tot), torch.float32)
    check("mean", mean, (b, c_tot), torch.float32)

    lib = library()
    bf16 = dtype == torch.bfloat16
    entry = lib.misonet_dense_layer_bf16 if bf16 else lib.misonet_dense_layer
    y = torch.empty((b, n, t, f), device=device, dtype=dtype)
    sums = sqs = part = None
    if want_stats:
        ntiles = pos_tiles(lib, bf16, t, f)
        part = torch.empty((2, b, n, ntiles), device=device)
        sums = torch.empty((b, n), device=device)
        sqs = torch.empty((b, n), device=device)
    # the kernel reads its weights packed for its tensor cores
    wk = tc_pack.packed(w, widths)
    ptrs = (_P * len(xs))(*(x.data_ptr() for x in xs))
    cs = (_I * len(xs))(*widths)

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(device):
        err = entry(
            ptrs, cs, len(xs), scale.data_ptr(), mean.data_ptr(),
            wk.data_ptr(), bias.data_ptr(), y.data_ptr(), ptr(part),
            ptr(sums), ptr(sqs), b, t, f, n, int(fuse_elu), int(want_stats),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"dense_layer kernel launch failed: CUDA error {err}")
    if bf16:
        build.count_launch(dense_layer, "launches_bf16")
    else:
        build.count_launch(dense_layer, "launches")
    return y, sums, sqs


dense_layer.launches = 0
dense_layer.launches_bf16 = 0


def library() -> ctypes.CDLL:
    lib = dense_stack_library()
    for entry in (lib.misonet_dense_layer, lib.misonet_dense_layer_bf16):
        entry.argtypes = [
            ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P, _P, _P, _P, _P,
            _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
        ]
        entry.restype = _I
    return lib

"""Kernel 2.5: the int8 decode mode of the stacked DenseBlock call.

Replaces misonet_tpu/ops/pallas/dense_stack.py::dense_stack_flat with
``quant=True`` (the JAX package's ``ModelConfig.quant_int8`` on a bf16
model; decode only).  Same arguments and results as the bfloat16 mode of
:func:`~misonet_tpu_torch.ops.kernels.dense_stack.dense_stack`, with
``w_stack`` float32, and the same quantized quantities as the TPU kernel:

* activations: ``q_x = clip(rint(16 * (x * scale)), -127, 127)`` of the
  stored bfloat16 raw sources (uncentred, zero halo; the mean enters
  through the correction coefficients below);
* weight rows, per batch element b and output row n: the 9 x C conv
  weights followed by the 9 mean-correction coefficients of the TPU
  kernel's ``stack_wb`` (from ``beta = -sum_c w * mean * scale``),
  quantized with one row scale ``rs = max(max|row|, 1e-20) / 127`` over the
  whole row, coefficients included;
* ``z = rs / 16 * (sum q_w q_x + 16 * sum_j q_coef_j field_j(t, f))``
  exactly in int32, then the bfloat16 epilogue (+ ``acc_in``, + bias, ELU,
  statistics from the float32 ``y``, ``y`` and ``acc_out`` bfloat16).

The rows depend on ``mean * scale`` and so on the batch element; they are
built once per call, as the JAX package builds them in XLA outside its
``pallas_call``: on the card by one kernel launch
(:func:`quantize_rows_packed`, ``quantize_rows_kernel``), whose plain twin
is :func:`quantize_rows` (+ ``tc_pack.pack_int8_rows``).  Both take beta
and the coefficients as float64 sums of the float32 products, rounded once
to float32, so the card's rows equal the plain version's.  CUDA source:
``misonet_tpu_torch/csrc/dense_stack_int8.cu`` (the row kernel and the
int8 tensor-core kernel; what bounds them on the H100 and how the design
answers that is written at the top of that file).

``dense_stack_int8`` launches the kernels for CUDA tensors (raising on any
shape or dtype it does not take, and on source widths that are not
multiples of 4) and runs ``dense_stack_int8_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from misonet_tpu_torch.ops.kernels import build
from misonet_tpu_torch.ops.kernels.dense_stack import check_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

# The static activation scale of the JAX package's int8 mode
# (misonet_tpu/ops/pallas/dense_stack.py: QS): activations are
# InstanceNorm-scaled, so round(16 x) clips at +-7.94 sigma, and the 0/1
# indicator fields quantize exactly to 16.
QS = 16.0


@functools.cache
def _fields(device) -> torch.Tensor:
    """int32 [16, 9]: the TPU kernel's 9 indicator fields (ones, t == 0,
    t == T-1, f == 0, f == F-1, the four corners) for each edge class, bit
    0 t == 0, bit 1 t == T-1, bit 2 f == 0, bit 3 f == F-1."""
    rows = []
    for e in range(16):
        t0, tn, f0, fn = (e >> k & 1 for k in range(4))
        rows.append([1, t0, tn, f0, fn, t0 * f0, t0 * fn, tn * f0, tn * fn])
    return torch.tensor(rows, dtype=torch.int32, device=device)


def quantize_rows(w_stack, scale, mean):
    """The TPU kernel's quantized weight rows for one call.

    w_stack float32 [N, C, 3, 3], scale / mean float32 [B, C] ->
    (qw int8 [B, N, 9, C] (tap-major, channels fastest),
     corr int32 [B, N, 16] (16 * the coefficients' sum for each edge class),
     rq float32 [B, N] (the row scale over 16)).

    beta and the coefficients are float64 sums of the float32 products
    ``w * (mean * scale)`` (exact in float64), rounded once to float32, as
    the card's row kernel takes them: sums in another order then differ
    only where a float64 value sits on a float32 rounding tie."""
    n, c = w_stack.shape[:2]
    b = scale.shape[0]
    beta = -torch.einsum("ncij,bc->bnij", w_stack.double(),
                         (mean * scale).double())
    coef = torch.stack([
        beta.sum(dim=(2, 3)),
        -beta[:, :, 0, :].sum(-1), -beta[:, :, 2, :].sum(-1),
        -beta[:, :, :, 0].sum(-1), -beta[:, :, :, 2].sum(-1),
        beta[:, :, 0, 0], beta[:, :, 0, 2], beta[:, :, 2, 0], beta[:, :, 2, 2],
    ], dim=2).float()                                      # [B, N, 9]
    w_rows = w_stack.permute(0, 2, 3, 1).reshape(n, 9 * c)
    row_max = torch.maximum(w_rows.abs().amax(dim=1), coef.abs().amax(dim=2))
    # a divisor on the tensors' device: PyTorch's CUDA division by a Python
    # number multiplies by its reciprocal, one ulp off the quotient the row
    # kernel (and the CPU) take
    rs = torch.clamp(row_max, min=1e-20) / row_max.new_tensor(127.0)

    def q(v):
        return torch.clamp(torch.round(v / rs[..., None]), -127.0, 127.0)

    qw = q(w_rows).to(torch.int8).reshape(b, n, 9, c)
    qc = q(coef).to(torch.int32)
    corr = (qc[:, :, None, :] * _fields(qc.device)).sum(-1) * int(QS)
    return qw, corr.to(torch.int32).contiguous(), rs / QS


def quantize_rows_packed(w_stack, scale, mean, widths):
    """The rows of one int8 call in the tensor-core kernel's layout:
    (qw int8 [B, G16, 9, N, 16] (tc_pack.pack_int8_rows), corr int32
    [B, N, 16], rq float32 [B, N]): one launch of
    ``quantize_rows_kernel``, CUDA tensors only (its plain twin is
    :func:`quantize_rows` + ``tc_pack.pack_int8_rows``).  Arguments as
    :func:`quantize_rows`; ``widths`` the 1 or 2 source widths."""
    widths = [int(c) for c in widths]
    device = w_stack.device
    if device.type != "cuda":
        raise ValueError(f"quantize_rows_packed: unsupported device {device}")
    if not 1 <= len(widths) <= 2:
        raise ValueError("quantize_rows_packed takes 1 or 2 source widths, "
                         f"got {widths}")
    n, c_tot = int(w_stack.shape[0]), sum(widths)
    b = int(scale.shape[0])

    def check(name, t_, shape):
        check_tensor("quantize_rows_packed", name, t_, shape, device)

    check("w_stack", w_stack, (n, c_tot, 3, 3))
    check("scale", scale, (b, c_tot))
    check("mean", mean, (b, c_tot))
    groups = sum(-(-c // 16) for c in widths)
    qw = torch.empty((b, groups, 9, n, 16), device=device, dtype=torch.int8)
    corr = torch.empty((b, n, 16), device=device, dtype=torch.int32)
    rq = torch.empty((b, n), device=device)
    with torch.cuda.device(device):
        err = library().misonet_quantize_rows_int8(
            w_stack.data_ptr(), scale.data_ptr(), mean.data_ptr(), widths[0],
            widths[1] if len(widths) == 2 else 0, b, n, qw.data_ptr(),
            corr.data_ptr(), rq.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"quantize_rows_kernel launch failed: CUDA error {err}")
    build.count_launch(quantize_rows_packed, "launches")
    return qw, corr, rq


# launches of the row kernel (part of each dense_stack_int8 call, so not
# one of launch_counts()'s kernel modes)
quantize_rows_packed.launches = 0


def _edge_class(t: int, f: int, device) -> torch.Tensor:
    """int64 [T, F]: each position's edge class (see :func:`_fields`)."""
    ti = torch.arange(t, device=device)[:, None]
    fi = torch.arange(f, device=device)[None, :]
    return ((ti == 0).long() | (ti == t - 1).long() << 1
            | (fi == 0).long() << 2 | (fi == f - 1).long() << 3)


def dense_stack_int8_plain(xs, acc_in, w_stack, bias, scale, mean, n_fin):
    """Plain PyTorch version: same arguments and results as
    :func:`dense_stack_int8`.  The integer sums run as a float64 conv of the
    quantized values, exact at any width (|sum| < 2^53)."""
    qw, corr, rq = quantize_rows(w_stack, scale, mean)
    x = torch.cat([x.float() for x in xs], dim=1)
    b, c, t, f = x.shape
    n = qw.shape[1]
    qx = torch.clamp(torch.round(x * scale[:, :, None, None] * QS),
                     -127.0, 127.0).double()
    wq = qw.double().permute(0, 1, 3, 2).reshape(b * n, c, 3, 3)
    zi = F.conv2d(qx.reshape(1, b * c, t, f), wq, padding=1, groups=b)
    zi = zi.reshape(b, n, t, f) + corr[:, :, _edge_class(t, f, x.device)]
    z = zi.float() * rq[:, :, None, None]
    if acc_in is not None:
        z = z + acc_in.float()
    y = F.elu(z[:, :n_fin] + bias[None, :, None, None])
    acc_out = (z[:, n_fin:].to(torch.bfloat16).contiguous() if n > n_fin
               else None)
    return (y.to(torch.bfloat16), y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3)),
            acc_out)


def dense_stack_int8(xs, acc_in, w_stack, bias, scale, mean, n_fin: int):
    """One stacked DenseBlock call in the int8 decode mode.

    xs        1 or 2 raw bfloat16 source tensors [B, c_i, T, F], c_i a
              multiple of 4 (the kernel pads each to 16 channels)
    acc_in    bfloat16 [B, N, T, F] partial pre-activations, or None
    w_stack   float32 [N, sum(c_i), 3, 3] stacked kernels
    bias      float32 [n_fin]; scale, mean float32 [B, sum(c_i)]

    Returns (y bfloat16 [B, n_fin, T, F], sums, sqs float32 [B, n_fin],
    acc_out bfloat16 [B, N - n_fin, T, F] or None when N == n_fin)."""
    xs = tuple(xs)
    if not 1 <= len(xs) <= 2:
        raise ValueError(
            f"dense_stack_int8 takes 1 or 2 sources, got {len(xs)}")
    device = xs[0].device
    if device.type == "cpu":
        return dense_stack_int8_plain(xs, acc_in, w_stack, bias, scale, mean,
                                      n_fin)
    if device.type != "cuda":
        raise ValueError(f"dense_stack_int8: unsupported device {device}")
    b, _, t, f = xs[0].shape
    widths = [int(x.shape[1]) for x in xs]
    if any(w % 4 for w in widths):
        raise ValueError(f"dense_stack_int8: source widths {widths} must be "
                         "multiples of 4 (4 channels per packed word)")
    c_tot = sum(widths)
    n = int(w_stack.shape[0])
    if not 0 < n_fin <= n:
        raise ValueError(f"dense_stack_int8: n_fin={n_fin} outside (0, {n}]")

    def check(name, t_, shape, dt=torch.float32):
        check_tensor("dense_stack_int8", name, t_, shape, device, dt)

    for i, x in enumerate(xs):
        check(f"xs[{i}]", x, (b, widths[i], t, f), torch.bfloat16)
    check("w_stack", w_stack, (n, c_tot, 3, 3))
    check("bias", bias, (n_fin,))
    check("scale", scale, (b, c_tot))
    check("mean", mean, (b, c_tot))
    if acc_in is not None:
        check("acc_in", acc_in, (b, n, t, f), torch.bfloat16)

    qw, corr, rq = quantize_rows_packed(w_stack, scale, mean, widths)
    lib = library()
    ntiles = lib.misonet_tc_pos_tiles(t, f)
    y = torch.empty((b, n_fin, t, f), device=device, dtype=torch.bfloat16)
    acc_out = (torch.empty((b, n - n_fin, t, f), device=device,
                           dtype=torch.bfloat16) if n > n_fin else None)
    part = torch.empty((2, b, n_fin, ntiles), device=device)
    sums = torch.empty((b, n_fin), device=device)
    sqs = torch.empty((b, n_fin), device=device)
    with torch.cuda.device(device):
        err = lib.misonet_dense_stack_int8(
            xs[0].data_ptr(), widths[0],
            xs[1].data_ptr() if len(xs) == 2 else None,
            widths[1] if len(xs) == 2 else 0,
            scale.data_ptr(), qw.data_ptr(), corr.data_ptr(), rq.data_ptr(),
            bias.data_ptr(),
            acc_in.data_ptr() if acc_in is not None else None,
            y.data_ptr(),
            acc_out.data_ptr() if acc_out is not None else None,
            part.data_ptr(), sums.data_ptr(), sqs.data_ptr(),
            b, t, f, n, n_fin, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"dense_stack_int8 kernel launch failed: CUDA error {err}")
    build.count_launch(dense_stack_int8, "launches")
    return y, sums, sqs, acc_out


dense_stack_int8.launches = 0


def library() -> ctypes.CDLL:
    lib = build.library()
    lib.misonet_dense_stack_int8.argtypes = [
        _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _P,
    ]
    lib.misonet_dense_stack_int8.restype = _I
    lib.misonet_quantize_rows_int8.argtypes = [
        _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
    ]
    lib.misonet_quantize_rows_int8.restype = _I
    lib.misonet_tc_pos_tiles.argtypes = [_I, _I]
    lib.misonet_tc_pos_tiles.restype = _I
    return lib

"""Kernel 3: the fused backward of the U-Net body convs.

Replaces misonet_tpu/ops/pallas/stencil_bwd.py::stencil_bwd_flat in its
float32 ("precise") and bfloat16 (precise=False) modes, the backward of
both forward kernels: ``dense_stack``
(mode ``"dense"``) and the four ``stencil`` instances (``"enc0"``,
``"down"``, ``"up"``, ``"final"``).  It differentiates the linear part of
the forward,

    xn = (x - mean) * scale,   z = conv(xn, W) + bias (+ acc_in),

given ``g = dL/dz`` with the ELU and statistics cotangents already folded
in (``ops/kernels/flat_grad.py``).  CUDA source:
``misonet_tpu_torch/csrc/stencil_bwd.cu`` (what bounds it on the H100 and
how the design answers that is written at the top of that file).

The mode follows the cotangent's dtype.  float32: every tensor float32.
bfloat16: ``g``, the sources, ``w`` and the input gradients ``dxs`` are
bfloat16; ``scale``, ``mean``, ``dw``, ``dbias``, ``dscale`` and ``dmean``
are float32 (the parameters stay float32).  The bfloat16 mode multiplies
bfloat16 operands (the weights and cotangents for the dgrad; the forward's
bf16-rounded normalized input ``bf16((x - mean) * scale)`` and the
cotangents for the wgrad) and sums in float32; ``dx`` is rounded for the
store, ``dscale``/``dmean`` come from the float32 dgrad.  Both modes run
their products on the tensor cores (float32 as three TF32 passes over
split operands, ``tc_pack.tf32_split``), the dgrad reading the weight
packed by ``tc_pack.packed`` (output channel c, reduced channel n;
float32: 4 channels a group, as TF32 big and small planes; bf16: 8 a
group; cached per weight tensor and version).

``stencil_bwd`` launches the kernel for CUDA tensors (raising on anything it
does not take, or on a refused launch) and runs ``stencil_bwd_plain`` for
CPU tensors.  Each mode has its own launch counter: ``stencil_bwd.launches``
(float32) and ``stencil_bwd.launches_bf16``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from misonet_tpu_torch.ops.kernels import build, tc_pack
from misonet_tpu_torch.ops.kernels.dense_stack import (
    DTYPES, check_tensor, library as dense_stack_library)
from misonet_tpu_torch.ops.kernels.stencil import out_bins

_P = ctypes.c_void_p
_I = ctypes.c_int

MODES = {"enc0": 0, "down": 1, "up": 2, "final": 3, "dense": 4}
_TRANSPOSE = ("up", "final")


def geometry(mode: str):
    """(stride, padding) of the forward conv / transpose conv of ``mode``."""
    if mode == "dense":
        return (1, 1), (1, 1)
    return ((1, 2) if mode in ("down", "up") else (1, 1)), (1, 0)


def stencil_bwd_plain(g, xs, w, scale, mean, mode: str, need_dx: bool = True,
                      need_stats: bool = True):
    """Plain PyTorch version: same arguments and results as
    :func:`stencil_bwd`.  In the bfloat16 mode it runs float32 convs of the
    bfloat16 operands (g, w and the bf16-rounded normalized input), so it
    rounds at the kernel's points (with TF32 off, only the order of the
    sums differs).  float32 and float64 inputs compute in their own type."""
    dtype = g.dtype
    work = torch.float32 if dtype == torch.bfloat16 else dtype
    x = torch.cat(list(xs), dim=1) if len(xs) > 1 else xs[0]
    x, g, w = x.to(work), g.to(work), w.to(work)
    xc = x if mean is None else x - mean[:, :, None, None]
    xn = xc if scale is None else xc * scale[:, :, None, None]
    xn = xn.to(dtype).to(work)   # the bf16 mode's rounded normalized input
    stride, padding = geometry(mode)
    if mode in _TRANSPOSE:
        # the transpose conv's input gradient is the conv of g with the same
        # weight, and its weight gradient pairs the same index triples
        dw = conv2d_weight(g, w.shape, xn, stride=stride, padding=padding)
        big_g = (F.conv2d(g, w, stride=stride, padding=padding)
                 if need_dx else None)
    else:
        dw = conv2d_weight(xn, w.shape, g, stride=stride, padding=padding)
        big_g = (conv2d_input(xn.shape, w, g, stride=stride, padding=padding)
                 if need_dx else None)
    dbias = g.sum(dim=(0, 2, 3))
    if big_g is None:
        return None, dw, dbias, None, None
    dx = big_g if scale is None else big_g * scale[:, :, None, None]
    dx = dx.to(dtype)
    dxs = tuple(torch.split(dx, [int(t.shape[1]) for t in xs], dim=1))
    dscale = dmean = None
    if need_stats and scale is not None:
        dscale = (big_g * xc).sum(dim=(2, 3))
        dmean = -scale * big_g.sum(dim=(2, 3))
    return dxs, dw, dbias, dscale, dmean


def stencil_bwd(g, xs, w, scale, mean, mode: str, need_dx: bool = True,
                need_stats: bool = True):
    """The backward of one ``dense_stack`` or ``stencil`` call.

    g      [B, N, T, F_out] cotangent of the conv output (all N rows of a
           dense call: the finalized rows' then the partials), float32 or
           bfloat16 (the mode)
    xs     the forward's raw sources: 1 or 2 (``"dense"`` only) tensors
           [B, c_i, T, F_in]
    w      the forward's weight: [N, C, 3, 3] (``"dense"``, ``"enc0"``,
           ``"down"``) or [C, N, 3, 3] (``"up"``, ``"final"``), of g's dtype
    scale  [B, C] 1/sigma and mean [B, C] of the sources; both None for
           ``"enc0"`` (identity)
    need_dx     compute the input gradients (False: dxs, dscale and dmean
                are None, and no dgrad runs)
    need_stats  compute dscale and dmean

    Returns (dxs tuple of [B, c_i, T, F_in] of g's dtype or None, dw of
    w's shape, dbias [N] summed over all N rows, dscale [B, C] or None,
    dmean [B, C] or None), the last four float32."""
    if mode not in MODES:
        raise ValueError(f"stencil_bwd: unknown mode {mode!r}")
    xs = tuple(xs)
    if not 1 <= len(xs) <= (2 if mode == "dense" else 1):
        raise ValueError(f"stencil_bwd: mode {mode!r} takes "
                         f"{'1 or 2 sources' if mode == 'dense' else '1 source'}"
                         f", got {len(xs)}")
    if (scale is None) != (mode == "enc0") or (scale is None) != (mean is None):
        raise ValueError(
            "stencil_bwd: scale/mean must be None for mode 'enc0' and given "
            f"for the other modes (mode {mode!r})"
        )
    device = g.device
    if device.type == "cpu":
        return stencil_bwd_plain(g, xs, w, scale, mean, mode, need_dx,
                                 need_stats)
    if device.type != "cuda":
        raise ValueError(f"stencil_bwd: unsupported device {device}")
    dtype = g.dtype
    if dtype not in DTYPES:
        raise ValueError(f"stencil_bwd: g must be float32 or bfloat16, got "
                         f"{dtype}")
    b, _, t, f_in = xs[0].shape
    widths = [int(x.shape[1]) for x in xs]
    c = sum(widths)
    n = int(w.shape[1] if mode in _TRANSPOSE else w.shape[0])
    f_out = f_in if mode == "dense" else out_bins(mode, f_in)

    def check(name, t_, shape, dt=dtype):
        check_tensor("stencil_bwd", name, t_, shape, device, dt)

    for i, x in enumerate(xs):
        check(f"xs[{i}]", x, (b, widths[i], t, f_in))
    check("g", g, (b, n, t, f_out))
    check("w", w, (c, n, 3, 3) if mode in _TRANSPOSE else (n, c, 3, 3))
    if scale is not None:
        check("scale", scale, (b, c), torch.float32)
        check("mean", mean, (b, c), torch.float32)
    stats = need_dx and need_stats and scale is not None

    lib = library()
    bf16 = dtype == torch.bfloat16
    entry = lib.misonet_stencil_bwd_bf16 if bf16 else lib.misonet_stencil_bwd
    dxs = tuple(torch.empty_like(x) for x in xs) if need_dx else None
    ntiles = lib.misonet_tc_pos_tiles(t, f_in)
    dpart = (torch.empty((2, b, c, ntiles), device=device) if stats
             else None)
    sg = torch.empty((b, c), device=device) if stats else None
    sgx = torch.empty((b, c), device=device) if stats else None
    splits = (lib.misonet_stencil_bwd_bf16_splits if bf16
              else lib.misonet_stencil_bwd_splits)(n, c, b, t, f_out)
    wpart = torch.empty((splits, n, 9 * c + 1), device=device)
    dw = torch.empty(w.shape, device=device)
    dbias = torch.empty((n,), device=device)

    # the dgrad reads the weight packed for its tensor cores, output
    # channel c and reduced channel n
    wk = (tc_pack.packed(w, (n,), transpose=mode not in _TRANSPOSE)
          if need_dx else w)

    def ptr(v):
        return v.data_ptr() if v is not None else None

    with torch.cuda.device(device):
        err = entry(
            MODES[mode], g.data_ptr(), n, xs[0].data_ptr(), widths[0],
            ptr(xs[1]) if len(xs) == 2 else None,
            widths[1] if len(xs) == 2 else 0,
            ptr(scale), ptr(mean), wk.data_ptr(),
            ptr(dxs[0]) if dxs else None,
            ptr(dxs[1]) if dxs and len(xs) == 2 else None,
            ptr(dpart), ptr(sg), ptr(sgx), wpart.data_ptr(), dw.data_ptr(),
            dbias.data_ptr(), b, t, f_in, f_out,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"stencil_bwd kernel launch failed: CUDA error {err}")
    if bf16:
        build.count_launch(stencil_bwd, "launches_bf16")
    else:
        build.count_launch(stencil_bwd, "launches")
    dscale = dmean = None
    if stats:
        dscale, dmean = sgx, -scale * sg
    return dxs, dw, dbias, dscale, dmean


stencil_bwd.launches = 0
stencil_bwd.launches_bf16 = 0


def library() -> ctypes.CDLL:
    lib = dense_stack_library()
    for entry in (lib.misonet_stencil_bwd, lib.misonet_stencil_bwd_bf16):
        entry.argtypes = [
            _I, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _P, _P, _I, _I, _I, _I, _P,
        ]
        entry.restype = _I
    for splits in (lib.misonet_stencil_bwd_splits,
                   lib.misonet_stencil_bwd_bf16_splits):
        splits.argtypes = [_I, _I, _I, _I, _I]
        splits.restype = _I
    lib.misonet_tc_pos_tiles.argtypes = [_I, _I]
    lib.misonet_tc_pos_tiles.restype = _I
    return lib

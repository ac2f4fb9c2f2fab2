"""Kernel 3: the fused backward of the U-Net body convs.

Replaces misonet_tpu/ops/pallas/stencil_bwd.py::stencil_bwd_flat (float32
"precise" mode), the backward of both forward kernels: ``dense_stack``
(mode ``"dense"``) and the four ``stencil`` instances (``"enc0"``,
``"down"``, ``"up"``, ``"final"``).  It differentiates the linear part of
the forward,

    xn = (x - mean) * scale,   z = conv(xn, W) + bias (+ acc_in),

given ``g = dL/dz`` with the ELU and statistics cotangents already folded
in (``ops/kernels/flat_grad.py``).  CUDA source:
``misonet_tpu_torch/csrc/stencil_bwd.cu`` (what bounds it on the H100 and
how the design answers that is written at the top of that file).

``stencil_bwd`` launches the kernel for CUDA tensors (raising on anything it
does not take, or on a refused launch) and runs ``stencil_bwd_plain`` for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from misonet_tpu_torch.ops.kernels import build
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
    :func:`stencil_bwd`."""
    x = torch.cat(list(xs), dim=1) if len(xs) > 1 else xs[0]
    xc = x if mean is None else x - mean[:, :, None, None]
    xn = xc if scale is None else xc * scale[:, :, None, None]
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
    dxs = tuple(torch.split(dx, [int(t.shape[1]) for t in xs], dim=1))
    dscale = dmean = None
    if need_stats and scale is not None:
        dscale = (big_g * xc).sum(dim=(2, 3))
        dmean = -scale * big_g.sum(dim=(2, 3))
    return dxs, dw, dbias, dscale, dmean


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(
            f"stencil_bwd: {name} must be float32 on {device}, got "
            f"{t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"stencil_bwd: {name} shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"stencil_bwd: {name} must be contiguous")


def stencil_bwd(g, xs, w, scale, mean, mode: str, need_dx: bool = True,
                need_stats: bool = True):
    """The backward of one ``dense_stack`` or ``stencil`` call.

    g      [B, N, T, F_out] cotangent of the conv output (all N rows of a
           dense call: the finalized rows' then the partials')
    xs     the forward's raw sources: 1 or 2 (``"dense"`` only) tensors
           [B, c_i, T, F_in]
    w      the forward's weight: [N, C, 3, 3] (``"dense"``, ``"enc0"``,
           ``"down"``) or [C, N, 3, 3] (``"up"``, ``"final"``)
    scale  [B, C] 1/sigma and mean [B, C] of the sources; both None for
           ``"enc0"`` (identity)
    need_dx     compute the input gradients (False: dxs, dscale and dmean
                are None, and no dgrad runs)
    need_stats  compute dscale and dmean

    Returns (dxs tuple of [B, c_i, T, F_in] or None, dw like w, dbias [N]
    summed over all N rows, dscale [B, C] or None, dmean [B, C] or None)."""
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
    b, _, t, f_in = xs[0].shape
    widths = [int(x.shape[1]) for x in xs]
    c = sum(widths)
    n = int(w.shape[1] if mode in _TRANSPOSE else w.shape[0])
    f_out = f_in if mode == "dense" else out_bins(mode, f_in)
    for i, x in enumerate(xs):
        _check(f"xs[{i}]", x, (b, widths[i], t, f_in), device)
    _check("g", g, (b, n, t, f_out), device)
    _check("w", w, (c, n, 3, 3) if mode in _TRANSPOSE else (n, c, 3, 3),
           device)
    if scale is not None:
        _check("scale", scale, (b, c), device)
        _check("mean", mean, (b, c), device)
    stats = need_dx and need_stats and scale is not None

    lib = library()
    dxs = tuple(torch.empty_like(x) for x in xs) if need_dx else None
    ntiles = -(-(t * f_in) // lib.misonet_pos_tile())
    dpart = (torch.empty((2, b, c, ntiles), device=device) if stats
             else None)
    sg = torch.empty((b, c), device=device) if stats else None
    sgx = torch.empty((b, c), device=device) if stats else None
    splits = lib.misonet_stencil_bwd_splits(n, c, b * t * f_out)
    wpart = torch.empty((splits, n, 9 * c + 1), device=device)
    dw = torch.empty_like(w)
    dbias = torch.empty((n,), device=device)

    def ptr(v):
        return v.data_ptr() if v is not None else None

    with torch.cuda.device(device):
        err = lib.misonet_stencil_bwd(
            MODES[mode], g.data_ptr(), n, xs[0].data_ptr(), widths[0],
            ptr(xs[1]) if len(xs) == 2 else None,
            widths[1] if len(xs) == 2 else 0,
            ptr(scale), ptr(mean), w.data_ptr(),
            ptr(dxs[0]) if dxs else None,
            ptr(dxs[1]) if dxs and len(xs) == 2 else None,
            ptr(dpart), ptr(sg), ptr(sgx), wpart.data_ptr(), dw.data_ptr(),
            dbias.data_ptr(), b, t, f_in, f_out,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"stencil_bwd kernel launch failed: CUDA error {err}")
    stencil_bwd.launches += 1
    dscale = dmean = None
    if stats:
        dscale, dmean = sgx, -scale * sg
    return dxs, dw, dbias, dscale, dmean


stencil_bwd.launches = 0


def library() -> ctypes.CDLL:
    lib = build.library()
    lib.misonet_stencil_bwd.argtypes = [
        _I, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _I, _I, _I, _I, _P,
    ]
    lib.misonet_stencil_bwd.restype = _I
    lib.misonet_stencil_bwd_splits.argtypes = [_I, _I, _I]
    lib.misonet_stencil_bwd_splits.restype = _I
    lib.misonet_pos_tile.argtypes = []
    lib.misonet_pos_tile.restype = _I
    return lib

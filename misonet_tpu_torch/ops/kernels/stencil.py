"""Kernel 2: the U-Net body's trunk and transpose convs.

Replaces misonet_tpu/ops/pallas/stencil_flat.py::stencil_layer_flat
(float32 "precise" mode) in its four instances, selected by ``mode``:

  ``"enc0"``   3x3 conv, stride (1,1), time SAME / freq VALID (F -> F-2),
               raw input (identity normalization), bare: no ELU, no stats
  ``"down"``   3x3 conv, stride (1,2), freq VALID (F -> (F-3)//2+1),
               normalize on load, + ELU + stats
  ``"up"``     3x3 transpose conv, stride (1,2), torch geometry
               (F -> 2F+1), normalize on load, + ELU + stats
  ``"final"``  3x3 transpose conv, stride (1,1) (F -> F+2), normalize on
               load, bare

Conv weights are ``[N, C, 3, 3]`` (Conv2d), transpose weights
``[C, N, 3, 3]`` (ConvTranspose2d); time padding is 1 and frequency padding
0 in all modes.  CUDA source: ``misonet_tpu_torch/csrc/stencil.cu``.

``stencil`` launches the kernel for CUDA tensors (raising on anything it
does not take) and runs ``stencil_plain`` for CPU tensors.  It returns
``(y, sums, sqs)``; the sums are None for the bare modes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from misonet_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int

MODES = {"enc0": 0, "down": 1, "up": 2, "final": 3}
_TRANSPOSE = ("up", "final")
_ACT = ("down", "up")


def out_bins(mode: str, f_in: int) -> int:
    """Output frequency bins of ``mode`` for ``f_in`` input bins."""
    return {
        "enc0": f_in - 2,
        "down": (f_in - 3) // 2 + 1,
        "up": 2 * f_in + 1,
        "final": f_in + 2,
    }[mode]


def stencil_plain(x, w, bias, scale, mean, mode: str):
    """Plain PyTorch version: same arguments and results as :func:`stencil`."""
    if scale is not None:
        x = (x - mean[:, :, None, None]) * scale[:, :, None, None]
    stride = (1, 2) if mode in ("down", "up") else (1, 1)
    if mode in _TRANSPOSE:
        y = F.conv_transpose2d(x, w, bias, stride=stride, padding=(1, 0))
    else:
        y = F.conv2d(x, w, bias, stride=stride, padding=(1, 0))
    if mode not in _ACT:
        return y, None, None
    y = F.elu(y)
    return y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(
            f"stencil: {name} must be float32 on {device}, got "
            f"{t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"stencil: {name} shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"stencil: {name} must be contiguous")


def stencil(x, w, bias, scale, mean, mode: str):
    """One stencil layer.

    x      [B, C, T, F_in] raw input
    w      [N, C, 3, 3] (conv modes) or [C, N, 3, 3] (transpose modes)
    bias   [N]
    scale  [B, C] 1/sigma and mean [B, C] of the input; both None for
           ``"enc0"`` (identity), required otherwise

    Returns (y [B, N, T, out_bins(mode, F_in)], sums [B, N] or None,
    sqs [B, N] or None)."""
    if mode not in MODES:
        raise ValueError(f"stencil: unknown mode {mode!r}")
    if (scale is None) != (mode == "enc0") or (scale is None) != (mean is None):
        raise ValueError(
            "stencil: scale/mean must be None for mode 'enc0' and given "
            f"for the other modes (mode {mode!r})"
        )
    device = x.device
    if device.type == "cpu":
        return stencil_plain(x, w, bias, scale, mean, mode)
    if device.type != "cuda":
        raise ValueError(f"stencil: unsupported device {device}")
    b, c, t, f_in = x.shape
    n = int(w.shape[1] if mode in _TRANSPOSE else w.shape[0])
    f_out = out_bins(mode, f_in)
    if f_out < 1:
        raise ValueError(f"stencil: mode {mode!r} needs more than {f_in} bins")
    _check("x", x, (b, c, t, f_in), device)
    _check("w", w, (c, n, 3, 3) if mode in _TRANSPOSE else (n, c, 3, 3),
           device)
    _check("bias", bias, (n,), device)
    if scale is not None:
        _check("scale", scale, (b, c), device)
        _check("mean", mean, (b, c), device)

    lib = library()
    ntiles = lib.misonet_stencil_tiles(MODES[mode], t, f_in, f_out)
    y = torch.empty((b, n, t, f_out), device=device)
    act = mode in _ACT
    part = torch.empty((2, b, n, ntiles), device=device) if act else None
    sums = torch.empty((b, n), device=device) if act else None
    sqs = torch.empty((b, n), device=device) if act else None

    def ptr(v):
        return v.data_ptr() if v is not None else None

    with torch.cuda.device(device):
        err = lib.misonet_stencil(
            MODES[mode], x.data_ptr(), ptr(scale), ptr(mean), w.data_ptr(),
            bias.data_ptr(), y.data_ptr(), ptr(part), ptr(sums), ptr(sqs),
            b, c, t, f_in, f_out, n, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"stencil kernel launch failed: CUDA error {err}")
    stencil.launches += 1
    return y, sums, sqs


stencil.launches = 0


def library() -> ctypes.CDLL:
    lib = build.library()
    lib.misonet_stencil.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _P,
    ]
    lib.misonet_stencil.restype = _I
    lib.misonet_stencil_tiles.argtypes = [_I, _I, _I, _I]
    lib.misonet_stencil_tiles.restype = _I
    return lib

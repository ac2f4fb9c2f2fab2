"""Kernel 2: the U-Net body's trunk and transpose convs.

Replaces misonet_tpu/ops/pallas/stencil_flat.py::stencil_layer_flat in its
float32 ("precise") and bfloat16 (precise=False) modes, in its four
instances, selected by ``mode``:

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
0 in all modes.  CUDA source: ``misonet_tpu_torch/csrc/stencil.cu``: both
modes on the tensor cores (``stencil_tc_kernel``; float32 as three TF32
passes over split operands, ``tc_pack.tf32_split``), weights packed by
``tc_pack.packed`` (float32: 4 channels a group, as TF32 big and small
planes; bf16: 8 a group), cached per weight tensor and version.

The dtype mode follows ``x``: float32 throughout, or ``x``, ``w`` and ``y``
bfloat16 with ``bias``, ``scale``, ``mean`` and the sums float32, rounded
where the TPU kernel rounds (the normalized input and the weights are
bfloat16, the sums run in float32, the statistics come from the float32
output before its bfloat16 store).  In the bfloat16 mode ``w`` may also be
the float32 parameter: it is rounded to bfloat16 where it is packed (on
the card, once per parameter version, so a model serving under
``torch.inference_mode`` casts and packs nothing per call) or before the
plain version's conv.

``stencil`` launches the kernel for CUDA tensors (raising on anything it
does not take) and runs ``stencil_plain`` for CPU tensors.  It returns
``(y, sums, sqs)``; the sums are None for the bare modes.  Each dtype mode
has its own launch counter: ``stencil.launches`` (float32) and
``stencil.launches_bf16``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from misonet_tpu_torch.ops.kernels import build
from misonet_tpu_torch.ops.kernels.dense_stack import DTYPES, check_tensor
from misonet_tpu_torch.ops.kernels.tc_pack import packed

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
    """Plain PyTorch version: same arguments and results as :func:`stencil`.
    In the bfloat16 mode it runs float32 convs of the bfloat16-rounded
    normalized input and weights (the kernel's rounding points)."""
    dtype = x.dtype
    if scale is not None:
        x = ((x.float() - mean[:, :, None, None])
             * scale[:, :, None, None]).to(dtype)
    x, w = x.float(), w.to(dtype).float()
    stride = (1, 2) if mode in ("down", "up") else (1, 1)
    if mode in _TRANSPOSE:
        y = F.conv_transpose2d(x, w, bias, stride=stride, padding=(1, 0))
    else:
        y = F.conv2d(x, w, bias, stride=stride, padding=(1, 0))
    if mode not in _ACT:
        return y.to(dtype), None, None
    y = F.elu(y)
    return y.to(dtype), y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))


def stencil(x, w, bias, scale, mean, mode: str):
    """One stencil layer.

    x      [B, C, T, F_in] raw input
    w      [N, C, 3, 3] (conv modes) or [C, N, 3, 3] (transpose modes), of
           x's dtype (or float32 for a bfloat16 x)
    bias   [N] float32
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
    dtype = x.dtype
    if dtype not in DTYPES:
        raise ValueError(f"stencil: x must be float32 or bfloat16, got {dtype}")
    b, c, t, f_in = x.shape
    n = int(w.shape[1] if mode in _TRANSPOSE else w.shape[0])
    f_out = out_bins(mode, f_in)
    if f_out < 1:
        raise ValueError(f"stencil: mode {mode!r} needs more than {f_in} bins")
    def check(name, t_, shape, dt=dtype):
        check_tensor("stencil", name, t_, shape, device, dt)

    bf16 = dtype == torch.bfloat16
    check("x", x, (b, c, t, f_in))
    check("w", w, (c, n, 3, 3) if mode in _TRANSPOSE else (n, c, 3, 3),
          torch.float32 if bf16 and w.dtype == torch.float32 else dtype)
    check("bias", bias, (n,), torch.float32)
    if scale is not None:
        check("scale", scale, (b, c), torch.float32)
        check("mean", mean, (b, c), torch.float32)

    lib = library()
    entry = lib.misonet_stencil_bf16 if bf16 else lib.misonet_stencil
    w = packed(w, (c,), transpose=mode in _TRANSPOSE, dtype=dtype)
    ntiles = lib.misonet_stencil_tc_tiles(MODES[mode], t, f_in, f_out)
    y = torch.empty((b, n, t, f_out), device=device, dtype=dtype)
    act = mode in _ACT
    part = torch.empty((2, b, n, ntiles), device=device) if act else None
    sums = torch.empty((b, n), device=device) if act else None
    sqs = torch.empty((b, n), device=device) if act else None

    def ptr(v):
        return v.data_ptr() if v is not None else None

    with torch.cuda.device(device):
        err = entry(
            MODES[mode], x.data_ptr(), ptr(scale), ptr(mean), w.data_ptr(),
            bias.data_ptr(), y.data_ptr(), ptr(part), ptr(sums), ptr(sqs),
            b, c, t, f_in, f_out, n, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"stencil kernel launch failed: CUDA error {err}")
    if bf16:
        stencil.launches_bf16 += 1
    else:
        stencil.launches += 1
    return y, sums, sqs


stencil.launches = 0
stencil.launches_bf16 = 0


def library() -> ctypes.CDLL:
    lib = build.library()
    for entry in (lib.misonet_stencil, lib.misonet_stencil_bf16):
        entry.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _P,
        ]
        entry.restype = _I
    lib.misonet_stencil_tc_tiles.argtypes = [_I, _I, _I, _I]
    lib.misonet_stencil_tc_tiles.restype = _I
    return lib

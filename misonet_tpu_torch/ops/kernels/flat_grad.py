"""Autograd for the fused U-Net body kernels (misonet_tpu/ops/pallas/
flat_grad.py and the custom VJP of ops/pallas/dense_stack.py).

Each forward kernel gets a ``torch.autograd.Function``:

* forward: the kernel (``dense_stack`` or ``stencil``), unchanged;
* backward: exact, with no forward recompute.  The kernel's output ``y``
  is saved; the ELU derivative is recovered from it (1 where y > 0, else
  y + 1 = e^z) and the fused-statistics cotangents fold in as
  dL/dy += sbar + 2 y qbar (``fold_cotangents``, in PyTorch, as the JAX
  package's ``_fold_cts``).  What remains is the backward of the linear map
  z = conv((x - mean) * scale) + bias, one ``stencil_bwd`` call.

Saved tensors: y, the sources, scale, mean and the weight, as in JAX.  A
dense call's ``acc_in`` is not saved: its gradient is the conv output's
cotangent itself.  ``backward`` runs on autograd's thread; the kernel
wrappers read the current CUDA stream at each launch.

``dense_stack_ad`` / ``stencil_ad`` go through the Functions when autograd
records, and call the kernels directly otherwise.
"""

from __future__ import annotations

import torch

from misonet_tpu_torch.ops.kernels.dense_stack import dense_stack
from misonet_tpu_torch.ops.kernels.stencil import stencil
from misonet_tpu_torch.ops.kernels.stencil_bwd import stencil_bwd

_ACT = ("down", "up")


def fold_cotangents(y, ybar, sbar, qbar):
    """dL/dz of ``y = ELU(z)`` with the per-(b, c) sum and sum-of-squares
    cotangents ``sbar``/``qbar`` [B, N] folded in."""
    g = ybar + sbar[:, :, None, None] + 2.0 * y * qbar[:, :, None, None]
    return (g * torch.where(y > 0, 1.0, y + 1.0)).contiguous()


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class DenseStackFn(torch.autograd.Function):
    """One stacked DenseBlock call; backward = fold + ``stencil_bwd``
    (mode ``"dense"``), the counterpart of dense_stack.py::_stack_bwd."""

    @staticmethod
    def forward(ctx, n_fin, acc_in, w_stack, bias, scale, mean, *xs):
        y, sums, sqs, acc_out = dense_stack(xs, acc_in, w_stack, bias, scale,
                                            mean, n_fin)
        ctx.n_fin = n_fin
        ctx.has_acc = acc_in is not None
        ctx.save_for_backward(y, w_stack, scale, mean, *xs)
        if acc_out is None:
            return y, sums, sqs
        return y, sums, sqs, acc_out

    @staticmethod
    def backward(ctx, ybar, sbar, qbar, gacc=None):
        y, w_stack, scale, mean, *xs = ctx.saved_tensors
        g = fold_cotangents(y, ybar, sbar, qbar)
        if gacc is not None:
            g = torch.cat([g, gacc], dim=1)
        need = ctx.needs_input_grad
        dxs, dw, dbias, dscale, dmean = stencil_bwd(
            g, xs, w_stack, scale, mean, "dense",
            need_dx=any(need[6:]) or need[4] or need[5],
            need_stats=need[4] or need[5],
        )
        dxs = dxs if dxs is not None else (None,) * len(xs)
        return (None, g if ctx.has_acc else None, dw, dbias[:ctx.n_fin],
                dscale, dmean, *dxs)


class StencilFn(torch.autograd.Function):
    """One stencil layer (any mode); backward = fold (ELU modes) +
    ``stencil_bwd``, the counterpart of flat_grad.py::_conv_down_bwd,
    _deconv_up_bwd, _enc0_bwd and _final_bwd."""

    @staticmethod
    def forward(ctx, mode, x, w, bias, scale, mean):
        y, sums, sqs = stencil(x, w, bias, scale, mean, mode)
        ctx.mode = mode
        ctx.save_for_backward(y, x, w, scale, mean)
        if mode in _ACT:
            return y, sums, sqs
        return y

    @staticmethod
    def backward(ctx, ybar, sbar=None, qbar=None):
        y, x, w, scale, mean = ctx.saved_tensors
        mode = ctx.mode
        g = (fold_cotangents(y, ybar, sbar, qbar) if mode in _ACT
             else ybar.contiguous())
        need = ctx.needs_input_grad
        dxs, dw, dbias, dscale, dmean = stencil_bwd(
            g, (x,), w, scale, mean, mode,
            need_dx=need[1] or need[4] or need[5],
            need_stats=need[4] or need[5],
        )
        dx = dxs[0] if dxs is not None else None
        return None, dx, dw, dbias, dscale, dmean


def dense_stack_ad(xs, acc_in, w_stack, bias, scale, mean, n_fin: int):
    """Differentiable :func:`dense_stack` (same arguments and results)."""
    xs = tuple(xs)
    if not _records(*xs, acc_in, w_stack, bias, scale, mean):
        return dense_stack(xs, acc_in, w_stack, bias, scale, mean, n_fin)
    out = DenseStackFn.apply(n_fin, acc_in, w_stack, bias, scale, mean, *xs)
    return out if len(out) == 4 else (*out, None)


def stencil_ad(x, w, bias, scale, mean, mode: str):
    """Differentiable :func:`stencil` (same arguments and results)."""
    if not _records(x, w, bias, scale, mean):
        return stencil(x, w, bias, scale, mean, mode)
    out = StencilFn.apply(mode, x, w, bias, scale, mean)
    return out if mode in _ACT else (out, None, None)

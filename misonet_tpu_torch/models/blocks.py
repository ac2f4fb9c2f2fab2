"""Building blocks of the MISO U-Net/TCN in PyTorch (misonet_tpu/models/blocks.py;
reference model.py:401-632).

Layouts are NCHW ``[B, C, T, F]`` for the U-Net and ``[B, C, T]`` for the
TCN.  Every conv is float32 with time padding 1 and, except in the
DenseBlocks, frequency padding 0 (reference padding=(1, 0)).  Transposed
convs keep torch's geometry ``out = (in - 1) * stride - 2 * pad + kernel``
and torch's ``[I, O, kh, kw]`` weight, so the frequency ladder
129 -> 127 -> 63 -> 31 -> 15 -> 7 -> 3 -> 1 and back matches the reference.

Modules are built without initializing their parameters;
:func:`init_parameters` fills them from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

EPS_GLN = 1e-8   # reference model.py:6
EPS_IN = 1e-5    # torch InstanceNorm default (model.py:413)


def conv2d(in_ch: int, out_ch: int, **kw) -> nn.Conv2d:
    return skip_init(nn.Conv2d, in_ch, out_ch, 3, **kw)


class InstanceNorm(nn.Module):
    """Per-(batch, channel) normalization over all spatial axes, no affine
    (torch InstanceNorm1d/2d(affine=False))."""

    def __init__(self, eps: float = EPS_IN):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(2, x.ndim))
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.eps)


class GlobalLayerNorm(nn.Module):
    """gLN over (channel, time) of ``[B, C, T]`` with affine parameters kept
    in the JAX layout ``[1, 1, C]`` (reference model.py:609-632)."""

    def __init__(self, channels: int, eps: float = EPS_GLN):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(1, 1, channels))
        self.beta = nn.Parameter(torch.empty(1, 1, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        gamma = self.gamma.reshape(1, -1, 1)
        beta = self.beta.reshape(1, -1, 1)
        return gamma * (x - mean) / torch.sqrt(var + self.eps) + beta


class ChannelwiseLayerNorm(nn.Module):
    """cLN over the channel axis per (batch, time) (reference
    model.py:583-605); parameters ``[1, 1, C]`` as in JAX."""

    def __init__(self, channels: int, eps: float = EPS_GLN):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(1, 1, channels))
        self.beta = nn.Parameter(torch.empty(1, 1, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        gamma = self.gamma.reshape(1, -1, 1)
        beta = self.beta.reshape(1, -1, 1)
        return gamma * (x - mean) / torch.sqrt(var + self.eps) + beta


class SimpleBatchNorm(nn.Module):
    """Batch normalization over (batch, time) per channel from batch
    statistics (the reference's chose_norm BatchNorm fallback,
    model.py:581)."""

    def __init__(self, channels: int, eps: float = EPS_IN):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(channels))
        self.beta = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, keepdim=True, unbiased=False)
        return (self.gamma.reshape(shape) * (x - mean)
                * torch.rsqrt(var + self.eps) + self.beta.reshape(shape))


def choose_norm(norm_type: str, channels: int) -> nn.Module:
    """Norm dispatch of the reference's chose_norm (model.py:570-581)."""
    if norm_type == "gLN":
        return GlobalLayerNorm(channels)
    if norm_type == "cLN":
        return ChannelwiseLayerNorm(channels)
    if norm_type == "IN":
        return InstanceNorm()
    if norm_type == "BN":
        return SimpleBatchNorm(channels)
    raise ValueError(f"unsupported norm_type: {norm_type}")


class PReLU(nn.Module):
    """Single-parameter PReLU (scalar ``alpha``, torch default 0.25)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class ConvTranspose2dTorch(nn.Module):
    """3x3 transposed conv with torch ConvTranspose2d geometry and weight
    ``[I, O, 3, 3]`` (reference model.py:418-433)."""

    def __init__(self, in_ch: int, features: int,
                 stride: tuple[int, int] = (1, 2),
                 padding: tuple[int, int] = (1, 0)):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.weight = nn.Parameter(torch.empty(in_ch, features, 3, 3))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias,
                                  stride=self.stride, padding=self.padding)


class ConvBlock(nn.Module):
    """Conv2d 3x3 (+ ELU + InstanceNorm when ``act_norm``), time SAME-1,
    frequency VALID (reference Conv2d_ / init_Conv2d_, model.py:401-416)."""

    def __init__(self, in_ch: int, features: int,
                 stride: tuple[int, int] = (1, 1), act_norm: bool = True):
        super().__init__()
        self.act_norm = act_norm
        self.conv = conv2d(in_ch, features, stride=tuple(stride),
                           padding=(1, 0))
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.act_norm:
            x = self.norm(F.elu(x))
        return x


class DeconvBlock(nn.Module):
    """ConvTranspose2d (+ ELU + InstanceNorm) (reference DeConv2d_,
    model.py:425-433)."""

    def __init__(self, in_ch: int, features: int,
                 stride: tuple[int, int] = (1, 2), act_norm: bool = True):
        super().__init__()
        self.act_norm = act_norm
        self.deconv = ConvTranspose2dTorch(in_ch, features, stride=stride)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.deconv(x)
        if self.act_norm:
            x = self.norm(F.elu(x))
        return x


class DenseBlock(nn.Module):
    """5-layer DenseNet block: layer i is Conv2d(3x3, SAME) + ELU +
    InstanceNorm over the concatenation of the input and all previous
    outputs; growth g1, final width g2 (reference model.py:437-482)."""

    def __init__(self, in_ch: int, g1: int, g2: int):
        super().__init__()
        self.in_ch, self.g1, self.g2 = in_ch, g1, g2
        self.widths = [g1] * 4 + [g2]
        self.convs = nn.ModuleList(
            conv2d(in_ch + i * g1, self.widths[i], padding=1)
            for i in range(5)
        )
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tensors = [x]
        for conv in self.convs:
            tensors.append(self.norm(F.elu(conv(torch.cat(tensors, dim=1)))))
        return tensors[-1]


class DepthwiseSeparableConv(nn.Module):
    """Dilated depthwise Conv1d (no bias) -> PReLU -> gLN -> pointwise
    Conv1d (no bias) on ``[B, C, T]`` (reference model.py:553-567)."""

    def __init__(self, channels: int, features: int, dilation: int):
        super().__init__()
        self.depthwise = skip_init(
            nn.Conv1d, channels, channels, 3, padding=dilation,
            dilation=dilation, groups=channels, bias=False,
        )
        self.prelu = PReLU()
        self.norm = GlobalLayerNorm(channels)
        self.pointwise = skip_init(nn.Conv1d, channels, features, 1,
                                   bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.norm(self.prelu(self.depthwise(x))))


class TemporalBlock(nn.Module):
    """norm -> ELU -> DSConv -> norm -> ELU -> DSConv + residual (reference
    model.py:517-550); the DSConvs' inner norm is always gLN."""

    def __init__(self, features: int, dilation: int, norm_type: str = "IN"):
        super().__init__()
        self.norm1 = choose_norm(norm_type, features)
        self.dsconv1 = DepthwiseSeparableConv(features, features, dilation)
        self.norm2 = choose_norm(norm_type, features)
        self.dsconv2 = DepthwiseSeparableConv(features, features, dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dsconv1(F.elu(self.norm1(x)))
        y = self.dsconv2(F.elu(self.norm2(y)))
        return y + x


class TemporalConvNet(nn.Module):
    """Conv-TasNet-style TCN: R repeats of X blocks with dilations
    2^0..2^(X-1), non-causal (reference model.py:486-515).  ``[B, C, T]``."""

    def __init__(self, repeats: int = 2, blocks: int = 7,
                 features: int = 128, norm_type: str = "IN"):
        super().__init__()
        for r in range(repeats):
            for b in range(blocks):
                self.add_module(f"repeat{r}_block{b}",
                                TemporalBlock(features, 2**b, norm_type))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``module`` from ``generator`` (a CPU
    generator): conv weights LeCun-normal (std 1/sqrt(fan_in), as the JAX
    package's lecun_normal), biases 0, norm gains 1 and shifts 0, PReLU
    0.25."""

    def normal(p: torch.Tensor, fan_in: int) -> None:
        v = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
        p.copy_(v)

    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            normal(m.weight, m.weight[0].numel())
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ConvTranspose2dTorch):
            normal(m.weight, m.weight.shape[0] * 9)
            m.bias.zero_()
        elif isinstance(m, (GlobalLayerNorm, ChannelwiseLayerNorm,
                            SimpleBatchNorm)):
            m.gamma.fill_(1.0)
            m.beta.zero_()
        elif isinstance(m, PReLU):
            m.alpha.fill_(0.25)

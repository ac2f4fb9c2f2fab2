"""Plain float32 MISO nets: the U-Net + TCN of Wang et al., TASLP 29 (2021),
as configured by a benchmark configuration's ``model`` plan.

A frozen, independent copy of the architecture (reference model.py:8-632):
plain ``torch`` ops only, no kernel, no fused path, no bf16.  Parameter names
and shapes are those of the measured program's ``MISONet``, so one state
dict, made by the benchmark from the seed, loads into both.

Layout: complex spectrogram [B, C, T, F] in, [B, S, T, F] out; inside, the
real parts then the imaginary parts as 2C real channels in NCHW.  Convs are
3x3 with time padding 1 and frequency padding 0 (the DenseBlocks pad both);
every norm is an InstanceNorm without affine (eps 1e-5), the TCN's inner
norm a global layer norm (eps 1e-8).

``quant="fp8"`` rounds every conv's input and weight to float8 e4m3 with a
per-tensor scale before the conv: the control that computes this reference
one precision below the configuration's bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS_IN = 1e-5
EPS_GLN = 1e-8
FP8_MAX = 448.0


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in
    ``t``'s dtype."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (t * scale).to(torch.float8_e4m3fn).to(t.dtype)
    return q / scale


def _q(quant, x):
    return fake_fp8(x) if quant == "fp8" else x


class Conv(nn.Module):
    def __init__(self, cin, cout, stride=(1, 1), padding=(1, 0)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.padding = stride, padding
        self.quant = None

    def forward(self, x):
        return F.conv2d(_q(self.quant, x), _q(self.quant, self.weight),
                        self.bias, self.stride, self.padding)


class ConvT(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride = stride
        self.quant = None

    def forward(self, x):
        return F.conv_transpose2d(_q(self.quant, x),
                                  _q(self.quant, self.weight), self.bias,
                                  self.stride, (1, 0))


def inorm(x):
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + EPS_IN)


class ConvBlock(nn.Module):
    """conv (+ ELU + IN)."""

    def __init__(self, cin, cout, stride, act_norm=True):
        super().__init__()
        self.conv = Conv(cin, cout, stride)
        self.act_norm = act_norm

    def forward(self, x):
        x = self.conv(x)
        return inorm(F.elu(x)) if self.act_norm else x


class DeconvBlock(nn.Module):
    """transposed conv + ELU + IN."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.deconv = ConvT(cin, cout, stride)

    def forward(self, x):
        return inorm(F.elu(self.deconv(x)))


class DenseBlock(nn.Module):
    """Five conv + ELU + IN layers, each over the concatenation of the
    block's input and every earlier layer's output; growth g1, last width
    g2."""

    def __init__(self, cin, g1, g2):
        super().__init__()
        widths = [g1] * 4 + [g2]
        self.convs = nn.ModuleList(
            Conv(cin + i * g1, widths[i], padding=(1, 1)) for i in range(5))

    def forward(self, x):
        ts = [x]
        for conv in self.convs:
            ts.append(inorm(F.elu(conv(torch.cat(ts, dim=1)))))
        return ts[-1]


class DSConv(nn.Module):
    """depthwise dilated conv1d -> PReLU -> gLN -> pointwise conv1d."""

    def __init__(self, c, dilation):
        super().__init__()
        self.dilation = dilation
        self.depthwise = nn.Module()
        self.depthwise.weight = nn.Parameter(torch.empty(c, 1, 3))
        self.prelu = nn.Module()
        self.prelu.alpha = nn.Parameter(torch.empty(()))
        self.norm = nn.Module()
        self.norm.gamma = nn.Parameter(torch.empty(1, 1, c))
        self.norm.beta = nn.Parameter(torch.empty(1, 1, c))
        self.pointwise = nn.Module()
        self.pointwise.weight = nn.Parameter(torch.empty(c, c, 1))
        self.quant = None

    def forward(self, x):
        c = x.shape[1]
        x = F.conv1d(_q(self.quant, x), _q(self.quant, self.depthwise.weight),
                     padding=self.dilation, dilation=self.dilation, groups=c)
        x = torch.where(x >= 0, x, self.prelu.alpha * x)
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        x = (self.norm.gamma.reshape(1, -1, 1) * (x - mean)
             / torch.sqrt(var + EPS_GLN) + self.norm.beta.reshape(1, -1, 1))
        return F.conv1d(_q(self.quant, x), _q(self.quant, self.pointwise.weight))


class TemporalBlock(nn.Module):
    def __init__(self, c, dilation):
        super().__init__()
        self.dsconv1 = DSConv(c, dilation)
        self.dsconv2 = DSConv(c, dilation)

    def forward(self, x):
        y = self.dsconv1(F.elu(inorm(x)))
        y = self.dsconv2(F.elu(inorm(y)))
        return y + x


class MISONet(nn.Module):
    """The separation (MISO1: C mics in, S speakers out) or per-speaker
    enhancement (MISO3: C + 2 channels in, 1 out) net of ``plan``."""

    def __init__(self, plan: dict, in_channels: int, num_spks: int):
        super().__init__()
        if plan.get("norm_type", "IN") != "IN":
            raise ValueError("the reference implements norm_type IN only")
        nb = plan["num_bottleneck"]
        en = list(plan["en_channels"])
        de = list(plan["de_channels"]) + [2 * num_spks]
        self.nb = nb
        c_in = 2 * in_channels
        for i in range(nb):
            stride = (1, 1 if i in (0, nb - 1) else 2)
            self.add_module(f"enc{i}", ConvBlock(c_in, en[i], stride,
                                                 act_norm=i > 0))
            if i < 5:
                self.add_module(f"enc{i}_dense", DenseBlock(en[i], en[i], en[i]))
            c_in = en[i]
        self.tcn = nn.Module()
        for r in range(plan["tcn_repeats"]):
            for b in range(plan["tcn_blocks"]):
                self.tcn.add_module(f"repeat{r}_block{b}",
                                    TemporalBlock(plan["tcn_channels"], 2**b))
        c_x = plan["tcn_channels"]
        for i in range(nb):
            cin = c_x + en[nb - 1 - i]
            if i >= 2:
                self.add_module(f"dec{i}_dense", DenseBlock(cin, cin // 2, cin))
            if i == nb - 1:
                self.add_module(f"dec{i}", ConvT(cin, de[i + 1], (1, 1)))
            else:
                self.add_module(f"dec{i}", DeconvBlock(
                    cin, de[i + 1], (1, 1 if i == 0 else 2)))
            c_x = de[i + 1]

    def set_quant(self, quant: str | None) -> None:
        for m in self.modules():
            if hasattr(m, "quant"):
                m.quant = quant

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        x = torch.cat([mix.real, mix.imag], dim=1).float()
        skips = []
        for i in range(self.nb):
            x = getattr(self, f"enc{i}")(x)
            dense = getattr(self, f"enc{i}_dense", None)
            if dense is not None:
                x = dense(x)
            skips.append(x)
        if x.shape[3] != 1:
            raise ValueError(f"the frequency ladder ends at {x.shape[3]}, not 1")
        y = x[..., 0]
        for block in self.tcn.children():
            y = block(y)
        x = y[..., None]
        for i in range(self.nb):
            x = torch.cat([x, skips[self.nb - 1 - i]], dim=1)
            dense = getattr(self, f"dec{i}_dense", None)
            if dense is not None:
                x = dense(x)
            x = getattr(self, f"dec{i}")(x)
        re, im = torch.chunk(x, 2, dim=1)
        return torch.complex(re, im)


def param_spec(net: nn.Module) -> list[tuple[str, tuple[int, ...], str, int]]:
    """(name, shape, init, fan_in) of every parameter, in state-dict order:
    ``init`` is "normal" (LeCun normal, std 1/sqrt(fan_in)) for conv
    weights, "zero" for biases and shifts, "one" for gains, "prelu" (0.25)
    for PReLU slopes: the measured program's initialization rule."""
    out = []
    for name, p in net.named_parameters():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            owner = net.get_submodule(name.rsplit(".", 1)[0])
            fan = shape[0] * 9 if isinstance(owner, ConvT) else int(
                torch.Size(shape[1:]).numel())
            out.append((name, shape, "normal", fan))
        elif leaf in ("bias", "beta"):
            out.append((name, shape, "zero", 0))
        elif leaf == "gamma":
            out.append((name, shape, "one", 0))
        elif leaf == "alpha":
            out.append((name, shape, "prelu", 0))
        else:
            raise ValueError(f"no initialization rule for {name}")
    return out

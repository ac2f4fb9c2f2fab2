"""TF-GridNet as a MISO1 separator (Wang, Cornell, Choi, Lee, Kim, Watanabe,
"TF-GridNet: Integrating Full- and Sub-Band Modeling for Speech Separation",
IEEE/ACM TASLP 31 (2023), arXiv:2211.12433).

The layout and the parameter names are those of ESPnet's ``TFGridNet``
separator (espnet2/enh/separator/tfgridnet_separator.py); the net takes and
gives spectrograms, as the port's other separator (``MISONet``) does:

  complex [B, M, T, F] -> divided by its RMS over (mics, frames, bins)
  -> the real planes, then the imaginary ones [B, 2M, T, F]
  -> Conv2d 3x3 (2M -> D) -> GroupNorm with one group
  -> ``n_layers`` GridNet blocks, each
       intra  LN4D -> unfold along F (kernel I, stride J) -> a BLSTM of H
              units each way over the F' = (F - I) / J + 1 positions ->
              ConvTranspose1d (2H -> D, kernel I, stride J) -> + its input
       inter  the same along T, with its own LN4D, BLSTM and deconv
       attn   L heads: Q, K = LN4DCF(PReLU(conv1x1 D -> E)) and
              V = LN4DCF(PReLU(conv1x1 D -> D/L)), each flattened per frame;
              softmax(Q K^T / sqrt(E F)) V; the heads concatenated ->
              LN4DCF(PReLU(conv1x1 D -> D)) -> + its input
  -> ConvTranspose2d 3x3 (D -> 2S), speaker s's real and imaginary planes
     at channels 2s and 2s + 1 -> times the RMS -> complex [B, S, T, F].

LN4D normalises over channels at each (t, f), LN4DCF over (channels,
frequency) at each t.  ESPnet scales the waveform by its standard deviation;
this net is given the spectrogram, so it scales by the spectrogram's RMS, on
the device.

Layout.  The blocks hold their activations as [B, T, F, D]: the logical
[B, D, T, F] in channels-last order, from the input conv's output to the
output deconv's input.  So LN4D normalises over the innermost axis, and the
attention's 1x1 convs are matmuls over it.  In each full- or sub-band
module:

* the normalised input is gathered straight into the BLSTM's sequence-major
  order, [L', N, I*D], and rounded as it goes; the I taps of a window are
  tap-major (row l, tap k: position l*J + k), and the BLSTM's input weights
  keep ESPnet's channel-major columns (channel c, tap k: c*I + k) and are
  reordered in their per-call cast;
* ``torch.lstm`` runs sequence-major (``batch_first=False``), so neither the
  call nor its backward transposes;
* the ConvTranspose1d is one matmul of the BLSTM's output [L'*N, 2H] with
  the weight as [2H, I*D] (tap-major), then an overlap-add of the I taps at
  stride J onto the residual plus the bias, written in the residual's
  layout.  The gather and the overlap-add are each other's backward.

The attention flattens Q and K per frame in (F, E) order and V in (F, C):
one order shared by Q and K leaves the scores as they are, and V's order is
the heads' output's, which the concat projection reads as channels.

Precision (``TFGridNetConfig.compute_dtype``): parameters stay float32 and
are cast where they are used.  In "bfloat16":

* activations between modules are bfloat16; convs and matmuls take bfloat16
  operands and accumulate in float32;
* the BLSTMs run ``torch.lstm`` (cuDNN's LSTM on the card) on bfloat16
  inputs, weights and states; cuDNN sums the gates in float32;
* the norms compute their statistics and their output in float32 and store
  the output in bfloat16;
* the deconv's taps are bfloat16 products; the overlap-add sums them, the
  bias and the residual in float32 and rounds once;
* the attention's scores are a bfloat16 matmul, its softmax float32;
* the RMS and the rescale of the output are float32, the output complex64.

"float32" computes everything in float32.

Traced (``utils/profiling``): the spans ``tfgridnet.intra``,
``tfgridnet.inter`` and ``tfgridnet.attn`` around each block's three
modules, ``tfgridnet.rnn`` around each BLSTM call and ``tfgridnet.rnn_bwd``
around its autograd node in the backward; the counters
``tfgridnet.rnn_steps``, adding each BLSTM call's sequence length, and
``tfgridnet.relayout_bytes``, adding the bytes the forward's layout work
writes: each module's gather and overlap-add (its float32 accumulator, the
taps added to it and its rounding), the attention's two relayouts (the
heads stacked into the batch, their outputs into channels), and the padding
and crop where T or F needs them.  The backward does the mirror of each.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from misonet_tpu_torch.config import TFGridNetConfig
from misonet_tpu_torch.utils import profiling

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MS_FLOOR = 1e-10   # the input's mean square is held above this (silence)
# cuDNN copies weights that are not views of one buffer (the casts are not)
_UNFLATTENED = "RNN module weights are not part of single contiguous chunk"
RELAYOUT = "tfgridnet.relayout_bytes"
# a module's sequence axis first: the full band runs along F, the sub band
# along T, over the [B, T, F, D] activations
ALONG_F, ALONG_T = (2, 0, 1, 3), (1, 0, 2, 3)


def _standardize(x, dims, eps):
    """(x - mean) / sqrt(var + eps) over ``dims``, in float32."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dims, unbiased=False, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps)


def _norm(x, dims, gamma, beta, eps):
    """(x - mean) / sqrt(var + eps) * gamma + beta over ``dims``, in
    float32."""
    return _standardize(x, dims, eps) * gamma + beta


def _cast(w, dtype):
    """``w`` in ``dtype``, contiguous, in one pass."""
    return w.to(dtype, memory_format=torch.contiguous_format).contiguous()


class LayerNormalization4D(nn.Module):
    """Over the channels at each (t, f) of [B, T, F, D]; gain and shift
    [1, D, 1, 1].  Its output goes straight into a BLSTM's input: the
    windows of ``taps`` positions at ``stride`` along the axis ``perm`` puts
    first, [L', N, I*D] in x's dtype (:class:`_NormUnfold`)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1, 1))
        self.eps = eps

    def forward(self, x, perm, taps: int, stride: int):
        return _NormUnfold.apply(_standardize(x, (3,), self.eps),
                                 self.gamma.flatten(), self.beta.flatten(),
                                 perm, taps, stride, x.dtype)


class LayerNormalization4DCF(nn.Module):
    """Over (frequency, channels) at each t of [B, T, F, C], stored in x's
    dtype; gain and shift [1, C, 1, F]."""

    def __init__(self, channels: int, freqs: int, eps: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channels, 1, freqs))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1, freqs))
        self.eps = eps

    def forward(self, x):
        c, f = self.gamma.shape[1], self.gamma.shape[3]
        gamma, beta = (p.view(c, f).t() for p in (self.gamma, self.beta))
        return _norm(x, (2, 3), gamma, beta, self.eps).to(x.dtype)


def _projection(cin: int, cout: int, freqs: int, eps: float) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1), nn.PReLU(),
                         LayerNormalization4DCF(cout, freqs, eps))


def _project(seq: nn.Sequential, x):
    """LN4DCF(PReLU(conv1x1(x))) on [B, T, F, Cin] in ``x``'s dtype: the
    conv a matmul over the innermost axis."""
    conv, prelu, norm = seq
    y = F.linear(x, conv.weight.to(x.dtype).flatten(1), conv.bias.to(x.dtype))
    return norm(F.prelu(y, prelu.weight.to(x.dtype)))


def _taps(seq, taps: int, stride: int) -> list:
    """The views [L', ...] of ``seq`` [S, ...] at positions k, k + J, ...:
    tap k of each of the L' = (S - I) / J + 1 windows, for k < I."""
    steps = (seq.shape[0] - taps) // stride + 1
    return [seq[k:k + (steps - 1) * stride + 1:stride] for k in range(taps)]


def _gather(seq, taps: int, stride: int, dtype):
    """seq [S, ..., D] -> [L', ..., I, D] in ``dtype``: row l, tap k holds
    position l*J + k."""
    views = _taps(seq, taps, stride)
    out = seq.new_empty((*views[0].shape[:-1], taps, seq.shape[-1]),
                        dtype=dtype)
    for k, v in enumerate(views):
        out[..., k, :].copy_(v)
    return out


def _overlap_add(seq, z, stride: int) -> None:
    """seq [S, ..., D] += z [L', ..., I, D] in place, tap k of row l onto
    position l*J + k."""
    for k, v in enumerate(_taps(seq, z.shape[-2], stride)):
        v += z[..., k, :]


class _NormUnfold(torch.autograd.Function):
    """A norm's last op, xhat * gamma + beta, written straight into the
    BLSTM's input: xhat [B, T, F, D] (float32) -> [L', N, I*D] in ``dtype``,
    sequence-major along the axis ``perm`` puts first (N the other two, in
    order), row l's taps tap-major; one write a tap.  The backward
    overlap-adds the gradient in float32."""

    @staticmethod
    def forward(ctx, xhat, gamma, beta, perm, taps, stride, dtype):
        views = _taps(xhat.permute(perm), taps, stride)
        u = xhat.new_empty((*views[0].shape[:-1], taps, xhat.shape[-1]),
                           dtype=dtype)                      # [L', N1, N2, I, D]
        for k, v in enumerate(views):
            torch.addcmul(beta, v, gamma, out=u[..., k, :])
        ctx.save_for_backward(xhat, gamma)
        ctx.perm, ctx.stride, ctx.taps_shape = perm, stride, u.shape
        return u.view(u.shape[0], -1, taps * u.shape[-1])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xhat, gamma = ctx.saved_tensors
        acc = torch.zeros_like(xhat)
        _overlap_add(acc.permute(ctx.perm), g.reshape(ctx.taps_shape),
                     ctx.stride)
        need = ctx.needs_input_grad
        return (acc * gamma if need[0] else None,
                (acc * xhat).sum((0, 1, 2)) if need[1] else None,
                acc.sum((0, 1, 2)) if need[2] else None,
                None, None, None, None)


class _OverlapAdd(torch.autograd.Function):
    """h [B, T, F, D] + bias [D] + the taps z [L', N1, N2, I, D]
    overlap-added along the axis ``perm`` puts first: summed in float32,
    rounded once to h's dtype, in h's layout; the backward gathers."""

    @staticmethod
    def forward(ctx, z, h, bias, perm, stride):
        ctx.perm, ctx.stride, ctx.taps = perm, stride, z.shape[-2]
        acc = h + bias                    # float32: the bias is float32
        _overlap_add(acc.permute(perm), z, stride)
        return acc.to(h.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dz = db = None
        if ctx.needs_input_grad[0]:
            dz = _gather(g.permute(ctx.perm), ctx.taps, ctx.stride, g.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2), dtype=torch.float32)
        return dz, g, db, None, None


def _deconv(linear: nn.ConvTranspose1d, y, h, perm, stride: int):
    """h + ConvTranspose1d(y) along the axis ``perm`` puts first, y [L', N1,
    N2, 2H]: one matmul with the weight as [2H, I*D], tap-major, then the
    overlap-add of the I taps onto h and the bias."""
    cin, d, taps = linear.weight.shape
    w = _cast(linear.weight.permute(0, 2, 1), y.dtype).view(cin, taps * d)
    z = torch.mm(y.reshape(-1, cin), w).view(*y.shape[:-1], taps, d)
    return _OverlapAdd.apply(z, h, linear.bias, perm, stride)


def _blstm(rnn: nn.LSTM, x, train: bool, taps: int = 1):
    """[L, N, In] -> [L, N, 2H]: the bidirectional LSTM ``rnn`` over N
    sequences, sequence-major, in ``x``'s dtype, its weights cast to it.
    x's columns are ``taps`` groups of In / taps, group k holding tap k;
    ``rnn``'s input weights keep ESPnet's columns (channel c, tap k at
    c * taps + k) and are reordered in the cast."""
    length, n, cin = x.shape
    profiling.count("tfgridnet.rnn_steps", length)
    with profiling.span("tfgridnet.rnn"):
        h0 = x.new_zeros(2, n, rnn.hidden_size)
        weights = []
        for w_ih, *rest in rnn.all_weights:
            w_ih = w_ih.view(-1, cin // taps, taps).transpose(1, 2)
            weights += [_cast(w_ih, x.dtype).view(-1, cin),
                        *(w.to(x.dtype) for w in rest)]
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_UNFLATTENED)
            out = torch.lstm(x, (h0, h0), weights, True, 1, 0.0, train, True,
                             False)[0]
    profiling.node_span(out.grad_fn, "tfgridnet.rnn_bwd")
    return out


class GridNetBlock(nn.Module):
    """[B, T, F, D] -> [B, T, F, D]."""

    def __init__(self, cfg: TFGridNetConfig, freqs: int):
        super().__init__()
        d, i, j = cfg.emb_dim, cfg.emb_ks, cfg.emb_hs
        h, heads = cfg.lstm_hidden_units, cfg.attn_n_head
        if d % heads:
            raise ValueError(f"emb_dim {d} is not a multiple of "
                             f"attn_n_head {heads}")
        e = math.ceil(cfg.attn_approx_qk_dim / freqs)
        self.emb_ks, self.emb_hs, self.n_head = i, j, heads
        for side in ("intra", "inter"):
            self.add_module(f"{side}_norm", LayerNormalization4D(d, cfg.eps))
            self.add_module(f"{side}_rnn", nn.LSTM(d * i, h, 1,
                                                   bidirectional=True))
            self.add_module(f"{side}_linear",
                            nn.ConvTranspose1d(2 * h, d, i, stride=j))
        for k in range(heads):
            self.add_module(f"attn_conv_Q_{k}", _projection(d, e, freqs, cfg.eps))
            self.add_module(f"attn_conv_K_{k}", _projection(d, e, freqs, cfg.eps))
            self.add_module(f"attn_conv_V_{k}",
                            _projection(d, d // heads, freqs, cfg.eps))
        self.attn_concat_proj = _projection(d, d, freqs, cfg.eps)

    def _module(self, side: str, h, perm):
        """h + deconv(BLSTM(unfold(LN4D(h)))) along the axis ``perm`` puts
        first."""
        i, j = self.emb_ks, self.emb_hs
        u = getattr(self, f"{side}_norm")(h, perm, i, j)
        y = _blstm(getattr(self, f"{side}_rnn"), u, self.training, i)
        n1, n2 = (h.shape[p] for p in perm[1:3])
        profiling.count(RELAYOUT, u.numel() * u.element_size()
                        + (h.numel() + u.numel()) * 4
                        + (h.numel() * h.element_size()
                           if h.dtype != torch.float32 else 0))
        return _deconv(getattr(self, f"{side}_linear"),
                       y.view(y.shape[0], n1, n2, -1), h, perm, j)

    def forward(self, h):
        _, t0, f0, _ = h.shape
        i, j = self.emb_ks, self.emb_hs
        t = math.ceil((t0 - i) / j) * j + i
        f = math.ceil((f0 - i) / j) * j + i
        padded = (t, f) != (t0, f0)
        if padded:
            h = F.pad(h, (0, 0, 0, f - f0, 0, t - t0))
            profiling.count(RELAYOUT, h.numel() * h.element_size())
        with profiling.span("tfgridnet.intra"):
            h = self._module("intra", h, ALONG_F)
        with profiling.span("tfgridnet.inter"):
            h = self._module("inter", h, ALONG_T)
        if padded:
            h = h[:, :t0, :f0].contiguous()
            profiling.count(RELAYOUT, h.numel() * h.element_size())
        with profiling.span("tfgridnet.attn"):
            return h + self._attention(h)

    def _attention(self, h):
        b, t, f, _ = h.shape
        heads = self.n_head
        q, k, v = (torch.cat([_project(getattr(self, f"attn_conv_{w}_{i}"), h)
                              for i in range(heads)]).flatten(2)
                   for w in "QKV")                   # [L*B, T, F*C]
        c = v.shape[-1] // f
        scores = torch.matmul(q, k.transpose(1, 2)).float()  # [L*B, T, T]
        attn = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)               # [L*B, T, F*C]
        out = out.view(heads, b, t, f, c).permute(1, 2, 3, 0, 4)
        out = out.reshape(b, t, f, heads * c)
        profiling.count(RELAYOUT, (q.numel() + k.numel() + v.numel()
                                   + out.numel()) * out.element_size())
        return _project(self.attn_concat_proj, out)


class TFGridNet(nn.Module):
    """complex64 [B, num_mics, T, n_fft // 2 + 1] -> complex64
    [B, num_spks, T, F]."""

    def __init__(self, cfg: TFGridNetConfig, num_mics: int, num_spks: int = 2):
        super().__init__()
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: the PyTorch "
                             f"port computes in {' or '.join(COMPUTE_DTYPES)}")
        self.cfg = cfg
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.num_spks = num_spks
        self.freqs = cfg.n_fft // 2 + 1
        d = cfg.emb_dim
        self.conv = nn.Sequential(nn.Conv2d(2 * num_mics, d, 3, padding=1),
                                  nn.GroupNorm(1, d, eps=cfg.eps))
        self.blocks = nn.ModuleList(GridNetBlock(cfg, self.freqs)
                                    for _ in range(cfg.n_layers))
        self.deconv = nn.ConvTranspose2d(d, 2 * num_spks, 3, padding=1)

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        if (mixture.ndim != 4 or not mixture.is_complex()
                or mixture.shape[3] != self.freqs):
            raise ValueError(f"expected complex [B, C, T, {self.freqs}], got "
                             f"{mixture.dtype} {tuple(mixture.shape)}")
        dt, cl = self.dtype, torch.channels_last
        re, im = mixture.real.float(), mixture.imag.float()
        ms = (re.square() + im.square()).mean((1, 2, 3), keepdim=True)
        rms = torch.sqrt(ms.clamp_min(MS_FLOOR))               # [B, 1, 1, 1]
        x = (torch.cat([re, im], dim=1) / rms).to(dt, memory_format=cl)
        conv, norm = self.conv
        x = F.conv2d(x, conv.weight.to(dt, memory_format=cl), conv.bias.to(dt),
                     padding=1)
        h = x.permute(0, 2, 3, 1).contiguous()                 # [B, T, F, D]
        # GroupNorm with one group: over (T, F, D) of each item
        h = _norm(h, (1, 2, 3), norm.weight, norm.bias, norm.eps).to(dt)
        for block in self.blocks:
            h = block(h)
        y = F.conv_transpose2d(h.permute(0, 3, 1, 2),
                               self.deconv.weight.to(dt, memory_format=cl),
                               self.deconv.bias.to(dt), padding=1).float()
        b, _, t, f = y.shape
        y = y.view(b, self.num_spks, 2, t, f) * rms[..., None]
        return torch.complex(y[:, :, 0], y[:, :, 1])


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Weights LeCun-normal (std 1/sqrt(fan_in); a transposed conv's fan_in
    is its input channels times its kernel, an LSTM matrix's its columns),
    biases and shifts 0, gains 1, PReLU 0.25, drawn from ``generator`` (a
    CPU generator) in module order."""

    def normal(p, fan_in):
        p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            normal(m.weight, m.weight[0].numel())
            m.bias.zero_()
        elif isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
            normal(m.weight, m.weight.shape[0] * m.weight[0, 0].numel())
            m.bias.zero_()
        elif isinstance(m, nn.LSTM):
            for name, p in m.named_parameters():
                if name.startswith("weight"):
                    normal(p, p.shape[1])
                else:
                    p.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)


def make_tfgridnet(cfg: TFGridNetConfig, num_mics: int = 6, num_spks: int = 2,
                   *, device="cuda", generator: torch.Generator | None = None
                   ) -> TFGridNet:
    """A TF-GridNet separator with parameters drawn from ``generator`` (a
    CPU generator; seed 0 when None), on ``device``."""
    model = TFGridNet(cfg, num_mics, num_spks)
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.to(device)

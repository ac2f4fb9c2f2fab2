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

Precision (``TFGridNetConfig.compute_dtype``): parameters stay float32 and
are cast where they are used.  In "bfloat16":

* activations between modules are bfloat16; convs and matmuls take bfloat16
  operands and accumulate in float32;
* the BLSTMs run ``torch.lstm`` (cuDNN's LSTM on the card) on bfloat16
  inputs, weights and states; cuDNN sums the gates in float32;
* the norms compute their statistics and their output in float32 and store
  the output in bfloat16;
* the attention's scores are a bfloat16 matmul, its softmax float32;
* the RMS and the rescale of the output are float32, the output complex64.

"float32" computes everything in float32.

Traced (``utils/profiling``): the spans ``tfgridnet.intra``,
``tfgridnet.inter`` and ``tfgridnet.attn`` around each block's three
modules, ``tfgridnet.rnn`` around each BLSTM call and ``tfgridnet.rnn_bwd``
around its autograd node in the backward; the counter
``tfgridnet.rnn_steps`` adds each BLSTM call's sequence length.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F

from misonet_tpu_torch.config import TFGridNetConfig
from misonet_tpu_torch.utils import profiling

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MS_FLOOR = 1e-10   # the input's mean square is held above this (silence)
# cuDNN copies weights that are not views of one buffer (the casts are not)
_UNFLATTENED = "RNN module weights are not part of single contiguous chunk"


def _norm(x, dims, gamma, beta, eps):
    """(x - mean) / sqrt(var + eps) * gamma + beta over ``dims``, in
    float32, stored in ``x``'s dtype."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dims, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


class LayerNormalization4D(nn.Module):
    """Over the channels at each (t, f); gain and shift [1, C, 1, 1]."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1, 1))
        self.eps = eps

    def forward(self, x):
        return _norm(x, (1,), self.gamma, self.beta, self.eps)


class LayerNormalization4DCF(nn.Module):
    """Over (channels, frequency) at each t; gain and shift [1, C, 1, F]."""

    def __init__(self, channels: int, freqs: int, eps: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channels, 1, freqs))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1, freqs))
        self.eps = eps

    def forward(self, x):
        return _norm(x, (1, 3), self.gamma, self.beta, self.eps)


def _projection(cin: int, cout: int, freqs: int, eps: float) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1), nn.PReLU(),
                         LayerNormalization4DCF(cout, freqs, eps))


def _project(seq: nn.Sequential, x):
    """LN4DCF(PReLU(conv1x1(x))) in ``x``'s dtype."""
    conv, prelu, norm = seq
    y = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))
    return norm(F.prelu(y, prelu.weight.to(x.dtype)))


def _blstm(rnn: nn.LSTM, x, train: bool):
    """[N, L, In] -> [N, L, 2H]: the bidirectional LSTM ``rnn`` in ``x``'s
    dtype, its weights cast to it."""
    n, length, _ = x.shape
    profiling.count("tfgridnet.rnn_steps", length)
    with profiling.span("tfgridnet.rnn"):
        h0 = x.new_zeros(2, n, rnn.hidden_size)
        weights = [w.to(x.dtype) for layer in rnn.all_weights for w in layer]
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_UNFLATTENED)
            out = torch.lstm(x, (h0, h0), weights, True, 1, 0.0, train, True,
                             True)[0]
    profiling.node_span(out.grad_fn, "tfgridnet.rnn_bwd")
    return out


class GridNetBlock(nn.Module):
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
            self.add_module(f"{side}_rnn", nn.LSTM(d * i, h, 1, batch_first=True,
                                                   bidirectional=True))
            self.add_module(f"{side}_linear",
                            nn.ConvTranspose1d(2 * h, d, i, stride=j))
        for k in range(heads):
            self.add_module(f"attn_conv_Q_{k}", _projection(d, e, freqs, cfg.eps))
            self.add_module(f"attn_conv_K_{k}", _projection(d, e, freqs, cfg.eps))
            self.add_module(f"attn_conv_V_{k}",
                            _projection(d, d // heads, freqs, cfg.eps))
        self.attn_concat_proj = _projection(d, d, freqs, cfg.eps)

    def _sequence(self, rnn, linear, u):
        """[N, D, L] -> unfold -> BLSTM -> deconv -> [N, D, L]."""
        u = u.unfold(2, self.emb_ks, self.emb_hs)            # [N, D, L', I]
        n, d, steps, k = u.shape
        u = u.permute(0, 2, 1, 3).reshape(n, steps, d * k)   # [N, L', D*I]
        y = _blstm(rnn, u, self.training).transpose(1, 2)    # [N, 2H, L']
        return F.conv_transpose1d(y, linear.weight.to(y.dtype),
                                  linear.bias.to(y.dtype), stride=self.emb_hs)

    def forward(self, x):
        b, d, t0, f0 = x.shape
        i, j = self.emb_ks, self.emb_hs
        t = math.ceil((t0 - i) / j) * j + i
        f = math.ceil((f0 - i) / j) * j + i
        if (t, f) != (t0, f0):
            x = F.pad(x, (0, f - f0, 0, t - t0))
        with profiling.span("tfgridnet.intra"):
            u = self.intra_norm(x).transpose(1, 2).reshape(b * t, d, f)
            y = self._sequence(self.intra_rnn, self.intra_linear, u)
            x = x + y.view(b, t, d, f).transpose(1, 2)
        with profiling.span("tfgridnet.inter"):
            u = self.inter_norm(x).permute(0, 3, 1, 2).reshape(b * f, d, t)
            y = self._sequence(self.inter_rnn, self.inter_linear, u)
            x = x + y.view(b, f, d, t).permute(0, 2, 3, 1)
        x = x[..., :t0, :f0]
        with profiling.span("tfgridnet.attn"):
            return x + self._attention(x)

    def _attention(self, x):
        b, _, t, f = x.shape
        heads = range(self.n_head)
        q, k, v = (torch.cat([_project(getattr(self, f"attn_conv_{w}_{h}"), x)
                              for h in heads])
                   for w in "QKV")                          # [L*B, C, T, F]
        c = v.shape[1]
        q, k, v = (z.transpose(1, 2).flatten(2) for z in (q, k, v))
        scores = torch.matmul(q, k.transpose(1, 2)).float()  # [L*B, T, T]
        attn = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)               # [L*B, T, C*F]
        out = out.view(self.n_head, b, t, c, f).permute(1, 0, 3, 2, 4)
        return _project(self.attn_concat_proj,
                        out.reshape(b, self.n_head * c, t, f))


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
        dt = self.dtype
        re, im = mixture.real.float(), mixture.imag.float()
        ms = (re.square() + im.square()).mean((1, 2, 3), keepdim=True)
        rms = torch.sqrt(ms.clamp_min(MS_FLOOR))               # [B, 1, 1, 1]
        x = (torch.cat([re, im], dim=1) / rms).to(dt)
        conv, norm = self.conv
        x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
        x = F.group_norm(x.float(), 1, norm.weight, norm.bias, norm.eps).to(dt)
        for block in self.blocks:
            x = block(x)
        y = F.conv_transpose2d(x, self.deconv.weight.to(dt),
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

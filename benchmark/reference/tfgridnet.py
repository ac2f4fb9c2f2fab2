"""Plain float32 TF-GridNet (Wang, Cornell, Choi, Lee, Kim, Watanabe, IEEE/ACM
TASLP 31 (2023), arXiv:2211.12433) as a multi-mic separator, written from
the paper's equations in the layout of ESPnet's ``TFGridNet`` separator
(espnet2/enh/separator/tfgridnet_separator.py): plain ``torch`` ops, no
kernel, no bf16, and no ``nn.LSTM``.  Parameter names and shapes are the
measured program's (``misonet_tpu_torch/models/tfgridnet.py``), so one state
dict, made by the benchmark from the seed, loads into both.

  complex [B, M, T, F] / RMS over (mics, frames, bins) -> [re; im] planes
  -> Conv2d 3x3 + GroupNorm(1) -> blocks -> ConvTranspose2d 3x3 -> [B, S, 2,
  T, F] x RMS -> complex [B, S, T, F]

Each block: the full-band module (LN4D over channels, unfold along F with
kernel I and stride J, a BLSTM, ConvTranspose1d back to F, + residual), the
sub-band module (the same along T) and the cross-frame self-attention
(per head Q, K = LN4DCF(PReLU(conv1x1 D -> E)), V = LN4DCF(PReLU(conv1x1
D -> D/L)); softmax(Q K^T / sqrt(E F)) V; the heads concatenated ->
LN4DCF(PReLU(conv1x1 D -> D)), + residual).  The LSTM is its own recurrence:
gates = x W_ih^T + h W_hh^T + b_ih + b_hh in the order i, f, g, o; both
directions in one loop, as a batched matmul over a leading axis of 2.

ESPnet scales the waveform by its standard deviation; the measured program
is given the spectrogram, so both scale by its RMS (a departure from ESPnet,
the same in both).

``set_quant("fp8")`` rounds the operands of every matmul and conv (inputs
and weights, per tensor) to float8 e4m3: the control that computes this
reference one precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.nets import fake_fp8

MS_FLOOR = 1e-10


def _q(quant, x):
    return fake_fp8(x) if quant == "fp8" else x


class Conv(nn.Module):
    """Conv2d with a square kernel."""

    def __init__(self, cin, cout, k, padding=0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.padding = padding
        self.quant = None

    def forward(self, x):
        return F.conv2d(_q(self.quant, x), _q(self.quant, self.weight),
                        self.bias, padding=self.padding)


class ConvT(nn.Module):
    """ConvTranspose1d or 2d: weight [cin, cout, *kernel]."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, *kernel))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.padding = stride, padding
        self.quant = None

    def forward(self, x):
        fn = F.conv_transpose1d if self.weight.ndim == 3 else F.conv_transpose2d
        return fn(_q(self.quant, x), _q(self.quant, self.weight), self.bias,
                  self.stride, self.padding)


class GroupNorm1(nn.Module):
    """GroupNorm with one group: over (channels, frames, bins) per item."""

    def __init__(self, c, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(dim=(1, 2, 3), keepdim=True)
        var = x.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        x = (x - mu) / torch.sqrt(var + self.eps)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class LayerNorm(nn.Module):
    """LN4D (``freqs`` None: over channels, gain [1, C, 1, 1]) or LN4DCF
    (over channels and bins, gain [1, C, 1, F])."""

    def __init__(self, c, eps, freqs=None):
        super().__init__()
        shape = (1, c, 1, freqs or 1)
        self.gamma = nn.Parameter(torch.empty(shape))
        self.beta = nn.Parameter(torch.empty(shape))
        self.dims = (1,) if freqs is None else (1, 3)
        self.eps = eps

    def forward(self, x):
        mu = x.mean(dim=self.dims, keepdim=True)
        std = torch.sqrt(x.var(dim=self.dims, unbiased=False, keepdim=True)
                         + self.eps)
        return (x - mu) / std * self.gamma + self.beta


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight * x)


class BLSTM(nn.Module):
    """A one-layer bidirectional LSTM, batch first, written as its
    recurrence."""

    def __init__(self, cin, hidden):
        super().__init__()
        for sfx in ("", "_reverse"):
            self.register_parameter(f"weight_ih_l0{sfx}",
                                    nn.Parameter(torch.empty(4 * hidden, cin)))
            self.register_parameter(f"weight_hh_l0{sfx}",
                                    nn.Parameter(torch.empty(4 * hidden, hidden)))
            self.register_parameter(f"bias_ih_l0{sfx}",
                                    nn.Parameter(torch.empty(4 * hidden)))
            self.register_parameter(f"bias_hh_l0{sfx}",
                                    nn.Parameter(torch.empty(4 * hidden)))
        self.hidden = hidden
        self.quant = None

    def forward(self, x):
        """[N, L, In] -> [N, L, 2H]: the forward direction's states, then
        the reverse direction's, each at its own position."""
        q, hid = self.quant, self.hidden
        n, steps, cin = x.shape
        w_ih = torch.stack([self.weight_ih_l0, self.weight_ih_l0_reverse])
        w_hh = torch.stack([self.weight_hh_l0, self.weight_hh_l0_reverse])
        b = torch.stack([self.bias_ih_l0 + self.bias_hh_l0,
                         self.bias_ih_l0_reverse + self.bias_hh_l0_reverse])
        xs = torch.stack([x, x.flip(1)]).reshape(2, n * steps, cin)
        gx = torch.bmm(_q(q, xs), _q(q, w_ih).transpose(1, 2))
        gx = gx.view(2, n, steps, 4 * hid) + b[:, None, None]
        w_hh = _q(q, w_hh).transpose(1, 2)                  # [2, H, 4H]
        h = x.new_zeros(2, n, hid)
        c = x.new_zeros(2, n, hid)
        out = []
        for t in range(steps):
            g = gx[:, :, t] + torch.bmm(_q(q, h), w_hh)
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        hs = torch.stack(out, dim=2)                        # [2, N, L, H]
        return torch.cat([hs[0], hs[1].flip(1)], dim=-1)


def _projection(cin, cout, freqs, eps):
    return nn.Sequential(Conv(cin, cout, 1), PReLU(), LayerNorm(cout, eps, freqs))


class GridNetBlock(nn.Module):
    def __init__(self, plan: dict, freqs: int):
        super().__init__()
        d, ks, hs = plan["emb_dim"], plan["emb_ks"], plan["emb_hs"]
        hid, heads, eps = plan["lstm_hidden_units"], plan["attn_n_head"], plan["eps"]
        e = math.ceil(plan["attn_approx_qk_dim"] / freqs)
        self.ks, self.hs, self.heads = ks, hs, heads
        for side in ("intra", "inter"):
            self.add_module(f"{side}_norm", LayerNorm(d, eps))
            self.add_module(f"{side}_rnn", BLSTM(d * ks, hid))
            self.add_module(f"{side}_linear", ConvT(2 * hid, d, (ks,), hs))
        for k in range(heads):
            self.add_module(f"attn_conv_Q_{k}", _projection(d, e, freqs, eps))
            self.add_module(f"attn_conv_K_{k}", _projection(d, e, freqs, eps))
            self.add_module(f"attn_conv_V_{k}", _projection(d, d // heads, freqs, eps))
        self.attn_concat_proj = _projection(d, d, freqs, eps)
        self.quant = None

    def _along(self, rnn, linear, x):
        """[N, C, L] (already normalised) -> unfold -> BLSTM -> deconv."""
        r = F.unfold(x[..., None], (self.ks, 1), stride=(self.hs, 1))
        return linear(rnn(r.transpose(1, 2)).transpose(1, 2))

    def forward(self, x):
        b, c, old_t, old_q = x.shape
        t = math.ceil((old_t - self.ks) / self.hs) * self.hs + self.ks
        q = math.ceil((old_q - self.ks) / self.hs) * self.hs + self.ks
        x = F.pad(x, (0, q - old_q, 0, t - old_t))
        # full band: a sequence over the bins of each frame
        r = self.intra_norm(x).transpose(1, 2).reshape(b * t, c, q)
        r = self._along(self.intra_rnn, self.intra_linear, r)
        x = r.view(b, t, c, q).transpose(1, 2) + x
        # sub band: a sequence over the frames of each bin
        r = self.inter_norm(x).permute(0, 3, 1, 2).reshape(b * q, c, t)
        r = self._along(self.inter_rnn, self.inter_linear, r)
        x = r.view(b, q, c, t).permute(0, 2, 3, 1) + x
        x = x[..., :old_t, :old_q]
        # cross-frame self-attention
        qs, ks, vs = (torch.cat([getattr(self, f"attn_conv_{w}_{h}")(x)
                                 for h in range(self.heads)])
                      for w in "QKV")                       # [L*B, C', T, F]
        cv = vs.shape[1]
        qs, ks, vs = (z.transpose(1, 2).flatten(2) for z in (qs, ks, vs))
        scores = torch.matmul(_q(self.quant, qs),
                              _q(self.quant, ks).transpose(1, 2))
        attn = torch.softmax(scores / math.sqrt(qs.shape[-1]), dim=2)
        v = torch.matmul(_q(self.quant, attn), _q(self.quant, vs))
        v = v.reshape(self.heads * b, old_t, cv, old_q).transpose(1, 2)
        v = v.reshape(self.heads, b, cv, old_t, old_q).transpose(0, 1)
        v = v.reshape(b, self.heads * cv, old_t, old_q)
        return self.attn_concat_proj(v) + x


class TFGridNet(nn.Module):
    """``plan`` holds ESPnet's widths: n_layers, emb_dim, emb_ks, emb_hs,
    lstm_hidden_units, attn_n_head, attn_approx_qk_dim, eps; ``freqs`` is
    the STFT's bins."""

    def __init__(self, plan: dict, num_mics: int, num_spks: int, freqs: int):
        super().__init__()
        d = plan["emb_dim"]
        self.num_spks = num_spks
        self.conv = nn.Sequential(Conv(2 * num_mics, d, 3, padding=1),
                                  GroupNorm1(d, plan["eps"]))
        self.blocks = nn.ModuleList(GridNetBlock(plan, freqs)
                                    for _ in range(plan["n_layers"]))
        self.deconv = ConvT(d, 2 * num_spks, (3, 3), padding=1)

    def set_quant(self, quant: str | None) -> None:
        for m in self.modules():
            if hasattr(m, "quant"):
                m.quant = quant

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        re, im = mix.real.float(), mix.imag.float()
        ms = (re ** 2 + im ** 2).mean(dim=(1, 2, 3), keepdim=True)
        rms = torch.sqrt(torch.clamp(ms, min=MS_FLOOR))
        x = torch.cat([re, im], dim=1) / rms
        x = self.conv(x)
        for block in self.blocks:
            x = block(x)
        y = self.deconv(x)
        b, _, t, f = y.shape
        y = y.view(b, self.num_spks, 2, t, f) * rms[..., None]
        return torch.complex(y[:, :, 0], y[:, :, 1])


def param_spec(net: nn.Module) -> list[tuple[str, tuple[int, ...], str, int]]:
    """(name, shape, init, fan_in) of every parameter, in state-dict order,
    under ``reference/nets.py::param_spec``'s convention: "normal" (LeCun,
    std 1/sqrt(fan_in)) for conv, transposed-conv and LSTM weights (a
    transposed conv's fan_in is its input channels times its kernel, an LSTM
    matrix's its columns), "zero" for biases and shifts, "one" for gains,
    "prelu" (0.25) for PReLU slopes."""
    out = []
    for name, p in net.named_parameters():
        shape = tuple(p.shape)
        path, _, leaf = name.rpartition(".")
        owner = net.get_submodule(path)
        if isinstance(owner, PReLU):
            out.append((name, shape, "prelu", 0))
        elif isinstance(owner, (GroupNorm1, LayerNorm)):
            kind = "one" if leaf in ("weight", "gamma") else "zero"
            out.append((name, shape, kind, 0))
        elif leaf.startswith("bias"):
            out.append((name, shape, "zero", 0))
        elif isinstance(owner, ConvT):
            out.append((name, shape, "normal", shape[0] * math.prod(shape[2:])))
        elif isinstance(owner, (Conv, BLSTM)):
            out.append((name, shape, "normal", math.prod(shape[1:])))
        else:
            raise ValueError(f"no initialization rule for {name}")
    return out


def make_state_dict(net: nn.Module, seed: int, device) -> dict:
    """A state dict for ``net`` under :func:`param_spec`, drawn as
    ``reference/weights.py`` draws MISONet's: one ``randn`` on ``device``
    from a generator seeded by ``seed``, split and scaled."""
    spec = param_spec(net)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = sum(math.prod(s) for _, s, kind, _ in spec if kind == "normal")
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    fill = {"zero": 0.0, "one": 1.0, "prelu": 0.25}
    for name, shape, kind, fan in spec:
        if kind == "normal":
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape) / math.sqrt(fan)
            off += k
        else:
            out[name] = torch.full(shape, fill[kind], device=device)
    return out

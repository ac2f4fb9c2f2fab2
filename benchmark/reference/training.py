"""The MISO1 training step in plain form (reference Trainer_Separate,
trainer.py:144-212): the scaled STFT of the wave batch, the net, the
utterance-level PIT loss (criterion.py:8-63: the summed L1 of real,
imaginary and magnitude per speaker pair, the cheapest permutation per
row, the mean over rows), the backward, optax's clip of the global norm
when the configuration clips, and Adam (lr from the configuration,
betas 0.9 / 0.999, eps 1e-8).

Rows go through the net in blocks, their gradients summed, so the step
fits beside whatever else is on the card; the norms are per row, so the
blocks change nothing but the order of sums.
"""

from __future__ import annotations

import itertools

import torch

from benchmark.reference import dsp

EPS = 1e-8


def upit_rows(est: torch.Tensor, ref: torch.Tensor, margins=None) -> torch.Tensor:
    """Per-row PIT loss of [B, S, T, F] complex estimates and references;
    each row's relative margin between its two cheapest permutations is
    appended to ``margins`` when given."""
    e, r = est[:, :, None], ref[:, None, :]
    mag_e = torch.sqrt(e.real ** 2 + e.imag ** 2 + EPS)
    pair = ((e.real - r.real).abs().sum((3, 4)) + (e.imag - r.imag).abs().sum((3, 4))
            + (mag_e - r.abs()).abs().sum((3, 4)))                 # [B, S, S]
    s = est.shape[1]
    costs = [pair[:, torch.arange(s), torch.tensor(p)].sum(-1)
             for p in itertools.permutations(range(s))]
    costs = torch.stack(costs, -1)
    if margins is not None:
        srt = costs.detach().sort(-1).values
        margins += ((srt[:, 1] - srt[:, 0]) / srt[:, 0]).tolist()
    return costs.amin(-1)


def features(mix_wave, ref_wave, cfg):
    """[B, samples, C], [B, S, samples] -> ([B, C, T, F] mixture rolled so
    the reference mic is first, [B, S, T, F] references), complex64."""
    st = cfg["stft"]
    length, hop = st["length"], st["length"] - st["overlap"]
    mix = dsp.stft(mix_wave.transpose(1, 2), length, hop)
    mix = torch.roll(mix, -cfg["dataset"]["ref_ch"], dims=1)
    return mix.to(torch.complex64), dsp.stft(ref_wave, length, hop).to(
        torch.complex64)


class Adam:
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def train(net, batches, cfg: dict, steps: int, rows_per_block: int = 4):
    """Run ``steps`` steps from ``net``'s parameters over ``batches`` (a list
    of (mix_wave, ref_wave) device tensors).  Returns {``loss``: [steps]
    floats, ``grad1``: {leaf: the gradient step 1's Adam got}, ``params``:
    {leaf: its value after the last step}, ``pit_margins``: each row's}."""
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    opt_cfg = cfg["optimizer"]
    opt = Adam(params, opt_cfg["lr"])
    losses, grad1, margins = [], None, []
    for k in range(steps):
        mix_wave, ref_wave = batches[k]
        b = mix_wave.shape[0]
        grads = [torch.zeros_like(p) for p in params]
        total = 0.0
        for lo in range(0, b, rows_per_block):
            mix, ref = features(mix_wave[lo:lo + rows_per_block],
                                ref_wave[lo:lo + rows_per_block], cfg)
            loss = upit_rows(net(mix), ref, margins).sum() / b
            for acc, g in zip(grads, torch.autograd.grad(loss, params)):
                acc += g
            total += float(loss.detach())
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if opt_cfg.get("clipping") and norm >= opt_cfg["max_norm"]:
            grads = [g / norm * opt_cfg["max_norm"] for g in grads]
        if k == 0:
            grad1 = [g.clone() for g in grads]
        opt.step(grads)
        losses.append(total)
    return {"loss": losses, "grad1": dict(zip(names, grad1)), "pit_margins": margins,
            "params": {n: p.detach().clone() for n, p in zip(names, params)}}

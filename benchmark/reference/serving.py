"""The served paths in plain form: the MISO1 -> MVDR -> MISO3 cascade over a
whole utterance (reference Tester_Enhance with utterance-mode MVDR,
tester.py:340-451 and :846-975, no clean references) and streaming CSS over
consecutive 4 s blocks with running SCMs.

Nets run in float32 (TF32 off), one 4 s chunk (M shifted copies) per
forward; everything else in float64 / complex128.

Speaker order is a discrete choice: each shifted run's speakers are ordered
to the reference-mic run's, and each chunk's (block's) to the previous
one's, by the cheapest permutation of magnitude distances.  Where the two
cheapest permutations' costs differ by less than ``TIE`` of the cheaper,
rounding decides, and either order is a correct answer.  So each function
returns every variant of its outputs over those ties (the cheapest order,
and the next one at each tie, up to ``MAX_VARIANTS``); a comparison judges
the program's outputs against the nearest variant.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import dsp

TIE = 3e-3
MAX_VARIANTS = 16


class Decisions:
    """Speaker-order decisions of one pass: ``choose(key, dist)`` returns the
    cheapest permutation, or the second cheapest where ``key`` is
    overridden, and records each decision's margin."""

    def __init__(self, overrides=frozenset()):
        self.overrides = overrides
        self.margins: dict = {}

    def choose(self, key, dist: torch.Tensor) -> torch.Tensor:
        perms, margin = dsp.align2(dist)
        self.margins[key] = margin
        return perms[1] if key in self.overrides else perms[0]

    def ties(self):
        return sorted((m, k) for k, m in self.margins.items() if m < TIE)


def variants(run):
    """``run(decisions)`` for the cheapest orders and for the next order at
    each tie (ties of ties too), up to MAX_VARIANTS.  Returns (outputs of
    each variant, every margin of the first pass)."""
    first = Decisions()
    outs = [run(first)]
    queue = [frozenset([k]) for _, k in first.ties()]
    seen = set(queue)
    while queue and len(outs) < MAX_VARIANTS:
        over = queue.pop(0)
        d = Decisions(over)
        outs.append(run(d))
        for _, k in d.ties():
            nxt = over | {k}
            if k not in over and nxt not in seen:
                seen.add(nxt)
                queue.append(nxt)
    return outs, list(first.margins.values())


def shifted(net, mix: torch.Tensor) -> torch.Tensor:
    """Every circular mic shift of one chunk through the net: mix [C, T, F]
    -> [M, S, T, F] complex128; shift m puts mic m first."""
    m = mix.shape[0]
    shifts = torch.stack([torch.roll(mix, -s, dims=0) for s in range(m)])
    return net(shifts.to(torch.complex64)).to(torch.complex128)


def align_shifts(est: torch.Tensor, ref_ch: int, dec: Decisions, key):
    """[M, S, T, F] -> [S, M, T, F], each shift's speakers ordered to the
    ref-mic run's: each speaker's image at every mic."""
    mag = est.abs()
    out = []
    for m in range(est.shape[0]):
        if m == ref_ch:
            out.append(est[m])
            continue
        dist = (mag[ref_ch][:, None] - mag[m][None, :]).abs().sum((-2, -1))
        out.append(est[m][dec.choose(key + (m,), dist)])
    return torch.stack(out, dim=1)


def chain(x: torch.Tensor, prev_mag, ref_ch: int, dec: Decisions, key):
    """Order a chunk's [S, C, T, F] speakers to the previous chunk's
    magnitudes at the reference mic (none before the first)."""
    if prev_mag is not None:
        mag = x[:, ref_ch].abs()
        d = (prev_mag[:, None] - mag[None, :]).abs().sum((-2, -1))
        x = x[dec.choose(key, d)]
    return x, x[:, ref_ch].abs()


@torch.no_grad()
def cascade(miso1, miso3, mix_wave: np.ndarray, cfg: dict, device):
    """mix_wave [samples, C] -> (variants, margins): each variant a dict of
    [S, samples] numpy waves ``separated``, ``beamformed``, ``enhanced``."""
    st, ds = cfg["stft"], cfg["dataset"]
    length, hop = st["length"], st["length"] - st["overlap"]
    chunk = int(ds["chunk_time"] * ds["fs"])
    ref = ds["ref_ch"]
    out_len = mix_wave.shape[0]
    pieces, _ = dsp.split_chunks(mix_wave, chunk)                # [N, chunk, C]
    n = pieces.shape[0]
    x = torch.as_tensor(pieces.transpose(0, 2, 1).copy(), device=device)
    mix = dsp.stft(x, length, hop)                                # [N, C, T, F]
    est = [shifted(miso1, mix[i]) for i in range(n)]
    mixw = torch.as_tensor(mix_wave.T.copy(), device=device)      # [C, samples]
    mixs = dsp.stft(mixw, length, hop)
    # the SCMs are normalized by the frame count of the power-of-two bucket
    # of chunks, as the program's function states
    frames = dsp.num_frames((1 << (n - 1).bit_length()) * chunk, length, hop)

    def run(dec: Decisions) -> dict:
        full, prev = [], None
        for i in range(n):
            xi, prev = chain(align_shifts(est[i], ref, dec, ("shift", i)), prev,
                             ref, dec, ("chain", i))
            full.append(xi)
        full = torch.stack(full)                                  # [N, S, C, T, F]
        s, c = full.shape[1], full.shape[2]
        m1 = full[:, :, ref]                                      # [N, S, T, F]
        separated = stitch(dsp.istft(m1, length, hop, chunk), out_len)
        # utterance-mode MVDR over the stitched multi-channel estimates
        wav = dsp.istft(full, length, hop, chunk)                 # [N, S, C, chunk]
        wav = wav.permute(1, 2, 0, 3).reshape(s, c, n * chunk)[..., :out_len]
        src = dsp.stft(wav, length, hop)
        w = dsp.mvdr_weights(dsp.scm(src, frames), dsp.scm(mixs[None] - src, frames),
                             ref, cfg["mvdr"]["power_iters"], cfg["mvdr"]["diag_load"])
        bf = dsp.apply_weights(w, mixs[None])                     # [S, T, F]
        bf_wave = dsp.istft(bf, length, hop, out_len)             # [S, samples]
        bf_chunks, _ = dsp.split_chunks(bf_wave.T.cpu().numpy(), chunk)
        bf_stft = dsp.stft(torch.as_tensor(bf_chunks.transpose(0, 2, 1).copy(),
                                           device=device), length, hop)
        enh = []
        for i in range(n):
            inp = torch.cat([mix[i][None].expand(s, -1, -1, -1), m1[i][:, None],
                             bf_stft[i][:, None]], dim=1)         # [S, C+2, T, F]
            enh.append(miso3(inp.to(torch.complex64))[:, 0].to(torch.complex128))
        enhanced = stitch(dsp.istft(torch.stack(enh), length, hop, chunk), out_len)
        return {"separated": separated, "beamformed": bf_wave.cpu().numpy(),
                "enhanced": enhanced}

    return variants(run)


def stitch(chunks: torch.Tensor, out_len: int) -> np.ndarray:
    """[N, S, chunk] -> [S, out_len] numpy."""
    n, s, chunk = chunks.shape
    return chunks.permute(1, 0, 2).reshape(s, n * chunk)[:, :out_len].cpu().numpy()


@torch.no_grad()
def css(miso1, scene: np.ndarray, blocks: int, cfg: dict, device,
        forget: float = 1.0):
    """Streaming CSS over the first ``blocks`` 4 s blocks of ``scene``
    [samples, C], running SCMs from the scene's start.  Returns (variants,
    margins): each variant a list of per-block dicts {``miso1``,
    ``beamformed``: [S, chunk] numpy}."""
    st, ds = cfg["stft"], cfg["dataset"]
    length, hop = st["length"], st["length"] - st["overlap"]
    chunk = int(ds["chunk_time"] * ds["fs"])
    ref = ds["ref_ch"]
    mixes, ests = [], []
    for k in range(blocks):
        wave = torch.as_tensor(scene[k * chunk:(k + 1) * chunk].T.copy(),
                               device=device)
        mixes.append(dsp.stft(wave, length, hop))                 # [C, T, F]
        ests.append(shifted(miso1, mixes[-1]))

    def run(dec: Decisions) -> list:
        rs = rn = None
        frames, prev, out = 0.0, None, []
        for k, (mix, est) in enumerate(zip(mixes, ests)):
            full, prev = chain(align_shifts(est, ref, dec, ("shift", k)), prev,
                               ref, dec, ("chain", k))
            s_sum, n_sum = _outer(full), _outer(mix[None] - full)
            rs = s_sum if rs is None else forget * rs + s_sum
            rn = n_sum if rn is None else forget * rn + n_sum
            frames = forget * frames + full.shape[-2]
            w = dsp.mvdr_weights(_herm(rs) / frames, _herm(rn) / frames, ref,
                                 cfg["mvdr"]["power_iters"], cfg["mvdr"]["diag_load"])
            bf = dsp.apply_weights(w, mix[None])
            out.append({
                "miso1": dsp.istft(full[:, ref], length, hop, chunk).cpu().numpy(),
                "beamformed": dsp.istft(bf, length, hop, chunk).cpu().numpy()})
        return out

    return variants(run)


def _outer(x):
    x = x.to(torch.complex128)
    return torch.einsum("...ctf,...dtf->...fcd", x, x.conj())


def _herm(r):
    return 0.5 * (r + r.transpose(-1, -2).conj())

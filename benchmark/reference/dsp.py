"""Plain signal processing in float64 / complex128: the reference's scaled
STFT and its inverse (scipy.signal semantics: periodic Hann window,
boundary zeros, padded to whole hops; the features are scipy's STFT times
the window sum), utterance chunking, and MVDR beamforming (reference
tester.py:637-794) with the steering vector from a fixed count of power
iterations, the JAX package's and the measured program's stated function.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F


def hann(length: int, device) -> torch.Tensor:
    n = torch.arange(length, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos(2 * np.pi * n / length)


def num_frames(samples: int, length: int, hop: int) -> int:
    padded = samples + length
    extra = (-(padded - length)) % hop
    return (padded + extra - length) // hop + 1


def stft(x: torch.Tensor, length: int, hop: int) -> torch.Tensor:
    """[..., S] real -> [..., T, F] complex128, unnormalized framed rFFT."""
    half = length // 2
    padded = x.shape[-1] + 2 * half
    extra = (-(padded - length)) % hop
    xp = F.pad(x.to(torch.float64), (half, half + extra))
    frames = xp.unfold(-1, length, hop) * hann(length, x.device)
    return torch.fft.rfft(frames, dim=-1)


def istft(z: torch.Tensor, length: int, hop: int, out: int) -> torch.Tensor:
    """Inverse of :func:`stft` by windowed overlap-add over the overlap-added
    squared window; [..., T, F] -> [..., out] float64."""
    win = hann(length, z.device)
    frames = torch.fft.irfft(z.to(torch.complex128), n=length, dim=-1) * win
    t = frames.shape[-2]
    total = (t - 1) * hop + length
    num = torch.zeros(frames.shape[:-2] + (total,), dtype=torch.float64,
                      device=z.device)
    den = torch.zeros(total, dtype=torch.float64, device=z.device)
    for i in range(t):
        num[..., i * hop:i * hop + length] += frames[..., i, :]
        den[i * hop:i * hop + length] += win ** 2
    y = num / torch.where(den > 1e-10, den, torch.ones_like(den))
    y = y[..., length // 2:]
    return y[..., :out] if y.shape[-1] >= out else F.pad(
        y, (0, out - y.shape[-1]))


def split_chunks(x: np.ndarray, chunk: int) -> tuple[np.ndarray, int]:
    """[S, ...] -> ([N, chunk, ...] zero-padded, gap)."""
    n = max(1, -(-x.shape[0] // chunk))
    gap = n * chunk - x.shape[0]
    xp = np.pad(x, [(0, gap)] + [(0, 0)] * (x.ndim - 1))
    return xp.reshape((n, chunk) + x.shape[1:]), gap


def align2(dist: torch.Tensor) -> tuple[torch.Tensor, float]:
    """dist [S, S] (slot x candidate) -> (the permutations [P, S] from the
    cheapest up, each giving the candidate per slot; the relative margin of
    the cheapest over the next)."""
    s = dist.shape[-1]
    perms = torch.tensor(list(itertools.permutations(range(s))),
                         device=dist.device)                     # [P, S]
    cost = torch.stack([dist[torch.arange(s), p].sum() for p in perms])
    order = torch.argsort(cost)
    srt = cost[order]
    margin = float((srt[1] - srt[0]) / srt[0].clamp(min=1e-30))
    return perms[order], margin


def scm(x: torch.Tensor, frames: int) -> torch.Tensor:
    """[..., C, T, F] -> hermitized sum_t x x^H / frames, [..., F, C, C]."""
    x = x.to(torch.complex128)
    r = torch.einsum("...ctf,...dtf->...fcd", x, x.conj()) / frames
    return 0.5 * (r + r.transpose(-1, -2).conj())


def _norm(v):
    return torch.sqrt((v.abs() ** 2).sum(-1, keepdim=True))


def steering(rs: torch.Tensor, ref_ch: int, iters: int) -> torch.Tensor:
    """Principal eigenvector of each [M, M] by ``iters`` power iterations from
    R 1, divided by its reference-mic entry, scaled by sqrt(M / ||d||),
    phase-corrected across frequency.  [..., F, M, M] -> [..., F, M]."""
    m = rs.shape[-1]
    v = rs.sum(-1)
    n = _norm(v)
    v = torch.where(n > 0, v / n.clamp(min=1e-30),
                    torch.full_like(v, 1 / m ** 0.5))
    for _ in range(iters):
        w = (rs @ v[..., None])[..., 0]
        n = _norm(w)
        v = torch.where(n > 1e-30, w / n.clamp(min=1e-30), v)
    d = v / v[..., ref_ch:ref_ch + 1]
    d = d * torch.sqrt(m / _norm(d))
    s = (d[..., 1:, :] * d[..., :-1, :].conj()).sum(-1)
    unit = torch.where(s.abs() > 0, s / s.abs().clamp(min=1e-30),
                       torch.ones_like(s))
    first = torch.ones(s.shape[:-1] + (1,), dtype=s.dtype, device=s.device)
    return d * torch.cumprod(torch.cat([first, unit.conj()], -1), -1)[..., None]


def mvdr_weights(rs, rn, ref_ch: int, iters: int, diag: float = 1e-6):
    """w = (Rn + diag I)^-1 d / (d^H (Rn + diag I)^-1 d)."""
    d = steering(rs, ref_ch, iters)
    eye = torch.eye(rn.shape[-1], dtype=rn.dtype, device=rn.device)
    x = torch.linalg.solve(rn + diag * eye, d[..., None])[..., 0]
    return x / (d.conj() * x).sum(-1, keepdim=True)


def apply_weights(w, x):
    """sum_c conj(w[..., f, c]) x[..., c, t, f] -> [..., T, F]."""
    return (w.conj().transpose(-1, -2)[..., None, :] * x).sum(-3)

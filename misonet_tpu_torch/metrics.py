"""Evaluation metrics (misonet_tpu/metrics.py): SI-SDR, its permutation-
best mean over speakers, plain SDR, the PESQ hook, and an independent
numpy oracle."""

from __future__ import annotations

import itertools

import numpy as np
import torch

EPS = 1e-8


def si_sdr(estimate: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SDR in dB (Le Roux et al. 2019).

    estimate, reference: [..., T] time-domain signals.  Returns [...]."""
    ref = reference - reference.mean(dim=-1, keepdim=True)
    est = estimate - estimate.mean(dim=-1, keepdim=True)
    dot = (est * ref).sum(dim=-1, keepdim=True)
    energy = (ref**2).sum(dim=-1, keepdim=True)
    target = dot / (energy + EPS) * ref
    noise = est - target
    ratio = (target**2).sum(dim=-1) / ((noise**2).sum(dim=-1) + EPS)
    return 10.0 * torch.log10(ratio + EPS)


def sdr(estimate: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Plain (scale-dependent) SDR in dB: [..., T] -> [...]."""
    noise = estimate - reference
    ratio = (reference**2).sum(dim=-1) / ((noise**2).sum(dim=-1) + EPS)
    return 10.0 * torch.log10(ratio + EPS)


def si_sdr_pit(estimates: torch.Tensor,
               references: torch.Tensor) -> torch.Tensor:
    """Permutation-optimal mean SI-SDR: [S, T] (or [B, S, T]) -> scalar
    (or [B])."""
    squeeze = estimates.ndim == 2
    if squeeze:
        estimates, references = estimates[None], references[None]
    num_spks = estimates.shape[1]
    pair = si_sdr(estimates[:, :, None], references[:, None, :])  # [B, S, S]
    scores = torch.stack(
        [
            torch.stack([pair[:, p[s], s] for s in range(num_spks)],
                        dim=1).mean(dim=1)
            for p in itertools.permutations(range(num_spks))
        ],
        dim=1,
    )  # [B, S!]
    out = scores.max(dim=1).values
    return out[0] if squeeze else out


def pesq(estimate: np.ndarray, reference: np.ndarray, fs: int = 8000):
    """PESQ (ITU-T P.862) hook: the ``pesq`` package's score (narrow band
    up to 8 kHz, wide band above), or None where that package does not
    import, so evaluation reports it opportunistically beside SI-SDR.  No
    P.862 implementation of its own (misonet_tpu/metrics.py says why)."""
    try:
        from pesq import pesq as _pesq  # type: ignore
    except ImportError:
        return None
    mode = "nb" if fs <= 8000 else "wb"
    return float(_pesq(fs, np.asarray(reference), np.asarray(estimate), mode))


def numpy_si_sdr(estimate: np.ndarray, reference: np.ndarray) -> float:
    """Host-side oracle (independent numpy implementation)."""
    ref = reference - reference.mean()
    est = estimate - estimate.mean()
    target = np.dot(est, ref) / (np.dot(ref, ref) + EPS) * ref
    noise = est - target
    return float(10 * np.log10(np.dot(target, target)
                               / (np.dot(noise, noise) + EPS) + EPS))

"""Training losses and the PIT alignment helpers (misonet_tpu/losses.py;
reference criterion.py).

The permutation search is a static einsum over a precomputed
permutation-indicator tensor, as in the JAX package.  All losses take
complex spectrograms ``[B, S, T, F]``.  The minimum over permutations is
``torch.amin``, which splits the gradient evenly between tied
permutations, as JAX's ``min`` does.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from misonet_tpu_torch.utils import profiling

EPS = 1e-8  # reference criterion.py:6


def _perm_one_hot(num_spks: int) -> np.ndarray:
    """[S!, S, S] permutation indicator tensor (reference criterion.py:49-53)."""
    perms = list(itertools.permutations(range(num_spks)))
    one_hot = np.zeros((len(perms), num_spks, num_spks), np.float32)
    for p, perm in enumerate(perms):
        one_hot[p, np.arange(num_spks), perm] = 1.0
    return one_hot


def _one_hot(num_spks: int, device) -> torch.Tensor:
    profiling.host_copy(device)
    return torch.as_tensor(_perm_one_hot(num_spks), device=device)


def _magnitude(z: torch.Tensor) -> torch.Tensor:
    """sqrt(re^2 + im^2 + EPS): differentiable at 0 (criterion.py:43)."""
    return torch.sqrt(z.real**2 + z.imag**2 + EPS)


def _pairwise_l1(estimate: torch.Tensor,
                 reference: torch.Tensor) -> torch.Tensor:
    """Pairwise L1(real)+L1(imag)+L1(magnitude) matrix [B, S, S] summed over
    (T, F) (criterion.py:36-47).  Axis 1 indexes the estimate, axis 2 the
    reference."""
    est = estimate[:, :, None]
    ref = reference[:, None, :]
    l1_real = (est.real - ref.real).abs().sum(dim=(3, 4))
    l1_imag = (est.imag - ref.imag).abs().sum(dim=(3, 4))
    l1_mag = (_magnitude(est) - ref.abs()).abs().sum(dim=(3, 4))
    return l1_real + l1_imag + l1_mag


def _pit(pair: torch.Tensor) -> torch.Tensor:
    per_perm = torch.einsum("bij,pij->bp", pair,
                            _one_hot(pair.shape[-1], pair.device))
    return torch.amin(per_perm, dim=1).mean()


def loss_upit(estimate: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Utterance-level PIT loss: min over speaker permutations of the summed
    pairwise L1 loss, averaged over the batch (criterion.py:8-63).
    Returns a scalar."""
    return _pit(_pairwise_l1(estimate, reference))


def loss_upit_overest(estimate: torch.Tensor, reference: torch.Tensor,
                      alpha) -> torch.Tensor:
    """PIT loss with the over-estimation penalty
    ``alpha * sum(max(|est| - |ref|, 0))`` (criterion.py:65-119)."""
    est = estimate[:, :, None]
    ref = reference[:, None, :]
    over = torch.clamp(_magnitude(est) - ref.abs(), min=0.0).sum(dim=(3, 4))
    return _pit(_pairwise_l1(estimate, reference) + alpha * over)


def loss_enhance(estimate: torch.Tensor,
                 reference: torch.Tensor) -> torch.Tensor:
    """Non-PIT enhancement loss for an aligned source: the sum of
    L1(real)+L1(imag)+L1(mag) over everything, over the batch size
    (criterion.py:121-141)."""
    l1_real = (estimate.real - reference.real).abs().sum()
    l1_imag = (estimate.imag - reference.imag).abs().sum()
    l1_mag = (_magnitude(estimate) - reference.abs()).abs().sum()
    return (l1_real + l1_imag + l1_mag) / estimate.shape[0]


def best_permutation(estimate_mag_dist: torch.Tensor) -> torch.Tensor:
    """Given a pairwise distance matrix [B, S, S] (est x ref), the
    per-batch alignment indices [B, S] mapping output slot s to the
    estimate that matches reference s (reference tester.py:125-147)."""
    one_hot = _one_hot(estimate_mag_dist.shape[-1], estimate_mag_dist.device)
    per_perm = torch.einsum("bij,pij->bp", estimate_mag_dist, one_hot)
    best = torch.argmin(per_perm, dim=1)
    return torch.argmax(one_hot[best], dim=2)


def magnitude_distance(estimate: torch.Tensor,
                       reference: torch.Tensor) -> torch.Tensor:
    """Pairwise |.|-distance matrix [B, S_est, S_ref] summed over (T, F):
    the alignment metric (reference tester.py:134-136).  Complex
    [B, S, T, F] inputs."""
    est_mag = estimate.abs()[:, :, None]
    ref_mag = reference.abs()[:, None, :]
    return (est_mag - ref_mag).abs().sum(dim=(3, 4))

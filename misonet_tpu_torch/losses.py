"""The two loss-module helpers the decode needs (misonet_tpu/losses.py
``_perm_one_hot`` and ``magnitude_distance``).  The training losses are
ported with the training slice."""

from __future__ import annotations

import itertools

import numpy as np
import torch


def _perm_one_hot(num_spks: int) -> np.ndarray:
    """[S!, S, S] permutation indicator tensor (reference criterion.py:49-53)."""
    perms = list(itertools.permutations(range(num_spks)))
    one_hot = np.zeros((len(perms), num_spks, num_spks), np.float32)
    for p, perm in enumerate(perms):
        one_hot[p, np.arange(num_spks), perm] = 1.0
    return one_hot


def magnitude_distance(estimate: torch.Tensor,
                       reference: torch.Tensor) -> torch.Tensor:
    """Pairwise |.|-distance matrix [B, S_est, S_ref] summed over (T, F):
    the alignment metric (reference tester.py:134-136).  Complex
    [B, S, T, F] inputs."""
    est_mag = estimate.abs()[:, :, None]
    ref_mag = reference.abs()[:, None, :]
    return (est_mag - ref_mag).abs().sum(dim=(3, 4))

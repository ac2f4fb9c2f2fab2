"""InstanceNorm statistics from the kernels' fused sums
(misonet_tpu/ops/pallas/dense_flat.py::stats_to_scale_mean)."""

from __future__ import annotations

import torch

EPS_IN = 1e-5  # torch InstanceNorm default (reference model.py:413)


def stats_to_scale_mean(
    sums: torch.Tensor, sqs: torch.Tensor, count: int, eps: float = EPS_IN
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, sumsq) [B, N] over ``count`` valid positions -> (1/sigma, mean)
    [B, N]: biased variance, eps inside the square root."""
    mean = sums / count
    var = torch.clamp(sqs / count - mean * mean, min=0.0)
    return torch.rsqrt(var + eps), mean

"""Streaming spatial-covariance accumulation for long-form continuous speech
separation (misonet_tpu/beamforming/scm.py).

A running SCM is kept as (sum, frame count): per-block partial sums over
disjoint frame sets combine exactly.  The JAX package can also reduce the
partial sums across devices (``chunked_scm(axis_name=...)``); that waits
for the port of ``parallel/`` and raises here.
"""

from __future__ import annotations

import torch

from misonet_tpu_torch.beamforming.mvdr import frame_outer_sum, hermitize


def scm_partial(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized SCM partial sum of one block.

    x: complex [..., C, T, F] -> (sum [..., F, C, C], frames T as a float32
    tensor on x's device)."""
    t = torch.tensor(float(x.shape[-2]), dtype=torch.float32, device=x.device)
    return frame_outer_sum(x), t


def streaming_scm_update(
    acc: tuple[torch.Tensor, torch.Tensor], block: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one block into a running (sum, count) accumulator."""
    s, t = scm_partial(block)
    return acc[0] + s, acc[1] + t


def scm_finalize(acc: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """(sum, count) -> time-averaged Hermitian SCM [..., F, C, C]."""
    s, t = acc
    return hermitize(s / t)


def chunked_scm(blocks: torch.Tensor,
                axis_name: str | None = None) -> torch.Tensor:
    """SCM over a stack of blocks [N, C, T, F] (concatenated in time),
    equal to the SCM of the concatenation.  ``axis_name`` (a reduction of
    the partial sums across devices) is not ported yet and raises."""
    if axis_name is not None:
        raise NotImplementedError(
            "chunked_scm(axis_name=...): the collective SCM reduction needs "
            "parallel/, which is not ported yet (ROADMAP)"
        )
    n, c, t, f = blocks.shape
    s = frame_outer_sum(blocks.transpose(0, 1).reshape(c, n * t, f))
    return hermitize(s / (n * t))

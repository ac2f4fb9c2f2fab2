"""Streaming spatial-covariance accumulation for long-form continuous speech
separation (misonet_tpu/beamforming/scm.py).

A running SCM is kept as (sum, frame count): per-block partial sums over
disjoint frame sets combine exactly, also across the ranks of a mesh
(``chunked_scm(blocks, mesh)``, the JAX package's ``axis_name``).
"""

from __future__ import annotations

import torch

from misonet_tpu_torch.beamforming.mvdr import frame_outer_sum, hermitize
from misonet_tpu_torch.parallel.mesh import sum_over


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


def chunked_scm(blocks: torch.Tensor, mesh=None) -> torch.Tensor:
    """SCM over a stack of blocks [N, C, T, F] (concatenated in time),
    equal to the SCM of the concatenation.  With ``mesh`` (a
    ``parallel.Mesh``; the JAX package names it by ``axis_name``) each rank
    holds its own blocks, and the partial sums and frame counts are summed
    over the mesh, so every rank gets the SCM of all the ranks' blocks."""
    n, c, t, f = blocks.shape
    x = blocks.transpose(0, 1).reshape(c, n * t, f)
    frames = n * t
    if mesh is None:
        s = frame_outer_sum(x)
    else:   # the partial sums meet in complex128
        s = frame_outer_sum(x.to(torch.complex128))
        sum_over(torch.view_as_real(s), mesh)
        s = s.to(blocks.dtype)
        frames *= mesh.size   # shards of one shape, as under shard_map
    return hermitize(s / frames)

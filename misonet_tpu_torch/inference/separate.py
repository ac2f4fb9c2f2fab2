"""MISO1 inference: circular-shift full-array decode + PIT alignment
(misonet_tpu/inference/separate.py; reference MISO1_Inference,
tester.py:201-255).

All M microphone shifts ride the batch axis of ONE forward; each shifted
run's speaker order is aligned to the reference-mic run by minimum
magnitude distance, per (shift, batch) element."""

from __future__ import annotations

import torch

from misonet_tpu_torch.losses import _perm_one_hot
from misonet_tpu_torch.utils import profiling


def align_slots(dist: torch.Tensor) -> torch.Tensor:
    """Minimum-cost slot assignment: dist [..., S, S] with dist[..., slot,
    candidate] -> int64 [..., S], the candidate chosen for each slot under
    the best global permutation (tester.py:137-147)."""
    s = dist.shape[-1]
    profiling.host_copy(dist.device)
    one_hot = torch.as_tensor(_perm_one_hot(s), device=dist.device,
                              dtype=dist.dtype)              # [S!, S, S]
    per_perm = torch.einsum("...ij,pij->...p", dist, one_hot)
    best = torch.argmin(per_perm, dim=-1)
    perms = torch.argmax(one_hot, dim=2)                      # [S!, S]
    return perms[best]


def magnitude(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.real**2 + x.imag**2)


def make_full_array_decode(model, num_mics: int, ref_ch: int = 0):
    """Build the full-array decode: mix [B, C, T, F] complex ->
    [B, S, C, T, F] complex, where output channel c is each speaker's
    estimated image at mic c.  Runs without autograd."""

    @torch.inference_mode()
    def decode(mix: torch.Tensor) -> torch.Tensor:
        b, m, t, f = mix.shape
        if m != num_mics:
            raise ValueError(f"expected {num_mics} mics, got {m}")
        with profiling.span("miso1.decode"):
            # run `sh` puts mic `sh` first and estimates the images at mic
            # `sh`
            shifts = torch.stack(
                [torch.roll(mix, -sh, dims=1) for sh in range(num_mics)]
            )                                                 # [M, B, C, T, F]
            est = model(shifts.reshape(num_mics * b, m, t, f))
            s = est.shape[1]
            est = est.reshape(num_mics, b, s, t, f)          # [M, B, S, T, F]
            mag = magnitude(est)
            dist = (mag[ref_ch][None, :, :, None] - mag[:, :, None]).abs().sum(
                dim=(-2, -1)
            )                                                 # [M, B, S, S]
            idx = align_slots(dist)                           # [M, B, S]
            aligned = torch.take_along_dim(est, idx[..., None, None], dim=2)
            return aligned.permute(1, 2, 0, 3, 4)             # [B, S, M, T, F]

    return decode

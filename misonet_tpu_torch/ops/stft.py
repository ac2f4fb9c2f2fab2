"""STFT / iSTFT with exact scipy.signal semantics
(misonet_tpu/ops/stft.py; reference dataloader/data.py:37-38,58,78 and
tester.py:149-157,186-198).

``stft_scaled`` is the reference's feature transform (scipy stft divided by
its window-sum scale), which is the unnormalized framed rFFT

    Z[t, f] = rfft(hann * x[t*hop : t*hop + nperseg])[f]

and ``istft_scaled`` inverts it by windowed overlap-add normalized by the
overlap-added squared window.  ``stft`` / ``istft`` are the scipy-scaled
variants.  All functions batch over leading axes and run on the tensor's
device; the FFT is ``torch.fft`` (JAX left it to XLA)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from misonet_tpu_torch.config import StftConfig


def hann_periodic(length: int) -> np.ndarray:
    """Periodic Hann window, identical to scipy.signal.get_window('hann', N)."""
    n = np.arange(length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)).astype(np.float64)


def _window(length: int, device) -> torch.Tensor:
    return torch.as_tensor(hann_periodic(length), dtype=torch.float32,
                           device=device)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., T, length] -> [..., (T-1)*hop + length] overlap-add: frame t's
    p-th hop-block lands on output block t + p."""
    *lead, num_frames, length = frames.shape
    r = length // hop
    out_blocks = num_frames + r - 1
    phases = frames.reshape(*lead, num_frames, r, hop)
    total = frames.new_zeros(*lead, out_blocks, hop)
    for p in range(r):
        total[..., p : p + num_frames, :] += phases[..., p, :]
    return total.reshape(*lead, out_blocks * hop)


def _stft_raw(x: torch.Tensor, length: int, hop: int) -> torch.Tensor:
    """Unnormalized framed rFFT with scipy's boundary='zeros' and
    padded=True conventions.  [..., S] -> [..., T, F] complex64."""
    if length % hop:
        raise ValueError(f"nperseg {length} must be a multiple of hop {hop}")
    half = length // 2
    padded = x.shape[-1] + 2 * half
    extra = (-(padded - length)) % hop
    xp = F.pad(x.to(torch.float32), (half, half + extra))
    frames = xp.unfold(-1, length, hop) * _window(length, x.device)
    return torch.fft.rfft(frames, dim=-1).to(torch.complex64)


def _istft_raw(z: torch.Tensor, length: int, hop: int,
               out_samples: int) -> torch.Tensor:
    """Inverse of `_stft_raw`: windowed OLA / OLA(win^2), trim the
    length//2 boundary padding, crop or zero-pad to ``out_samples``.
    [..., T, F] -> [..., out_samples] float32."""
    win = hann_periodic(length)
    num_frames = z.shape[-2]
    xsubs = torch.fft.irfft(z, n=length, dim=-1).to(torch.float32)
    num = _overlap_add(xsubs * _window(length, z.device), hop)
    norm = np.zeros((num_frames - 1) * hop + length)
    for t in range(num_frames):
        norm[t * hop : t * hop + length] += win**2
    norm = np.where(norm > 1e-10, norm, 1.0)
    y = num / torch.as_tensor(norm, dtype=torch.float32, device=z.device)
    y = y[..., length // 2 :]
    if y.shape[-1] >= out_samples:
        return y[..., :out_samples]
    return F.pad(y, (0, out_samples - y.shape[-1]))


def stft(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """scipy-compatible STFT: [..., S] -> [..., T, F] complex64, scaled by
    1/win.sum() exactly like scipy.signal.stft."""
    scale = 1.0 / hann_periodic(cfg.length).sum()
    return _stft_raw(x, cfg.length, cfg.hop) * scale


def istft(z: torch.Tensor, cfg: StftConfig, out_samples: int) -> torch.Tensor:
    """scipy-compatible iSTFT of `stft` output: [..., T, F] -> [..., S]."""
    scale = hann_periodic(cfg.length).sum()
    return _istft_raw(z * scale, cfg.length, cfg.hop, out_samples)


def stft_scaled(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """The reference's feature transform (scipy stft then /scale) ==
    unnormalized framed rFFT.  [..., S] -> [..., T, F] complex64."""
    return _stft_raw(x, cfg.length, cfg.hop)


def istft_scaled(z: torch.Tensor, cfg: StftConfig,
                 out_samples: int) -> torch.Tensor:
    """The reference's synthesis transform (*scale then scipy istft) ==
    windowed OLA of irfft frames.  [..., T, F] -> [..., out_samples]."""
    return _istft_raw(z, cfg.length, cfg.hop, out_samples)

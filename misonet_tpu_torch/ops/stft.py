"""STFT / iSTFT with exact scipy.signal semantics
(misonet_tpu/ops/stft.py; reference dataloader/data.py:37-38,58,78 and
tester.py:149-157,186-198).

``stft_scaled`` is the reference's feature transform (scipy stft divided by
its window-sum scale), which is the unnormalized framed rFFT

    Z[t, f] = rfft(hann * x[t*hop : t*hop + nperseg])[f]

and ``istft_scaled`` inverts it by windowed overlap-add normalized by the
overlap-added squared window.  ``istft_scaled_masked`` synthesizes only
the first ``t_valid`` frames of a bucket-padded spectrogram, and
``mask_frames`` zeroes the frames past them.  ``stft`` / ``istft`` are the
scipy-scaled variants.  All functions batch over leading axes and run on
the tensor's device; the FFT is ``torch.fft`` (JAX left it to XLA).  The
transforms are ``torch.profiler`` ranges named "stft" and "istft"."""

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
    with torch.profiler.record_function("stft"):
        xp = F.pad(x.to(torch.float32), (half, half + extra))
        frames = xp.unfold(-1, length, hop) * _window(length, x.device)
        return torch.fft.rfft(frames, dim=-1).to(torch.complex64)


def _istft_raw(z: torch.Tensor, length: int, hop: int, out_samples: int,
               t_valid: int | None = None) -> torch.Tensor:
    """Inverse of `_stft_raw`: windowed OLA / OLA(win^2), trim the
    length//2 boundary padding, crop or zero-pad to ``out_samples``.
    With ``t_valid``, frames at index >= t_valid are left out of both the
    OLA numerator and the window-energy envelope.
    [..., T, F] -> [..., out_samples] float32."""
    win = hann_periodic(length)
    num_frames = z.shape[-2]
    used = num_frames if t_valid is None else min(int(t_valid), num_frames)
    with torch.profiler.record_function("istft"):
        xsubs = torch.fft.irfft(z, n=length, dim=-1).to(torch.float32)
        xsubs = xsubs * _window(length, z.device)
        if used < num_frames:
            xsubs = mask_frames(xsubs, used)
        num = _overlap_add(xsubs, hop)
        # the overlap-added squared window of the first `used` frames, one
        # vectorized add per hop-block of the window (as _overlap_add)
        r = length // hop
        norm = np.zeros((num_frames + r - 1, hop))
        for p, w2 in enumerate((win**2).reshape(r, hop)):
            norm[p : p + used] += w2
        norm = norm.reshape(-1)
        norm = np.where(norm > 1e-10, norm, 1.0)
        y = num / torch.as_tensor(norm, dtype=torch.float32, device=z.device)
        y = y[..., length // 2 :]
        if y.shape[-1] >= out_samples:
            return y[..., :out_samples]
        return F.pad(y, (0, out_samples - y.shape[-1]))


def mask_frames(z: torch.Tensor, t_valid: int) -> torch.Tensor:
    """Zero the frames (axis -2) at index >= ``t_valid``: the frames a
    bucket-padded signal has beyond its exact-length scipy framing."""
    keep = torch.arange(z.shape[-2], device=z.device) < t_valid
    return z * keep[:, None].to(z.real.dtype)


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


def istft_scaled_masked(z: torch.Tensor, t_valid: int, cfg: StftConfig,
                        out_samples: int) -> torch.Tensor:
    """Bucket-padded synthesis of `stft_scaled` features: [..., T_b, F]
    -> [..., out_samples] from the first ``t_valid`` frames only (their
    samples and their window energy), equal to ``istft_scaled`` of the
    t_valid-cropped spectrogram."""
    return _istft_raw(z, cfg.length, cfg.hop, out_samples, t_valid)

"""Observability: TensorBoard-compatible scalar / spectrogram / audio
logging (misonet_tpu/utils/writer.py).

Equivalent of the reference's MyWriter (utils/writer.py:15-135) on
tensorboardX: the same logging set — loss scalars, log-power spectrogram
images (jet colormap, clim [-140, -50] dB, utils/plotting.py:24-39), and
iSTFT'd audio (writer.py:32-68; the port's ``ops/stft.py::istft_scaled``
on the host) — plus step timing for throughput tracking.  Degrades to a
no-op if tensorboardX is unavailable.  Host logging only: spectrograms
come in as numpy arrays or tensors and are moved to the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from misonet_tpu_torch.config import StftConfig
from misonet_tpu_torch.ops.stft import istft_scaled
from misonet_tpu_torch.utils.profiling import StepTimer


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MetricWriter:
    def __init__(self, logdir: str | Path, stft_cfg: StftConfig | None = None):
        self.stft_cfg = stft_cfg or StftConfig()
        try:
            from tensorboardX import SummaryWriter

            Path(logdir).mkdir(parents=True, exist_ok=True)
            self._tb = SummaryWriter(str(logdir))
        except ImportError:
            self._tb = None
        self._timer = StepTimer()
        self._step_running = False

    # -- scalars ----------------------------------------------------------
    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb:
            self._tb.add_scalar(tag, float(value), step)

    def scalars(self, values: dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}{k}", v, step)

    # -- spectrograms ------------------------------------------------------
    def spectrogram(self, tag: str, spec, step: int) -> None:
        """Log-power spectrogram image of complex [T, F] (plotting.py:24-39:
        20*log10|S|, clim [-140, -50])."""
        if not self._tb:
            return
        mag = np.abs(_host(spec)).T  # [F, T], freq on y
        db = 20.0 * np.log10(np.maximum(mag, 1e-10))
        lo, hi = -140.0, -50.0
        img = np.clip((db - lo) / (hi - lo), 0.0, 1.0)[::-1]  # low freq bottom
        self._tb.add_image(tag, _jet(img), step, dataformats="HWC")

    # -- audio -------------------------------------------------------------
    def audio(self, tag: str, spec, step: int, num_samples: int) -> None:
        """iSTFT a complex [T, F] spectrogram and log as audio
        (writer.py:32-68 equivalent)."""
        if not self._tb:
            return
        z = torch.from_numpy(np.ascontiguousarray(_host(spec), np.complex64))
        wav = istft_scaled(z, self.stft_cfg, num_samples).numpy()
        peak = np.abs(wav).max() or 1.0
        try:
            self._tb.add_audio(
                tag, (wav / peak)[None, :], step, sample_rate=self.stft_cfg.fs
            )
        except ModuleNotFoundError:
            # tensorboardX's audio encoding needs soundfile; without it,
            # skip audio logging rather than fail the epoch
            pass

    # -- timing (trainer.py:216-221 equivalent) ---------------------------
    def step_start(self) -> None:
        self._timer.start()
        self._step_running = True

    def step_end(self, step: int, audio_seconds: float | None = None) -> None:
        if not self._step_running:
            return
        if audio_seconds:
            dt = self._timer.stop(audio_seconds)
        else:
            # time the step but keep the rolling throughput window clean —
            # a (dt, 0.0) sample would deflate perf/audio_s_per_s
            dt = self._timer.discard()
        self.scalar("perf/step_ms", dt * 1e3, step)
        if audio_seconds:
            # rolling-window throughput (utils/profiling.StepTimer): the
            # north-star audio-s/s metric smoothed over recent steps
            self.scalar(
                "perf/audio_s_per_s", self._timer.audio_seconds_per_second,
                step,
            )
        self._step_running = False

    def close(self) -> None:
        if self._tb:
            self._tb.close()


def _jet(x: np.ndarray) -> np.ndarray:
    """Minimal jet colormap [H, W] in [0,1] -> [H, W, 3] uint8 (the
    reference uses matplotlib's jet, plotting.py:31)."""
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)

"""Tracing / profiling utilities (misonet_tpu/utils/profiling.py).

The reference's only performance instrumentation is wall-clock ms/batch
prints (trainer.py:216-221).  Here: a ``torch.profiler`` trace of any code
region (CPU and, on a card, CUDA activity; written as a Chrome trace for
Perfetto or chrome://tracing), a step timer that reports audio-seconds per
second, and the CUDA allocator's memory statistics.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a trace of the enclosed region into <logdir>/trace.json::

        with profiling.trace("logs/profile") as prof:
            state, metrics = train_step(state, mix, ref)
            torch.cuda.synchronize()

    Yields the ``torch.profiler.profile`` (``prof.key_averages()`` gives
    time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Rolling throughput tracker: feed (seconds_of_audio) per step, read
    audio-seconds/s (BASELINE.json north-star metric).  Host clock: time a
    step that ends in a value read back from the card (a step's loss), or
    synchronize before ``stop``."""

    def __init__(self, window: int = 50):
        self.window = window
        self.samples: list[tuple[float, float]] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.samples.append((dt, audio_seconds))
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return dt

    def discard(self) -> float:
        """Stop timing WITHOUT adding a sample to the throughput window
        (for steps with unknown audio content, which would otherwise
        deflate audio_seconds_per_second)."""
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return dt

    @property
    def audio_seconds_per_second(self) -> float:
        if not self.samples:
            return 0.0
        dt = sum(s[0] for s in self.samples)
        au = sum(s[1] for s in self.samples)
        return au / dt if dt > 0 else 0.0


def device_memory_stats() -> dict:
    """The CUDA allocator's statistics per card (``torch.cuda.memory_stats``:
    ``allocated_bytes.all.peak`` and the rest); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}

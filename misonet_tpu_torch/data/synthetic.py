"""Synthetic multi-microphone mixtures for tests and benchmarks (a copy of
misonet_tpu/data/synthetic.py: the same seeds give the same arrays).

The reference has no fixture generator (its tests are manual, SURVEY.md §4);
this provides reproducible SMS-WSJ-shaped data: per-speaker sources convolved
with random sparse room impulse responses per mic, summed with diffuse noise.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from misonet_tpu_torch.data.extraction import ExtractionSpec, extract_utterance
from misonet_tpu_torch.data.wavio import write_wav


def _random_rir(rng, num_taps: int = 64, decay: float = 0.3) -> np.ndarray:
    """Sparse exponentially-decaying impulse response."""
    rir = np.zeros(num_taps, np.float32)
    rir[0] = 1.0
    taps = rng.integers(1, num_taps, size=8)
    rir[taps] += rng.standard_normal(8).astype(np.float32) * decay
    rir *= np.exp(-np.arange(num_taps, dtype=np.float32) / (num_taps / 3))
    return rir


def _voiced_source(rng, num_samples: int, fs: float = 8000.0) -> np.ndarray:
    """Speech-like harmonic source: random-F0 harmonic complex with
    vibrato, random formant-ish harmonic amplitudes, a syllabic envelope,
    and a weak aspiration-noise floor.  Distinct pitches give the sources
    the spectral sparsity real speech has — separation (and therefore the
    MVDR stage's SCM quality) behaves like the paper's regime instead of
    the white-on-white worst case."""
    t = np.arange(num_samples, dtype=np.float32) / fs
    f0 = rng.uniform(90.0, 230.0)
    vibrato = 1.0 + 0.02 * np.sin(
        2 * np.pi * rng.uniform(4.0, 6.5) * t + rng.uniform(0, 2 * np.pi)
    )
    phase = 2 * np.pi * f0 * np.cumsum(vibrato) / fs
    n_harm = max(3, int((fs / 2 * 0.9) // f0))
    src = np.zeros(num_samples, np.float32)
    for k in range(1, min(n_harm, 24) + 1):
        amp = rng.uniform(0.2, 1.0) / k      # sloped, formant-ish comb
        src += (amp * np.sin(k * phase + rng.uniform(0, 2 * np.pi))).astype(
            np.float32
        )
    src += 0.05 * rng.standard_normal(num_samples).astype(np.float32)
    return src


def synth_mixture(
    seed: int,
    num_samples: int = 32000,
    num_ch: int = 6,
    num_spks: int = 2,
    noise_level: float = 0.01,
    voiced: bool = False,
) -> dict[str, np.ndarray]:
    """One synthetic utterance: {"mix": [S, C], "ref": [num_spks, S]}.

    Default sources are band-limited noise bursts with speech-like
    envelopes so PIT losses and SI-SDR behave realistically (and test
    data stays exactly reproducible across rounds); ``voiced=True``
    switches to harmonic pseudo-speech (distinct pitches per speaker) —
    the regime the cascade demo trains in."""
    rng = np.random.default_rng(seed)
    sources, images = [], []
    for _ in range(num_spks):
        if voiced:
            src = _voiced_source(rng, num_samples)
        else:
            src = rng.standard_normal(num_samples).astype(np.float32)
        # speech-like amplitude modulation (~4 Hz syllable rate at 8 kHz)
        env = 0.5 + 0.5 * np.sin(
            2 * np.pi * 4 * np.arange(num_samples) / 8000.0
            + rng.uniform(0, 2 * np.pi)
        ).astype(np.float32)
        src = src * env * (0.1 if not voiced else 0.07)
        sources.append(src.astype(np.float32))
        imgs = np.stack(
            [
                np.convolve(src, _random_rir(rng), mode="full")[:num_samples]
                for _ in range(num_ch)
            ],
            axis=1,
        )
        images.append(imgs.astype(np.float32))
    mix = sum(images) + noise_level * rng.standard_normal(
        (num_samples, num_ch)
    ).astype(np.float32)
    return {"mix": mix.astype(np.float32), "ref": np.stack(sources, axis=0)}


def synth_shard_dir(
    out_dir: str | Path,
    num_utts: int = 4,
    num_samples: int = 48000,
    num_ch: int = 6,
    chunk: int = 32000,
    least: int = 16000,
    seed: int = 0,
    fs: int = 8000,
) -> Path:
    """Write a synthetic wav corpus + extract it to shards; returns the
    shard directory.  Exercises the full ETL path (wav -> chunks -> npz)."""
    out = Path(out_dir)
    wav_dir = out / "wav"
    shard_dir = out / "shards"
    wav_dir.mkdir(parents=True, exist_ok=True)
    for u in range(num_utts):
        d = synth_mixture(seed + u, num_samples, num_ch)
        write_wav(wav_dir / f"utt{u}.wav", d["mix"], fs)
        for s in range(d["ref"].shape[0]):
            write_wav(wav_dir / f"utt{u}_{s}.wav", d["ref"][s], fs)
        spec = ExtractionSpec(
            f"utt{u}",
            str(wav_dir / f"utt{u}.wav"),
            tuple(
                str(wav_dir / f"utt{u}_{s}.wav")
                for s in range(d["ref"].shape[0])
            ),
        )
        extract_utterance(spec, shard_dir, chunk, least)
    return shard_dir

"""The benchmark's one traffic generator.  A cell's traffic is a data file
(``workloads/<cell>.json``, key ``traffic``) that this module reads; the
same seed gives the same arrays on a device, and every seed the same set of
sizes.

Mixtures follow the recipe of the measured program's own synthetic data
(``synth_mixture(voiced=True)``), frozen here and drawn with a
``torch.Generator`` on the run's device in a few large calls: two harmonic
pseudo-speech sources with distinct pitches (90-230 Hz, up to 24 sloped
harmonics, 2 % vibrato at 4-6.5 Hz, a weak noise floor) under a 4 Hz
syllabic envelope, each convolved with a sparse decaying 64-tap impulse
response per mic, plus diffuse noise at 0.01.

Traffic kinds:
  ``utterances``  a pool of ``pool`` mixtures whose lengths are the fixed set
                  min_s + (max_s - min_s) (i + 0.5) / pool, shuffled by the
                  seed; each client sends the pool in its own seeded order
  ``scene``       one long mixture streamed in blocks
  ``batches``     ``pool`` training batches of ``batch`` chunks of
                  ``chunk_s`` seconds (mixture and reference waves)
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

STREAMS = {"weights_miso1": 1, "weights_miso3": 2, "pool": 3, "order": 4,
           "sample": 5}
TAPS = 64


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, STREAMS[stream]])


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a ``torch.Generator`` from the run's seed."""
    state = np.random.SeedSequence([seed % 2**63, STREAMS[stream]]).generate_state(
        2, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, stream))
    return g


def _u(g, lo, hi, *shape):
    return lo + (hi - lo) * torch.rand(shape or (1,), generator=g,
                                       device=g.device, dtype=torch.float64)


def _voiced(g, n: int, fs: int) -> torch.Tensor:
    t = torch.arange(n, device=g.device, dtype=torch.float64) / fs
    f0 = float(_u(g, 90.0, 230.0))
    vib = 1.0 + 0.02 * torch.sin(2 * math.pi * _u(g, 4.0, 6.5) * t
                                 + _u(g, 0, 2 * math.pi))
    phase = 2 * math.pi * f0 * torch.cumsum(vib, 0) / fs
    k = torch.arange(1, min(max(3, int((fs / 2 * 0.9) // f0)), 24) + 1,
                     device=g.device, dtype=torch.float64)
    amp = _u(g, 0.2, 1.0, k.numel()) / k
    off = _u(g, 0, 2 * math.pi, k.numel())
    src = (amp[:, None] * torch.sin(k[:, None] * phase[None] + off[:, None])).sum(0)
    src = src + 0.05 * torch.randn(n, generator=g, device=g.device,
                                   dtype=torch.float64)
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * 4 * t * fs / 8000.0
                                + _u(g, 0, 2 * math.pi))
    return (src * env * 0.07).float()


def _rirs(g, mics: int, decay: float = 0.3) -> torch.Tensor:
    """[mics, TAPS] sparse exponentially decaying impulse responses."""
    rir = torch.zeros(mics, TAPS, device=g.device)
    rir[:, 0] = 1.0
    taps = torch.randint(1, TAPS, (mics, 8), generator=g, device=g.device)
    amps = torch.randn(mics, 8, generator=g, device=g.device) * decay
    rir.scatter_add_(1, taps, amps)
    return rir * torch.exp(-torch.arange(TAPS, device=g.device) / (TAPS / 3))


def mixture(g, n: int, mics: int, fs: int, spks: int = 2,
            noise: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """One voiced mixture on ``g``'s device: (mix [n, mics], refs [spks, n])
    float32."""
    srcs = torch.stack([_voiced(g, n, fs) for _ in range(spks)])   # [S, n]
    rirs = torch.stack([_rirs(g, mics) for _ in range(spks)])      # [S, M, TAPS]
    # "full" convolution, first n samples: conv1d correlates, so flip
    images = F.conv1d(F.pad(srcs[None], (TAPS - 1, 0)),
                      rirs.flip(-1).reshape(spks * mics, 1, TAPS),
                      groups=spks)[0]                              # [S*M, n]
    mix = images.reshape(spks, mics, n).sum(0).T
    mix = mix + noise * torch.randn(n, mics, generator=g, device=g.device)
    return mix.contiguous(), srcs


def utterance_lengths(t: dict, fs: int) -> list[int]:
    """The fixed set of pool lengths in samples, before shuffling."""
    p = t["pool"]
    return [int(round((t["min_s"] + (t["max_s"] - t["min_s"]) * (i + 0.5) / p)
                      * fs)) for i in range(p)]


def utterances(t: dict, cfg: dict, seed: int, device) -> list[np.ndarray]:
    """The pool: ``pool`` host mixtures [samples, mics], lengths shuffled by
    the seed."""
    ds = cfg["dataset"]
    lengths = utterance_lengths(t, ds["fs"])
    rng(seed, "pool").shuffle(lengths)
    g = generator(seed, "pool", device)
    return [mixture(g, n, ds["num_ch"], ds["fs"], ds["num_spks"])[0].cpu().numpy()
            for n in lengths]


def client_orders(t: dict, seed: int) -> list[np.ndarray]:
    """Each client's order over the pool: a seeded permutation per pass."""
    g = rng(seed, "order")
    return [np.concatenate([g.permutation(t["pool"]) for _ in range(t["passes"])])
            for _ in range(t["clients"])]


def scene(t: dict, cfg: dict, seed: int, device) -> np.ndarray:
    """One ``scene_s``-second host mixture [samples, mics]."""
    ds = cfg["dataset"]
    g = generator(seed, "pool", device)
    return mixture(g, int(t["scene_s"] * ds["fs"]), ds["num_ch"], ds["fs"],
                   ds["num_spks"])[0].cpu().numpy()


def batches(t: dict, cfg: dict, seed: int, device):
    """``pool`` host batches of (mix [B, samples, mics], refs [B, spks,
    samples]) float32 tensors, every row a different mixture."""
    ds = cfg["dataset"]
    g = generator(seed, "pool", device)
    n = int(t["chunk_s"] * ds["fs"])
    out = []
    for _ in range(t["pool"]):
        rows = [mixture(g, n, ds["num_ch"], ds["fs"], ds["num_spks"])
                for _ in range(t["batch"])]
        out.append((torch.stack([r[0] for r in rows]).cpu(),
                    torch.stack([r[1] for r in rows]).cpu()))
    return out

"""What the example programs share: the device and precision, the PIT
SI-SDR score, the synthetic corpus and its batches, the separator's
scorer, and the training loop of the MISO1 stage (the JAX package's
examples/train_synthetic.py and examples/train_cascade.py run the same
loop each)."""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Iterator

import numpy as np
import torch

from misonet_tpu_torch.config import (
    DatasetConfig,
    ModelConfig,
    OptimizerConfig,
    StftConfig,
    load_yaml,
)
from misonet_tpu_torch.data.synthetic import synth_mixture
from misonet_tpu_torch.metrics import numpy_si_sdr
from misonet_tpu_torch.ops.stft import istft_scaled, stft_scaled
from misonet_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_separate_wave_train_step,
)
from misonet_tpu_torch.utils.checkpoint import load_checkpoint

EVAL_SEED = 10_000   # eval utterance i is synth_mixture(EVAL_SEED + i)
DEMO_TAG = "demo"    # the checkpoint tag of train_synthetic --save


def pick_device(name: str) -> torch.device:
    """The device a program runs on: ``cuda`` (the default of every
    example) needs a card and never falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def compute_dtype(device: torch.device) -> str:
    """bfloat16 on the card, float32 on the CPU, as the JAX programs pick
    by platform."""
    return "bfloat16" if device.type == "cuda" else "float32"


def plan(config: str, compute: str):
    """(STFT, dataset and MISO1 configs, the last at ``compute``): the
    SMS-WSJ defaults, or the STFT, dataset (mic count, block length) and
    MISO1 plan of a YAML, as the JAX programs' ``--config`` reads them."""
    if config:
        cfg = load_yaml(config)
        stft_cfg, ds_cfg, mcfg = cfg.stft, cfg.dataset, cfg.miso1
    else:
        stft_cfg, ds_cfg, mcfg = StftConfig(), DatasetConfig(), ModelConfig()
    return stft_cfg, ds_cfg, dataclasses.replace(mcfg, compute_dtype=compute)


def pit_si_sdr(est: np.ndarray, refs: np.ndarray) -> float:
    """Mean SI-SDR (dB) of the estimates [S, N] against the references
    [S, N] under the best speaker permutation."""
    s = refs.shape[0]
    return float(max(
        np.mean([numpy_si_sdr(est[perm[k]], refs[k]) for k in range(s)])
        for perm in itertools.permutations(range(s))))


def mixture_si_sdr(utt: dict, ref_ch: int = 0) -> float:
    """The baseline: the reference mic's mixture as every speaker's
    estimate."""
    mix = utt["mix"][:, ref_ch]
    return pit_si_sdr(np.stack([mix] * utt["ref"].shape[0]), utt["ref"])


@dataclasses.dataclass
class Corpus:
    """A synthetic corpus: the training utterances stacked on the device
    (``mix`` [N, S, C], ``ref`` [N, spks, S] float32) and the held-out
    utterances on the host ({"mix": [S, C], "ref": [spks, S]} each)."""

    mix: torch.Tensor
    ref: torch.Tensor
    evals: list[dict]

    def batches(self, batch: int, steps: int,
                seed: int) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """``steps`` batches of ``batch`` utterances drawn with replacement
        from the index stream of ``np.random.default_rng(seed)``."""
        rng = np.random.default_rng(seed)
        n = self.mix.shape[0]
        for _ in range(steps):
            idx = torch.from_numpy(rng.integers(0, n, batch)).to(
                self.mix.device)
            yield self.mix.index_select(0, idx), self.ref.index_select(0, idx)


def make_corpus(n_train: int, n_eval: int, samples: int, mics: int,
                voiced: bool, device="cpu") -> Corpus:
    """Train utterances from seeds 0..n_train-1, held-out ones from
    EVAL_SEED + i (data/synthetic.py::synth_mixture)."""
    train = [synth_mixture(i, samples, mics, voiced=voiced)
             for i in range(n_train)]
    evals = [synth_mixture(EVAL_SEED + i, samples, mics, voiced=voiced)
             for i in range(n_eval)]

    def stack(key, shape):
        a = (np.stack([d[key] for d in train]) if train
             else np.zeros(shape, np.float32))
        return torch.from_numpy(a).to(device)

    return Corpus(stack("mix", (0, samples, mics)),
                  stack("ref", (0, 2, samples)), evals)


def restore_demo(ckpt: str, model) -> dict:
    """Restore <ckpt>/demo (the train state that ``train_synthetic --save``
    wrote) into ``model``; returns its metadata."""
    opt = make_optimizer(OptimizerConfig(lr=1e-3), model.parameters())
    _, meta = load_checkpoint(ckpt, DEMO_TAG, create_train_state(model, opt))
    return meta


@torch.no_grad()
def separate(model, stft_cfg: StftConfig, mix_wave: np.ndarray) -> np.ndarray:
    """One utterance [S, C] through STFT -> MISO1 -> iSTFT: the separated
    waves [spks, S] (the reference mic is channel 0)."""
    device = next(model.parameters()).device
    wave = torch.from_numpy(np.ascontiguousarray(mix_wave))[None].to(device)
    est = model(stft_scaled(wave.transpose(1, 2), stft_cfg))
    return istft_scaled(est, stft_cfg, wave.shape[1])[0].float().cpu().numpy()


def score_separator(model, stft_cfg: StftConfig,
                    evals: list[dict]) -> tuple[float, float]:
    """(mixture, separated) PIT SI-SDR in dB, means over ``evals``."""
    base = [mixture_si_sdr(d) for d in evals]
    sep = [pit_si_sdr(separate(model, stft_cfg, d["mix"]), d["ref"])
           for d in evals]
    return float(np.mean(base)), float(np.mean(sep))


@dataclasses.dataclass
class TrainLog:
    """A training loop's record: the printed points (step, loss, host
    seconds since the first step), its steps, its host seconds, and on a
    card the milliseconds between CUDA events around the whole loop."""

    points: list[tuple[int, float, float]]
    steps: int
    seconds: float
    event_ms: float | None

    @property
    def step_ms(self) -> float:
        """Milliseconds a step: by the events on a card, else the host."""
        total = self.event_ms if self.event_ms is not None else (
            1e3 * self.seconds)
        return total / max(self.steps, 1)


def run_steps(step: Callable, state, batches, steps: int, every: int,
              log: Callable[[int, float, float], None] | None = None,
              device=None):
    """Run ``state = step(state, *batch)`` over the ``steps`` batches of
    ``batches``; read the loss (a host sync) at step 0, every ``every``
    steps and at the last, and hand each point to ``log``.  Returns
    (state, TrainLog)."""
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    points = []
    t0 = time.perf_counter()
    for it, batch in enumerate(batches):
        state, metrics = step(state, *batch)
        if it % every == 0 or it == steps - 1:
            point = (it, float(metrics["loss"]), time.perf_counter() - t0)
            points.append(point)
            if log:
                log(*point)
    event_ms = None
    if cuda:
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end)
    return state, TrainLog(points, steps, time.perf_counter() - t0, event_ms)


def train_separator(model, stft_cfg: StftConfig, corpus: Corpus, steps: int,
                    batch: int, every: int = 100, log=None):
    """MISO1 training on the corpus (examples/train_synthetic.py:101-141 of
    the JAX package): Adam at lr 1e-3 with its NaN guard, the wave train
    step (STFT on the device), batches from the index stream of
    ``default_rng(0)``.  Returns (train state, TrainLog)."""
    opt = make_optimizer(OptimizerConfig(lr=1e-3), model.parameters())
    state = create_train_state(model, opt)
    step = make_separate_wave_train_step(model, opt, stft_cfg)
    return run_steps(step, state, corpus.batches(batch, steps, seed=0),
                     steps, every, log, corpus.mix.device)

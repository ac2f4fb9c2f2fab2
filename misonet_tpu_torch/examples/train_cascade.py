"""Full-cascade training demo: MISO1 -> MVDR -> MISO3 on synthetic
mixtures (the port's twin of the JAX package's examples/train_cascade.py:
the same flags, defaults, seeds and printed lines).

Runs the reference pipeline's three stages (separation training,
frozen-MISO1 MVDR beamforming, per-speaker enhancement training;
reference run.py Train MISO1 / Test Beamforming / Train MISO3) end to end
on synthetic 6-channel reverberant 2-speaker data, and reports stage-wise
SI-SDR:

    mixture -> MISO1 -> MVDR beamformed -> MISO3 enhanced

bf16 on the card, float32 on the CPU.

Run:  python -m misonet_tpu_torch.examples.train_cascade [--steps1 3000]
      [--steps3 2000] [--joint] [--save <dir>]
      [--miso1-ckpt <dir>/<tag>]   (reuse a saved MISO1 train state)
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from misonet_tpu_torch.config import ModelConfig, OptimizerConfig, StftConfig
from misonet_tpu_torch.examples.common import (
    Corpus,
    compute_dtype,
    make_corpus,
    mixture_si_sdr,
    pick_device,
    pit_si_sdr,
    run_steps,
    train_separator,
)
from misonet_tpu_torch.inference.cascade import enhance
from misonet_tpu_torch.inference.separate import make_full_array_decode
from misonet_tpu_torch.models import make_miso1, make_miso2, make_miso3
from misonet_tpu_torch.ops.stft import istft_scaled
from misonet_tpu_torch.train import (
    create_train_state,
    make_enhance_joint_train_step,
    make_enhance_train_step,
    make_optimizer,
)
from misonet_tpu_torch.train.trainer import enhance_batch, enhance_features
from misonet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

NUM_CH, REF_CH = 6, 0


def stage3_name(joint: bool) -> str:
    return "MISO2" if joint else "MISO3"


def build_models(mcfg: ModelConfig, device, joint: bool, num_ch=NUM_CH):
    """(MISO1 from ``torch.Generator().manual_seed(0)``, the enhancement
    net, MISO2 (``joint``) or MISO3, from ``manual_seed(1)``)."""
    miso1 = make_miso1(mcfg, num_ch, device=device,
                       generator=torch.Generator().manual_seed(0))
    make = make_miso2 if joint else make_miso3
    enh = make(mcfg, num_ch, device=device,
               generator=torch.Generator().manual_seed(1))
    return miso1, enh


def restore_miso1(miso1, ckpt: str):
    """The MISO1 train state saved at ``<dir>/<tag>``."""
    ck = Path(ckpt)
    opt = make_optimizer(OptimizerConfig(lr=1e-3), miso1.parameters())
    state, _ = load_checkpoint(ck.parent, ck.name,
                               create_train_state(miso1, opt))
    return state


class Stage2:
    """The frozen MISO1's full-array decode and the MVDR features of a
    wave batch (``train/trainer.py::enhance_features``), and the enhancement
    net's (input, target) from them."""

    def __init__(self, miso1, stft_cfg: StftConfig, joint: bool,
                 num_ch: int = NUM_CH, ref_ch: int = REF_CH):
        self.decode = make_full_array_decode(miso1, num_ch, ref_ch)
        self.stft_cfg, self.joint, self.ref_ch = stft_cfg, joint, ref_ch
        self.device = next(miso1.parameters()).device

    def features(self, mix_wave, ref_wave):
        """-> (mix, ref_al, m1, bf) as the JAX program's ``features``."""
        return enhance_features(self.decode, self.stft_cfg, self.ref_ch,
                                mix_wave, ref_wave, self.device)

    def inputs(self, mix_wave, ref_wave):
        return enhance_batch(*self.features(mix_wave, ref_wave),
                             joint=self.joint)


def train_enhancer(enh, stage2: Stage2, corpus: Corpus, steps: int,
                   batch: int, every: int = 200, log=None):
    """Stage 3: MISO3 per speaker (or MISO2 under ``stage2.joint``) on the
    frozen stages' features, Adam at lr 1e-3, batches from the index
    stream of ``default_rng(1)``.  Returns (train state, TrainLog)."""
    opt = make_optimizer(OptimizerConfig(lr=1e-3), enh.parameters())
    make = (make_enhance_joint_train_step if stage2.joint
            else make_enhance_train_step)
    step = make(enh, opt)
    batches = (stage2.inputs(m, r)
               for m, r in corpus.batches(batch, steps, seed=1))
    return run_steps(step, create_train_state(enh, opt), batches, steps,
                     every, log, corpus.mix.device)


@torch.no_grad()
def eval_stages(enh, stage2: Stage2, evals: list[dict]) -> dict:
    """Stage-wise PIT SI-SDR (dB), means over ``evals``: {"mixture",
    "miso1", "mvdr", "miso3" or "miso2"}."""
    key = stage3_name(stage2.joint).lower()
    scores = {"mixture": [], "miso1": [], "mvdr": [], key: []}
    for d in evals:
        n = d["mix"].shape[0]
        mix, _, m1, bf = stage2.features(d["mix"][None], d["ref"][None])
        est = enhance(enh, mix, m1, bf, stage2.joint)
        scores["mixture"].append(mixture_si_sdr(d, stage2.ref_ch))
        for k, spec in (("miso1", m1), ("mvdr", bf), (key, est)):
            wave = istft_scaled(spec, stage2.stft_cfg, n)[0]
            scores[k].append(pit_si_sdr(wave.float().cpu().numpy(), d["ref"]))
    return {k: float(np.mean(v)) for k, v in scores.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps1", type=int, default=3000, help="MISO1 steps")
    ap.add_argument("--steps3", type=int, default=2000, help="MISO3 steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--train-utts", type=int, default=256)
    ap.add_argument("--eval-utts", type=int, default=8)
    ap.add_argument("--samples", type=int, default=32000)
    ap.add_argument("--miso1-ckpt", default="", help="skip MISO1 training")
    ap.add_argument("--save", default="")
    ap.add_argument(
        "--noise-sources", action="store_true",
        help="train on the legacy modulated-noise sources instead of "
        "harmonic pseudo-speech (data/synthetic.py voiced=True)",
    )
    ap.add_argument(
        "--joint", action="store_true",
        help="stage 3 trains MISO2 (joint two-speaker enhancement, "
        "reference enhance_mode='MISO2', run.py:117-125) instead of the "
        "per-speaker MISO3",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    voiced = not args.noise_sources

    device = pick_device(args.device)
    stft_cfg = StftConfig()
    mcfg = ModelConfig(compute_dtype=compute_dtype(device))
    miso1, enh = build_models(mcfg, device, args.joint)
    name = stage3_name(args.joint)
    print(f"platform={device.type} compute={mcfg.compute_dtype}", flush=True)

    print(f"generating data (voiced={voiced})...", flush=True)
    corpus = make_corpus(args.train_utts, args.eval_utts, args.samples,
                         NUM_CH, voiced, device)

    # ---- stage 1: MISO1 separation training -----------------------------
    if args.miso1_ckpt:
        state1 = restore_miso1(miso1, args.miso1_ckpt)
        print(f"MISO1 restored from {args.miso1_ckpt}", flush=True)
    else:
        state1, log1 = train_separator(
            miso1, stft_cfg, corpus, args.steps1, args.batch, every=200,
            log=lambda it, loss, dt: print(
                f"MISO1 step {it}: loss {loss:.0f} ({dt:.0f}s)", flush=True))
        print(f"MISO1 train: {log1.steps} steps in {log1.seconds:.1f}s, "
              f"{log1.step_ms:.1f} ms/step", flush=True)

    # ---- stages 2-3: frozen MISO1 + MVDR features, enhancement training --
    stage2 = Stage2(miso1, stft_cfg, args.joint)
    state3, log3 = train_enhancer(
        enh, stage2, corpus, args.steps3, args.batch,
        log=lambda it, loss, dt: print(
            f"{name} step {it}: loss {loss:.0f} ({dt:.0f}s)", flush=True))
    print(f"{name} train: {log3.steps} steps in {log3.seconds:.1f}s, "
          f"{log3.step_ms:.1f} ms/step", flush=True)

    # ---- evaluate all stages --------------------------------------------
    scores = eval_stages(enh, stage2, corpus.evals)
    print("\nstage-wise SI-SDR (dB), mean over eval utterances:", flush=True)
    for k, v in scores.items():
        print(f"  {k:8s} {v:7.2f}", flush=True)

    if args.save:
        save_checkpoint(args.save, "miso1", state1, {})
        save_checkpoint(args.save, name.lower(), state3, {})
        print(f"checkpoints saved to {args.save}", flush=True)


if __name__ == "__main__":
    main()

"""End-to-end training demo on synthetic multi-microphone mixtures (the
port's twin of the JAX package's examples/train_synthetic.py: the same
flags, defaults, seeds and printed lines).

Trains the full-size MISO1 separation net (2.59M parameters, bf16 on the
card, float32 on the CPU) on synthetic 6-channel reverberant 2-speaker
mixtures, then scores the separated output against the mixture on
held-out utterances: proof that the training step, the PIT loss and the
inference stack learn to separate.

Run:  python -m misonet_tpu_torch.examples.train_synthetic [--steps 2000]
      [--voiced] [--config configs/reverb_2mix.yml] [--save <dir>]
      [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from misonet_tpu_torch.config import ModelConfig
from misonet_tpu_torch.examples.common import (
    DEMO_TAG,
    compute_dtype,
    make_corpus,
    pick_device,
    plan,
    score_separator,
    train_separator,
)
from misonet_tpu_torch.models import make_miso1
from misonet_tpu_torch.utils.checkpoint import save_checkpoint


def build_miso1(mcfg: ModelConfig, num_ch: int, device):
    """MISO1 with the parameters of ``torch.Generator().manual_seed(0)``."""
    return make_miso1(mcfg, num_ch, device=device,
                      generator=torch.Generator().manual_seed(0))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--train-utts", type=int, default=256)
    ap.add_argument("--eval-utts", type=int, default=8)
    ap.add_argument("--samples", type=int, default=32000)
    ap.add_argument("--save", default="")
    ap.add_argument("--voiced", action="store_true",
                    help="harmonic pseudo-speech sources (the cascade "
                         "demo's regime) instead of modulated noise")
    ap.add_argument("--config", default="",
                    help="YAML config (e.g. configs/reverb_2mix.yml): "
                         "takes the model plan, STFT and mic count from it "
                         "instead of the SMS-WSJ defaults")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    device = pick_device(args.device)
    stft_cfg, ds_cfg, mcfg = plan(args.config, compute_dtype(device))
    num_ch = ds_cfg.num_ch_utilize
    model = build_miso1(mcfg, num_ch, device)
    print(f"platform={device.type} compute={mcfg.compute_dtype} "
          f"ch={num_ch} F={stft_cfg.num_bins}", flush=True)
    print("generating data...", flush=True)
    corpus = make_corpus(args.train_utts, args.eval_utts, args.samples,
                         num_ch, args.voiced, device)

    state, log = train_separator(
        model, stft_cfg, corpus, args.steps, args.batch,
        log=lambda it, loss, dt: print(f"step {it}: loss {loss:.0f} "
                                       f"({dt:.0f}s)", flush=True))
    print(f"train: {log.steps} steps in {log.seconds:.1f}s, "
          f"{log.step_ms:.1f} ms/step", flush=True)

    base, sep = score_separator(model, stft_cfg, corpus.evals)
    print(f"mixture SI-SDR: {base:.2f} dB", flush=True)
    print(f"MISO1 separated SI-SDR: {sep:.2f} dB", flush=True)
    print(f"improvement: {sep - base:.2f} dB", flush=True)

    if args.save:
        save_checkpoint(args.save, DEMO_TAG, state, {"si_sdr": sep, "base": base})
        print(f"checkpoint saved to {args.save}/demo", flush=True)


if __name__ == "__main__":
    main()

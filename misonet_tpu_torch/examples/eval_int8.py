"""SI-SDR cost of the int8 decode on a TRAINED separator (the port's twin
of the JAX package's scripts/eval_int8.py).

Restores the checkpoint that ``train_synthetic --save`` wrote into a bf16
MISO1 and into the same weights with ``quant_int8=True``, and scores the
same held-out synthetic mixtures (seeds 10_000+i) with both decodes.  On
the card the int8 model's DenseBlocks run the int8 kernel; on the CPU
both run the plain bf16 modules (int8 is a mode of the fused path only),
so there the cost is 0.

Run:  python -m misonet_tpu_torch.examples.train_synthetic --steps 3000 \\
          --save /tmp/int8_ckpt
      python -m misonet_tpu_torch.examples.eval_int8 --ckpt /tmp/int8_ckpt
"""

from __future__ import annotations

import argparse
import dataclasses

from misonet_tpu_torch.config import ModelConfig, StftConfig
from misonet_tpu_torch.examples.common import (
    make_corpus,
    pick_device,
    plan,
    restore_demo,
    score_separator,
)
from misonet_tpu_torch.models import make_miso1


def restore(ckpt: str, mcfg: ModelConfig, num_ch: int, device):
    """(bf16 MISO1, its int8 twin, metadata): the checkpoint's "demo" state
    restored into a bf16 model, whose parameters the int8 model copies."""
    m16 = make_miso1(mcfg, num_ch, device=device)
    meta = restore_demo(ckpt, m16)
    m8 = make_miso1(dataclasses.replace(mcfg, quant_int8=True), num_ch,
                    device=device)
    m8.load_state_dict(m16.state_dict())
    return m16, m8, meta


def evaluate(m16, m8, stft_cfg: StftConfig, evals: list[dict]) -> dict:
    """{"mixture", "bf16", "int8", "cost"}: PIT SI-SDR means in dB and the
    int8 decode's cost (bf16 - int8)."""
    base, s16 = score_separator(m16, stft_cfg, evals)
    _, s8 = score_separator(m8, stft_cfg, evals)
    return {"mixture": base, "bf16": s16, "int8": s8, "cost": s16 - s8}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="/tmp/int8_ckpt")
    ap.add_argument("--eval-utts", type=int, default=8)
    ap.add_argument("--samples", type=int, default=32000)
    ap.add_argument("--voiced", action="store_true")
    ap.add_argument("--config", default="",
                    help="YAML config: the model plan, STFT and mic count "
                         "the checkpoint was trained with")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    device = pick_device(args.device)
    stft_cfg, ds_cfg, mcfg = plan(args.config, "bfloat16")
    num_ch = ds_cfg.num_ch_utilize
    m16, m8, meta = restore(args.ckpt, mcfg, num_ch, device)
    print(f"restored {args.ckpt}/demo meta={meta}", flush=True)
    evals = make_corpus(0, args.eval_utts, args.samples, num_ch,
                        args.voiced).evals
    r = evaluate(m16, m8, stft_cfg, evals)
    print(f"mixture SI-SDR:      {r['mixture']:6.2f} dB", flush=True)
    print(f"bf16 decode SI-SDR:  {r['bf16']:6.2f} dB", flush=True)
    print(f"int8 decode SI-SDR:  {r['int8']:6.2f} dB  "
          f"(cost {r['cost']:+.2f} dB)", flush=True)


if __name__ == "__main__":
    main()

"""Long-form continuous speech separation (CSS) quality demo (the port's
twin of the JAX package's examples/css_longform.py).

A 60 s synthetic 6-channel 2-speaker scene goes block by block (4 s
blocks, running SCMs, adaptive MVDR: one ``mvdr_weights`` launch a block
on the card) through ``inference/css.py::StreamingCSS`` with a trained
MISO1, edge to edge and with cross-fade overlap stitching, and is scored
stage-wise with PIT SI-SDR.  bf16 on the card, float32 on the CPU.

Run (needs a MISO1 checkpoint from ``train_synthetic --save``):
    python -m misonet_tpu_torch.examples.css_longform --ckpt /tmp/int8_ckpt \\
        [--voiced]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from misonet_tpu_torch.config import DatasetConfig
from misonet_tpu_torch.data.synthetic import synth_mixture
from misonet_tpu_torch.examples.common import (
    compute_dtype,
    pick_device,
    pit_si_sdr,
    plan,
    restore_demo,
)
from misonet_tpu_torch.inference.css import StreamingCSS
from misonet_tpu_torch.models import make_miso1


def passes(ds_cfg: DatasetConfig) -> tuple[int, ...]:
    """The stitchings scored: edge to edge, and a cross-fade over a
    quarter block."""
    return (0, ds_cfg.chunk_samples // 4)


def run_css(css: StreamingCSS, mix: np.ndarray, refs: np.ndarray,
            seconds: float, overlaps=(0,)) -> list[dict]:
    """One pass of the scene [samples, C] per overlap: {"overlap",
    "mixture", "miso1", "mvdr" (PIT SI-SDR, dB), "audio_s_per_s",
    "seconds"} each."""
    ref_ch = css.ds.ref_ch
    base = pit_si_sdr(np.stack([mix[:, ref_ch]] * refs.shape[0]), refs)
    rows = []
    for overlap in overlaps:
        t0 = time.perf_counter()
        out = css.process(mix, overlap=overlap)
        dt = time.perf_counter() - t0
        rows.append({"overlap": overlap, "mixture": base,
                     "miso1": pit_si_sdr(out["miso1"], refs),
                     "mvdr": pit_si_sdr(out["beamformed"], refs),
                     "audio_s_per_s": seconds / dt, "seconds": dt})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="/tmp/int8_ckpt")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=20_000)
    ap.add_argument("--voiced", action="store_true")
    ap.add_argument("--forget", type=float, default=1.0)
    ap.add_argument("--config", default="",
                    help="YAML config: the model plan, STFT, mic count and "
                         "block length the checkpoint was trained with")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    device = pick_device(args.device)
    stft_cfg, ds_cfg, mcfg = plan(args.config, compute_dtype(device))
    n = int(args.seconds * ds_cfg.fs)
    print(f"platform={device.type} "
          f"scene={args.seconds:.0f}s x {ds_cfg.num_ch}ch", flush=True)

    scene = synth_mixture(args.seed, n, ds_cfg.num_ch, voiced=args.voiced)
    model = make_miso1(mcfg, ds_cfg.num_ch_utilize, device=device)
    meta = restore_demo(args.ckpt, model)
    print(f"restored {args.ckpt}/demo meta={meta}", flush=True)

    css = StreamingCSS(model, stft_cfg, ds_cfg, forget=args.forget)
    for r in run_css(css, scene["mix"], scene["ref"], args.seconds,
                     passes(ds_cfg)):
        tag = f"overlap={r['overlap']}" + (
            " (cross-fade)" if r["overlap"] else "")
        print(f"{tag:26s}: mixture {r['mixture']:6.2f}  "
              f"miso1 {r['miso1']:6.2f}  mvdr {r['mvdr']:6.2f} dB   "
              f"({r['audio_s_per_s']:.1f} audio-s/s)", flush=True)


if __name__ == "__main__":
    main()

"""The port's command line: ``python -m misonet_tpu_torch`` (run.py's flags,
modes and YAML files, on PyTorch).

Modes (reference run.py:278-292):
  Extraction   wav corpus -> chunked shards        (-m Extraction)
  Train        MISO1 / MISO2 / MISO3 training      (-m Train -t <stage>)
  Test         MISO1 / Beamforming / MISO2 / MISO3 (-m Test -t <stage>)
               + CSS: streaming block-wise long-form separation
               (--css-overlap for cross-fade)

Usage:
  python -m misonet_tpu_torch -c configs/smswsj.yml -m Train -t MISO1 -n logs/run1
  torchrun --nproc_per_node=N -m misonet_tpu_torch -c ... -m Train ...
                                                   (data parallel, N cards)
  python -m misonet_tpu_torch -c configs/smswsj.yml -m Test -t MISO3 -n logs/eval
  python -m misonet_tpu_torch ... --device cpu     (the plain path, no card)

The models run on ``--device`` (the card, ``cuda``, unless ``cpu`` is
given) at the YAML's precision (``ModelConfig.compute_dtype``, bfloat16
by default, as in the JAX package).  Checkpoints are the port's own
(``utils/checkpoint.py``): the MISO1 checkpoint that enhancement training
and testing load (``trainer_en.MISO1_path``) and the enhancement net's
``best`` must come from the port's trainers, or from JAX params moved in
with ``utils/weights.py::load_jax_params``.

Training under ``torchrun`` is data parallel (run.py's mesh, run.py:220-227):
one process per card over NCCL (gloo with ``--device cpu``), a mesh of
``mesh.num_devices`` ranks (0: all; the largest divisor of the batch not
above it, which must be every rank), each rank reading the same global
batches and keeping its own rows; rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
import itertools
import os
from pathlib import Path

import numpy as np

from misonet_tpu_torch.config import Config, load_yaml

CONFIG_NAMES = {
    "SMS_WSJ": "smswsj.yml",
    "REVERB_2MIX": "reverb_2mix.yml",
    "RIR_mixing": "reverb_2mix.yml",  # premixed RIR shares the plan
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m misonet_tpu_torch",
                                 description="misonet_tpu_torch")
    ap.add_argument(
        "-c", "--config", required=True,
        help="YAML config path, or a directory resolved with -d "
        "(reference run.py:280 takes a directory)",
    )
    ap.add_argument(
        "-d", "--dataset", default="SMS_WSJ", choices=list(CONFIG_NAMES),
        help="dataset name; with a -c directory selects <dir>/<dataset>.yml",
    )
    ap.add_argument(
        "-m", "--mode", required=True, choices=["Extraction", "Train", "Test"]
    )
    ap.add_argument(
        "-t", "--target", default="MISO1",
        choices=["MISO1", "Beamforming", "MISO2", "MISO3", "CSS"],
    )
    ap.add_argument(
        "-u", "--use-device", default=None,
        help="accepted for reference-CLI compatibility (run.py:284 gpu "
        "selector); the card is --device",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the models run: cuda (the default) or cpu",
    )
    ap.add_argument("-n", "--logdir", default="logs/run")
    ap.add_argument("--max-utts", type=int, default=None)
    ap.add_argument(
        "--wav-subtype", default="PCM_16", choices=("PCM_16", "PCM_24"),
        help="output wav sample format; PCM_24 reproduces the reference's "
        "on-disk byte format (tester.py:157)",
    )
    ap.add_argument(
        "--eval-workers", type=int, default=2,
        help="utterances pipelined through the evaluator: one utterance's "
        "host half (wav IO/stitch/scoring) overlaps another's device half",
    )
    ap.add_argument(
        "--css-overlap", type=int, default=0,
        help="-t CSS: block overlap in samples (cross-fade stitching); "
        "0 = edge-to-edge blocks (the reference's chunked semantics)",
    )
    ap.add_argument(
        "--split", default=None,
        help="corpus split directory under rootdir (the reference walks "
        "fixed splits train_si284/cv_dev93/test_eval92, run.py:245-250); "
        "default: Test uses <test_file>, Extraction walks <tr_file> and "
        "<dev_file> when those split dirs exist",
    )
    return ap


def main(argv: list[str] | None = None) -> None:
    """Parse ``argv`` (the command line's by default), read the YAML and
    run the mode."""
    args = parser().parse_args(argv)
    cfg_path = Path(args.config)
    if cfg_path.is_dir():
        cfg_path = cfg_path / CONFIG_NAMES[args.dataset]
    cfg = load_yaml(cfg_path)
    if args.mode == "Extraction":
        extract(cfg, args.split)
    elif args.mode == "Train":
        train(cfg, args)
    else:
        test(cfg, args)


def _split_root(ds, split: str | None) -> Path:
    """Resolve the corpus root for a split: <rootdir>/<split> when that
    split directory exists (reference layout, run.py:245-250), else the
    plain rootdir (flat single-directory corpora)."""
    root = Path(ds.root_dir)
    if split and (root / split / ds.mix_subdir).is_dir():
        return root / split
    return root


def discover(cfg: Config, split: str | None = None):
    """Dataset-specific corpus discovery (the reference dispatches per
    dataset in its Extraction branch, run.py:33-61)."""
    from misonet_tpu_torch.data.extraction import discover_smswsj
    from misonet_tpu_torch.data.reverb import (
        discover_reverb_2mix,
        discover_rir_mixing,
    )

    ds = cfg.dataset
    root = Path(ds.root_dir)
    if ds.name == "REVERB_2MIX":
        # .lst scp file if present (REVERB_2MIX.py:120-138), else glob
        return discover_reverb_2mix(root / "list.lst", root, ds.num_spks)
    if ds.name == "RIR_mixing":
        return discover_rir_mixing(root, ds.num_spks)
    root = _split_root(ds, split)
    return discover_smswsj(
        root / ds.mix_subdir,
        root / ds.clean_subdir,
        ds.num_spks,
        early_dir=root / ds.early_subdir if ds.save_early else None,
        tail_dir=root / ds.tail_subdir if ds.save_tail else None,
        noise_dir=root / ds.noise_subdir if ds.save_noise else None,
    )


def extract(cfg: Config, split: str | None = None) -> None:
    from misonet_tpu_torch.data.extraction import extract_corpus

    ds = cfg.dataset
    # the reference extracts the train and dev splits (SMS_WSJ.py:233-235);
    # walk each split that exists, landing train chunks in pickle_dir and
    # dev chunks in dev_pickle_dir.  --split restricts to one.
    jobs = [(split, ds.pickle_dir)] if split else [
        (ds.tr_file, ds.pickle_dir),
        (ds.dev_file, ds.dev_pickle_dir or ds.pickle_dir),
    ]
    ran_split = False
    for sp, out_dir in jobs:
        root = _split_root(ds, sp)
        if sp and root == Path(ds.root_dir) and not split:
            continue  # split dir absent -> flat corpus fallback below
        ran_split = True
        specs = discover(cfg, sp)
        n = extract_corpus(specs, out_dir, ds.chunk_samples, ds.least_samples,
                           workers=os.cpu_count() or 1)
        print(f"extracted {n} chunks from {len(specs)} utterances "
              f"[{sp or 'all'}] -> {out_dir}")
    if not ran_split:
        specs = discover(cfg)
        n = extract_corpus(specs, ds.pickle_dir, ds.chunk_samples,
                           ds.least_samples, workers=os.cpu_count() or 1)
        print(f"extracted {n} chunks from {len(specs)} utterances -> "
              f"{ds.pickle_dir}")


def _loaders(cfg: Config, trainer_cfg):
    from misonet_tpu_torch.data import Batcher, ShardDataset

    ds = cfg.dataset
    train_data = Batcher(ShardDataset(ds.pickle_dir, ds.num_spks),
                         trainer_cfg.batch_size, shuffle=True)
    val_dir = ds.dev_pickle_dir or ds.pickle_dir
    val_data = Batcher(ShardDataset(val_dir, ds.num_spks),
                       trainer_cfg.batch_size, shuffle=False)
    return train_data, val_data


def _model(cfg: Config, target: str, device: str):
    """A new ``target`` net (MISO1, MISO2 or MISO3) of ``cfg`` on
    ``device``, with seed-0 parameters."""
    from misonet_tpu_torch.models import make_miso1, make_miso2, make_miso3

    ds = cfg.dataset
    if target == "MISO1":
        return make_miso1(cfg.miso1, ds.num_ch_utilize, ds.num_spks,
                          device=device)
    if target == "MISO2":
        return make_miso2(cfg.miso2, ds.num_ch_utilize, ds.num_spks,
                          device=device)
    return make_miso3(cfg.miso3, ds.num_ch_utilize, device=device)


def load_miso1(cfg: Config, device: str):
    """Cross-stage hand-off: the frozen MISO1 from ``trainer_en.MISO1_path``
    (run.py:101-109)."""
    from misonet_tpu_torch.utils.checkpoint import load_model

    ckpt = Path(cfg.trainer_en.miso1_checkpoint)
    return load_model(ckpt.parent, ckpt.name, _model(cfg, "MISO1", device))


def _train_mesh(cfg: Config, batch_size: int, device: str):
    """The data-parallel mesh of a run under torchrun, or None for one
    process (run.py:220-227)."""
    import torch.distributed as dist

    from misonet_tpu_torch.parallel import distributed, make_mesh_for_batch

    if not distributed.initialize(device=device):
        return None
    mesh = make_mesh_for_batch(batch_size, cfg.mesh.num_devices)
    if mesh.size != dist.get_world_size():
        raise ValueError(
            f"a batch of {batch_size} over mesh.num_devices="
            f"{cfg.mesh.num_devices} makes a mesh of {mesh.size} ranks: "
            f"launch {mesh.size} processes, not {dist.get_world_size()}")
    return mesh


def train(cfg: Config, args) -> None:
    import torch.distributed as dist

    from misonet_tpu_torch.train.trainer import EnhanceTrainer, SeparationTrainer
    from misonet_tpu_torch.utils.writer import MetricWriter

    tr_cfg = cfg.trainer_sp if args.target == "MISO1" else cfg.trainer_en
    mesh = _train_mesh(cfg, tr_cfg.batch_size, args.device)
    writer = (MetricWriter(args.logdir, cfg.stft)
              if mesh is None or mesh.index == 0 else None)
    try:
        if args.target == "MISO1":
            train_data, val_data = _loaders(cfg, tr_cfg)
            trainer = SeparationTrainer(
                _model(cfg, "MISO1", args.device), tr_cfg, cfg.optimizer,
                cfg.stft, cfg.dataset, train_data, val_data, mesh=mesh,
                writer=writer)
        elif args.target in ("MISO2", "MISO3"):
            train_data, val_data = _loaders(cfg, tr_cfg)
            trainer = EnhanceTrainer(
                _model(cfg, args.target, args.device),
                load_miso1(cfg, args.device), tr_cfg, cfg.optimizer,
                cfg.stft, cfg.dataset, train_data, val_data,
                joint=args.target == "MISO2", mesh=mesh, writer=writer)
        else:
            raise ValueError(f"-m Train takes -t MISO1, MISO2 or MISO3, not "
                             f"{args.target}")
        trainer.train()
    finally:
        if writer is not None:
            writer.close()
        if mesh is not None:
            dist.destroy_process_group()


def _pit_np(est, refs) -> float:
    """Permutation-optimal mean SI-SDR, host-side numpy ([S, T] arrays)."""
    from misonet_tpu_torch.metrics import numpy_si_sdr

    spks = range(est.shape[0])
    return float(max(
        np.mean([numpy_si_sdr(est[p[s]], refs[s]) for s in spks])
        for p in itertools.permutations(spks)
    ))


def test_css(cfg: Config, args) -> dict[str, float]:
    """-m Test -t CSS: stream each test utterance through the block-wise
    CSS pipeline (inference/css.py: running per-speaker SCMs + adaptive
    MVDR).  Writes per-speaker MISO1 and Beamforming wavs and returns
    (and prints) the stage-wise mean PIT-SI-SDR."""
    from misonet_tpu_torch.data.wavio import read_wav, write_wav
    from misonet_tpu_torch.inference.css import StreamingCSS

    ds = cfg.dataset
    css = StreamingCSS(load_miso1(cfg, args.device), cfg.stft, ds)
    specs = discover(cfg, args.split or ds.test_file)
    out = Path(args.logdir) / "wav_out"
    agg: dict[str, list[float]] = {"mixture": [], "miso1": [], "beamformed": []}
    for spec in specs[: args.max_utts]:
        mix, fs = read_wav(spec.mix_path)
        mix = mix[:, : ds.num_ch_utilize]
        res = css.process(mix, overlap=args.css_overlap)
        for stage in ("miso1", "beamformed"):
            for sp in range(res[stage].shape[0]):
                write_wav(out / stage / f"{spec.utt_id}_{sp}.wav",
                          res[stage][sp], fs, subtype=args.wav_subtype)
        if spec.source_paths:
            refs = np.stack([read_wav(p)[0] for p in spec.source_paths])
            n = min(refs.shape[-1], mix.shape[0])
            mix0 = np.stack([mix[:n, ds.ref_ch]] * refs.shape[0])
            agg["mixture"].append(_pit_np(mix0, refs[:, :n]))
            agg["miso1"].append(_pit_np(res["miso1"][:, :n], refs[:, :n]))
            agg["beamformed"].append(
                _pit_np(res["beamformed"][:, :n], refs[:, :n]))
    scores = {k: float(np.mean(v)) for k, v in agg.items() if v}
    print("mean PIT-SI-SDR per stage:", scores)
    return scores


def test(cfg: Config, args) -> dict[str, float]:
    """-m Test: the cascade evaluator over the test split; writes the
    per-stage wavs and returns (and prints) the mean SI-SDR per stage."""
    from misonet_tpu_torch.inference.evaluate import CascadeEvaluator
    from misonet_tpu_torch.utils.checkpoint import load_model

    if args.target == "CSS":
        return test_css(cfg, args)
    ds = cfg.dataset
    enhance_model = None
    joint = args.target == "MISO2"
    if args.target in ("MISO2", "MISO3"):
        # the enhancement net from its own save_folder's 'best'
        enhance_model = load_model(cfg.trainer_en.save_folder, "best",
                                   _model(cfg, args.target, args.device))
    ev = CascadeEvaluator(
        load_miso1(cfg, args.device), cfg.stft, ds,
        enhance_model=enhance_model, joint=joint,
        beamform_utterance=args.target != "MISO1",
    )
    # Test mode walks the test split like the reference's tr_inference_flag
    # dispatch (run.py:245-250, tester.py:44-79); --split overrides.
    specs = discover(cfg, args.split or ds.test_file)
    scores = ev.evaluate_corpus(
        specs, Path(args.logdir) / "wav_out", max_utts=args.max_utts,
        wav_subtype=args.wav_subtype, workers=args.eval_workers,
    )
    print("mean SI-SDR per stage:", scores)
    return scores

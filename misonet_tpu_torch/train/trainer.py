"""Training loops: separation (MISO1) and enhancement (MISO2/MISO3) stages
(misonet_tpu/train/trainer.py).

Reference counterparts: Trainer_Separate (trainer.py:22-223) and
Trainer_Enhance (trainer.py:225-514).  As in the JAX package:

* batches are time-domain waves; the STFT runs on the device inside the
  train step (the reference ran scipy STFT in 70 DataLoader workers);
* for the enhancement stage the frozen-MISO1 decode and the MVDR stage run
  on the device in a feature step (the reference ran the model and NumPy
  MVDR inside DataLoader worker processes — data.py:148, :201-207), and
  the per-speaker MISO3 passes are folded into the batch axis;
* a real validation loader is used (the reference validates on the
  training loader — run.py:231);
* periodic + best checkpoints and resume (``utils/checkpoint.py``).

Where the JAX trainers initialize parameters from a first batch, the
port's models hold theirs: the constructors take the models as they are
(the frozen MISO1 included, so ``EnhanceTrainer`` has no ``miso1_params``
argument), and a resume loads into them.  The steps update the model and
the optimizer in place (``train/steps.py``).

Data parallel (``mesh``, a ``parallel.Mesh``, as the JAX trainers take
one): every rank of the mesh runs the trainer over the same global batches
and keeps its own rows of each (``parallel.shard_batch``); the model is
broadcast from the mesh's first rank when the state is set up
(``parallel.replicate``), and the steps average the gradients.  Epoch
losses are global means, so the schedule and early stop agree on every
rank; the first rank alone prints, logs and writes checkpoints.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable

import torch

from misonet_tpu_torch.config import (
    DatasetConfig,
    OptimizerConfig,
    StftConfig,
    TrainerConfig,
)
from misonet_tpu_torch.inference.cascade import beamform_sources, enhance_inputs
from misonet_tpu_torch.inference.separate import align_slots, make_full_array_decode
from misonet_tpu_torch.losses import loss_enhance, loss_upit, magnitude_distance
from misonet_tpu_torch.ops.stft import stft_scaled
from misonet_tpu_torch.parallel.mesh import (
    Mesh,
    mean_over,
    replicate,
    shard_batch,
)
from misonet_tpu_torch.train.state import (
    PlateauScheduler,
    create_train_state,
    make_optimizer,
    set_learning_rate,
)
from misonet_tpu_torch.train.steps import (
    make_enhance_joint_train_step,
    make_enhance_train_step,
    make_separate_wave_eval_step,
    make_separate_wave_train_step,
)
from misonet_tpu_torch.utils import profiling
from misonet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a misonet_tpu_torch.parallel.Mesh, "
                        f"got {type(mesh).__name__}")


def _scheduler(opt_cfg: OptimizerConfig, trainer_cfg: TrainerConfig):
    return PlateauScheduler(
        lr=opt_cfg.lr,
        factor=opt_cfg.plateau_factor,
        patience=opt_cfg.plateau_patience,
        min_lr=opt_cfg.min_lr,
        early_stop_patience=trainer_cfg.early_stop_patience,
    )


@torch.no_grad()
def enhance_features(decode, stft_cfg: StftConfig, ref_ch: int, mix_wave,
                     ref_wave, device, miso1_ref=None, bf=None):
    """The frozen stages' features of a wave batch: mix_wave [B, S, C],
    ref_wave [B, spks, S] -> (mix_stft [B, C, T, F], ref_stft aligned to
    MISO1's speaker order, MISO1 at the reference mic, bf), each [B, spks,
    T, F] but the first.  ``decode`` is the frozen MISO1's full-array
    decode (``make_full_array_decode``); the MVDR takes every speaker of
    the batch in one ``mvdr_beamform`` call.  This is the on-device
    replacement for the reference's in-DataLoader model inference + NumPy
    MVDR (data.py:148, :201-207).  With precomputed ``miso1_ref``/``bf``
    (data/precompute.py; the reference's load_MISO1_Output /
    load_MVDR_Output modes, data.py:133-145, :190-199) the decode and the
    MVDR are skipped."""
    mix_wave = profiling.to_device(mix_wave, device)
    ref_wave = profiling.to_device(ref_wave, device)
    mix = stft_scaled(mix_wave.transpose(1, 2), stft_cfg)
    ref = stft_scaled(ref_wave, stft_cfg)                   # [B, S, T, F]
    if miso1_ref is None:
        full = decode(mix)                                  # [B, S, C, T, F]
        bf = beamform_sources(full, mix, ref_ch)
        miso1_ref = full[:, :, ref_ch].clone()
    else:
        miso1_ref = profiling.to_device(miso1_ref, device)
        bf = profiling.to_device(bf, device)
    # align references to MISO1 speaker order (data.py:154-182)
    idx = align_slots(magnitude_distance(miso1_ref, ref))
    ref_aligned = torch.take_along_dim(ref, idx[..., None, None], dim=1)
    return mix, ref_aligned, miso1_ref, bf


def enhance_batch(mix, ref_aligned, miso1_ref, bf, joint: bool):
    """(input, target) of an enhancement step from the features: MISO2's
    (``joint``) over all speakers at once, MISO3's with the speakers folded
    into the batch (targets [B*S, 1, T, F])."""
    b, s, t, f = miso1_ref.shape
    y = ref_aligned if joint else ref_aligned.reshape(b * s, 1, t, f)
    return enhance_inputs(mix, miso1_ref, bf, joint), y


class _Trainer:
    """The epoch loop both stages share: train and validation epochs, the
    plateau schedule and early stop, checkpoints, resume."""

    @property
    def lead(self) -> bool:
        """Whether this process prints, logs and writes checkpoints."""
        return self.mesh is None or self.mesh.index == 0

    def _rows(self, batch):
        """This rank's rows of a global batch."""
        return batch if self.mesh is None else shard_batch(batch, self.mesh)

    def _init_state(self) -> None:
        """The train state over the model as it is, and the resume
        (reference trainer.py:54-71; the reference resumes both trainers
        from model_load): parameters, optimizer state (Adam's moments and
        step counts, the NaN guard's counter), step and learning rate, then
        the epoch, history and best validation loss from the metadata."""
        self.state = create_train_state(self.model, self.optimizer)
        if self.cfg.resume:
            ckdir = Path(self.cfg.save_folder)
            self.state, meta = load_checkpoint(ckdir, self.cfg.resume,
                                               self.state)
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.history = meta.get("history", self.history)
            self.scheduler.lr = float(meta.get("lr", self.scheduler.lr))
            self.scheduler.best = float(meta.get("best_val",
                                                 self.scheduler.best))
        if self.mesh is not None:
            replicate(self.model, self.mesh)

    def _record(self, epoch, train_loss, val_loss, lr, t_epoch) -> None:
        """An epoch's logs, checkpoints and summary line."""
        if self.writer:
            self.writer.scalar("train/epoch_loss", train_loss, epoch)
            self.writer.scalar("val/epoch_loss", val_loss, epoch)
            self.writer.scalar("train/lr", lr, epoch)
        meta = {
            "epoch": epoch,
            "history": self.history,
            "lr": lr,
            "best_val": self.scheduler.best,
        }
        ckdir = Path(self.cfg.save_folder)
        if (epoch + 1) % self.cfg.checkpoint_every == 0:
            save_checkpoint(ckdir, f"epoch{epoch:03d}", self.state, meta)
        if val_loss <= self.scheduler.best:
            save_checkpoint(ckdir, "best", self.state, meta)
        print(
            f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
            f"lr {lr:.2e} ({time.perf_counter() - t_epoch:.1f}s)"
        )

    def train(self) -> dict[str, list[float]]:
        if self.state is None:
            self._init_state()   # and resume, before the epoch range
        for epoch in range(self.start_epoch, self.cfg.epochs):
            t_epoch = time.perf_counter()
            train_loss = self._run_epoch(epoch, training=True)
            val_loss = self._run_epoch(epoch, training=False)
            self.history["train"].append(train_loss)
            self.history["val"].append(val_loss)

            lr = self.scheduler.step(val_loss)
            self.state = set_learning_rate(self.state, lr)
            if self.lead:
                self._record(epoch, train_loss, val_loss, lr, t_epoch)
            if self.cfg.early_stop and self.scheduler.should_stop:
                if self.lead:
                    print(f"early stop at epoch {epoch}")
                break
        return self.history


class SeparationTrainer(_Trainer):
    """MISO1 training (reference Trainer_Separate, trainer.py:22-223)."""

    def __init__(
        self,
        model,
        trainer_cfg: TrainerConfig,
        opt_cfg: OptimizerConfig,
        stft_cfg: StftConfig,
        ds_cfg: DatasetConfig,
        train_data: Iterable,
        val_data: Iterable,
        mesh=None,
        writer=None,
    ):
        _check_mesh(mesh)
        self.mesh = mesh
        self.model = model
        self.cfg = trainer_cfg
        self.stft_cfg = stft_cfg
        self.ds_cfg = ds_cfg
        self.train_data = train_data
        self.val_data = val_data
        self.writer = writer if self.lead else None
        self.optimizer = make_optimizer(opt_cfg, model.parameters())
        self.scheduler = _scheduler(opt_cfg, trainer_cfg)
        # training and eval share the model: on a card the fused U-Net
        # body trains through its backward kernel (ops/kernels/flat_grad.py)
        self.train_step = make_separate_wave_train_step(
            model, self.optimizer, stft_cfg, ref_ch=ds_cfg.ref_ch, mesh=mesh,
            overest=trainer_cfg.overest_alpha > 0.0,
        )
        self.eval_step = make_separate_wave_eval_step(
            model, stft_cfg, ref_ch=ds_cfg.ref_ch, mesh=mesh)
        self.state = None
        self.start_epoch = 0
        self.history: dict[str, list[float]] = {"train": [], "val": []}

    def _run_epoch(self, epoch: int, training: bool) -> float:
        data = self.train_data if training else self.val_data
        total, count = 0.0, 0
        for i, batch in enumerate(data):
            audio_s = (batch["mix"].shape[0] * batch["mix"].shape[1]
                       / self.stft_cfg.fs)
            batch = self._rows(batch)
            mix = torch.as_tensor(batch["mix"])
            ref = torch.as_tensor(batch["ref"])
            if training:
                if self.writer:
                    self.writer.step_start()
                if self.cfg.overest_alpha > 0.0:
                    # reference's commented schedule: alpha=(epoch+1)*0.03
                    # (trainer.py:176)
                    alpha = (epoch + 1) * self.cfg.overest_alpha
                    self.state, metrics = self.train_step(
                        self.state, mix, ref, alpha)
                else:
                    self.state, metrics = self.train_step(self.state, mix,
                                                          ref)
                loss = float(metrics["loss"])
                if self.writer:
                    step = self.state.step
                    self.writer.step_end(step, audio_s)
                    self.writer.scalar("train/loss", loss, step)
                    self.writer.scalar(
                        "train/grad_norm", float(metrics["grad_norm"]), step
                    )
                if self.lead and i % self.cfg.print_freq == 0:
                    print(f"  epoch {epoch} batch {i}: loss {loss:.4f}")
            else:
                loss_val, est = self.eval_step(mix, ref)
                loss = float(loss_val)
                if self.writer and i == 0:
                    # first-val-batch spectrogram/audio logging
                    # (trainer.py:180-201 equivalent)
                    self.writer.spectrogram("val/est_s0", est[0, 0], epoch)
                    self.writer.audio("val/est_s0", est[0, 0], epoch,
                                      mix.shape[1])
            total += loss
            count += 1
        return total / max(count, 1)


class EnhanceTrainer(_Trainer):
    """MISO2/MISO3 training over frozen MISO1 + on-device MVDR features
    (reference Trainer_Enhance, trainer.py:225-514).

    joint=False -> MISO3 per-speaker (speakers folded into batch);
    joint=True  -> MISO2 joint two-speaker.  ``miso1_model`` holds the
    frozen MISO1's parameters."""

    def __init__(
        self,
        enhance_model,
        miso1_model,
        trainer_cfg: TrainerConfig,
        opt_cfg: OptimizerConfig,
        stft_cfg: StftConfig,
        ds_cfg: DatasetConfig,
        train_data: Iterable,
        val_data: Iterable,
        joint: bool = False,
        mesh=None,
        writer=None,
    ):
        _check_mesh(mesh)
        self.mesh = mesh
        self.model = enhance_model
        self.joint = joint
        self.cfg = trainer_cfg
        self.stft_cfg = stft_cfg
        self.ds_cfg = ds_cfg
        self.train_data = train_data
        self.val_data = val_data
        self.writer = writer if self.lead else None
        self.optimizer = make_optimizer(opt_cfg, enhance_model.parameters())
        self.scheduler = _scheduler(opt_cfg, trainer_cfg)
        make_step = (make_enhance_joint_train_step if joint
                     else make_enhance_train_step)
        self.train_step = make_step(enhance_model, self.optimizer, mesh=mesh)
        self.decode = make_full_array_decode(
            miso1_model, ds_cfg.num_ch_utilize, ds_cfg.ref_ch)
        self.device = next(enhance_model.parameters()).device
        self.state = None
        self.start_epoch = 0
        self.history: dict[str, list[float]] = {"train": [], "val": []}

    @torch.no_grad()
    def eval_step(self, x, y):
        est = self.model(x)
        loss = (loss_upit if self.joint else loss_enhance)(est, y)
        if self.mesh is not None:
            mean_over([loss], self.mesh)
        return loss, est

    def feature_step(self, mix_wave, ref_wave, miso1_ref=None, bf=None):
        """The frozen stages' features of a wave batch
        (:func:`enhance_features`)."""
        return enhance_features(self.decode, self.stft_cfg, self.ds_cfg.ref_ch,
                                mix_wave, ref_wave, self.device, miso1_ref, bf)

    def _features(self, batch):
        if "miso1" in batch:
            return self.feature_step(batch["mix"], batch["ref"],
                                     batch["miso1"], batch["bf"])
        return self.feature_step(batch["mix"], batch["ref"])

    def _run_epoch(self, epoch: int, training: bool) -> float:
        data = self.train_data if training else self.val_data
        total, count = 0.0, 0
        for i, batch in enumerate(data):
            n_glob, n_samp = batch["mix"].shape[:2]
            batch = self._rows(batch)
            feats = self._features(batch)
            x, y = enhance_batch(*feats, joint=self.joint)
            if training:
                if self.writer:
                    self.writer.step_start()
                self.state, metrics = self.train_step(self.state, x, y)
                loss = float(metrics["loss"])
                if self.writer:
                    step = self.state.step
                    self.writer.step_end(step, n_glob * n_samp
                                         / self.stft_cfg.fs)
                    self.writer.scalar("train/loss", loss, step)
                if self.lead and i % self.cfg.print_freq == 0:
                    print(f"  epoch {epoch} batch {i}: loss {loss:.4f}")
            else:
                loss_val, est = self.eval_step(x, y)
                loss = float(loss_val)
                if self.writer and i == 0:
                    self._log_eval_stages(epoch, batch, feats, est)
            total += loss
            count += 1
        return total / max(count, 1)

    def _log_eval_stages(self, epoch, batch, feats, est) -> None:
        """First-val-batch spectrogram/audio logging of every cascade stage
        — mixture / clean / MISO1 / beamformed / enhanced — the reference
        Trainer_Enhance's TensorBoard set (trainer.py:445-497)."""
        mix, ref_aligned, miso1_ref, bf = feats
        n_samp = int(batch["mix"].shape[1])
        est = est.reshape(-1, est.shape[-2], est.shape[-1])  # flatten spk dim
        stages = {
            "mix": mix[0, self.ds_cfg.ref_ch],
            "clean_s0": ref_aligned[0, 0],
            "miso1_s0": miso1_ref[0, 0],
            "bf_s0": bf[0, 0],
            "enhanced_s0": est[0],
        }
        for tag, spec in stages.items():
            self.writer.spectrogram(f"val/{tag}", spec, epoch)
            self.writer.audio(f"val/{tag}", spec, epoch, n_samp)

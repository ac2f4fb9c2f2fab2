"""Train and eval steps (misonet_tpu/train/steps.py; reference
Trainer_Separate._run_one_epoch per-batch body, trainer.py:144-212, and
Trainer_Enhance, trainer.py:353-442).

Each factory closes over the model and optimizer and returns a step.  A
train step runs the forward, the loss, the backward and the optimizer
update, and returns ``(state, metrics)`` with ``metrics = {"loss",
"grad_norm"}`` (0-dim tensors; ``grad_norm`` is the global norm of the raw
gradients, before clipping).  Where JAX donated the state and returned a
new one, the step updates the model's parameters and the optimizer's state
in place and returns the same ``state`` with its step count advanced; the
gradients stay in the parameters' ``.grad``.  Inputs go to the model's
device.  On a CUDA model the U-Net body runs forward and backward through
the fused kernels (``flat_dense="auto"``).

Data parallel: with ``mesh`` (a ``parallel.Mesh``) every rank of the mesh
calls the step with its own rows of the global batch
(``parallel.shard_batch``; the JAX steps take the global array sharded
the same way) and the same parameters (``parallel.replicate``).  The
gradients are averaged over the mesh in one ``all_reduce`` before the
global norm, the clip, the NaN guard and the optimizer, so every rank
takes the same update and the same guard decision; the loss in the
metrics and the eval steps' loss are the mean over the mesh, which for
equal shards is the loss of the global batch.  The eval steps return the
estimates of this rank's rows.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from misonet_tpu_torch.config import StftConfig
from misonet_tpu_torch.losses import loss_enhance, loss_upit, loss_upit_overest
from misonet_tpu_torch.ops.stft import stft_scaled
from misonet_tpu_torch.parallel.mesh import Mesh, mean_over
from misonet_tpu_torch.train.state import Optimizer, TrainState


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on(model: nn.Module, *tensors):
    dev = _device(model)
    return [torch.as_tensor(t).to(dev) for t in tensors]


def _check_state(state: TrainState, model, optimizer) -> None:
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the train state holds another model or optimizer "
                         "than the one this step was made for")


def _global_loss(loss: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    loss = loss.detach()
    if mesh is not None:
        loss = loss.clone()
        mean_over([loss], mesh)
    return loss


def _update(state: TrainState, model: nn.Module, optimizer: Optimizer,
            loss_fn: Callable[[], torch.Tensor], mesh: Mesh | None):
    _check_state(state, model, optimizer)
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    if mesh is not None:   # the same parameters have gradients on every rank
        mean_over([p.grad for p in optimizer.params if p.grad is not None],
                  mesh)
    grad_norm = optimizer.update()
    state.step += 1
    return state, {"loss": _global_loss(loss, mesh),
                   "grad_norm": grad_norm.detach()}


def _features(mix_wave, ref_wave, stft_cfg: StftConfig, ref_ch: int):
    """[B, S, C] / [B, spks, S] waves -> rolled [B, C, T, F] mixture and
    [B, spks, T, F] reference spectrograms (data.py:77-79)."""
    mix = stft_scaled(mix_wave.transpose(1, 2), stft_cfg)
    ref = stft_scaled(ref_wave, stft_cfg)
    return torch.roll(mix, -ref_ch, dims=1), ref


def make_separate_train_step(model: nn.Module, optimizer: Optimizer,
                             ref_ch: int = 0,
                             mesh: Mesh | None = None) -> Callable:
    """MISO1 training step.

    (state, mix [B,C,T,F] c64, ref [B,S,T,F] c64) -> (state, metrics).
    Rolls the mic axis so the reference channel is first (trainer.py:155),
    runs the forward, and minimizes the uPIT loss (trainer.py:159-173)."""

    def step(state: TrainState, mix, ref):
        mix, ref = _on(model, mix, ref)
        mix = torch.roll(mix, -ref_ch, dims=1)
        return _update(state, model, optimizer,
                       lambda: loss_upit(model(mix), ref), mesh)

    return step


def make_separate_eval_step(model: nn.Module, ref_ch: int = 0,
                            mesh: Mesh | None = None) -> Callable:
    """(mix, ref) -> (loss, estimates) for validation, without gradients
    (trainer.py:224; the JAX step also takes the params, which the port's
    model holds)."""

    @torch.no_grad()
    def step(mix, ref):
        mix, ref = _on(model, mix, ref)
        est = model(torch.roll(mix, -ref_ch, dims=1))
        return _global_loss(loss_upit(est, ref), mesh), est

    return step


def make_separate_wave_train_step(model: nn.Module, optimizer: Optimizer,
                                  stft_cfg: StftConfig, ref_ch: int = 0,
                                  mesh: Mesh | None = None,
                                  overest: bool = False) -> Callable:
    """MISO1 training step over time-domain batches, the STFT on the device
    in the same step as the forward and backward.

    (state, mix_wave [B, S, C] f32, ref_wave [B, num_spks, S] f32)
        -> (state, metrics).

    ``overest=True`` trains with loss_upit_overest (the reference's
    loss_uPIT_v1, criterion.py:65-119) and the step takes ``alpha``:
    (state, mix_wave, ref_wave, alpha)."""

    def step(state: TrainState, mix_wave, ref_wave, alpha=None):
        if overest and alpha is None:
            raise ValueError("an overest step needs alpha")
        mix_wave, ref_wave = _on(model, mix_wave, ref_wave)
        mix, ref = _features(mix_wave, ref_wave, stft_cfg, ref_ch)

        def loss_fn():
            est = model(mix)
            if overest:
                return loss_upit_overest(est, ref, alpha)
            return loss_upit(est, ref)

        return _update(state, model, optimizer, loss_fn, mesh)

    return step


def make_separate_wave_eval_step(model: nn.Module, stft_cfg: StftConfig,
                                 ref_ch: int = 0,
                                 mesh: Mesh | None = None) -> Callable:
    """(mix_wave [B,S,C], ref_wave [B,spks,S]) -> (loss, est)."""

    @torch.no_grad()
    def step(mix_wave, ref_wave):
        mix_wave, ref_wave = _on(model, mix_wave, ref_wave)
        mix, ref = _features(mix_wave, ref_wave, stft_cfg, ref_ch)
        est = model(mix)
        return _global_loss(loss_upit(est, ref), mesh), est

    return step


def make_enhance_train_step(model: nn.Module, optimizer: Optimizer,
                            mesh: Mesh | None = None) -> Callable:
    """MISO3 (per-speaker) training step, speakers folded into the batch
    (trainer.py:394-425 with the intended per-speaker conditioning).

    (state, x [B,C+2,T,F] c64, ref [B,1,T,F] c64) -> (state, metrics),
    where the caller builds x with models.enhance_input per speaker."""

    def step(state: TrainState, x, ref):
        x, ref = _on(model, x, ref)
        return _update(state, model, optimizer,
                       lambda: loss_enhance(model(x), ref), mesh)

    return step


def make_enhance_joint_train_step(model: nn.Module, optimizer: Optimizer,
                                  mesh: Mesh | None = None) -> Callable:
    """MISO2 (joint two-speaker) training step: one forward + uPIT loss
    (trainer.py:427-442).

    (state, x [B,C+2S,T,F] c64, ref [B,S,T,F] c64) -> (state, metrics)."""

    def step(state: TrainState, x, ref):
        x, ref = _on(model, x, ref)
        return _update(state, model, optimizer,
                       lambda: loss_upit(model(x), ref), mesh)

    return step

"""Train state, optimizer, learning-rate schedule (misonet_tpu/train/state.py).

The optimizer follows the reference as the JAX package built it with optax:
Adam (lr 1e-3, wd 0; AdamW when weight decay is set), RMSprop or SGD, an
optional clip of the global gradient norm, and a guard that rejects updates
with non-finite gradients.  ``Optimizer.update`` reproduces optax's
``apply_if_finite(chain(clip_by_global_norm, inject_hyperparams(opt)))``:

* the guard looks at the raw gradients; a rejected update leaves the
  parameters AND the inner optimizer state untouched (``step()`` is not
  called, so Adam's step count does not advance).  After MORE than
  ``max_consecutive_nan_steps`` consecutive rejections it gives up and
  applies the update, as optax's code does;
* clipping scales by ``max_norm / g_norm`` only when ``g_norm >=
  max_norm`` (optax), not by ``max_norm / (g_norm + 1e-6)`` as
  ``torch.nn.utils.clip_grad_norm_`` would;
* optax's RMSprop (decay 0.9, eps inside the square root) is not
  ``torch.optim.RMSprop``, so it is written here (:class:`OptaxRMSprop`);
  Adam, AdamW and SGD are ``torch.optim``'s, whose updates are optax's.

The learning rate lives in ``param_groups[i]["lr"]`` (where JAX kept it in
the ``inject_hyperparams`` state), so the host-driven plateau schedule sets
it between epochs.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from misonet_tpu_torch.config import OptimizerConfig
from misonet_tpu_torch.utils import profiling


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)`` with its defaults: nu = decay nu + (1 - decay)
    g^2, p -= lr g / sqrt(nu + eps), nu starting at 0."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1.0 - group["decay"])
                p.sub_(group["lr"] * p.grad / torch.sqrt(nu + group["eps"]))


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over all gradient tensors (optax.global_norm)."""
    return torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())


@dataclasses.dataclass
class Optimizer:
    """A ``torch.optim`` optimizer with optax's clipping and NaN guard.

    ``nan_steps`` counts consecutive rejected updates (optax's
    ``notfinite_count``)."""

    inner: torch.optim.Optimizer
    max_norm: float | None = None
    guard_nans: bool = True
    max_consecutive_nan_steps: int = 5
    nan_steps: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def update(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad`` in place.
        Returns the global norm of the raw gradients (before clipping)."""
        with profiling.span("train.optimizer"):
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = global_norm(grads)
            if self.guard_nans:
                finite = _host_bool(torch.stack(
                    [torch.isfinite(g).all() for g in grads]).all())
                self.nan_steps = 0 if finite else self.nan_steps + 1
                if (not finite
                        and self.nan_steps <= self.max_consecutive_nan_steps):
                    return norm
            if self.max_norm is not None and _host_bool(norm >= self.max_norm):
                with torch.no_grad():
                    for g in grads:
                        g.div_(norm).mul_(self.max_norm)
            self.inner.step()
            return norm


def _host_bool(x: torch.Tensor) -> bool:
    """``bool(x)``, counted as a ``sync`` where ``x`` is on a card."""
    if x.is_cuda:
        profiling.count("sync")
    return bool(x)


def make_optimizer(cfg: OptimizerConfig, params) -> Optimizer:
    """The optimizer of ``cfg`` over ``params`` (make_optimizer of the JAX
    package, which needs no parameters to build one)."""
    params = list(params)
    if cfg.name == "adam":
        if cfg.weight_decay:
            inner = torch.optim.AdamW(params, lr=cfg.lr,
                                      weight_decay=cfg.weight_decay)
        else:
            inner = torch.optim.Adam(params, lr=cfg.lr)
    elif cfg.name == "rmsprop":
        inner = OptaxRMSprop(params, lr=cfg.lr)
    elif cfg.name == "sgd":
        inner = torch.optim.SGD(params, lr=cfg.lr)
    else:
        raise ValueError(f"unsupported optimizer: {cfg.name}")
    return Optimizer(
        inner,
        max_norm=cfg.max_norm if cfg.clipping else None,
        guard_nans=cfg.guard_nans,
        max_consecutive_nan_steps=cfg.max_consecutive_nan_steps,
    )


@dataclasses.dataclass
class TrainState:
    """What a train step updates: its count, the model (whose parameters
    are the JAX state's ``params``) and the optimizer (``opt_state``).
    Steps update the model and optimizer in place."""

    step: int
    model: nn.Module
    optimizer: Optimizer


def create_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every parameter group; returns ``state``."""
    for group in state.optimizer.inner.param_groups:
        group["lr"] = lr
    return state


def current_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.inner.param_groups[0]["lr"])


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau(mode=min): halve the LR when the monitored loss has
    not improved for ``patience`` epochs, floored at ``min_lr``
    (reference run.py:219-223).  Also tracks the early-stop counter the
    reference keeps in the trainer (NN_BSS.yml:143, trainer.py)."""

    lr: float
    factor: float = 0.5
    patience: int = 3
    min_lr: float = 5e-6
    early_stop_patience: int = 10

    best: float = float("inf")
    bad_epochs: int = 0
    epochs_since_best: int = 0

    def step(self, val_loss: float) -> float:
        """Record an epoch's validation loss; returns the (possibly reduced)
        learning rate to use next."""
        if val_loss < self.best:
            self.best = val_loss
            self.bad_epochs = 0
            self.epochs_since_best = 0
        else:
            self.bad_epochs += 1
            self.epochs_since_best += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    @property
    def should_stop(self) -> bool:
        return self.epochs_since_best >= self.early_stop_patience

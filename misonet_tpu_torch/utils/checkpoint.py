"""Checkpoint / resume (misonet_tpu/utils/checkpoint.py, Orbax there).

Reference counterpart: torch.save dicts of {model_state_dict, optimizer,
epoch, tr/val loss arrays} every N epochs + best-model save
(trainer.py:88-99, :126-139) and resume from config (trainer.py:54-71), plus
cross-stage hand-off of the frozen MISO1 parameters into enhancement
training/testing (run.py:101-109, :137-145).

Layout, as in the JAX package: ``<dir>/<tag>/`` holds the train state
(``state.pt``: the model's ``state_dict``, the optimizer's state with
Adam's moments and step counts, the NaN guard's counter, the step and the
learning rate) and ``<dir>/<tag>.meta.json`` the host-side metadata
(``epoch``, ``history``, ``lr``, ``best_val``).  Tensors are saved from
wherever they live and restored onto the model's device.  A checkpoint of
the JAX package (an Orbax directory) is read outside the port and its
params moved in with ``utils/weights.py::load_jax_params``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from misonet_tpu_torch.train.state import (
    TrainState,
    current_learning_rate,
    set_learning_rate,
)

STATE_FILE = "state.pt"


def save_checkpoint(directory: str | Path, tag: str, state: TrainState,
                    metadata: dict | None = None) -> Path:
    """Save ``state`` under <directory>/<tag> (e.g. 'epoch005', 'best'),
    replacing an older checkpoint of that tag."""
    path = (Path(directory) / tag).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.inner.state_dict(),
        "nan_steps": state.optimizer.nan_steps,
        "step": state.step,
        "lr": current_learning_rate(state),
    }, path / STATE_FILE)
    if metadata is not None:
        (path.parent / f"{tag}.meta.json").write_text(
            json.dumps(metadata, default=_json_default)
        )
    return path


def _read(path: Path, device) -> dict:
    return torch.load(path / STATE_FILE, map_location=device,
                      weights_only=True)


def load_checkpoint(directory: str | Path, tag: str,
                    state: TrainState) -> tuple[TrainState, dict]:
    """Restore a checkpoint saved by :func:`save_checkpoint` into ``state``
    (its model and optimizer, in place; strictly).  Returns (state,
    metadata)."""
    path = (Path(directory) / tag).absolute()
    device = next(state.model.parameters()).device
    saved = _read(path, device)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.inner.load_state_dict(saved["optimizer"])
    state.optimizer.nan_steps = int(saved["nan_steps"])
    state.step = int(saved["step"])
    set_learning_rate(state, float(saved["lr"]))
    meta_path = path.parent / f"{tag}.meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return state, meta


def load_model(directory: str | Path, tag: str,
               model: torch.nn.Module) -> torch.nn.Module:
    """Load only the model's parameters of a checkpoint into ``model`` (in
    place, strictly), for a frozen stage; returns ``model``."""
    path = (Path(directory) / tag).absolute()
    saved = _read(path, next(model.parameters()).device)
    model.load_state_dict(saved["model"], strict=True)
    return model


def latest_checkpoint(directory: str | Path) -> str | None:
    """Most recent epochNNN tag in a checkpoint dir ('best' excluded)."""
    root = Path(directory)
    if not root.exists():
        return None
    epochs = sorted(p.name for p in root.iterdir()
                    if p.name.startswith("epoch") and p.is_dir())
    return epochs[-1] if epochs else None


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))

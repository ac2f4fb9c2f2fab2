"""Weight bridge: misonet_tpu (JAX/flax) params -> this port's ``state_dict``.

The inverse direction of misonet_tpu/utils/port_torch.py.  Strict: every
JAX leaf must map to a port parameter, every port parameter must be set
exactly once, and shapes must agree after the layout conversion.

JAX path (``/``-joined)                         port key, layout
  enc{i}/Conv_0/{kernel,bias}                   enc{i}.conv.{weight,bias}
  {enc,dec}{i}_dense/conv{n}_{kernel,bias}      ...dense.convs.{n-1}.{weight,bias}
  dec{i}/ConvTranspose2dTorch_0/{kernel,bias}   dec{i}.deconv.{weight,bias}
  dec{last}/{kernel,bias}                       dec{last}.{weight,bias}
  tcn/repeat{r}_block{b}/DepthwiseSeparableConv_{j}/
      depthwise/kernel                          ...dsconv{j+1}.depthwise.weight
      PReLU_0/alpha                             ...dsconv{j+1}.prelu.alpha
      GlobalLayerNorm_0/{gamma,beta}            ...dsconv{j+1}.norm.{gamma,beta}
      pointwise/kernel                          ...dsconv{j+1}.pointwise.weight
  tcn/repeat{r}_block{b}/<Norm>_{j}/{gamma,beta}  ...norm{j+1}.{gamma,beta}

Layout conversions:
  Conv2d            HWIO [kh, kw, I, O] -> OIHW [O, I, kh, kw]
  ConvTranspose2d   [kh, kw, I, O]      -> [I, O, kh, kw]  (no flip: both
                                           store the true-convolution kernel)
  Conv1d depthwise  [k, 1, C]           -> [C, 1, k]
  Conv1d pointwise  [1, I, O]           -> [O, I, 1]
  gLN/cLN/BN, PReLU kept as they are
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _conv2d(w):
    return w.transpose(3, 2, 0, 1)


def _deconv2d(w):
    return w.transpose(2, 3, 0, 1)


def _conv1d(w):
    return w.transpose(2, 1, 0)


def _same(w):
    return w


_TB = r"tcn/(repeat\d+_block\d+)"
_RULES = [
    (r"(enc\d+)/Conv_0/kernel", lambda m: f"{m[1]}.conv.weight", _conv2d),
    (r"(enc\d+)/Conv_0/bias", lambda m: f"{m[1]}.conv.bias", _same),
    (r"((?:enc|dec)\d+_dense)/conv(\d)_kernel",
     lambda m: f"{m[1]}.convs.{int(m[2]) - 1}.weight", _conv2d),
    (r"((?:enc|dec)\d+_dense)/conv(\d)_bias",
     lambda m: f"{m[1]}.convs.{int(m[2]) - 1}.bias", _same),
    (r"(dec\d+)/ConvTranspose2dTorch_0/kernel",
     lambda m: f"{m[1]}.deconv.weight", _deconv2d),
    (r"(dec\d+)/ConvTranspose2dTorch_0/bias",
     lambda m: f"{m[1]}.deconv.bias", _same),
    (r"(dec\d+)/kernel", lambda m: f"{m[1]}.weight", _deconv2d),
    (r"(dec\d+)/bias", lambda m: f"{m[1]}.bias", _same),
    (_TB + r"/DepthwiseSeparableConv_(\d)/depthwise/kernel",
     lambda m: f"tcn.{m[1]}.dsconv{int(m[2]) + 1}.depthwise.weight", _conv1d),
    (_TB + r"/DepthwiseSeparableConv_(\d)/pointwise/kernel",
     lambda m: f"tcn.{m[1]}.dsconv{int(m[2]) + 1}.pointwise.weight", _conv1d),
    (_TB + r"/DepthwiseSeparableConv_(\d)/PReLU_0/alpha",
     lambda m: f"tcn.{m[1]}.dsconv{int(m[2]) + 1}.prelu.alpha", _same),
    (_TB + r"/DepthwiseSeparableConv_(\d)/GlobalLayerNorm_0/(gamma|beta)",
     lambda m: f"tcn.{m[1]}.dsconv{int(m[2]) + 1}.norm.{m[3]}", _same),
    (_TB + r"/(?:GlobalLayerNorm|ChannelwiseLayerNorm|SimpleBatchNorm)_(\d)"
     r"/(gamma|beta)",
     lambda m: f"tcn.{m[1]}.norm{int(m[2]) + 1}.{m[3]}", _same),
]
_RULES = [(re.compile(p + "$"), key, conv) for p, key, conv in _RULES]


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _leaves(value, path)
        else:
            yield path, value


def jax_to_state_dict(params, model: torch.nn.Module) -> dict:
    """Convert a misonet_tpu MISONet params tree (``{"params": {...}}`` or
    its inner dict; leaves JAX or numpy arrays) into a ``state_dict`` for
    ``model``.  Raises on any unmapped leaf, missing parameter or shape
    mismatch."""
    if "params" in params:
        params = params["params"]
    expected = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        for pattern, key_of, convert in _RULES:
            m = pattern.match(path)
            if m:
                break
        else:
            raise KeyError(f"no port parameter for JAX leaf {path!r}")
        key = key_of(m)
        if key not in expected:
            raise KeyError(f"JAX leaf {path!r} maps to {key!r}, which the "
                           "port model does not have")
        if key in out:
            raise KeyError(f"port parameter {key!r} set twice")
        value = np.array(convert(np.asarray(leaf, np.float32)), order="C")
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{path!r} -> {key!r}: shape {value.shape} after conversion, "
                f"port expects {tuple(expected[key].shape)}"
            )
        out[key] = torch.from_numpy(value)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters not set by the JAX params: {missing}")
    return out


def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load JAX params into ``model`` in place (strictly) and return it."""
    model.load_state_dict(jax_to_state_dict(params, model), strict=True)
    return model

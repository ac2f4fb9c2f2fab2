"""Weight porting: a reference MISOnet PyTorch ``state_dict`` straight into
the port's (misonet_tpu/utils/port_torch.py, which maps it to JAX params).

Both sides are PyTorch modules with the same layouts, so only the names
move, with two reshapes:

  reference name                                port key
  encoders.0.0.conv2d.*                         enc0.conv.*
  encoders.{i}.0.net.0.*                        enc{i}.conv.*
  encoders.{i}.1.conv{n}.0.*       (i < 5)      enc{i}_dense.convs.{n-1}.*
  TCN.temporal_conv_net.{r}.{x}.net.{2|5}.net.
      0.weight                                  tcn.repeat{r}_block{x}.
                                                  dsconv{1|2}.depthwise.weight
      1.weight  [1] -> []                         ...prelu.alpha
      2.{gamma,beta}  [1, C, 1] -> [1, 1, C]      ...norm.{gamma,beta}
      3.weight                                    ...pointwise.weight
  decoders.{i}.0.net.0.*           (i < 2)      dec{i}.deconv.*
  decoders.{i}.0.conv{n}.0.*       (i >= 2)     dec{i}_dense.convs.{n-1}.*
  decoders.{i}.1.net.0.*           (2 <= i < last)  dec{i}.deconv.*
  decoders.{last}.1.deconv2d.*                  dec{last}.*

Strict, like ``utils/weights.py::load_jax_params``: every reference entry
maps to a port parameter, every port parameter is set once, and shapes
agree.
"""

from __future__ import annotations

import numpy as np
import torch


def _pairs(num_bottleneck: int, tcn_repeats: int, tcn_blocks: int):
    """(reference name, port key, reshape or None) of every parameter."""
    out = []

    def conv(ref, port):
        out.extend((f"{ref}.{p}", f"{port}.{p}", None)
                   for p in ("weight", "bias"))

    for i in range(num_bottleneck):
        conv("encoders.0.0.conv2d" if i == 0 else f"encoders.{i}.0.net.0",
             f"enc{i}.conv")
        if i < 5:
            for n in range(1, 6):
                conv(f"encoders.{i}.1.conv{n}.0", f"enc{i}_dense.convs.{n - 1}")
    for r in range(tcn_repeats):
        for x in range(tcn_blocks):
            for j, net in enumerate((2, 5)):
                ref = f"TCN.temporal_conv_net.{r}.{x}.net.{net}.net"
                port = f"tcn.repeat{r}_block{x}.dsconv{j + 1}"
                out += [
                    (f"{ref}.0.weight", f"{port}.depthwise.weight", None),
                    (f"{ref}.1.weight", f"{port}.prelu.alpha", "scalar"),
                    (f"{ref}.2.gamma", f"{port}.norm.gamma", "channels"),
                    (f"{ref}.2.beta", f"{port}.norm.beta", "channels"),
                    (f"{ref}.3.weight", f"{port}.pointwise.weight", None),
                ]
    last = num_bottleneck - 1
    for i in range(num_bottleneck):
        if i < 2:
            conv(f"decoders.{i}.0.net.0", f"dec{i}.deconv")
            continue
        for n in range(1, 6):
            conv(f"decoders.{i}.0.conv{n}.0", f"dec{i}_dense.convs.{n - 1}")
        if i == last:
            conv(f"decoders.{i}.1.deconv2d", f"dec{i}")
        else:
            conv(f"decoders.{i}.1.net.0", f"dec{i}.deconv")
    return out


def port_miso_state_dict(state_dict, model: torch.nn.Module) -> dict:
    """A reference MISO_{1,2,3} ``state_dict`` (tensors or numpy arrays) as
    a ``state_dict`` for ``model`` (a port ``MISONet`` of the same plan).
    Raises on a reference entry it does not map, a port parameter left
    unset, or a shape that disagrees."""
    cfg = model.cfg
    expected = model.state_dict()
    pairs = _pairs(cfg.num_bottleneck, cfg.tcn_repeats, cfg.tcn_blocks)
    unmapped = sorted(set(state_dict) - {ref for ref, _, _ in pairs})
    if unmapped:
        raise KeyError(f"reference entries with no port parameter: "
                       f"{unmapped}")
    out: dict[str, torch.Tensor] = {}
    for ref, key, reshape in pairs:
        if ref not in state_dict:
            raise KeyError(f"reference state_dict lacks {ref!r} (for {key!r})")
        if key not in expected:
            raise KeyError(f"{ref!r} maps to {key!r}, which the port model "
                           "does not have")
        value = torch.as_tensor(np.asarray(state_dict[ref], np.float32))
        if reshape == "scalar":
            value = value.reshape(())
        elif reshape == "channels":
            value = value.transpose(1, 2)
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(f"{ref!r} -> {key!r}: shape {tuple(value.shape)}"
                             f", port expects {tuple(expected[key].shape)}")
        out[key] = value.contiguous()
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters not set by the reference: {missing}")
    return out


def load_reference_state_dict(model: torch.nn.Module,
                              state_dict) -> torch.nn.Module:
    """Load a reference MISOnet ``state_dict`` into ``model`` in place
    (strictly) and return it."""
    model.load_state_dict(port_miso_state_dict(state_dict, model),
                          strict=True)
    return model

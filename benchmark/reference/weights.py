"""Weights from the seed, made on the device in a few large calls."""

from __future__ import annotations

import math

import torch

from benchmark.reference.nets import param_spec


def make_state_dict(net: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for ``net``'s parameters under the program's
    initialization rule (``nets.param_spec``), drawn from one generator on
    ``device`` seeded by ``seed``: one ``randn`` for every weight, split and
    scaled by 1/sqrt(fan_in); biases and shifts 0, gains 1, PReLU 0.25."""
    spec = param_spec(net)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = sum(math.prod(s) for _, s, kind, _ in spec if kind == "normal")
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    fill = {"zero": 0.0, "one": 1.0, "prelu": 0.25}
    for name, shape, kind, fan in spec:
        if kind == "normal":
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape) / math.sqrt(fan)
            off += k
        else:
            out[name] = torch.full(shape, fill[kind], device=device)
    return out

"""PyTorch port, utils/port_torch.py: a reference MISOnet ``state_dict``
loaded straight into the port, bit-equal to the JAX package's
``port_miso_state_dict`` followed by ``load_jax_params``, and strict.

The reference ``state_dict`` is built here from the reference module names
(misonet_tpu/utils/port_torch.py:50-119) at the narrow 7-level plan of
tests/test_torch_weights.py, filled from a numpy seed; no reference
checkout is needed."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from misonet_tpu.utils.port_torch import port_miso_state_dict as jax_port  # noqa: E402
from misonet_tpu_torch.config import ModelConfig  # noqa: E402
from misonet_tpu_torch.models import make_miso1  # noqa: E402
from misonet_tpu_torch.utils.port_torch import (  # noqa: E402
    load_reference_state_dict,
    port_miso_state_dict,
)
from misonet_tpu_torch.utils.weights import load_jax_params  # noqa: E402

PLAN = ModelConfig(en_channels=(8, 8, 8, 8, 8, 16, 16),
                   de_channels=(16, 16, 8, 8, 8, 8, 8), tcn_repeats=1,
                   tcn_blocks=2, tcn_channels=16, compute_dtype="float32")
MICS, SPKS = 6, 2


def _reference_shapes(cfg=PLAN):
    """{reference name: shape} of the reference MISO_1 at ``cfg``."""
    en, nb = cfg.en_channels, cfg.num_bottleneck
    de = list(cfg.de_channels) + [2 * SPKS]
    out = {}

    def conv(name, o, i, transpose=False):
        out[f"{name}.weight"] = (i, o, 3, 3) if transpose else (o, i, 3, 3)
        out[f"{name}.bias"] = (o,)

    c_in = 2 * MICS
    for i in range(nb):
        conv("encoders.0.0.conv2d" if i == 0 else f"encoders.{i}.0.net.0",
             en[i], c_in)
        if i < 5:
            for n in range(1, 6):
                conv(f"encoders.{i}.1.conv{n}.0", en[i], n * en[i])
        c_in = en[i]
    c = cfg.tcn_channels
    for r in range(cfg.tcn_repeats):
        for x in range(cfg.tcn_blocks):
            for net in (2, 5):
                base = f"TCN.temporal_conv_net.{r}.{x}.net.{net}.net"
                out[f"{base}.0.weight"] = (c, 1, 3)
                out[f"{base}.1.weight"] = (1,)
                out[f"{base}.2.gamma"] = (1, c, 1)
                out[f"{base}.2.beta"] = (1, c, 1)
                out[f"{base}.3.weight"] = (c, c, 1)
    c_x = c
    for i in range(nb):
        cin = c_x + en[nb - 1 - i]
        if i >= 2:
            for n in range(1, 6):
                conv(f"decoders.{i}.0.conv{n}.0",
                     cin if n == 5 else cin // 2, cin + (n - 1) * (cin // 2))
        name = (f"decoders.{i}.0.net.0" if i < 2 else
                f"decoders.{i}.1.deconv2d" if i == nb - 1 else
                f"decoders.{i}.1.net.0")
        conv(name, de[i + 1], cin, transpose=True)
        c_x = de[i + 1]
    return out


def _reference_state_dict(seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in _reference_shapes().items()}


def _model():
    return make_miso1(PLAN, MICS, SPKS, device="cpu")


def test_direct_load_equals_the_jax_route():
    ref = _reference_state_dict()
    got = load_reference_state_dict(_model(), ref).state_dict()
    params = jax_port({k: v.numpy() for k, v in ref.items()},
                      num_bottleneck=PLAN.num_bottleneck,
                      tcn_repeats=PLAN.tcn_repeats,
                      tcn_blocks=PLAN.tcn_blocks)
    want = load_jax_params(_model(), params).state_dict()
    assert got.keys() == want.keys()
    assert len(ref) == len(got)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def test_port_is_strict():
    ref = _reference_state_dict(1)
    model = _model()
    with pytest.raises(KeyError, match="no port parameter"):
        port_miso_state_dict({**ref, "encoders.9.0.net.0.weight":
                              torch.zeros(1)}, model)
    short = dict(ref)
    del short["TCN.temporal_conv_net.0.1.net.5.net.2.gamma"]
    with pytest.raises(KeyError, match="lacks"):
        port_miso_state_dict(short, model)
    bad = dict(ref)
    bad["decoders.6.1.deconv2d.bias"] = torch.zeros(5)
    with pytest.raises(ValueError, match="dec6.bias"):
        port_miso_state_dict(bad, model)

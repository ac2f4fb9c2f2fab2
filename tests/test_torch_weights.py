"""PyTorch port: the JAX -> port weight bridge (utils/weights.py) and the
model-level configuration checks.

The bridge must be strict: every JAX leaf used, every port parameter set,
shapes checked.  The parameter count of the default plan is the JAX
package's 2,587,384 (README, tests/test_model.py).

Tolerance: none; the bridge only transposes, so values must be equal
exactly."""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu.config import ModelConfig  # noqa: E402
from misonet_tpu.models import make_miso1 as jax_miso1  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch.models import make_miso1 as port_miso1  # noqa: E402
from misonet_tpu_torch.utils.weights import (  # noqa: E402
    jax_to_state_dict,
    load_jax_params,
)


def _narrow(**kw):
    return ModelConfig(**{
        "en_channels": (8, 8, 8, 8, 8, 16, 16),
        "de_channels": (16, 16, 8, 8, 8, 8, 8),
        "tcn_repeats": 1, "tcn_blocks": 2, "tcn_channels": 16,
        "compute_dtype": "float32", **kw,
    })


def _jax_params(cfg):
    """The JAX params tree of ``cfg`` (shapes traced, values random)."""
    x = jax.lax.complex(jnp.zeros((1, 6, 4, 129)), jnp.zeros((1, 6, 4, 129)))
    shapes = jax.eval_shape(jax_miso1(cfg).init, jax.random.key(0), x)
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes
    )


def make_miso1(cfg):
    """The port's MISO1 on the CPU, from the port's copy of ``cfg``."""
    return port_miso1(tcfg.ModelConfig(**dataclasses.asdict(cfg)),
                      device="cpu")


@pytest.fixture(scope="module")
def narrow_params():
    return _jax_params(_narrow())


def test_default_plan_parameter_count():
    model = make_miso1(ModelConfig(compute_dtype="float32"))
    assert sum(p.numel() for p in model.parameters()) == 2_587_384


@pytest.mark.parametrize("norm_type", ["IN", "gLN"])
def test_bridge_sets_every_parameter(norm_type, narrow_params):
    cfg = _narrow(norm_type=norm_type)
    params = narrow_params if norm_type == "IN" else _jax_params(cfg)
    model = make_miso1(cfg)
    load_jax_params(model, params)
    n_leaves = len(jax.tree.leaves(params))
    assert n_leaves == len(model.state_dict())
    # layouts: OIHW conv, [I, O, kh, kw] transpose conv, [C, 1, k] depthwise
    p = params["params"]
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["enc1.conv.weight"].numpy(),
        np.asarray(p["enc1"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["dec3.deconv.weight"].numpy(),
        np.asarray(p["dec3"]["ConvTranspose2dTorch_0"]["kernel"])
        .transpose(2, 3, 0, 1))
    dw = p["tcn"]["repeat0_block1"]["DepthwiseSeparableConv_0"]["depthwise"]
    np.testing.assert_array_equal(
        sd["tcn.repeat0_block1.dsconv1.depthwise.weight"].numpy(),
        np.asarray(dw["kernel"]).transpose(2, 1, 0))


def _edit(params, fn):
    tree = jax.tree.map(np.asarray, params)
    tree = {"params": {k: dict(v) for k, v in tree["params"].items()}}
    fn(tree["params"])
    return tree


def test_bridge_rejects_missing_leaf(narrow_params):
    model = make_miso1(_narrow())
    broken = _edit(narrow_params, lambda p: p["dec6"].pop("bias"))
    with pytest.raises(KeyError, match="dec6.bias"):
        jax_to_state_dict(broken, model)


def test_bridge_rejects_unknown_leaf(narrow_params):
    model = make_miso1(_narrow())
    extra = _edit(narrow_params,
                  lambda p: p["enc0"].update(Extra_0={"kernel": np.zeros(3)}))
    with pytest.raises(KeyError, match="Extra_0"):
        jax_to_state_dict(extra, model)


def test_bridge_rejects_wrong_shape(narrow_params):
    model = make_miso1(_narrow())

    def widen(p):
        p["enc0_dense"]["conv1_bias"] = np.zeros(9, np.float32)

    with pytest.raises(ValueError, match="conv1_bias"):
        jax_to_state_dict(_edit(narrow_params, widen), model)


@pytest.mark.parametrize("kw,err", [
    ({"compute_dtype": "float16"}, ValueError),
    ({"compute_dtype": "float16", "quant_int8": True}, ValueError),
    ({"compute_dtype": "float32", "norm_type": "LN"}, ValueError),
])
def test_unported_settings_raise(kw, err):
    """bfloat16 and quant_int8 are ported (see below), and so is the
    sequence-parallel TCN (tests/test_torch_tcn_sp.py); a compute dtype the
    port has no kernels for and a norm the reference has not raise."""
    with pytest.raises(err):
        make_miso1(ModelConfig(**kw))


@pytest.mark.parametrize("kw", [
    {"compute_dtype": "bfloat16"},
    {"compute_dtype": "bfloat16", "quant_int8": True},
    {"compute_dtype": "float32", "quant_int8": True},
])
def test_bridge_fills_bf16_and_int8_models(kw, narrow_params):
    """The bf16 and int8 models build, the bridge fills them with the same
    float32 parameters as the float32 model (parameters stay float32 and are
    cast at use, as in JAX), and on the CPU, where the plain modules run and
    quant_int8 does not apply, the int8 model computes exactly what the
    model of its compute dtype without it does."""
    ref = load_jax_params(make_miso1(_narrow()), narrow_params).state_dict()
    model = load_jax_params(make_miso1(_narrow(**kw)), narrow_params)
    sd = model.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in sd.items():
        assert v.dtype == torch.float32 and torch.equal(v, ref[k]), k
    plain = load_jax_params(
        make_miso1(_narrow(compute_dtype=kw["compute_dtype"])), narrow_params)
    x = torch.from_numpy((np.random.default_rng(4).standard_normal(
        (1, 6, 4, 129, 2))).astype(np.float32))
    x = torch.view_as_complex(x)
    with torch.no_grad():
        out = model(x)
        want = plain(x)
    assert out.dtype == torch.complex64 and out.shape == (1, 2, 4, 129)
    assert torch.isfinite(torch.view_as_real(out)).all()
    assert torch.equal(out, want)


def test_fused_path_needs_cuda():
    model = make_miso1(_narrow(flat_dense=True))
    x = torch.zeros(1, 6, 4, 129, dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA"):
        model(x)

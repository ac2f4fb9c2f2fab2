"""PyTorch port: every block of models/blocks.py against its JAX module,
with the JAX parameters (randomized, so biases and affine terms are
non-trivial) moved into the port by the bridge's layout conversions.

Tolerance: float32 on both sides, differing only in summation order
(XLA vs. oneDNN/ATen convolutions, two-pass statistics), so outputs agree
to ~1e-6 of their max-abs; the bound is 1e-5 normalized by max-abs."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu.models import blocks as jb  # noqa: E402
from misonet_tpu_torch.models import blocks as tb  # noqa: E402
from misonet_tpu_torch.utils.weights import (  # noqa: E402
    _conv1d,
    _conv2d,
    _deconv2d,
)

ATOL = 1e-5


def _randomize(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(
            (0.3 * rng.standard_normal(p.shape)).astype(np.float32)
        ),
        params,
    )


def _load(module, params, mapping):
    """mapping: {jax path: (port key, layout conversion)}."""
    flat = {
        "/".join(k.key for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    sd = {key: torch.from_numpy(np.array(conv(flat[p])))
          for p, (key, conv) in mapping.items()}
    assert set(flat) == set(mapping), (sorted(flat), sorted(mapping))
    module.load_state_dict(sd, strict=True)
    return module


def _same(w):
    return w


def _close(out, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out / scale, ref / scale, atol=ATOL)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _run2d(jmod, tmod, mapping, shape, seed=0):
    """NHWC JAX module vs NCHW port module on the same input."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    params = _randomize(jmod.init(jax.random.key(0), jnp.asarray(x)), seed)
    ref = jmod.apply(params, jnp.asarray(x))
    if mapping:
        _load(tmod, params["params"], mapping)
    with torch.no_grad():
        out = tmod(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    _close(out, ref)


def _run1d(jmod, tmod, mapping, shape, seed=0):
    """[B, T, C] JAX module vs [B, C, T] port module."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    params = _randomize(jmod.init(jax.random.key(0), jnp.asarray(x)), seed)
    ref = jmod.apply(params, jnp.asarray(x))
    if mapping:
        _load(tmod, params["params"], mapping)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    _close(out.numpy().transpose(0, 2, 1), ref)


def _affine(prefix=""):
    return {f"{prefix}gamma": (f"{prefix.replace('/', '.')}gamma", _same),
            f"{prefix}beta": (f"{prefix.replace('/', '.')}beta", _same)}


def test_instance_norm():
    _run2d(jb.InstanceNorm(), tb.InstanceNorm(), None, (2, 9, 7, 5))


@pytest.mark.parametrize("jcls,tcls", [
    (jb.GlobalLayerNorm, tb.GlobalLayerNorm),
    (jb.ChannelwiseLayerNorm, tb.ChannelwiseLayerNorm),
    (jb.SimpleBatchNorm, tb.SimpleBatchNorm),
])
def test_affine_norms(jcls, tcls):
    _run1d(jcls(), tcls(6), _affine(), (2, 11, 6))


def test_prelu():
    _run1d(jb.PReLU(), tb.PReLU(), {"alpha": ("alpha", _same)}, (2, 11, 6))


@pytest.mark.parametrize("stride,f", [((1, 2), 7), ((1, 1), 127)])
def test_conv_transpose(stride, f):
    _run2d(jb.ConvTranspose2dTorch(5, strides=stride),
           tb.ConvTranspose2dTorch(4, 5, stride=stride),
           {"kernel": ("weight", _deconv2d), "bias": ("bias", _same)},
           (2, 6, f, 4))


@pytest.mark.parametrize("stride,act_norm", [((1, 2), True), ((1, 1), False)])
def test_conv_block(stride, act_norm):
    _run2d(jb.ConvBlock(8, strides=stride, act_norm=act_norm),
           tb.ConvBlock(4, 8, stride=stride, act_norm=act_norm),
           {"Conv_0/kernel": ("conv.weight", _conv2d),
            "Conv_0/bias": ("conv.bias", _same)},
           (2, 6, 15, 4))


def test_deconv_block():
    _run2d(jb.DeconvBlock(6, strides=(1, 2)), tb.DeconvBlock(8, 6),
           {"ConvTranspose2dTorch_0/kernel": ("deconv.weight", _deconv2d),
            "ConvTranspose2dTorch_0/bias": ("deconv.bias", _same)},
           (2, 6, 7, 8))


def test_dense_block():
    mapping = {}
    for n in range(1, 6):
        mapping[f"conv{n}_kernel"] = (f"convs.{n - 1}.weight", _conv2d)
        mapping[f"conv{n}_bias"] = (f"convs.{n - 1}.bias", _same)
    _run2d(jb.DenseBlock(4, 8), tb.DenseBlock(8, 4, 8), mapping,
           (2, 6, 7, 8))


def _dsconv_map(prefix, key):
    return {
        f"{prefix}depthwise/kernel": (f"{key}depthwise.weight", _conv1d),
        f"{prefix}pointwise/kernel": (f"{key}pointwise.weight", _conv1d),
        f"{prefix}PReLU_0/alpha": (f"{key}prelu.alpha", _same),
        f"{prefix}GlobalLayerNorm_0/gamma": (f"{key}norm.gamma", _same),
        f"{prefix}GlobalLayerNorm_0/beta": (f"{key}norm.beta", _same),
    }


def test_depthwise_separable_conv():
    _run1d(jb.DepthwiseSeparableConv(6, dilation=2),
           tb.DepthwiseSeparableConv(6, 6, 2), _dsconv_map("", ""),
           (2, 13, 6))


def _temporal_map(prefix, key, norm_type):
    mapping = {}
    for j in range(2):
        mapping.update(_dsconv_map(f"{prefix}DepthwiseSeparableConv_{j}/",
                                   f"{key}dsconv{j + 1}."))
        if norm_type == "gLN":
            for leaf in ("gamma", "beta"):
                mapping[f"{prefix}GlobalLayerNorm_{j}/{leaf}"] = (
                    f"{key}norm{j + 1}.{leaf}", _same)
    return mapping


@pytest.mark.parametrize("norm_type", ["IN", "gLN"])
def test_temporal_block(norm_type):
    _run1d(jb.TemporalBlock(6, dilation=4, norm_type=norm_type),
           tb.TemporalBlock(6, 4, norm_type),
           _temporal_map("", "", norm_type), (2, 13, 6))


def test_temporal_conv_net():
    mapping = {}
    for r in range(2):
        for b in range(2):
            name = f"repeat{r}_block{b}"
            mapping.update(_temporal_map(f"{name}/", f"{name}.", "IN"))
    _run1d(jb.TemporalConvNet(repeats=2, blocks=2, features=6),
           tb.TemporalConvNet(2, 2, 6), mapping, (2, 13, 6))

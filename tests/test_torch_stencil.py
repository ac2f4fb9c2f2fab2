"""PyTorch port, kernel 2 (ops/kernels/stencil.py): the plain version of
each mode against the JAX package.

  * "down" / "up" against the Pallas ``conv_down_flat`` / ``deconv_up_flat``
    (+ ``interleave_up``) in interpret mode, at the shapes of
    tests/test_stencil_flat.py, outputs and fused statistics;
  * "enc0" / "final" against the JAX ``ConvBlock(act_norm=False)`` and
    ``ConvTranspose2dTorch(strides=(1, 1))`` at F = 129 / 127.

The CUDA kernel is held to the plain version in tests/test_torch_cuda.py.

Tolerance: float32 throughout; the kernels fold the input normalization
into correction fields and sum in another order, so outputs agree to
~1e-6 of max-abs; bound 1e-5 normalized by max-abs."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from misonet_tpu.models.blocks import ConvBlock, ConvTranspose2dTorch  # noqa: E402
from misonet_tpu.ops.pallas.conv_flat import flatten_tf, unflatten_tf  # noqa: E402
from misonet_tpu.ops.pallas.stencil_flat import (  # noqa: E402
    conv_down_flat,
    deconv_up_flat,
    interleave_up,
    s2d_flat,
)
from misonet_tpu_torch.ops.kernels.stencil import out_bins, stencil  # noqa: E402
from misonet_tpu_torch.ops.stats import stats_to_scale_mean  # noqa: E402

ATOL = 1e-5
TILE = 256


def _close(out, ref, atol=ATOL):
    out, ref = np.asarray(out), np.asarray(ref)
    scale = np.abs(ref).max()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out / scale, ref / scale, atol=atol)


def _raw_with_stats(rng, b, t, f, c):
    """NHWC raw tensor, its normalized form and IN statistics [B, C]."""
    x = (rng.standard_normal((b, t, f, c)) + 0.3).astype(np.float32)
    mean = x.mean((1, 2))
    scale = (1.0 / np.sqrt(x.var((1, 2)) + 1e-5)).astype(np.float32)
    return x, (x - mean[:, None, None]) * scale[:, None, None], scale, mean


def _weights(rng, shape):
    return (0.2 * rng.standard_normal(shape)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("b,t,f_in,c,n", [(2, 12, 15, 8, 16), (1, 9, 31, 16, 8)])
def test_down_matches_pallas(b, t, f_in, c, n):
    rng = np.random.default_rng(0)
    x, _, scale, mean = _raw_with_stats(rng, b, t, f_in, c)
    w = _weights(rng, (3, 3, c, n))                     # HWIO
    bias = _weights(rng, (n,))
    f_out = out_bins("down", f_in)
    with pltpu.force_tpu_interpret_mode():
        xe, xo = s2d_flat(flatten_tf(jnp.asarray(x), TILE), t, f_in, TILE,
                          TILE)
        yj, sj, qj = conv_down_flat(
            xe, xo, jnp.asarray(w), jnp.asarray(bias), jnp.asarray(scale),
            jnp.asarray(mean), t=t, f_in=f_in, tile_m=TILE, precise=True,
        )
    yt, st, qt = stencil(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                         torch.from_numpy(bias), torch.from_numpy(scale),
                         torch.from_numpy(mean), "down")
    ref = np.asarray(unflatten_tf(yj, t, f_out, TILE)).transpose(0, 3, 1, 2)
    _close(yt.numpy(), ref)
    _close(st.numpy(), np.asarray(sj)[..., 0])
    _close(qt.numpy(), np.asarray(qj)[..., 0])


@pytest.mark.parametrize("b,t,f_in,c,n", [(2, 12, 7, 8, 16), (1, 9, 15, 16, 8)])
def test_up_matches_pallas(b, t, f_in, c, n):
    rng = np.random.default_rng(1)
    x, _, scale, mean = _raw_with_stats(rng, b, t, f_in, c)
    w = _weights(rng, (3, 3, c, n))                     # [kh, kw, I, O]
    bias = _weights(rng, (n,))
    f_out = out_bins("up", f_in)
    with pltpu.force_tpu_interpret_mode():
        y2, sj, qj = deconv_up_flat(
            flatten_tf(jnp.asarray(x), TILE), jnp.asarray(w),
            jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(mean),
            t=t, f_in=f_in, tile_m=TILE, precise=True,
        )
        yj, scj, mnj = interleave_up(y2, sj, qj, t, f_in, TILE, TILE)
    yt, st, qt = stencil(_nchw(x), torch.from_numpy(w.transpose(2, 3, 0, 1)),
                         torch.from_numpy(bias), torch.from_numpy(scale),
                         torch.from_numpy(mean), "up")
    ref = np.asarray(unflatten_tf(yj, t, f_out, TILE)).transpose(0, 3, 1, 2)
    _close(yt.numpy(), ref)
    sc, mn = stats_to_scale_mean(st, qt, t * f_out)
    _close(sc.numpy(), np.asarray(scj))
    _close(mn.numpy(), np.asarray(mnj))


def test_enc0_matches_convblock():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 129, 12)).astype(np.float32)
    mod = ConvBlock(24, strides=(1, 1), act_norm=False)
    params = mod.init(jax.random.key(0), jnp.asarray(x))
    p = params["params"]["Conv_0"]
    p = {"kernel": jnp.asarray(_weights(rng, p["kernel"].shape)),
         "bias": jnp.asarray(_weights(rng, p["bias"].shape))}
    ref = mod.apply({"params": {"Conv_0": p}}, jnp.asarray(x))
    y, s, q = stencil(_nchw(x),
                      torch.from_numpy(np.array(p["kernel"]).transpose(3, 2, 0, 1).copy()),
                      torch.from_numpy(np.array(p["bias"])), None, None,
                      "enc0")
    assert s is None and q is None
    _close(y.numpy(), np.asarray(ref).transpose(0, 3, 1, 2))


def test_final_matches_conv_transpose():
    rng = np.random.default_rng(3)
    x, xn, scale, mean = _raw_with_stats(rng, 2, 7, 127, 12)
    mod = ConvTranspose2dTorch(4, strides=(1, 1))
    params = mod.init(jax.random.key(0), jnp.asarray(xn))["params"]
    params = {k: jnp.asarray(_weights(rng, v.shape)) for k, v in params.items()}
    ref = mod.apply({"params": params}, jnp.asarray(xn))
    y, _, _ = stencil(_nchw(x),
                      torch.from_numpy(np.array(params["kernel"]).transpose(2, 3, 0, 1).copy()),
                      torch.from_numpy(np.array(params["bias"])),
                      torch.from_numpy(scale), torch.from_numpy(mean),
                      "final")
    assert y.shape[-1] == 129
    _close(y.numpy(), np.asarray(ref).transpose(0, 3, 1, 2))


def test_mode_arguments_are_checked():
    x = torch.zeros(1, 2, 3, 9)
    w = torch.zeros(4, 2, 3, 3)
    with pytest.raises(ValueError, match="unknown mode"):
        stencil(x, w, torch.zeros(4), None, None, "sideways")
    with pytest.raises(ValueError, match="scale/mean"):
        stencil(x, w, torch.zeros(4), None, None, "down")


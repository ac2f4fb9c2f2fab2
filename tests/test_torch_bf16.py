"""PyTorch port, bfloat16 serving (``compute_dtype="bfloat16"``, the JAX
package's default): the plain versions of the bf16 kernel modes against the
JAX Pallas kernels with ``precise=False`` in interpret mode, the plain
modules and the whole plain MISO1 at bf16 against the JAX package's, and
the bf16 fused path under autograd.

Inputs come from a numpy seed, are rounded to bfloat16 once, and go to both
packages.  Tolerances, each normalized by the reference's max-abs:

* kernels (a, b): the port normalizes as ``(x - mean) * scale`` rounded to
  bf16 with a zero halo, where the TPU kernel rounds ``x * scale`` to bf16
  and corrects the mean through bf16 coefficient columns; both sum bf16 x
  bf16 products in float32 and round y and the partials to bf16.  So the
  outputs differ by a few bf16 ulps where a rounding falls the other way.
  Measured: y 2.8e-3-5.8e-3 and acc_out 3.6e-3-4.5e-3 of max-abs for one
  call, 8.5e-3 for a five-call DenseBlockFlat; bound 1.6e-2, under JAX's
  own bf16 class of 4e-2 (tests/test_dense_stack.py:127), with correlation
  above 0.9999 (measured >= 0.99997).  The statistics, summed in float32
  from the float32 y on both sides: measured 6.7e-4-1.95e-3, bound 4e-3.
* plain modules and MISO1 (d): XLA and oneDNN round their bf16 conv
  outputs at other points; measured 0-8.5e-3 (blocks) and 1.9e-2 (MISO1,
  correlation 0.99984) of max-abs; bound 4e-2 (JAX's bf16 class) with
  correlation above 0.999.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from misonet_tpu.config import ModelConfig  # noqa: E402
from misonet_tpu.models import blocks as jb  # noqa: E402
from misonet_tpu.models import make_miso1 as jax_miso1  # noqa: E402
from misonet_tpu.models.flat_dense import DenseBlockFlat as JaxDenseBlockFlat  # noqa: E402
from misonet_tpu.models.flat_dense import (  # noqa: E402
    from_flat_bundle,
    merge_bundles as jax_merge,
)
from misonet_tpu.ops.pallas.conv_flat import flatten_tf, unflatten_tf  # noqa: E402
from misonet_tpu.ops.pallas.dense_stack import dense_stack_flat  # noqa: E402
from misonet_tpu.ops.pallas.stencil_flat import (  # noqa: E402
    conv_down_flat,
    deconv_up_flat,
    enc0_down_flat,
    final_bin128,
    final_deconv_flat,
    interleave_up,
    s2d_flat,
)
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch.models import blocks as tb  # noqa: E402
from misonet_tpu_torch.models import make_miso1 as port_miso1  # noqa: E402
from misonet_tpu_torch.models.flat_dense import (  # noqa: E402
    DenseBlockFlat,
    from_bundle,
    merge_bundles,
)
from misonet_tpu_torch.ops.kernels.dense_stack import dense_stack  # noqa: E402
from misonet_tpu_torch.ops.kernels.flat_grad import (  # noqa: E402
    dense_stack_ad,
    stencil_ad,
)
from misonet_tpu_torch.ops.kernels.stencil import out_bins, stencil  # noqa: E402
from misonet_tpu_torch.utils.weights import (  # noqa: E402
    _conv1d,
    _conv2d,
    _deconv2d,
    load_jax_params,
)

TILE = 256
BF16 = torch.bfloat16
KERNEL_TOL = 1.6e-2   # bf16-stored outputs of one kernel call
STATS_TOL = 4e-3      # float32 statistics of one kernel call
MODEL_TOL = 4e-2      # plain modules / MISO1 (JAX's bf16 class)


def _err(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _close(out, ref, tol, corr=0.9999):
    assert _err(out, ref) <= tol, _err(out, ref)
    c = np.corrcoef(np.ravel(out).astype(np.float64),
                    np.ravel(ref).astype(np.float64))[0, 1]
    assert c > corr, c


def _bf16(x):
    """numpy float32 -> the bf16-rounded values as float32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16).float().numpy()


def _flat(x):  # NCHW numpy -> JAX bf16 flat layout
    return flatten_tf(jnp.asarray(x.transpose(0, 2, 3, 1)),
                      TILE).astype(jnp.bfloat16)


def _unflat(y, t, f):  # JAX flat layout -> NCHW float32 numpy
    y = unflatten_tf(y.astype(jnp.float32), t, f, TILE)
    return np.asarray(y).transpose(0, 3, 1, 2)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _dense_inputs(seed, b, t, f, widths, n, with_acc):
    rng = np.random.default_rng(seed)
    c = sum(widths)
    xs = [_bf16(rng.standard_normal((b, w, t, f)) + 0.5) for w in widths]
    acc = _bf16(rng.standard_normal((b, n, t, f))) if with_acc else None
    w = _bf16(0.2 * rng.standard_normal((n, c, 3, 3)))
    scale = rng.uniform(0.5, 1.5, (b, c)).astype(np.float32)
    mean = rng.uniform(-0.5, 1.0, (b, c)).astype(np.float32)
    return xs, acc, w, scale, mean


@pytest.mark.parametrize("widths,n,n_fin,with_acc", [
    ((8,), 24, 8, False),       # first call of an encoder block
    ((8,), 24, 8, True),        # middle call: partials in and out
    ((8, 8), 32, 8, False),     # decoder skip concat, two sources
    ((8, 8), 16, 16, True),     # last call: no partials out
])
def test_bf16_dense_stack_matches_pallas(widths, n, n_fin, with_acc):
    """(a) the plain bf16 mode of dense_stack against dense_stack_flat
    (precise=False), b = 2, t = 10, f = 7 (tests/test_dense_stack.py)."""
    b, t, f = 2, 10, 7
    xs, acc, w, scale, mean = _dense_inputs(1, b, t, f, widths, n, with_acc)
    bias = np.linspace(-0.3, 0.3, n_fin).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj, sj, qj, aj = dense_stack_flat(
            tuple(_flat(x) for x in xs), _flat(acc) if with_acc else None,
            jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(bias),
            jnp.asarray(scale), jnp.asarray(mean),
            t=t, f=f, n_fin=n_fin, tile_m=TILE, precise=False,
        )
    yt, st, qt, at = dense_stack(
        [_t(x, BF16) for x in xs], _t(acc, BF16) if with_acc else None,
        _t(w, BF16), _t(bias), _t(scale), _t(mean), n_fin)
    assert yt.dtype == BF16 and st.dtype == torch.float32
    _close(yt.float(), _unflat(yj, t, f), KERNEL_TOL)
    _close(st, np.asarray(sj)[..., 0], STATS_TOL)
    _close(qt, np.asarray(qj)[..., 0], STATS_TOL)
    if n > n_fin:
        assert at.dtype == BF16
        _close(at.float(), _unflat(aj, t, f), KERNEL_TOL)
    else:
        assert at is None and aj is None


def _stats(x):
    x = x.float()
    return (torch.rsqrt(x.var(dim=(2, 3), unbiased=False) + 1e-5),
            x.mean(dim=(2, 3)))


def _jax_dense_params(block, seed):
    """The JAX DenseBlockFlat params of the port ``block``'s weights."""
    rng = np.random.default_rng(seed)
    p = {}
    for i, conv in enumerate(block.convs):
        w = _bf16(0.3 * rng.standard_normal(tuple(conv.weight.shape)))
        bias = (0.1 * rng.standard_normal(conv.bias.shape)).astype(np.float32)
        conv.weight.data.copy_(torch.from_numpy(w))
        conv.bias.data.copy_(torch.from_numpy(bias))
        p[f"conv{i + 1}_kernel"] = jnp.asarray(w.transpose(2, 3, 1, 0))
        p[f"conv{i + 1}_bias"] = jnp.asarray(bias)
    return {"params": p}


def test_bf16_dense_block_flat_matches_pallas():
    """(a) DenseBlockFlat.flat (five stacked calls through the plain bf16
    mode) on a two-source bundle against JAX's DenseBlockFlat at
    precise=False."""
    b, t, f = 2, 10, 7
    rng = np.random.default_rng(5)
    xa = _bf16(rng.standard_normal((b, 8, t, f)) + 0.3)
    xb = _bf16(rng.standard_normal((b, 8, t, f)) - 0.2)
    block = DenseBlockFlat(16, 8, 16)
    params = _jax_dense_params(block, 6)
    ta, tb_ = _t(xa, BF16), _t(xb, BF16)
    sa, ma = _stats(ta)
    sb, mb = _stats(tb_)
    with torch.no_grad():
        y, sc, mn = block.flat(merge_bundles(((ta,), sa, ma),
                                             ((tb_,), sb, mb)))
        out = from_bundle((y, sc, mn))
    # raw bf16 tensors, float32 statistics (from float32 sums)
    assert out.dtype == y[0].dtype == BF16
    assert sc.dtype == mn.dtype == torch.float32

    bundles = [((_flat(x),), jnp.asarray(s.numpy()), jnp.asarray(m.numpy()))
               for x, s, m in ((xa, sa, ma), (xb, sb, mb))]
    def run(p, bundle):
        y = JaxDenseBlockFlat(8, 16).apply(p, bundle, t=t, f=f, tile_m=TILE,
                                           precise=False)
        return from_flat_bundle(y, t, f, jnp.float32, TILE)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(run)(params, jax_merge(*bundles))
    _close(out.float().numpy().transpose(0, 2, 3, 1), np.asarray(ref),
           KERNEL_TOL)


def _raw_with_stats(rng, b, c, t, f):
    """bf16-valued raw NCHW input and its IN statistics [B, C]."""
    x = _bf16(rng.standard_normal((b, c, t, f)) + 0.3)
    mean = x.mean((2, 3))
    scale = (1.0 / np.sqrt(x.var((2, 3)) + 1e-5)).astype(np.float32)
    return x, scale, mean


def _jax_stencil(mode, x, w, bias, scale, mean, t, f_in):
    """The JAX Pallas route of ``mode`` at precise=False -> (y NCHW f32,
    sums [B, N] or None, sqs or None); ``w`` HWIO ([kh, kw, I, O])."""
    xn = jnp.asarray(x.transpose(0, 2, 3, 1))
    w, bias = jnp.asarray(w), jnp.asarray(bias)
    f_out = out_bins(mode, f_in)
    with pltpu.force_tpu_interpret_mode():
        if mode == "enc0":
            y = enc0_down_flat(jnp.asarray(x), w, bias, t=t, tile_m=TILE)
            return _unflat(y, t, f_out), None, None
        sc, mn = jnp.asarray(scale), jnp.asarray(mean)
        xf = flatten_tf(xn, TILE).astype(jnp.bfloat16)
        if mode == "down":
            xe, xo = s2d_flat(xf, t, f_in, TILE, TILE)
            y, s, q = conv_down_flat(xe, xo, w, bias, sc, mn, t=t, f_in=f_in,
                                     tile_m=TILE)
            return _unflat(y, t, f_out), s[..., 0], q[..., 0]
        if mode == "up":
            y2, s, q = deconv_up_flat(xf, w, bias, sc, mn, t=t, f_in=f_in,
                                      tile_m=TILE)
            y, _, _ = interleave_up(y2, s, q, t, f_in, TILE, TILE)
            n = w.shape[-1]
            return (_unflat(y, t, f_out), s[:, :n, 0] + s[:, n:, 0],
                    q[:, :n, 0] + q[:, n:, 0])
        y = final_deconv_flat(xf, w, bias, sc, mn, t=t, f=f_in, tile_m=TILE)
        y128 = final_bin128(xf, w, bias, sc, mn, t=t, f=f_in, tile_m=TILE)
        # bins 0..F (the kernel's fp = F + 1 columns), then bin F + 1
        main = np.asarray(y.astype(jnp.float32))[:, :, TILE:TILE + t * (f_in + 1)]
        main = main.reshape(y.shape[0], -1, t, f_in + 1)
        return (np.concatenate([main, np.asarray(y128)[..., None]], axis=3),
                None, None)


@pytest.mark.parametrize("mode,b,t,f_in,c,n", [
    ("enc0", 2, 5, 129, 12, 8),
    ("down", 2, 12, 15, 8, 16),
    ("up", 2, 12, 7, 8, 16),
    ("final", 2, 5, 127, 8, 4),
])
def test_bf16_stencil_matches_pallas(mode, b, t, f_in, c, n):
    """(b) the plain bf16 mode of each stencil instance against its
    stencil_layer_flat route at precise=False (enc0_down_flat,
    conv_down_flat, deconv_up_flat + interleave_up, final_deconv_flat +
    final_bin128)."""
    rng = np.random.default_rng(3)
    x, scale, mean = _raw_with_stats(rng, b, c, t, f_in)
    w = _bf16(0.2 * rng.standard_normal((3, 3, c, n)))     # HWIO
    bias = (0.2 * rng.standard_normal(n)).astype(np.float32)
    yj, sj, qj = _jax_stencil(mode, x, w, bias, scale, mean, t, f_in)
    wt = w.transpose(2, 3, 0, 1) if mode in ("up", "final") else \
        w.transpose(3, 2, 0, 1)
    stats = ((None, None) if mode == "enc0"
             else (_t(scale), _t(mean)))
    yt, st, qt = stencil(_t(x, BF16), _t(wt, BF16), _t(bias), *stats, mode)
    assert yt.dtype == BF16
    _close(yt.float(), yj, KERNEL_TOL)
    if sj is not None:
        _close(st, np.asarray(sj), STATS_TOL)
        _close(qt, np.asarray(qj), STATS_TOL)


def _randomize(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray((0.3 * rng.standard_normal(p.shape))
                              .astype(np.float32)), params)


def _load(module, params, mapping):
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    module.load_state_dict(
        {key: torch.from_numpy(np.array(conv(flat[p])))
         for p, (key, conv) in mapping.items()}, strict=True)


def _same(w):
    return w


def _dense_map():
    m = {}
    for i in range(1, 6):
        m[f"conv{i}_kernel"] = (f"convs.{i - 1}.weight", _conv2d)
        m[f"conv{i}_bias"] = (f"convs.{i - 1}.bias", _same)
    return m


def _dsconv_map(prefix, key):
    return {
        f"{prefix}depthwise/kernel": (f"{key}depthwise.weight", _conv1d),
        f"{prefix}pointwise/kernel": (f"{key}pointwise.weight", _conv1d),
        f"{prefix}PReLU_0/alpha": (f"{key}prelu.alpha", _same),
        f"{prefix}GlobalLayerNorm_0/gamma": (f"{key}norm.gamma", _same),
        f"{prefix}GlobalLayerNorm_0/beta": (f"{key}norm.beta", _same),
    }


BLOCKS = {
    "conv_block": (lambda d: jb.ConvBlock(8, strides=(1, 2), dtype=d),
                   lambda: tb.ConvBlock(4, 8, stride=(1, 2)),
                   {"Conv_0/kernel": ("conv.weight", _conv2d),
                    "Conv_0/bias": ("conv.bias", _same)}, (2, 6, 15, 4)),
    "deconv_block": (lambda d: jb.DeconvBlock(6, strides=(1, 2), dtype=d),
                     lambda: tb.DeconvBlock(8, 6),
                     {"ConvTranspose2dTorch_0/kernel":
                      ("deconv.weight", _deconv2d),
                      "ConvTranspose2dTorch_0/bias": ("deconv.bias", _same)},
                     (2, 6, 7, 8)),
    "dense_block": (lambda d: jb.DenseBlock(4, 8, dtype=d),
                    lambda: tb.DenseBlock(8, 4, 8), _dense_map(),
                    (2, 6, 7, 8)),
    "temporal_block": (
        lambda d: jb.TemporalBlock(6, dilation=2, norm_type="gLN", dtype=d),
        lambda: tb.TemporalBlock(6, 2, "gLN"),
        {**_dsconv_map("DepthwiseSeparableConv_0/", "dsconv1."),
         **_dsconv_map("DepthwiseSeparableConv_1/", "dsconv2."),
         "GlobalLayerNorm_0/gamma": ("norm1.gamma", _same),
         "GlobalLayerNorm_0/beta": ("norm1.beta", _same),
         "GlobalLayerNorm_1/gamma": ("norm2.gamma", _same),
         "GlobalLayerNorm_1/beta": ("norm2.beta", _same)},
        (2, 13, 6)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_bf16_plain_blocks_match_jax(name):
    """(d) the plain modules in bf16 (input bf16, float32 parameters cast at
    use, float32 norm statistics) against the JAX modules at
    dtype=bfloat16."""
    jmake, tmake, mapping, shape = BLOCKS[name]
    x = _bf16(np.random.default_rng(2).standard_normal(shape))
    jmod = jmake(jnp.bfloat16)
    params = _randomize(
        jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(x)), 4)
    ref = np.asarray(jax.jit(jmod.apply)(
        params, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    tmod = tmake()
    _load(tmod, params["params"], mapping)
    perm = (0, 3, 1, 2) if len(shape) == 4 else (0, 2, 1)
    inv = (0, 2, 3, 1) if len(shape) == 4 else (0, 2, 1)
    with torch.no_grad():
        out = tmod(_t(x.transpose(perm), BF16))
    assert out.dtype == BF16
    _close(out.float().numpy().transpose(inv), ref, MODEL_TOL, corr=0.999)


def test_bf16_miso1_matches_jax():
    """(d) the port's plain MISO1 at compute_dtype="bfloat16" against JAX's
    plain bf16 MISO1 at a narrow 7-level plan, through the weight bridge;
    the output is complex64 on both sides."""
    cfg = ModelConfig(
        en_channels=(8, 8, 8, 8, 8, 16, 16),
        de_channels=(16, 16, 8, 8, 8, 8, 8),
        tcn_repeats=1, tcn_blocks=3, tcn_channels=16,
        compute_dtype="bfloat16", flat_dense=False,
    )
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((1, 6, 8, 129))
           + 1j * rng.standard_normal((1, 6, 8, 129))).astype(np.complex64)
    jmodel = jax_miso1(cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(mix))
    prng = np.random.default_rng(1)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 0
        std = 1.0 / np.sqrt(fan_in) if fan_in > 1 else 0.1
        return jnp.asarray((std * prng.standard_normal(s.shape))
                           .astype(np.float32))

    params = jax.tree.map(draw, shapes)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(mix)))
    model = load_jax_params(
        port_miso1(tcfg.ModelConfig(**dataclasses.asdict(cfg)),
                   device="cpu"), params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.from_numpy(mix)).numpy()
    assert out.dtype == np.complex64 and ref.dtype == np.complex64
    _close(out.view(np.float32), ref.view(np.float32), MODEL_TOL, corr=0.999)


def test_bf16_fused_path_refuses_autograd():
    """(e) the fused kernels refused bf16 under autograd until the bf16 mode
    of stencil_bwd came (tests/test_torch_stencil_bwd_bf16.py holds it to
    JAX); a bf16 call under autograd now runs the bf16 backward: bf16
    source gradients, float32 weight gradients (the float32 parameter cast
    inside the Function), and the same forward as without autograd."""
    x = torch.ones(1, 8, 4, 7, dtype=BF16, requires_grad=True)
    w = torch.full((8, 8, 3, 3), 0.1, requires_grad=True)
    s = torch.ones(1, 8)
    y, _, _, _ = dense_stack_ad([x], None, w, torch.zeros(8), s, s * 0, 8)
    z, _, _ = stencil_ad(x, w, torch.zeros(8), s, s * 0, "down")
    (y.float().sum() + z.float().sum()).backward()
    assert x.grad.dtype == BF16 and w.grad.dtype == torch.float32
    assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0
    with torch.no_grad():  # the same calls without autograd
        y0, _, _, _ = dense_stack_ad([x], None, w, torch.zeros(8), s, s * 0,
                                     8)
    assert y.dtype == y0.dtype == BF16 and torch.equal(y, y0)


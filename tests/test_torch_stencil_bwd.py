"""PyTorch port, kernel 3 (ops/kernels/stencil_bwd.py) through the autograd
Functions of ops/kernels/flat_grad.py, on the CPU (plain versions).

1. Per op, against the JAX package's differentiable fused ops
   (``dense_stack_flat_ad``, ``conv_down_flat_ad``, ``deconv_up_flat_ad``,
   ``enc0_down_flat_ad``, ``final_deconv_flat_ad``) run under
   ``pltpu.force_tpu_interpret_mode()`` with ``precise=True``, at the tiny
   geometry of tests/test_stencil_bwd.py and tests/test_stencil_flat.py:
   the same numpy inputs and cotangents (on the outputs and on the fused
   statistics) give the same input, weight, bias, scale and mean
   gradients.  The JAX ops take the lane-flattened layout, so each JAX loss
   flattens NHWC inputs and unflattens outputs; the gradients come back in
   NHWC and HWIO and are transposed to the port's NCHW / OIHW.
2. The fused modules (DenseBlockFlat, TrunkDownFlat, DeconvUpFlat,
   Enc0Flat, FinalDeconvFlat) against their plain modules under autograd,
   as tests/test_flat_grad.py does for the JAX package.

The CUDA kernel is held to the plain version in tests/test_torch_cuda.py
and chip_smoke.py.

Tolerance: float32 throughout; the Pallas backward folds the mean into
validity fields and sums in another order.  Bound 1e-5 of each gradient's
max-abs; 1e-4 for the DenseBlock, whose five chained calls and statistics
compound the rounding."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from misonet_tpu.ops.pallas.conv_flat import flatten_tf, unflatten_tf  # noqa: E402
from misonet_tpu.ops.pallas.dense_stack import dense_stack_flat_ad  # noqa: E402
from misonet_tpu.ops.pallas.flat_grad import (  # noqa: E402
    conv_down_flat_ad,
    deconv_up_flat_ad,
    enc0_down_flat_ad,
    final_deconv_flat_ad,
)
from misonet_tpu.ops.pallas.stencil_flat import interleave_up, s2d_flat  # noqa: E402
from misonet_tpu_torch.models.blocks import (  # noqa: E402
    ConvBlock,
    ConvTranspose2dTorch,
    DeconvBlock,
    DenseBlock,
    InstanceNorm,
    init_parameters,
)
from misonet_tpu_torch.models.flat_dense import (  # noqa: E402
    DeconvUpFlat,
    DenseBlockFlat,
    Enc0Flat,
    FinalDeconvFlat,
    TrunkDownFlat,
    from_bundle,
    merge_bundles,
)
from misonet_tpu_torch.ops.kernels.flat_grad import (  # noqa: E402
    dense_stack_ad,
    stencil_ad,
)
from misonet_tpu_torch.ops.kernels.stencil import out_bins  # noqa: E402
from misonet_tpu_torch.ops.kernels.stencil_bwd import (  # noqa: E402
    stencil_bwd,
    stencil_bwd_plain,
)
from misonet_tpu_torch.ops.stats import stats_to_scale_mean  # noqa: E402

ATOL = 1e-5
TILE = 256


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _nchw(g):
    return np.asarray(g).transpose(0, 3, 1, 2)


def _leaf(x):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()


def _stats(rng, b, c):
    return (rng.uniform(0.5, 1.5, (b, c)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (b, c)).astype(np.float32))


# ---------------------------------------------------------------------------
# 1. the port's Functions against the JAX fused ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("widths,n,n_fin,with_acc", [
    ((8,), 24, 8, False),       # first call of a block
    ((8,), 24, 8, True),        # middle call: partials in and out
    ((8, 8), 32, 8, False),     # decoder skip concat, two sources
    ((8, 8), 16, 16, True),     # last call: n_fin == N, two sources
    ((8,), 16, 16, False),      # n_fin == N, no partials at all
])
def test_dense_grads_match_jax(widths, n, n_fin, with_acc):
    b, t, f = 2, 10, 7
    rng = np.random.default_rng(11)
    c = sum(widths)
    xs = [rng.standard_normal((b, w, t, f)).astype(np.float32) + 0.5
          for w in widths]
    acc = rng.standard_normal((b, n, t, f)).astype(np.float32)
    w = (0.2 * rng.standard_normal((n, c, 3, 3))).astype(np.float32)
    bias = (0.2 * rng.standard_normal(n_fin)).astype(np.float32)
    scale, mean = _stats(rng, b, c)
    cy = rng.standard_normal((b, n_fin, t, f)).astype(np.float32)
    cs = rng.standard_normal((b, n_fin)).astype(np.float32)
    cq = (0.1 * rng.standard_normal((b, n_fin))).astype(np.float32)
    ca = rng.standard_normal((b, n - n_fin, t, f)).astype(np.float32)

    def jloss(xs_, acc_, w_, bias_, scale_, mean_):
        y, s, q, acc_out = dense_stack_flat_ad(
            tuple(flatten_tf(x, TILE) for x in xs_),
            flatten_tf(acc_, TILE) if with_acc else None, w_, bias_, scale_,
            mean_, t=t, f=f, n_fin=n_fin, tile_m=TILE, precise=True)
        loss = (jnp.sum(unflatten_tf(y, t, f, TILE) * _nhwc(cy))
                + jnp.sum(s[..., 0] * cs) + jnp.sum(q[..., 0] * cq))
        if acc_out is not None:
            loss += jnp.sum(unflatten_tf(acc_out, t, f, TILE) * _nhwc(ca))
        return loss

    args = ([_nhwc(x) for x in xs], _nhwc(acc),
            jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(bias),
            jnp.asarray(scale), jnp.asarray(mean))
    with pltpu.force_tpu_interpret_mode():
        gx, gacc, gw, gb, gs, gm = jax.grad(jloss, argnums=tuple(range(6)))(
            *args)

    txs = [_leaf(x) for x in xs]
    tacc = _leaf(acc) if with_acc else None
    tw, tb, ts, tm = _leaf(w), _leaf(bias), _leaf(scale), _leaf(mean)
    y, s, q, acc_out = dense_stack_ad(txs, tacc, tw, tb, ts, tm, n_fin)
    loss = ((y * torch.from_numpy(cy)).sum() + (s * torch.from_numpy(cs)).sum()
            + (q * torch.from_numpy(cq)).sum())
    if acc_out is not None:
        loss = loss + (acc_out * torch.from_numpy(ca)).sum()
    loss.backward()

    for tx, jx in zip(txs, gx):
        _close(tx.grad.numpy(), _nchw(jx))
    if with_acc:
        _close(tacc.grad.numpy(), _nchw(gacc))
    _close(tw.grad.numpy(), np.asarray(gw).transpose(3, 2, 0, 1))
    _close(tb.grad.numpy(), np.asarray(gb))
    _close(ts.grad.numpy(), np.asarray(gs))
    _close(tm.grad.numpy(), np.asarray(gm))


def test_down_grads_match_jax():
    b, t, f_in, c, n = 2, 12, 15, 8, 16
    f_out = out_bins("down", f_in)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((b, c, t, f_in)).astype(np.float32) + 0.3
    w = (0.2 * rng.standard_normal((n, c, 3, 3))).astype(np.float32)
    bias = (0.2 * rng.standard_normal(n)).astype(np.float32)
    scale, mean = _stats(rng, b, c)
    cy = rng.standard_normal((b, n, t, f_out)).astype(np.float32)
    cs = rng.standard_normal((b, n)).astype(np.float32)
    cq = (0.1 * rng.standard_normal((b, n))).astype(np.float32)

    def jloss(x_, w_, bias_, scale_, mean_):
        xe, xo = s2d_flat(flatten_tf(x_, TILE), t, f_in, TILE, TILE)
        y, s, q = conv_down_flat_ad(xe, xo, w_, bias_, scale_, mean_, t=t,
                                    f_in=f_in, tile_m=TILE, precise=True)
        return (jnp.sum(unflatten_tf(y, t, f_out, TILE) * _nhwc(cy))
                + jnp.sum(s[..., 0] * cs) + jnp.sum(q[..., 0] * cq))

    with pltpu.force_tpu_interpret_mode():
        gx, gw, gb, gs, gm = jax.grad(jloss, argnums=tuple(range(5)))(
            _nhwc(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
            jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(mean))

    tx, tw, tb, ts, tm = map(_leaf, (x, w, bias, scale, mean))
    y, s, q = stencil_ad(tx, tw, tb, ts, tm, "down")
    ((y * torch.from_numpy(cy)).sum() + (s * torch.from_numpy(cs)).sum()
     + (q * torch.from_numpy(cq)).sum()).backward()
    _close(tx.grad.numpy(), _nchw(gx))
    _close(tw.grad.numpy(), np.asarray(gw).transpose(3, 2, 0, 1))
    _close(tb.grad.numpy(), np.asarray(gb))
    _close(ts.grad.numpy(), np.asarray(gs))
    _close(tm.grad.numpy(), np.asarray(gm))


def test_up_grads_match_jax():
    """The cotangents sit on the interleaved output and its (scale, mean),
    the form in which interleave_up hands them on."""
    b, t, f_in, c, n = 2, 12, 7, 8, 16
    f_out = out_bins("up", f_in)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((b, c, t, f_in)).astype(np.float32) + 0.3
    w = (0.2 * rng.standard_normal((c, n, 3, 3))).astype(np.float32)
    bias = (0.2 * rng.standard_normal(n)).astype(np.float32)
    scale, mean = _stats(rng, b, c)
    cy = rng.standard_normal((b, n, t, f_out)).astype(np.float32)
    csc = rng.standard_normal((b, n)).astype(np.float32)
    cmn = rng.standard_normal((b, n)).astype(np.float32)

    def jloss(x_, w_, bias_, scale_, mean_):
        y2, su, sq = deconv_up_flat_ad(flatten_tf(x_, TILE), w_, bias_,
                                       scale_, mean_, t=t, f_in=f_in,
                                       tile_m=TILE, precise=True)
        y, sc, mn = interleave_up(y2, su, sq, t, f_in, TILE, TILE)
        return (jnp.sum(unflatten_tf(y, t, f_out, TILE) * _nhwc(cy))
                + jnp.sum(sc * csc) + jnp.sum(mn * cmn))

    with pltpu.force_tpu_interpret_mode():
        gx, gw, gb, gs, gm = jax.grad(jloss, argnums=tuple(range(5)))(
            _nhwc(x), jnp.asarray(w.transpose(2, 3, 0, 1)),
            jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(mean))

    tx, tw, tb, ts, tm = map(_leaf, (x, w, bias, scale, mean))
    y, s, q = stencil_ad(tx, tw, tb, ts, tm, "up")
    sc, mn = stats_to_scale_mean(s, q, t * f_out)
    ((y * torch.from_numpy(cy)).sum() + (sc * torch.from_numpy(csc)).sum()
     + (mn * torch.from_numpy(cmn)).sum()).backward()
    _close(tx.grad.numpy(), _nchw(gx))
    _close(tw.grad.numpy(), np.asarray(gw).transpose(2, 3, 0, 1))
    _close(tb.grad.numpy(), np.asarray(gb))
    _close(ts.grad.numpy(), np.asarray(gs))
    _close(tm.grad.numpy(), np.asarray(gm))


def test_enc0_grads_match_jax():
    b, t, f_full, c, n = 2, 6, 17, 12, 8
    f_out = out_bins("enc0", f_full)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((b, c, t, f_full)).astype(np.float32)
    w = (0.2 * rng.standard_normal((n, c, 3, 3))).astype(np.float32)
    bias = (0.2 * rng.standard_normal(n)).astype(np.float32)
    cy = rng.standard_normal((b, n, t, f_out)).astype(np.float32)

    def jloss(x_, w_, bias_):
        y = enc0_down_flat_ad(x_, w_, bias_, t=t, tile_m=TILE, precise=True)
        return jnp.sum(unflatten_tf(y, t, f_out, TILE) * _nhwc(cy))

    with pltpu.force_tpu_interpret_mode():
        gx, gw, gb = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
            jnp.asarray(bias))

    tx, tw, tb = map(_leaf, (x, w, bias))
    y, s, q = stencil_ad(tx, tw, tb, None, None, "enc0")
    assert s is None and q is None
    (y * torch.from_numpy(cy)).sum().backward()
    _close(tx.grad.numpy(), np.asarray(gx))
    _close(tw.grad.numpy(), np.asarray(gw).transpose(3, 2, 0, 1))
    _close(tb.grad.numpy(), np.asarray(gb))


def test_final_grads_match_jax():
    b, t, f, c, n = 2, 6, 15, 16, 8
    rng = np.random.default_rng(15)
    x = rng.standard_normal((b, c, t, f)).astype(np.float32) + 0.3
    w = (0.2 * rng.standard_normal((c, n, 3, 3))).astype(np.float32)
    bias = (0.2 * rng.standard_normal(n)).astype(np.float32)
    scale, mean = _stats(rng, b, c)
    cy = rng.standard_normal((b, n, t, f + 2)).astype(np.float32)

    def jloss(x_, w_, bias_, scale_, mean_):
        y, y_last = final_deconv_flat_ad(
            flatten_tf(x_, TILE), w_, bias_, scale_, mean_, t=t, f=f,
            tile_m=TILE, precise=True)
        y = y[:, :, TILE:TILE + t * (f + 1)].reshape(b, n, t, f + 1)
        out = jnp.concatenate([y, y_last[..., None]], axis=-1)
        return jnp.sum(out * jnp.asarray(cy))

    with pltpu.force_tpu_interpret_mode():
        gx, gw, gb, gs, gm = jax.grad(jloss, argnums=tuple(range(5)))(
            _nhwc(x), jnp.asarray(w.transpose(2, 3, 0, 1)),
            jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(mean))

    tx, tw, tb, ts, tm = map(_leaf, (x, w, bias, scale, mean))
    y, _, _ = stencil_ad(tx, tw, tb, ts, tm, "final")
    (y * torch.from_numpy(cy)).sum().backward()
    _close(tx.grad.numpy(), _nchw(gx))
    _close(tw.grad.numpy(), np.asarray(gw).transpose(2, 3, 0, 1))
    _close(tb.grad.numpy(), np.asarray(gb))
    _close(ts.grad.numpy(), np.asarray(gs))
    _close(tm.grad.numpy(), np.asarray(gm))


def test_wrapper_arguments_are_checked():
    g = torch.zeros(1, 4, 3, 9)
    x = torch.zeros(1, 2, 3, 9)
    w = torch.zeros(4, 2, 3, 3)
    with pytest.raises(ValueError, match="unknown mode"):
        stencil_bwd(g, (x,), w, None, None, "sideways")
    with pytest.raises(ValueError, match="scale/mean"):
        stencil_bwd(g, (x,), w, None, None, "dense")
    with pytest.raises(ValueError, match="1 source"):
        stencil_bwd(g, (x, x), w, torch.ones(1, 4), torch.zeros(1, 4), "down")


def test_no_dx_skips_the_dgrad():
    """enc0 in the train step: weight and bias gradients only."""
    rng = np.random.default_rng(16)
    g = torch.from_numpy(rng.standard_normal((2, 4, 5, 7)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
    full = stencil_bwd_plain(g, (x,), w, None, None, "enc0")
    dxs, dw, dbias, dscale, dmean = stencil_bwd(g, (x,), w, None, None, "enc0",
                                                need_dx=False)
    assert dxs is None and dscale is None and dmean is None
    _close(dw.numpy(), full[1].numpy())
    _close(dbias.numpy(), full[2].numpy())


# ---------------------------------------------------------------------------
# 2. fused modules against their plain modules under autograd
# ---------------------------------------------------------------------------


def _in_stats(x):
    """1/sigma and mean of an InstanceNorm over (T, F), differentiable."""
    mean = x.mean(dim=(2, 3))
    var = x.var(dim=(2, 3), unbiased=False)
    return torch.rsqrt(var + 1e-5), mean


def _seeded(module, seed):
    init_parameters(module, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.2, 0.2)
    return module


def _grads(module, *xs):
    return [p.grad.clone() for p in module.parameters()] + [
        x.grad.clone() for x in xs]


def _compare_paths(module, xs, fused_loss, plain_loss, atol):
    fused_loss().backward()
    fused = _grads(module, *xs)
    module.zero_grad()
    for x in xs:
        x.grad = None
    plain_loss().backward()
    for got, want in zip(fused, _grads(module, *xs)):
        _close(got.numpy(), want.numpy(), atol)


def test_dense_block_flat_grads_match_plain():
    b, t, f = 2, 6, 9
    rng = np.random.default_rng(21)
    xa = _leaf(rng.standard_normal((b, 8, t, f)).astype(np.float32))
    xb = _leaf(rng.standard_normal((b, 8, t, f)).astype(np.float32) + 0.5)
    probe = torch.from_numpy(rng.standard_normal((b, 16, t, f))
                             .astype(np.float32))
    block = _seeded(DenseBlockFlat(16, 8, 16), 0)

    def fused():
        bundle = merge_bundles(((xa,), *_in_stats(xa)),
                               ((xb,), *_in_stats(xb)))
        return (from_bundle(block.flat(bundle)) * probe).sum()

    def plain():
        norm = InstanceNorm()
        xn = torch.cat([norm(xa), norm(xb)], dim=1)
        return (DenseBlock.forward(block, xn) * probe).sum()

    _compare_paths(block, (xa, xb), fused, plain, 1e-4)


def test_trunk_down_flat_grads_match_convblock():
    b, t, f_in, c, n = 2, 12, 15, 8, 16
    rng = np.random.default_rng(22)
    x = _leaf(rng.standard_normal((b, c, t, f_in)).astype(np.float32))
    probe = torch.from_numpy(rng.standard_normal(
        (b, n, t, out_bins("down", f_in))).astype(np.float32))
    mod = _seeded(TrunkDownFlat(c, n, stride=(1, 2)), 1)
    _compare_paths(
        mod, (x,),
        lambda: (from_bundle(mod.flat(((x,), *_in_stats(x)))) * probe).sum(),
        lambda: (ConvBlock.forward(mod, InstanceNorm()(x)) * probe).sum(),
        ATOL)


def test_deconv_up_flat_grads_match_deconvblock():
    b, t, f_in, c, n = 2, 12, 7, 8, 16
    rng = np.random.default_rng(23)
    x = _leaf(rng.standard_normal((b, c, t, f_in)).astype(np.float32))
    probe = torch.from_numpy(rng.standard_normal(
        (b, n, t, out_bins("up", f_in))).astype(np.float32))
    mod = _seeded(DeconvUpFlat(c, n, stride=(1, 2)), 2)
    _compare_paths(
        mod, (x,),
        lambda: (from_bundle(mod.flat(((x,), *_in_stats(x)))) * probe).sum(),
        lambda: (DeconvBlock.forward(mod, InstanceNorm()(x)) * probe).sum(),
        ATOL)


def test_enc0_flat_grads_match_convblock():
    b, t, f, c, n = 2, 7, 17, 12, 8
    rng = np.random.default_rng(24)
    x = _leaf(rng.standard_normal((b, c, t, f)).astype(np.float32))
    probe = torch.from_numpy(rng.standard_normal((b, n, t, f - 2))
                             .astype(np.float32))
    mod = _seeded(Enc0Flat(c, n, act_norm=False), 3)
    _compare_paths(
        mod, (x,),
        lambda: (from_bundle(mod.flat(x)) * probe).sum(),
        lambda: (ConvBlock.forward(mod, x) * probe).sum(),
        ATOL)


def test_final_deconv_flat_grads_match_conv_transpose():
    b, t, f, c, n = 2, 7, 15, 12, 4
    rng = np.random.default_rng(25)
    x = _leaf(rng.standard_normal((b, c, t, f)).astype(np.float32) + 0.2)
    probe = torch.from_numpy(rng.standard_normal((b, n, t, f + 2))
                             .astype(np.float32))
    mod = _seeded(FinalDeconvFlat(c, n, stride=(1, 1)), 4)
    _compare_paths(
        mod, (x,),
        lambda: (mod.flat(((x,), *_in_stats(x))) * probe).sum(),
        lambda: (ConvTranspose2dTorch.forward(mod, InstanceNorm()(x))
                 * probe).sum(),
        ATOL)

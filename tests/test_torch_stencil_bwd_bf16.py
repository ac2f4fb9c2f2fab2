"""PyTorch port, the bfloat16 mode of kernel 3 (ops/kernels/stencil_bwd.py)
through the autograd Functions of ops/kernels/flat_grad.py, on the CPU
(plain versions), against the JAX package's differentiable fused ops at
``precise=False`` (``dense_stack_flat_ad``, ``conv_down_flat_ad``,
``deconv_up_flat_ad``, ``enc0_down_flat_ad``, ``final_deconv_flat_ad``)
under ``pltpu.force_tpu_interpret_mode()``, in every mode: dense with 1 or 2
sources, with and without ``acc_in``, down, up, enc0 and final.

Inputs, weights and cotangents come from a numpy seed and are rounded to
bfloat16 once; the sources and ``acc_in`` are bfloat16 on both sides, the
parameters float32 holding those values.  Three gradients of each input:
the port's bf16 path, JAX's bf16 path, and JAX's ``precise=True`` path on
the same values (the reference).

The two bf16 paths round at different points: the port's forward and
wgrad use the centred ``bf16((x - mean) * scale)`` where the TPU kernel
uses ``bf16(scale * x)`` and corrects the mean in float32.  So the port is
not held to JAX's bf16 rounding but to JAX's bf16 error class: each port
gradient's max-abs error against the reference, over the reference's
max-abs, is at most max(FLOOR, 2x JAX bf16's own error there).  FLOOR =
1e-2 (two bf16 ulps) covers gradients that JAX's bf16 path happens to get
almost exactly.  The cotangent of ``acc_in`` is bfloat16 (the TPU kernel's
``dacc``), those of the float32 parameters float32.
"""

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
from misonet_tpu_torch.ops.kernels.flat_grad import (  # noqa: E402
    dense_stack_ad,
    stencil_ad,
)
from misonet_tpu_torch.ops.kernels.stencil import out_bins  # noqa: E402
from misonet_tpu_torch.ops.stats import stats_to_scale_mean  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLOOR = 1e-2
TILE = 256
BF16 = torch.bfloat16


def _bf16(x):
    """numpy -> the bf16-rounded values as float32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        BF16).float().numpy()


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _nchw(g):
    return np.asarray(g, np.float32).transpose(0, 3, 1, 2)


def _leaf(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        dtype).requires_grad_()


def _stats(rng, b, c):
    return (rng.uniform(0.5, 1.5, (b, c)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (b, c)).astype(np.float32))


def _err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _check(names, port, jax_bf16, jax_f32):
    """Each port gradient within max(FLOOR, 2x JAX bf16's error) of the
    precise reference."""
    for name, p, j, r in zip(names, port, jax_bf16, jax_f32):
        e_port, e_jax = _err(p, r), _err(j, r)
        assert e_port <= max(FLOOR, 2 * e_jax), (name, e_port, e_jax)


def _jax_grads(jloss, args, precise):
    with pltpu.force_tpu_interpret_mode():
        return jax.grad(lambda *a: jloss(*a, precise=precise),
                        argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize("widths,n,n_fin,with_acc", [
    ((8,), 24, 8, False),       # first call of a block
    ((8,), 24, 8, True),        # middle call: partials in and out
    ((8, 8), 32, 8, False),     # decoder skip concat, two sources
    ((8, 8), 16, 16, True),     # last call: n_fin == N, two sources
])
def test_dense_bf16_grads_within_jax_class(widths, n, n_fin, with_acc):
    b, t, f = 2, 10, 7
    rng = np.random.default_rng(31)
    c = sum(widths)
    xs = [_bf16(rng.standard_normal((b, w, t, f)) + 0.5) for w in widths]
    acc = _bf16(rng.standard_normal((b, n, t, f)))
    w = _bf16(0.2 * rng.standard_normal((n, c, 3, 3)))
    bias = (0.2 * rng.standard_normal(n_fin)).astype(np.float32)
    scale, mean = _stats(rng, b, c)
    cy = _bf16(rng.standard_normal((b, n_fin, t, f)))
    cs = rng.standard_normal((b, n_fin)).astype(np.float32)
    cq = (0.1 * rng.standard_normal((b, n_fin))).astype(np.float32)
    ca = _bf16(rng.standard_normal((b, n - n_fin, t, f)))

    def jloss(xs_, acc_, w_, bias_, scale_, mean_, precise):
        dt = jnp.float32 if precise else jnp.bfloat16
        y, s, q, acc_out = dense_stack_flat_ad(
            tuple(flatten_tf(x, TILE).astype(dt) for x in xs_),
            flatten_tf(acc_, TILE).astype(dt) if with_acc else None, w_,
            bias_, scale_, mean_, t=t, f=f, n_fin=n_fin, tile_m=TILE,
            precise=precise)
        loss = (jnp.sum(unflatten_tf(y.astype(jnp.float32), t, f, TILE)
                        * _nhwc(cy))
                + jnp.sum(s[..., 0] * cs) + jnp.sum(q[..., 0] * cq))
        if acc_out is not None:
            loss += jnp.sum(unflatten_tf(acc_out.astype(jnp.float32), t, f,
                                         TILE) * _nhwc(ca))
        return loss

    args = ([_nhwc(x) for x in xs], _nhwc(acc),
            jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(bias),
            jnp.asarray(scale), jnp.asarray(mean))
    jax_grads = [_jax_grads(jloss, args, p) for p in (False, True)]

    txs = [_leaf(x, BF16) for x in xs]
    tacc = _leaf(acc, BF16) if with_acc else None
    tw, tb, ts, tm = _leaf(w), _leaf(bias), _leaf(scale), _leaf(mean)
    y, s, q, acc_out = dense_stack_ad(txs, tacc, tw, tb, ts, tm, n_fin)
    assert y.dtype == BF16
    loss = ((y.float() * torch.from_numpy(cy)).sum()
            + (s * torch.from_numpy(cs)).sum()
            + (q * torch.from_numpy(cq)).sum())
    if acc_out is not None:
        assert acc_out.dtype == BF16
        loss = loss + (acc_out.float() * torch.from_numpy(ca)).sum()
    loss.backward()
    assert all(tx.grad.dtype == BF16 for tx in txs)
    assert tw.grad.dtype == tb.grad.dtype == ts.grad.dtype == torch.float32

    def jax_side(g):
        gx, gacc, gw, gb, gs, gm = g
        out = [_nchw(jx) for jx in gx]
        if with_acc:
            out.append(_nchw(gacc))
        return out + [np.asarray(gw).transpose(3, 2, 0, 1), np.asarray(gb),
                      np.asarray(gs), np.asarray(gm)]

    port = [tx.grad.float().numpy() for tx in txs]
    names = [f"x{i}" for i in range(len(txs))]
    if with_acc:
        assert tacc.grad.dtype == BF16   # dacc: the bf16 masked g
        port.append(tacc.grad.float().numpy())
        names.append("acc_in")
    port += [tw.grad.numpy(), tb.grad.numpy(), ts.grad.numpy(),
             tm.grad.numpy()]
    names += ["w", "bias", "scale", "mean"]
    _check(names, port, *map(jax_side, jax_grads))


def _stencil_case(mode, rng, b, c, n, t, f_in):
    x = _bf16(rng.standard_normal((b, c, t, f_in)) + 0.3)
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
    w = _bf16(0.2 * rng.standard_normal(wshape))
    bias = (0.2 * rng.standard_normal(n)).astype(np.float32)
    return x, w, bias


def _jw(mode, w):
    """Port weight layout -> JAX HWIO."""
    return jnp.asarray(w.transpose(2, 3, 0, 1) if mode in ("up", "final")
                       else w.transpose(2, 3, 1, 0))


def _pw(mode, g):
    """JAX HWIO weight gradient -> port layout."""
    g = np.asarray(g)
    return g.transpose(2, 3, 0, 1) if mode in ("up", "final") else \
        g.transpose(3, 2, 0, 1)


@pytest.mark.parametrize("mode,b,t,f_in,c,n", [
    ("down", 2, 12, 15, 8, 16),
    ("up", 2, 12, 7, 8, 16),
    ("enc0", 2, 6, 17, 12, 8),
    ("final", 2, 6, 15, 16, 8),
])
def test_stencil_bf16_grads_within_jax_class(mode, b, t, f_in, c, n):
    """down / up with cotangents on the output and its fused statistics
    (up: on the interleaved output's scale and mean, the form interleave_up
    hands on), enc0 and final on the output."""
    rng = np.random.default_rng(32)
    x, w, bias = _stencil_case(mode, rng, b, c, n, t, f_in)
    scale, mean = _stats(rng, b, c)
    f_out = out_bins(mode, f_in)
    cy = _bf16(rng.standard_normal((b, n, t, f_out)))
    c1 = rng.standard_normal((b, n)).astype(np.float32)
    c2 = (0.1 * rng.standard_normal((b, n))).astype(np.float32)

    def jloss(x_, w_, bias_, scale_, mean_, precise):
        dt = jnp.float32 if precise else jnp.bfloat16
        kw = dict(tile_m=TILE, precise=precise)
        if mode == "down":
            xe, xo = s2d_flat(flatten_tf(x_, TILE).astype(dt), t, f_in, TILE,
                              TILE)
            y, s, q = conv_down_flat_ad(xe, xo, w_, bias_, scale_, mean_,
                                        t=t, f_in=f_in, **kw)
            return (jnp.sum(unflatten_tf(y.astype(jnp.float32), t, f_out,
                                         TILE) * _nhwc(cy))
                    + jnp.sum(s[..., 0] * c1) + jnp.sum(q[..., 0] * c2))
        if mode == "up":
            y2, su, sq = deconv_up_flat_ad(
                flatten_tf(x_, TILE).astype(dt), w_, bias_, scale_, mean_,
                t=t, f_in=f_in, **kw)
            y, sc, mn = interleave_up(y2, su, sq, t, f_in, TILE, TILE)
            return (jnp.sum(unflatten_tf(y.astype(jnp.float32), t, f_out,
                                         TILE) * _nhwc(cy))
                    + jnp.sum(sc * c1) + jnp.sum(mn * c2))
        if mode == "enc0":
            y = enc0_down_flat_ad(x_.astype(dt), w_, bias_, t=t, **kw)
            return jnp.sum(unflatten_tf(y.astype(jnp.float32), t, f_out,
                                        TILE) * _nhwc(cy))
        y, y_last = final_deconv_flat_ad(
            flatten_tf(x_, TILE).astype(dt), w_, bias_, scale_, mean_, t=t,
            f=f_in, **kw)
        y = y.astype(jnp.float32)[:, :, TILE:TILE + t * (f_in + 1)]
        y = y.reshape(b, n, t, f_in + 1)
        out = jnp.concatenate([y, y_last.astype(jnp.float32)[..., None]],
                              axis=-1)
        return jnp.sum(out * jnp.asarray(cy))

    xj = jnp.asarray(x) if mode == "enc0" else _nhwc(x)
    args = (xj, _jw(mode, w), jnp.asarray(bias), jnp.asarray(scale),
            jnp.asarray(mean))
    nargs = 3 if mode == "enc0" else 5

    def jgrads(precise):
        with pltpu.force_tpu_interpret_mode():
            return jax.grad(lambda *a: jloss(*a, precise=precise)
                            if nargs == 5 else
                            jloss(*a, None, None, precise=precise),
                            argnums=tuple(range(nargs)))(*args[:nargs])

    tx, tw, tb = _leaf(x, BF16), _leaf(w), _leaf(bias)
    stats = ((None, None) if mode == "enc0"
             else (_leaf(scale), _leaf(mean)))
    y, s, q = stencil_ad(tx, tw, tb, *stats, mode)
    assert y.dtype == BF16
    loss = (y.float() * torch.from_numpy(cy)).sum()
    if mode == "down":
        loss = loss + ((s * torch.from_numpy(c1)).sum()
                       + (q * torch.from_numpy(c2)).sum())
    elif mode == "up":
        sc, mn = stats_to_scale_mean(s, q, t * f_out)
        loss = loss + ((sc * torch.from_numpy(c1)).sum()
                       + (mn * torch.from_numpy(c2)).sum())
    loss.backward()
    assert tx.grad.dtype == BF16 and tw.grad.dtype == torch.float32

    def jax_side(g):
        gx = np.asarray(g[0], np.float32)
        out = [gx if mode == "enc0" else _nchw(gx), _pw(mode, g[1]),
               np.asarray(g[2])]
        return out + [np.asarray(v) for v in g[3:]]

    port = [tx.grad.float().numpy(), tw.grad.numpy(), tb.grad.numpy()]
    names = ["x", "w", "bias"]
    if mode != "enc0":
        port += [stats[0].grad.numpy(), stats[1].grad.numpy()]
        names += ["scale", "mean"]
    _check(names, port, jax_side(jgrads(False)), jax_side(jgrads(True)))

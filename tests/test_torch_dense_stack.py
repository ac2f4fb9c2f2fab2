"""PyTorch port, kernel 1 (ops/kernels/dense_stack.py): the plain version
against the JAX Pallas kernel ``dense_stack_flat(precise=True)`` run in
interpret mode, at the geometry of tests/test_dense_stack.py (b=2, t=10,
f=7, tile 256; 1 and 2 sources, with and without the partial
accumulator), and the fused DenseBlock against the plain one.  The CUDA
kernel is held to the plain version in tests/test_torch_cuda.py.

Tolerance: float32 throughout.  The Pallas kernel folds the mean into
correction fields and sums in another order, so the two agree to ~1e-6 of
max-abs; bound 1e-5 normalized by max-abs (outputs and fused sums)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from misonet_tpu.ops.pallas.conv_flat import flatten_tf, unflatten_tf  # noqa: E402
from misonet_tpu.ops.pallas.dense_stack import dense_stack_flat  # noqa: E402
from misonet_tpu_torch.models.blocks import DenseBlock, init_parameters  # noqa: E402
from misonet_tpu_torch.models.flat_dense import (  # noqa: E402
    DenseBlockFlat,
    from_bundle,
    merge_bundles,
)
from misonet_tpu_torch.ops.kernels.dense_stack import dense_stack  # noqa: E402

ATOL = 1e-5
TILE = 256


def _close(out, ref, atol=ATOL):
    out, ref = np.asarray(out), np.asarray(ref)
    scale = np.abs(ref).max()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out / scale, ref / scale, atol=atol)


def _inputs(seed, b, t, f, widths, n, with_acc):
    rng = np.random.default_rng(seed)
    c = sum(widths)
    xs = [rng.standard_normal((b, w, t, f)).astype(np.float32) + 0.5
          for w in widths]
    acc = (rng.standard_normal((b, n, t, f)).astype(np.float32)
           if with_acc else None)
    w = (0.2 * rng.standard_normal((n, c, 3, 3))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (b, c)).astype(np.float32)
    mean = rng.uniform(-0.5, 1.0, (b, c)).astype(np.float32)
    return xs, acc, w, scale, mean


def _flat(x):  # NCHW numpy -> JAX flat layout
    return flatten_tf(jnp.asarray(x.transpose(0, 2, 3, 1)), TILE)


def _unflat(y, t, f):  # JAX flat layout -> NCHW numpy
    return np.asarray(unflatten_tf(y, t, f, TILE)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("widths,n,n_fin,with_acc", [
    ((8,), 24, 8, False),       # first call of an encoder block
    ((8,), 24, 8, True),        # middle call: partials in and out
    ((8, 8), 32, 8, False),     # decoder skip concat, two sources
    ((8, 8), 16, 16, True),     # last call: no partials out
])
def test_plain_matches_pallas(widths, n, n_fin, with_acc):
    b, t, f = 2, 10, 7
    xs, acc, w, scale, mean = _inputs(1, b, t, f, widths, n, with_acc)
    bias = np.linspace(-0.3, 0.3, n_fin).astype(np.float32)

    with pltpu.force_tpu_interpret_mode():
        yj, sj, qj, aj = dense_stack_flat(
            tuple(_flat(x) for x in xs),
            _flat(acc) if with_acc else None,
            jnp.asarray(w.transpose(2, 3, 1, 0)),  # OIHW -> HWIO
            jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(mean),
            t=t, f=f, n_fin=n_fin, tile_m=TILE, precise=True,
        )

    T = torch.from_numpy
    yt, st, qt, at = dense_stack(
        [T(x) for x in xs], T(acc) if with_acc else None, T(w), T(bias),
        T(scale), T(mean), n_fin,
    )
    _close(yt.numpy(), _unflat(yj, t, f))
    _close(st.numpy(), np.asarray(sj)[..., 0])
    _close(qt.numpy(), np.asarray(qj)[..., 0])
    if n > n_fin:
        _close(at.numpy(), _unflat(aj, t, f))
    else:
        assert at is None and aj is None


def test_fused_dense_block_matches_plain_block():
    """DenseBlockFlat.flat (five stacked calls, two-source bundle) against
    the plain DenseBlock on the normalized concatenation."""
    b, t, f = 2, 6, 9
    rng = np.random.default_rng(4)
    xa = torch.from_numpy(rng.standard_normal((b, 8, t, f)).astype(np.float32))
    xb = torch.from_numpy(rng.standard_normal((b, 8, t, f)).astype(np.float32))
    block = DenseBlockFlat(16, 8, 16)
    init_parameters(block, torch.Generator().manual_seed(0))
    for conv in block.convs:
        conv.bias.data.uniform_(-0.2, 0.2)

    def stats(x):
        mean = x.mean(dim=(2, 3))
        var = x.var(dim=(2, 3), unbiased=False)
        return torch.rsqrt(var + 1e-5), mean

    sa, ma = stats(xa)
    sb, mb = stats(xb)
    with torch.no_grad():
        out = from_bundle(block.flat(merge_bundles(((xa,), sa, ma),
                                                   ((xb,), sb, mb))))
        xn = torch.cat([(xa - ma[..., None, None]) * sa[..., None, None],
                        (xb - mb[..., None, None]) * sb[..., None, None]], 1)
        ref = DenseBlock.forward(block, xn)
    _close(out.numpy(), ref.numpy())



def test_stacked_weights_follow_the_parameters():
    """Outside autograd the fused block stacks its kernels once per weight
    state: the stacks are reused while the weights stay, rebuilt after an
    in-place update, and each is the plain slices of layers s..4 over
    source s's channels.  When autograd records the weights, the stacks
    are built in the graph on each call, so their gradient reaches the
    layers' weights."""
    block = DenseBlockFlat(16, 8, 12)
    init_parameters(block, torch.Generator().manual_seed(1))
    graph = block.stacked_weights()
    assert all(w.grad_fn is not None for w in graph)
    assert graph[0] is not block.stacked_weights()[0]
    graph[2].sum().backward()
    assert block.convs[3].weight.grad[:, 24:32].eq(1).all()
    assert block.convs[3].weight.grad[:, :24].eq(0).all()
    torch.set_grad_enabled(False)
    try:
        _stacked_weights_cache(block)
    finally:
        torch.set_grad_enabled(True)


def _stacked_weights_cache(block):
    first = block.stacked_weights()
    assert all(a is b for a, b in zip(first, block.stacked_weights()))
    assert [tuple(w.shape) for w in first] == [
        (44, 16, 3, 3), (36, 8, 3, 3), (28, 8, 3, 3), (20, 8, 3, 3),
        (12, 8, 3, 3)]
    with torch.no_grad():
        block.convs[3].weight.mul_(2.0)
    second = block.stacked_weights()
    assert second[0] is not first[0]
    # call 2 reads channels 24..32 of layer 3 (source 2 = layer 1's output)
    torch.testing.assert_close(second[2][8:16],
                               block.convs[3].weight[:, 24:32])
    torch.testing.assert_close(second[0][:8], block.convs[0].weight)
    block.convs[1].weight = torch.nn.Parameter(
        -block.convs[1].weight.detach())
    third = block.stacked_weights()
    assert third[0] is not second[0]
    torch.testing.assert_close(third[1][:8], block.convs[1].weight[:, 16:24])


def test_stacked_weights_of_an_inference_mode_block():
    """Weights made under inference mode have no version counter: the
    stacks are rebuilt on each call and so follow in-place updates."""
    with torch.inference_mode():
        block = DenseBlockFlat(16, 8, 12)
        init_parameters(block, torch.Generator().manual_seed(2))
        first = block.stacked_weights()
        block.convs[4].weight.mul_(3.0)
        second = block.stacked_weights()
    assert second[4] is not first[4]
    torch.testing.assert_close(second[4], block.convs[4].weight[:, 40:48])

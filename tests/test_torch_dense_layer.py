"""PyTorch port, kernel 2.6 (ops/kernels/dense_layer.py): the plain version
against the JAX Pallas kernel ``dense_layer_flat`` run in interpret mode,
at tests/test_flat_grad.py's geometry (B = 1, T = 12, F = 15, tile 256),
in float32 (precise=True) and bfloat16 (precise=False), with 1, 2 and 5
sources (a DenseBlock's layers 1, 2 and 5), ``fuse_elu=False`` and
``want_stats=False``.  Six JAX compiles in all.  The CUDA kernel is held to
the plain version in tests/test_torch_cuda.py.

Tolerances, each normalized by the reference's max-abs:

* float32: tests/test_dense_flat.py's 2e-4 abs / 2e-3 rel on y; the sums
  (over 180 positions) to 1e-5 of their max-abs.  The Pallas kernel folds
  the mean into correction columns and sums in another order.
* bfloat16: JAX's own bf16 error class as tests/test_torch_bf16.py
  measures it for one kernel call: y within 1.6e-2 of max-abs with
  correlation above 0.9999, the float32 statistics within 4e-3.  The port
  rounds the centred ``bf16((x - mean) * scale)`` where the TPU kernel
  rounds ``x * scale`` and corrects the mean through bf16 coefficients.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from misonet_tpu.ops.pallas.conv_flat import flatten_tf, unflatten_tf  # noqa: E402
from misonet_tpu.ops.pallas.dense_flat import dense_layer_flat  # noqa: E402
from misonet_tpu_torch.ops.kernels.dense_layer import dense_layer  # noqa: E402

TILE = 256
B, T, F = 1, 12, 15
F32_ATOL, F32_RTOL = 2e-4, 2e-3
STATS_F32 = 1e-5
KERNEL_TOL = 1.6e-2   # bf16-stored y of one call (tests/test_torch_bf16.py)
STATS_TOL = 4e-3      # float32 statistics of one bf16 call


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    """numpy float32 -> the bf16-rounded values as float32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).float().numpy()


def _inputs(seed, widths, n, bf16):
    rng = np.random.default_rng(seed)
    c = sum(widths)
    xs = [rng.standard_normal((B, w, T, F)).astype(np.float32) + 0.5
          for w in widths]
    w = (0.2 * rng.standard_normal((n, c, 3, 3))).astype(np.float32)
    if bf16:
        xs, w = [_bf16(x) for x in xs], _bf16(w)
    bias = np.linspace(-0.3, 0.3, n).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (B, c)).astype(np.float32)
    mean = rng.uniform(-0.5, 1.0, (B, c)).astype(np.float32)
    return xs, w, bias, scale, mean


def _flat(x, dtype):  # NCHW numpy -> JAX flat layout
    return flatten_tf(jnp.asarray(x.transpose(0, 2, 3, 1)), TILE).astype(dtype)


def _unflat(y):  # JAX flat layout -> NCHW float32 numpy
    y = unflatten_tf(y.astype(jnp.float32), T, F, TILE)
    return np.asarray(y).transpose(0, 3, 1, 2)


def _err(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("widths,bf16,fuse_elu,want_stats", [
    ((8,), False, True, True),           # layer 1, float32
    ((8, 8, 8, 8, 8), False, True, True),  # layer 5, float32
    ((8, 8), False, False, True),        # no ELU: pre-ELU statistics
    ((8, 8), True, True, True),          # layer 2, bf16
    ((8, 8, 8, 8, 8), True, True, True),   # layer 5, bf16
    ((8,), True, True, False),           # bf16, no statistics
])
def test_plain_matches_pallas(widths, bf16, fuse_elu, want_stats):
    n = 8
    xs, w, bias, scale, mean = _inputs(len(widths), widths, n, bf16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        out = dense_layer_flat(
            tuple(_flat(x, jdt) for x in xs),
            jnp.asarray(w.transpose(2, 3, 1, 0)),  # OIHW -> HWIO
            jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(mean),
            t=T, f=F, tile_m=TILE, fuse_elu=fuse_elu, want_stats=want_stats,
            precise=not bf16,
        )
    tdt = torch.bfloat16 if bf16 else torch.float32
    y, sums, sqs = dense_layer(
        [torch.from_numpy(x).to(tdt) for x in xs],
        torch.from_numpy(w).to(tdt), torch.from_numpy(bias),
        torch.from_numpy(scale), torch.from_numpy(mean),
        fuse_elu=fuse_elu, want_stats=want_stats,
    )
    assert y.dtype == tdt and y.shape == (B, n, T, F)
    yj = _unflat(out[0])
    yt = y.float().numpy()
    if not fuse_elu:  # the ELU's floor at -1 is gone
        assert yj.min() < -1.0 and yt.min() < -1.0
    if bf16:
        assert _err(yt, yj) <= KERNEL_TOL, _err(yt, yj)
        corr = np.corrcoef(yt.ravel(), yj.ravel())[0, 1]
        assert corr > 0.9999, corr
    else:
        top = np.abs(yj).max()
        np.testing.assert_allclose(yt / top, yj / top, atol=F32_ATOL,
                                   rtol=F32_RTOL)
    if not want_stats:
        assert len(out) == 1 and sums is None and sqs is None
        return
    tol = STATS_TOL if bf16 else STATS_F32
    for got, ref in ((sums, out[1]), (sqs, out[2])):
        assert got.dtype == torch.float32
        assert _err(got.numpy(), np.asarray(ref)[..., 0]) <= tol

"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version (the version the CPU tests hold to the JAX package), and the fused
MISO1 forward against the plain one.

Card only (marker ``cuda``); every test skips itself without a CUDA device.
This file imports no JAX, so on a machine without JAX it runs with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.

Tolerance: 1e-4 normalized by max-abs.  Both sides are float32 (TF32 off),
but the kernel sums the 9*C products of each output in another order than
cuDNN, and the fused forward chains 60 such layers."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from misonet_tpu_torch.config import ModelConfig  # noqa: E402
from misonet_tpu_torch.models import make_miso1  # noqa: E402
from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts  # noqa: E402
from misonet_tpu_torch.ops.kernels.dense_stack import (  # noqa: E402
    dense_stack,
    dense_stack_plain,
)
from misonet_tpu_torch.ops.kernels.stencil import stencil, stencil_plain  # noqa: E402

ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=ATOL)


def _t(rng, shape, lo=None, hi=None, scale=1.0):
    v = (rng.uniform(lo, hi, shape) if lo is not None
         else scale * rng.standard_normal(shape))
    return torch.from_numpy(v.astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n,n_fin,with_acc,t,f", [
    ((24,), 120, 24, False, 37, 63),
    ((32,), 128, 32, True, 37, 63),
    ((24, 24), 144, 24, False, 37, 63),
    ((24,), 48, 48, True, 37, 63),
    ((16,), 40, 8, True, 9, 255),      # REVERB width: > 48 KB shared memory
    ((8, 5), 24, 16, False, 3, 2),     # plane smaller than one tile
])
def test_dense_stack_kernel_matches_plain(cuda, widths, n, n_fin, with_acc,
                                          t, f):
    rng = np.random.default_rng(2)
    b = 2
    c = sum(widths)
    args = (
        [_t(rng, (b, w, t, f)) for w in widths],
        _t(rng, (b, n, t, f)) if with_acc else None,
        _t(rng, (n, c, 3, 3), scale=0.2),
        _t(rng, (n_fin,), scale=0.2),
        _t(rng, (b, c), 0.5, 1.5),
        _t(rng, (b, c), -0.5, 0.5),
    )
    before = dense_stack.launches
    got = dense_stack(*args, n_fin)
    want = dense_stack_plain(*args, n_fin)
    torch.cuda.synchronize()
    assert dense_stack.launches == before + 1
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            _close(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,c,n,f_in,t", [
    ("enc0", 12, 24, 129, 37), ("down", 24, 32, 127, 37),
    ("up", 64, 24, 63, 37), ("final", 48, 4, 127, 37),
    ("up", 5, 33, 1, 3), ("up", 8, 8, 7, 50), ("down", 3, 40, 5, 2),
])
def test_stencil_kernel_matches_plain(cuda, mode, c, n, f_in, t):
    rng = np.random.default_rng(5)
    b = 2
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
    args = [_t(rng, (b, c, t, f_in)), _t(rng, wshape, scale=0.2),
            _t(rng, (n,), scale=0.2)]
    if mode == "enc0":
        args += [None, None]
    else:
        args += [_t(rng, (b, c), 0.5, 1.5), _t(rng, (b, c), -0.5, 0.5)]
    before = stencil.launches
    got = stencil(*args, mode)
    want = stencil_plain(*args, mode)
    torch.cuda.synchronize()
    assert stencil.launches == before + 1
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            _close(g, r)


@pytest.mark.cuda
def test_fused_forward_matches_plain(cuda):
    """Narrow 7-level plan at 129 bins: the fused path launches 50
    dense_stack and 10 stencil kernels and agrees with the plain path."""
    cfg = ModelConfig(en_channels=(8, 8, 8, 8, 8, 16, 16),
                      de_channels=(16, 16, 8, 8, 8, 8, 8), tcn_repeats=1,
                      tcn_blocks=3, tcn_channels=16, compute_dtype="float32")
    model = make_miso1(cfg, device=cuda,
                       generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)
    x = torch.complex(_t(rng, (2, 6, 40, 129)), _t(rng, (2, 6, 40, 129)))
    with torch.inference_mode():
        reset_launch_counts()
        fused = model(x)
        counts = launch_counts()
        model.cfg = dataclasses.replace(cfg, flat_dense=False)
        plain = model(x)
    assert counts == {"dense_stack": 50, "stencil": 10}
    _close(torch.view_as_real(fused), torch.view_as_real(plain))

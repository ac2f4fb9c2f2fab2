"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version (the version the CPU tests hold to the JAX package), and the fused
MISO1 forward and train-step gradients against the plain path.

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
from misonet_tpu_torch.losses import loss_enhance  # noqa: E402
from misonet_tpu_torch.models import make_miso1  # noqa: E402
from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts  # noqa: E402
from misonet_tpu_torch.ops.kernels.dense_stack import (  # noqa: E402
    dense_stack,
    dense_stack_plain,
)
from misonet_tpu_torch.ops.kernels.stencil import (  # noqa: E402
    out_bins,
    stencil,
    stencil_plain,
)
from misonet_tpu_torch.ops.kernels.stencil_bwd import (  # noqa: E402
    stencil_bwd,
    stencil_bwd_plain,
)

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
    assert counts == {"dense_stack": 50, "stencil": 10, "stencil_bwd": 0}
    _close(torch.view_as_real(fused), torch.view_as_real(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,widths,n,f_in,t", [
    ("dense", (24,), 120, 63, 37),
    ("dense", (24, 24), 144, 63, 37),     # two sources
    ("dense", (32,), 32, 15, 37),         # n_fin == N: the last call
    ("dense", (16,), 40, 255, 9),         # REVERB width
    ("dense", (8, 5), 24, 2, 3),          # plane smaller than one tile
    ("enc0", (12,), 24, 129, 37),
    ("down", (24,), 32, 127, 37), ("down", (3,), 40, 5, 2),
    ("up", (64,), 24, 63, 37), ("up", (5,), 33, 1, 3),   # F_in = 1
    ("final", (48,), 4, 127, 37),
])
def test_stencil_bwd_kernel_matches_plain(cuda, mode, widths, n, f_in, t):
    rng = np.random.default_rng(7)
    b = 2
    c = sum(widths)
    f_out = f_in if mode == "dense" else out_bins(mode, f_in)
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
    xs = [_t(rng, (b, w, t, f_in)) for w in widths]
    stats = ([None, None] if mode == "enc0" else
             [_t(rng, (b, c), 0.5, 1.5), _t(rng, (b, c), -0.5, 0.5)])
    args = (_t(rng, (b, n, t, f_out)), xs, _t(rng, wshape, scale=0.2),
            *stats, mode)
    before = stencil_bwd.launches
    got = stencil_bwd(*args)
    want = stencil_bwd_plain(*args)
    torch.cuda.synchronize()
    assert stencil_bwd.launches == before + 1
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        elif isinstance(r, tuple):
            for gi, ri in zip(g, r):
                _close(gi, ri)
        else:
            _close(g, r)


@pytest.mark.cuda
def test_fused_train_gradients_match_plain(cuda):
    """The narrow 7-level plan of tests/test_train_step.py (F = 129, B = 8,
    T = 8) under autograd: the fused path launches 50 dense_stack, 10
    stencil and 60 stencil_bwd kernels, and its loss and every gradient
    agree with the plain path's (1e-3 of each tensor's max-abs: 60 chained
    layers forward and backward)."""
    cfg = ModelConfig(en_channels=(8, 8, 8, 8, 8, 16, 16),
                      de_channels=(16, 16, 8, 8, 8, 8, 8), tcn_repeats=1,
                      tcn_blocks=2, tcn_channels=16, compute_dtype="float32")
    model = make_miso1(cfg, num_mics=3, device=cuda,
                       generator=torch.Generator().manual_seed(6))
    rng = np.random.default_rng(5)
    x = torch.complex(_t(rng, (8, 3, 8, 129)), _t(rng, (8, 3, 8, 129)))
    ref = torch.complex(_t(rng, (8, 2, 8, 129), scale=0.1),
                        _t(rng, (8, 2, 8, 129), scale=0.1))

    def grads():
        model.zero_grad(set_to_none=True)
        loss = loss_enhance(model(x), ref)
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    reset_launch_counts()
    fused_loss, fused = grads()
    counts = launch_counts()
    model.cfg = dataclasses.replace(cfg, flat_dense=False)
    plain_loss, plain = grads()
    assert counts == {"dense_stack": 50, "stencil": 10, "stencil_bwd": 60}
    assert abs(fused_loss - plain_loss) <= 1e-4 * abs(plain_loss)
    # leaves that are zero in exact arithmetic (the gLN shift of each
    # dsconv1) hold rounding noise: max-abs floored at 1e-3 of the largest
    floor = 1e-3 * max(w.abs().max().item() for w in plain)
    for got, want in zip(fused, plain):
        scale = max(want.abs().max().item(), floor)
        assert (got - want).abs().max().item() <= 1e-3 * scale

"""PyTorch port on the card: each CUDA kernel (and each dtype mode) against
its plain PyTorch version (the version the CPU tests hold to the JAX
package), the fused MISO1 and MISO3 forwards and MISO1 train-step gradients
(float32 and bf16) against the plain path, the bf16 and int8 forwards'
launches, and the MVDR stage through the solve kernel.

Card only (marker ``cuda``); every test skips itself without a CUDA device.
This file imports no JAX, so on a machine without JAX it runs with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.

Tolerance: 1e-4 normalized by max-abs in float32.  Both sides are float32
(TF32 off), but the kernel sums the 9*C products of each output in another
order than cuDNN, and the fused forward chains 60 such layers.  bfloat16
modes: the plain version rounds at the kernel's points, so only the float32
sums' order differs; a bf16-stored output (y, acc_out) may then round one
ulp the other way: 1e-2 of max-abs; the float32 statistics 1e-4.  int8:
the integer sums are identical, so acc_out is bit-identical and y within
one bf16 ulp (the ELU's expm1 may differ in the last float32 bit).  The
float32 stencil and stencil_bwd run three TF32 passes on the tensor
cores: besides 1e-4 of their plain versions they are held to 1e-5 of
max-abs of the float64 run (one TF32 pass would miss it at about 1e-3),
and their outputs repeat bit for bit; the float64 runs are chip_smoke.py's
references."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (  # noqa: E402
    dense_layer_f64, dense_stack_f64, stencil_f64)
from misonet_tpu_torch.beamforming.mvdr import mvdr_beamform  # noqa: E402
from misonet_tpu_torch.config import ModelConfig  # noqa: E402
from misonet_tpu_torch.losses import loss_enhance  # noqa: E402
from misonet_tpu_torch.models import make_miso1, make_miso3  # noqa: E402
from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts  # noqa: E402
from misonet_tpu_torch.ops.kernels.dense_layer import (  # noqa: E402
    dense_layer,
    dense_layer_plain,
)
from misonet_tpu_torch.ops.kernels.dense_stack import (  # noqa: E402
    dense_stack,
    dense_stack_plain,
)
from misonet_tpu_torch.ops.kernels.dense_stack_int8 import (  # noqa: E402
    dense_stack_int8,
    dense_stack_int8_plain,
)
from misonet_tpu_torch.ops.kernels.hermitian_solve import (  # noqa: E402
    hermitian_solve,
    hermitian_solve_plain,
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
BF16_ATOL = 1e-2
BF16 = torch.bfloat16


def _counts(**nonzero):
    """The launch counts of a run that launched only ``nonzero``."""
    return {"dense_stack": 0, "dense_stack_bf16": 0, "stencil": 0,
            "stencil_bf16": 0, "stencil_bwd": 0, "stencil_bwd_bf16": 0,
            "hermitian_solve": 0, "dense_stack_int8": 0, "dense_layer": 0,
            "dense_layer_bf16": 0, **nonzero}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, atol=ATOL):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _close_mode(got, want):
    """Outputs stored in bf16 to BF16_ATOL, float32 ones to ATOL."""
    _close(got, want, BF16_ATOL if want.dtype == BF16 else ATOL)


def _bf16_ulps(got, want):
    """Largest distance of two bf16 tensors in bf16 ulps (same-sign
    values: adjacent bf16 numbers differ by one in their 16-bit pattern)."""
    return (got.view(torch.int16).int() - want.view(torch.int16).int()).abs(
    ).max().item()


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
    # the enhancement nets' own: MISO3 / MISO2 enc0, MISO3 final
    ("enc0", 16, 24, 129, 37), ("enc0", 20, 24, 129, 37),
    ("final", 48, 2, 127, 37),
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
    assert counts == _counts(dense_stack=50, stencil=10)
    _close(torch.view_as_real(fused), torch.view_as_real(plain))


@pytest.mark.cuda
def test_fused_miso3_forward_matches_plain(cuda):
    """MISO3 (6 mics + MISO1 + BF = 8 complex input channels, 1 speaker) on
    the narrow 7-level plan: 50 dense_stack and 10 stencil launches, the
    enc0 stencil at C = 16 and the final one at N = 2."""
    cfg = ModelConfig(en_channels=(8, 8, 8, 8, 8, 16, 16),
                      de_channels=(16, 16, 8, 8, 8, 8, 8), tcn_repeats=1,
                      tcn_blocks=3, tcn_channels=16, compute_dtype="float32")
    model = make_miso3(cfg, device=cuda,
                       generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(1)
    x = torch.complex(_t(rng, (4, 8, 40, 129)), _t(rng, (4, 8, 40, 129)))
    with torch.inference_mode():
        reset_launch_counts()
        fused = model(x)
        counts = launch_counts()
        model.cfg = dataclasses.replace(cfg, flat_dense=False)
        plain = model(x)
    assert fused.shape == (4, 1, 40, 129)
    assert counts == _counts(dense_stack=50, stencil=10)
    _close(torch.view_as_real(fused), torch.view_as_real(plain))


def _systems(rng, batch, m):
    a = (rng.standard_normal(batch + (m, m))
         + 1j * rng.standard_normal(batch + (m, m)))
    r = np.einsum("...ij,...kj->...ik", a, a.conj()) + 0.1 * np.eye(m)
    r = 0.5 * (r + np.conj(r.swapaxes(-1, -2)))
    d = rng.standard_normal(batch + (m,)) + 1j * rng.standard_normal(
        batch + (m,))
    return (torch.from_numpy(np.ascontiguousarray(r, np.complex64)).cuda(),
            torch.from_numpy(np.ascontiguousarray(d, np.complex64)).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m", [
    ((1,), 6), ((63,), 6), ((65,), 4), ((1031,), 6), ((2, 129), 6),
    ((7, 3), 4), ((33,), 2), ((33,), 8),
])
def test_hermitian_solve_kernel_matches_plain(cuda, batch, m):
    """Odd batch sizes leave the last block part-empty; the plain version
    runs in float64 as the reference."""
    r, d = _systems(np.random.default_rng(8), batch, m)
    before = hermitian_solve.launches
    got = hermitian_solve(r, d)
    want = hermitian_solve_plain(r.to(torch.complex128),
                                 d.to(torch.complex128))
    torch.cuda.synchronize()
    assert hermitian_solve.launches == before + 1
    assert got.shape == d.shape and got.dtype == torch.complex64
    _close(torch.view_as_real(got), torch.view_as_real(want.to(got.dtype)))


@pytest.mark.cuda
def test_mvdr_on_the_card_launches_one_solve(cuda):
    """Speakers x chunks x bins in one call: one kernel launch; the result
    agrees with the CPU path (the plain solve) to 1e-3 of max-abs."""
    rng = np.random.default_rng(9)
    shape = (3, 2, 6, 50, 129)            # chunks, speakers, mics, T, F
    src = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    mix = src.sum(1) + 0.1 * (rng.standard_normal((3, 6, 50, 129))
                              + 1j * rng.standard_normal((3, 6, 50, 129)))
    src = torch.from_numpy(src.astype(np.complex64))
    mix = torch.from_numpy(mix.astype(np.complex64))[:, None]
    before = hermitian_solve.launches
    got = mvdr_beamform(src.cuda(), mix.cuda())
    torch.cuda.synchronize()
    assert hermitian_solve.launches == before + 1
    want = mvdr_beamform(src, mix)
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 1e-3 * scale


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


F64_ATOL = 1e-5   # float32 kernels vs their plain version run in float64


def _f64(v):
    """The arguments widened to float64 (tensors, and lists of them)."""
    if isinstance(v, torch.Tensor):
        return v.double()
    if isinstance(v, list):
        return [x.double() for x in v]
    return v


def _stencil_args(rng, mode, c, n, f_in, t, b=2):
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
    args = [_t(rng, (b, c, t, f_in)), _t(rng, wshape, scale=0.2),
            _t(rng, (n,), scale=0.2)]
    if mode == "enc0":
        return args + [None, None]
    return args + [_t(rng, (b, c), 0.5, 1.5), _t(rng, (b, c), -0.5, 0.5)]


def _bwd_args(rng, mode, widths, n, f_in, t, b=2):
    c = sum(widths)
    f_out = f_in if mode == "dense" else out_bins(mode, f_in)
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
    xs = [_t(rng, (b, w, t, f_in)) for w in widths]
    stats = ([None, None] if mode == "enc0" else
             [_t(rng, (b, c), 0.5, 1.5), _t(rng, (b, c), -0.5, 0.5)])
    return (_t(rng, (b, n, t, f_out)), xs, _t(rng, wshape, scale=0.2),
            *stats, mode)


def _outputs(out):
    flat = []
    for v in out:
        flat.extend(v if isinstance(v, tuple) else [v])
    return flat


@pytest.mark.cuda
@pytest.mark.parametrize("mode,c,n,f_in,t", [
    ("enc0", 12, 24, 129, 37), ("down", 24, 32, 127, 37),
    ("up", 64, 24, 63, 37), ("final", 48, 4, 127, 37),
    ("up", 5, 33, 1, 3), ("down", 3, 40, 5, 2),
    ("enc0", 16, 24, 257, 9), ("final", 48, 2, 127, 37),
    ("up", 8, 8, 8, 50), ("down", 40, 24, 31, 9),
])
def test_stencil_f32_matches_float64(cuda, mode, c, n, f_in, t):
    """The float32 mode runs three TF32 passes over split operands, so it
    stays in float32's class: within F64_ATOL of max-abs of the plain
    version run in float64, where one TF32 pass (about 1e-3) would not."""
    args = _stencil_args(np.random.default_rng(21), mode, c, n, f_in, t)
    got = stencil(*args, mode)
    want = stencil_f64(*args, mode)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            assert g.dtype == torch.float32
            _close(g.double(), r, F64_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,widths,n,f_in,t", [
    ("dense", (24,), 120, 63, 37), ("dense", (24, 24), 144, 63, 37),
    ("dense", (16,), 40, 255, 9), ("dense", (8, 5), 24, 2, 3),
    ("dense", (64, 64), 192, 7, 37),      # dec2 call 0: the longest dgrad
    ("enc0", (12,), 24, 129, 37), ("down", (24,), 32, 127, 37),
    ("down", (3,), 40, 5, 2), ("up", (64,), 24, 63, 37),
    ("up", (5,), 33, 1, 3), ("final", (48,), 4, 127, 37),
    ("final", (48,), 2, 127, 37), ("enc0", (20,), 24, 129, 9),
])
def test_stencil_bwd_f32_matches_float64(cuda, mode, widths, n, f_in, t):
    """As test_stencil_f32_matches_float64 for the backward: dx, dW
    (long wgrad reductions in the mma's float32 accumulators), dbias,
    dscale and dmean within F64_ATOL of the float64 run."""
    args = _bwd_args(np.random.default_rng(22), mode, widths, n, f_in, t)
    got = stencil_bwd(*args)
    want = stencil_bwd_plain(*[_f64(v) for v in args])
    torch.cuda.synchronize()
    for g, r in zip(_outputs(got), _outputs(want)):
        if r is None:
            assert g is None
        else:
            assert g.dtype == torch.float32
            _close(g.double(), r, F64_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["enc0", "down", "up", "final"])
def test_stencil_f32_repeats_bit_for_bit(cuda, mode):
    """Two float32 calls on the same inputs give the same bits (fixed-order
    sums and statistics)."""
    c, n = (12, 24) if mode == "enc0" else (32, 24) if mode != "final" \
        else (48, 4)
    args = _stencil_args(np.random.default_rng(23), mode, c, n, 63, 37)
    first = stencil(*args, mode)
    again = stencil(*args, mode)
    for a, b_ in zip(first, again):
        assert (a is None and b_ is None) or torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,widths,n,f_in", [
    ("dense", (24, 24), 144, 63), ("enc0", (12,), 24, 129),
    ("down", (24,), 32, 127), ("up", (64,), 24, 63), ("final", (48,), 4, 127),
])
def test_stencil_bwd_f32_repeats_bit_for_bit(cuda, mode, widths, n, f_in):
    """Two float32 backward calls on the same inputs give the same bits:
    the wgrad's fixed splits added in split order, the dgrad's statistics
    in a fixed order, no atomics."""
    args = _bwd_args(np.random.default_rng(24), mode, widths, n, f_in, 37)
    first = stencil_bwd(*args)
    again = stencil_bwd(*args)
    for a, r in zip(_outputs(first), _outputs(again)):
        assert (a is None and r is None) or torch.equal(a, r)


# the float32 dense_stack's cases: test_dense_stack_kernel_matches_plain's,
# and dec2's first call, the longest reduction (64 + 64 channels x 9 taps)
# on a plane of 7 bins
F32_DENSE_CASES = [
    ((24,), 120, 24, False, 37, 63),
    ((32,), 128, 32, True, 37, 63),
    ((24, 24), 144, 24, False, 37, 63),
    ((24,), 48, 48, True, 37, 63),
    ((16,), 40, 8, True, 9, 255),      # REVERB width
    ((8, 5), 24, 16, False, 3, 2),     # groups of 4: each source pads its own
    ((64, 64), 192, 32, False, 37, 7),  # dec2 call 0
]


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n,n_fin,with_acc,t,f", F32_DENSE_CASES)
def test_dense_stack_f32_matches_float64(cuda, widths, n, n_fin, with_acc,
                                         t, f):
    """The float32 mode runs three TF32 passes over split operands, each
    16-channel chunk in fresh accumulators, so it stays in float32's class:
    every output within F64_ATOL of max-abs of the float64 run."""
    args = _dense_args(np.random.default_rng(27), widths, n, n_fin,
                       with_acc, t, f, torch.float32, torch.float32)
    got = dense_stack(*args, n_fin)
    want = dense_stack_f64(*args, n_fin)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            assert g.dtype == torch.float32
            _close(g.double(), r, F64_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n,fuse_elu,want_stats,t,f", [
    ((8,) * 8, 16, True, True, 5, 33),             # MAX_SOURCES
    ((24,) * 5, 24, True, True, 9, 127),           # an encoder's layer 5
    ((5, 3) * 4, 24, True, True, 9, 31),           # 8 sources, odd widths
    ((24, 24), 24, False, True, 37, 63),           # no ELU
    ((24, 24), 48, True, False, 37, 63),           # no statistics
])
def test_dense_layer_f32_matches_float64(cuda, widths, n, fuse_elu,
                                         want_stats, t, f):
    """Kernel 2.6 in float32 (dense_stack's three TF32 passes over up to 8
    sources, each padded to its own groups of 4) within F64_ATOL of
    max-abs of its float64 run, with either switch off."""
    args = _dense_args(np.random.default_rng(28), widths, n, n, False, t, f,
                       torch.float32, torch.float32)
    args = (args[0], args[2], args[3], args[4], args[5])
    got = dense_layer(*args, fuse_elu=fuse_elu, want_stats=want_stats)
    want = dense_layer_f64(*args, fuse_elu, want_stats)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            _close(g.double(), r, F64_ATOL)


@pytest.mark.cuda
def test_dense_stack_f32_repeats_bit_for_bit(cuda):
    """Two float32 calls on the same inputs give the same bits (fixed-order
    sums and statistics, no atomics)."""
    args = _dense_args(np.random.default_rng(29), (24, 24), 144, 24, True,
                       37, 63, torch.float32, torch.float32)
    first = dense_stack(*args, 24)
    again = dense_stack(*args, 24)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("o,widths", [
    (24, (12,)), (5, (3,)), (33, (5,)), (7, (8, 5)), (64, (192,)),
])
def test_pack_tf32_kernel_equals_plain(cuda, o, widths, transpose):
    """The float32 weight planes built on the card (one launch of
    pack_tf32_kernel) are pack_tf32_plain's bit for bit: the same
    placement, the same cvt.rna split."""
    from misonet_tpu_torch.ops.kernels.tc_pack import (
        pack_tf32, pack_tf32_plain)

    r = sum(widths)
    shape = (r, o, 3, 3) if transpose else (o, r, 3, 3)
    w = _t(np.random.default_rng(o + r), shape)
    before = pack_tf32.launches
    got = pack_tf32(w, widths, transpose)
    assert pack_tf32.launches == before + 1
    assert torch.equal(got, pack_tf32_plain(w, widths, transpose))


@pytest.mark.cuda
def test_pack_tf32_refuses_what_it_does_not_take(cuda):
    from misonet_tpu_torch.ops.kernels.tc_pack import pack_tf32

    w = torch.zeros((4, 10, 3, 3), device=cuda)
    with pytest.raises(ValueError, match="do not sum"):
        pack_tf32(w, (4, 5))
    with pytest.raises(ValueError, match="float32"):
        pack_tf32(w.to(BF16), (10,))
    with pytest.raises(ValueError, match="source"):
        pack_tf32(torch.zeros((4, 9, 3, 3), device=cuda), (1,) * 9)


@pytest.mark.cuda
def test_f32_weights_are_packed_once_per_version(cuda):
    """A float32 stencil packs its weight on the card once per weight
    version (one pack_tf32_kernel launch), and stencil_bwd's dgrad packs
    its transposed role once more."""
    from misonet_tpu_torch.ops.kernels.tc_pack import pack_tf32

    args = _stencil_args(np.random.default_rng(25), "down", 24, 32, 63, 9)
    w = args[1]
    before = pack_tf32.launches
    stencil(*args, "down")
    stencil(*args, "down")
    assert pack_tf32.launches == before + 1
    g = _t(np.random.default_rng(26), (2, 32, 9, out_bins("down", 63)))
    for _ in range(2):
        stencil_bwd(g, [args[0]], w, args[3], args[4], "down")
    assert pack_tf32.launches == before + 2
    with torch.no_grad():
        w.mul_(0.5)                     # a new version
    stencil(*args, "down")
    assert pack_tf32.launches == before + 3


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
    assert counts == _counts(dense_stack=50, stencil=10, stencil_bwd=60)
    assert abs(fused_loss - plain_loss) <= 1e-4 * abs(plain_loss)
    # leaves that are zero in exact arithmetic (the gLN shift of each
    # dsconv1) hold rounding noise: max-abs floored at 1e-3 of the largest
    floor = 1e-3 * max(w.abs().max().item() for w in plain)
    for got, want in zip(fused, plain):
        scale = max(want.abs().max().item(), floor)
        assert (got - want).abs().max().item() <= 1e-3 * scale


DENSE_CASES = [
    ((24,), 120, 24, False, 37, 63),
    ((32,), 128, 32, True, 37, 63),
    ((24, 24), 144, 24, False, 37, 63),
    ((24,), 48, 48, True, 37, 63),
    ((16,), 40, 8, True, 9, 255),      # REVERB width: > 48 KB shared memory
    ((8, 4), 24, 16, False, 3, 2),     # plane smaller than one tile
]


def _dense_args(rng, widths, n, n_fin, with_acc, t, f, act, wdt):
    b, c = 2, sum(widths)
    return (
        [_t(rng, (b, w, t, f)).to(act) for w in widths],
        _t(rng, (b, n, t, f)).to(act) if with_acc else None,
        _t(rng, (n, c, 3, 3), scale=0.2).to(wdt),
        _t(rng, (n_fin,), scale=0.2),
        _t(rng, (b, c), 0.5, 1.5),
        _t(rng, (b, c), -0.5, 0.5),
    )


# the bf16 mode's tensor-core edges: channels that are no multiple of 16
# (a unit is 8 channels at one tap), two chunks of the reduction, two
# sources with acc_in, a plane narrower than 8 bins
TC_DENSE_CASES = [
    ((20,), 40, 8, True, 9, 63),
    ((24,), 24, 24, False, 9, 127),
    ((40,), 48, 16, False, 9, 31),
    ((24, 24), 96, 24, True, 9, 63),
    ((20, 20), 24, 8, True, 5, 7),
]


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n,n_fin,with_acc,t,f",
                         DENSE_CASES + TC_DENSE_CASES)
def test_dense_stack_bf16_kernel_matches_plain(cuda, widths, n, n_fin,
                                               with_acc, t, f):
    args = _dense_args(np.random.default_rng(12), widths, n, n_fin,
                       with_acc, t, f, BF16, BF16)
    before = dense_stack.launches_bf16
    got = dense_stack(*args, n_fin)
    want = dense_stack_plain(*args, n_fin)
    torch.cuda.synchronize()
    assert dense_stack.launches_bf16 == before + 1
    assert got[0].dtype == BF16 and got[1].dtype == torch.float32
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            _close_mode(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n,n_fin,with_acc,t,f", DENSE_CASES)
def test_dense_stack_int8_kernel_matches_plain(cuda, widths, n, n_fin,
                                               with_acc, t, f):
    args = _dense_args(np.random.default_rng(13), widths, n, n_fin,
                       with_acc, t, f, BF16, torch.float32)
    before = dense_stack_int8.launches
    y, s, q, a = dense_stack_int8(*args, n_fin)
    y0, s0, q0, a0 = dense_stack_int8_plain(*args, n_fin)
    torch.cuda.synchronize()
    assert dense_stack_int8.launches == before + 1
    assert (a is None) == (a0 is None)
    if a0 is not None:
        assert torch.equal(a, a0)           # the same integer sums
    assert _bf16_ulps(y, y0) <= 1
    _close(s, s0)
    _close(q, q0)


@pytest.mark.cuda
def test_dense_stack_int8_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(14)
    args = list(_dense_args(rng, (6,), 24, 8, False, 5, 7, BF16,
                            torch.float32))
    with pytest.raises(ValueError, match="multiples of 4"):
        dense_stack_int8(*args, 8)
    args = list(_dense_args(rng, (8,), 24, 8, False, 5, 7, torch.float32,
                            torch.float32))
    with pytest.raises(ValueError, match="bfloat16"):
        dense_stack_int8(*args, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,c,n,f_in,t", [
    ("enc0", 12, 24, 129, 37), ("down", 24, 32, 127, 37),
    ("up", 64, 24, 63, 37), ("final", 48, 4, 127, 37),
    ("up", 5, 33, 1, 3), ("down", 3, 40, 5, 2),
    # the tensor-core kernel's edges: the REVERB plan's enc0 (F_in = 257,
    # 8 mics), the enhancement nets' enc0 (C = 16, 20) and MISO3's final
    # N = 2, an up whose parity planes tile at 16 and 8 columns, two
    # chunks of the reduction
    ("enc0", 16, 24, 257, 9), ("enc0", 16, 24, 129, 37),
    ("enc0", 20, 24, 129, 37), ("final", 48, 2, 127, 37),
    ("up", 8, 8, 8, 50), ("down", 40, 24, 31, 9),
])
def test_stencil_bf16_kernel_matches_plain(cuda, mode, c, n, f_in, t):
    rng = np.random.default_rng(15)
    b = 2
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
    args = [_t(rng, (b, c, t, f_in)).to(BF16),
            _t(rng, wshape, scale=0.2).to(BF16), _t(rng, (n,), scale=0.2)]
    if mode == "enc0":
        args += [None, None]
    else:
        args += [_t(rng, (b, c), 0.5, 1.5), _t(rng, (b, c), -0.5, 0.5)]
    before = stencil.launches_bf16
    got = stencil(*args, mode)
    want = stencil_plain(*args, mode)
    torch.cuda.synchronize()
    assert stencil.launches_bf16 == before + 1
    assert got[0].dtype == BF16
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            _close_mode(g, r)


def _stencil_bf16_args(rng, mode, c, n, f_in, t, b=2):
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
    args = [_t(rng, (b, c, t, f_in)).to(BF16), _t(rng, wshape, scale=0.2),
            _t(rng, (n,), scale=0.2)]
    if mode == "enc0":
        return args + [None, None]
    return args + [_t(rng, (b, c), 0.5, 1.5), _t(rng, (b, c), -0.5, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["enc0", "down", "up", "final"])
def test_stencil_bf16_repeats_bit_for_bit(cuda, mode):
    """Two calls on the same inputs give the same bits (fixed-order sums
    and statistics), and the float32 parameter as ``w`` gives the bits of
    its bf16 cast (the serving path passes the parameter; the wrapper
    rounds it where it packs)."""
    c, n = (12, 24) if mode == "enc0" else (32, 24) if mode != "final" \
        else (48, 4)
    x, w, *rest = _stencil_bf16_args(np.random.default_rng(20), mode, c, n,
                                     63, 37)
    first = stencil(x, w.to(BF16), *rest, mode)
    again = stencil(x, w.to(BF16), *rest, mode)
    from_f32 = stencil(x, w, *rest, mode)
    for a, b_, c_ in zip(first, again, from_f32):
        if a is None:
            assert b_ is None and c_ is None
        else:
            assert torch.equal(a, b_) and torch.equal(a, c_)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n,n_fin,with_acc,t,f", DENSE_CASES)
def test_int8_rows_on_the_card_equal_quantize_rows(cuda, widths, n, n_fin,
                                                   with_acc, t, f):
    """The row kernel's qw (packed), corr and rq are the plain version's
    (quantize_rows in pack_int8_rows's layout) bit for bit: both take beta
    and the coefficients as float64 sums of the float32 products."""
    from misonet_tpu_torch.ops.kernels.dense_stack_int8 import (
        quantize_rows, quantize_rows_packed)
    from misonet_tpu_torch.ops.kernels.tc_pack import pack_int8_rows

    _, _, w, _, scale, mean = _dense_args(
        np.random.default_rng(21), widths, n, n_fin, with_acc, t, f, BF16,
        torch.float32)
    got = quantize_rows_packed(w, scale, mean, widths)
    qw, corr, rq = quantize_rows(w, scale, mean)
    torch.cuda.synchronize()
    assert torch.equal(got[0], pack_int8_rows(qw, widths))
    assert torch.equal(got[1], corr)
    assert torch.equal(got[2], rq)


@pytest.mark.cuda
def test_dense_stack_int8_repeats_bit_for_bit(cuda):
    args = _dense_args(np.random.default_rng(22), (24, 24), 96, 24, True,
                       37, 63, BF16, torch.float32)
    first = dense_stack_int8(*args, 24)
    again = dense_stack_int8(*args, 24)
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_int8_call_launches_one_row_kernel(cuda):
    """One int8 call is three kernels on the card: the row quantization
    (one launch, where PyTorch took 33), the tensor-core conv and the
    statistics' second pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from misonet_tpu_torch.ops.kernels.dense_stack_int8 import (
        quantize_rows_packed)

    args = _dense_args(np.random.default_rng(23), (24,), 120, 24, False, 37,
                       63, BF16, torch.float32)
    before = quantize_rows_packed.launches
    dense_stack_int8(*args, 24)
    torch.cuda.synchronize()
    assert quantize_rows_packed.launches == before + 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dense_stack_int8(*args, 24)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)}
    assert sum(kernels.values()) == 3, kernels
    for name in ("quantize_rows_kernel", "dense_stack_int8_tc_kernel",
                 "reduce_stats_kernel"):
        assert sum(c for k, c in kernels.items() if name in k) == 1, kernels


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_bf16_forward_launches(cuda, quant):
    """The narrow 7-level plan at compute_dtype="bfloat16": one forward
    launches 50 bf16 dense_stack (or, with quant_int8, 50 int8) and 10 bf16
    stencil kernels, returns complex64, and stays within the bf16 (int8)
    class of the plain bf16 path; under autograd the int8 path refuses to
    run and the bf16 path trains (test_fused_bf16_train_step)."""
    cfg = ModelConfig(en_channels=(8, 8, 8, 8, 8, 16, 16),
                      de_channels=(16, 16, 8, 8, 8, 8, 8), tcn_repeats=1,
                      tcn_blocks=3, tcn_channels=16, quant_int8=quant)
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
        model.cfg = cfg
    dense = {"dense_stack_int8" if quant else "dense_stack_bf16": 50}
    assert counts == _counts(**dense, stencil_bf16=10)
    assert fused.dtype == torch.complex64
    got, want = torch.view_as_real(fused), torch.view_as_real(plain)
    err = (got - want).abs().max() / want.abs().max()
    assert err <= (0.2 if quant else 0.05), err
    if quant:
        with pytest.raises(ValueError, match="decode-only"):
            model(x)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,widths,n,f_in,t", [
    ("dense", (24,), 120, 63, 37),
    ("dense", (24, 24), 144, 63, 37),     # two sources
    ("dense", (32,), 32, 15, 37),         # n_fin == N: the last call
    ("dense", (8, 5), 24, 2, 3),          # plane smaller than one tile
    ("enc0", (12,), 24, 129, 37),
    ("down", (24,), 32, 127, 37), ("down", (3,), 40, 5, 2),
    ("up", (64,), 24, 63, 37), ("up", (5,), 33, 1, 3),   # F_in = 1
    ("final", (48,), 4, 127, 37), ("final", (48,), 2, 127, 37),
    # tensor-core edges: C = 20, 24, 40 (no multiple of 16), two sources
    ("dense", (20,), 40, 63, 9), ("dense", (40,), 24, 31, 9),
    ("dense", (24, 24), 48, 63, 9), ("enc0", (20,), 24, 129, 9),
    ("down", (40,), 32, 63, 9), ("up", (24,), 20, 31, 9),
])
def test_stencil_bwd_bf16_kernel_matches_plain(cuda, mode, widths, n, f_in,
                                               t):
    """The bf16 mode: bf16 g, sources and weights; dx (bf16) within
    BF16_ATOL, dW, dbias, dscale, dmean (float32) within ATOL."""
    rng = np.random.default_rng(17)
    b = 2
    c = sum(widths)
    f_out = f_in if mode == "dense" else out_bins(mode, f_in)
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
    xs = [_t(rng, (b, w, t, f_in)).to(BF16) for w in widths]
    stats = ([None, None] if mode == "enc0" else
             [_t(rng, (b, c), 0.5, 1.5), _t(rng, (b, c), -0.5, 0.5)])
    args = (_t(rng, (b, n, t, f_out)).to(BF16), xs,
            _t(rng, wshape, scale=0.2).to(BF16), *stats, mode)
    before = stencil_bwd.launches_bf16, stencil_bwd.launches
    got = stencil_bwd(*args)
    want = stencil_bwd_plain(*args)
    torch.cuda.synchronize()
    assert (stencil_bwd.launches_bf16, stencil_bwd.launches) == (
        before[0] + 1, before[1])
    assert got[0][0].dtype == BF16 and got[1].dtype == torch.float32
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        elif isinstance(r, tuple):
            for gi, ri in zip(g, r):
                _close_mode(gi, ri)
        else:
            _close_mode(g, r)


@pytest.mark.cuda
def test_dense_stack_bf16_repeats_bit_for_bit(cuda):
    """Two calls on the same inputs give the same bits: the tensor-core
    kernel sums in a fixed order and its statistics take the fixed-order
    two-pass reduction (the train phases compare repeat gradients)."""
    args = _dense_args(np.random.default_rng(18), (24, 24), 96, 24, True,
                       37, 63, BF16, BF16)
    first = dense_stack(*args, 24)
    again = dense_stack(*args, 24)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,widths,n,f_in", [
    ("dense", (24, 24), 144, 63), ("final", (48,), 4, 127),
])
def test_stencil_bwd_bf16_repeats_bit_for_bit(cuda, mode, widths, n, f_in):
    """Two backward calls on the same inputs give the same bits: the
    wgrad's fixed splits added in split order, the dgrad's statistics in
    a fixed order, no atomics."""
    rng = np.random.default_rng(19)
    b, t, c = 2, 37, sum(widths)
    f_out = f_in if mode == "dense" else out_bins(mode, f_in)
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
    args = (_t(rng, (b, n, t, f_out)).to(BF16),
            [_t(rng, (b, w, t, f_in)).to(BF16) for w in widths],
            _t(rng, wshape, scale=0.2).to(BF16),
            _t(rng, (b, c), 0.5, 1.5), _t(rng, (b, c), -0.5, 0.5), mode)
    first = stencil_bwd(*args)
    again = stencil_bwd(*args)
    for a, r in zip(first, again):
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, r))
        else:
            assert torch.equal(a, r)


@pytest.mark.cuda
def test_fused_bf16_train_step(cuda):
    """The narrow 7-level plan at compute_dtype="bfloat16" under autograd:
    50 dense_stack_bf16, 10 stencil_bf16 and 60 stencil_bwd_bf16 launches;
    float32 gradients whose distance to the plain bf16 path's (L2 over all
    tensors, relative) is within max(2e-2, 2x the plain path's own
    movement under a 3e-6 relative input perturbation); the loss within
    1e-2 relative."""
    cfg = ModelConfig(en_channels=(8, 8, 8, 8, 8, 16, 16),
                      de_channels=(16, 16, 8, 8, 8, 8, 8), tcn_repeats=1,
                      tcn_blocks=2, tcn_channels=16)
    model = make_miso1(cfg, num_mics=3, device=cuda,
                       generator=torch.Generator().manual_seed(6))
    rng = np.random.default_rng(5)
    x = torch.complex(_t(rng, (8, 3, 8, 129)), _t(rng, (8, 3, 8, 129)))
    ref = torch.complex(_t(rng, (8, 2, 8, 129), scale=0.1),
                        _t(rng, (8, 2, 8, 129), scale=0.1))
    torch.backends.cudnn.deterministic = True

    def grads(inp):
        model.zero_grad(set_to_none=True)
        loss = loss_enhance(model(inp), ref)
        loss.backward()
        return loss.item(), torch.cat([p.grad.ravel()
                                       for p in model.parameters()])

    reset_launch_counts()
    fused_loss, fused = grads(x)
    counts = launch_counts()
    model.cfg = dataclasses.replace(cfg, flat_dense=False)
    plain_loss, plain = grads(x)
    _, moved = grads(x * (1 + 3e-6 * torch.randn(
        x.shape, generator=torch.Generator().manual_seed(1)).to(cuda)))
    assert counts == _counts(dense_stack_bf16=50, stencil_bf16=10,
                             stencil_bwd_bf16=60)
    assert fused.dtype == torch.float32 and torch.isfinite(fused).all()
    assert abs(fused_loss - plain_loss) <= 1e-2 * abs(plain_loss)
    err = ((fused - plain).norm() / plain.norm()).item()
    sens = ((moved - plain).norm() / plain.norm()).item()
    assert err <= max(2e-2, 2 * sens), (err, sens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("widths,n,fuse_elu,want_stats,t,f", [
    ((24,), 24, True, True, 37, 63),               # layer 1 of an encoder
    ((24, 24), 24, True, True, 37, 63),            # layer 2
    ((24, 24, 24, 24, 24), 24, True, True, 9, 127),  # layer 5
    ((64, 32, 32, 32, 32), 64, True, True, 9, 7),    # decoder layer 5
    ((8,) * 8, 16, True, True, 5, 33),             # MAX_SOURCES
    ((24,) * 6, 24, True, True, 9, 127),           # six sources
    ((24, 24), 24, False, True, 37, 63),           # no ELU
    ((24, 24), 24, True, False, 37, 63),           # no statistics
    ((5, 3), 8, True, True, 3, 2),                 # plane smaller than a tile
])
def test_dense_layer_kernel_matches_plain(cuda, dtype, widths, n, fuse_elu,
                                          want_stats, t, f):
    """Kernel 2.6 against dense_layer_plain: bf16-stored y within two bf16
    ulps, float32 outputs and sums within 1e-4 of max-abs."""
    args = _dense_args(np.random.default_rng(21), widths, n, n, False, t, f,
                       dtype, dtype)
    args = (args[0], args[2], args[3], args[4], args[5])
    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    before = getattr(dense_layer, counter)
    got = dense_layer(*args, fuse_elu=fuse_elu, want_stats=want_stats)
    want = dense_layer_plain(*args, fuse_elu=fuse_elu, want_stats=want_stats)
    torch.cuda.synchronize()
    assert getattr(dense_layer, counter) == before + 1
    assert got[0].dtype == dtype
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            _close_mode(g, r)


@pytest.mark.cuda
def test_dense_layer_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(3)
    xs = [_t(rng, (1, 4, 3, 5)) for _ in range(9)]
    w = _t(rng, (8, 36, 3, 3))
    stats = [_t(rng, (1, 36)), _t(rng, (1, 36))]
    with pytest.raises(ValueError, match="1 to 8 sources"):
        dense_layer(xs, w, _t(rng, (8,)), *stats)
    with pytest.raises(ValueError, match="w must be"):
        dense_layer(xs[:2], w[:, :8].to(BF16).contiguous(), _t(rng, (8,)),
                    stats[0][:, :8].contiguous(),
                    stats[1][:, :8].contiguous())


@pytest.mark.cuda
def test_dp_step_at_world_size_one_is_the_plain_step(cuda, tmp_path):
    """The data-parallel step over NCCL at world size 1 (the collectives
    run; one card cannot show scaling): the narrow bf16 MISO1's updated
    parameters and gradients bit-identical to the step without a mesh,
    through the fused kernels (50 / 10 / 60 launches)."""
    import torch.distributed as dist

    from misonet_tpu_torch.config import OptimizerConfig
    from misonet_tpu_torch.parallel import (
        distributed, make_mesh, replicate, shard_batch)
    from misonet_tpu_torch.train import (
        create_train_state, make_optimizer, make_separate_train_step)

    cfg = ModelConfig(en_channels=(8, 8, 8, 8, 8, 16, 16),
                      de_channels=(16, 16, 8, 8, 8, 8, 8), tcn_repeats=1,
                      tcn_blocks=2, tcn_channels=16)
    rng = np.random.default_rng(9)
    mix = torch.complex(_t(rng, (4, 3, 8, 129)), _t(rng, (4, 3, 8, 129)))
    ref = torch.complex(_t(rng, (4, 2, 8, 129), scale=0.1),
                        _t(rng, (4, 2, 8, 129), scale=0.1))
    torch.backends.cudnn.deterministic = True
    distributed.initialize(f"file://{tmp_path}/rdv", 1, 0, device="cuda",
                           force=True)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        out = []
        for m in (None, mesh):
            model = make_miso1(cfg, num_mics=3, device=cuda,
                               generator=torch.Generator().manual_seed(4))
            if m is not None:
                replicate(model, m)
            opt = make_optimizer(OptimizerConfig(), model.parameters())
            step = make_separate_train_step(model, opt, mesh=m)
            reset_launch_counts()
            batch = (mix, ref) if m is None else shard_batch((mix, ref), m)
            _, metrics = step(create_train_state(model, opt), *batch)
            torch.cuda.synchronize()
            assert launch_counts() == _counts(
                dense_stack_bf16=50, stencil_bf16=10, stencil_bwd_bf16=60)
            out.append((model, float(metrics["loss"])))
    finally:
        dist.destroy_process_group()
    (single, loss_s), (dp, loss_dp) = out
    assert loss_s == loss_dp
    for p, q in zip(single.parameters(), dp.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad)

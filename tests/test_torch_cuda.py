"""PyTorch port on the card: each CUDA kernel (and each dtype mode) against
its plain PyTorch version (the version the CPU tests hold to the JAX
package), the fused MISO1 and MISO3 forwards and MISO1 train-step gradients
(float32 and bf16) against the plain path, the bf16 and int8 forwards'
launches, the MVDR stage through the weights kernel (its solve is the
solve kernel's), and the decode's CUDA graph against the eager decode.

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
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (  # noqa: E402
    dense_layer_f64, dense_stack_f64, pd_scms, sim_scms, stencil_f64)
from misonet_tpu_torch.beamforming.mvdr import mvdr_beamform  # noqa: E402
from misonet_tpu_torch.config import ModelConfig  # noqa: E402
from misonet_tpu_torch.inference.separate import make_full_array_decode  # noqa: E402
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
from misonet_tpu_torch.ops.kernels.mvdr_weights import (  # noqa: E402
    mvdr_weights,
    mvdr_weights_plain,
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
from misonet_tpu_torch.utils import profiling  # noqa: E402

ATOL = 1e-4
BF16_ATOL = 1e-2
BF16 = torch.bfloat16


def _counts(**nonzero):
    """The launch counts of a run that launched only ``nonzero``."""
    return {"dense_stack": 0, "dense_stack_bf16": 0, "stencil": 0,
            "stencil_bf16": 0, "stencil_bwd": 0, "stencil_bwd_bf16": 0,
            "hermitian_solve": 0, "dense_stack_int8": 0, "dense_layer": 0,
            "dense_layer_bf16": 0, "mvdr_weights": 0, **nonzero}


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
    """Speakers x chunks x bins in one call: one mvdr_weights launch (and
    no hermitian_solve launch: the weights kernel solves); the result
    agrees with the CPU path (the plain versions) to 1e-3 of max-abs."""
    rng = np.random.default_rng(9)
    shape = (3, 2, 6, 50, 129)            # chunks, speakers, mics, T, F
    src = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    mix = src.sum(1) + 0.1 * (rng.standard_normal((3, 6, 50, 129))
                              + 1j * rng.standard_normal((3, 6, 50, 129)))
    src = torch.from_numpy(src.astype(np.complex64))
    mix = torch.from_numpy(mix.astype(np.complex64))[:, None]
    before = hermitian_solve.launches, mvdr_weights.launches
    got = mvdr_beamform(src.cuda(), mix.cuda())
    torch.cuda.synchronize()
    assert (hermitian_solve.launches, mvdr_weights.launches) == (
        before[0], before[1] + 1)
    want = mvdr_beamform(src, mix)
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 1e-3 * scale


# [rows, F, M] of chip_smoke.py phase 8 (utterance and chunk mode, M = 8 at
# F = 257), and edges: one bin, odd M and ref_ch, a row over several rounds
# of its blocks (F = 2,500: 313 bins a block, 256 a round)
WEIGHT_CASES = [((2, 129, 6), 0), ((8, 129, 6), 0), ((2, 257, 8), 0),
                ((1, 1, 6), 0), ((3, 17, 4), 2), ((1, 2500, 2), 1),
                ((2, 33, 7), 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ref_ch", WEIGHT_CASES)
def test_mvdr_weights_kernel_matches_plain(cuda, shape, ref_ch):
    """The kernel against its plain version run in complex128 on near-rank-1
    SCMs (chip_smoke.py's sim_scms): 1e-4 of max-abs; one launch a call."""
    rows, f, m = shape
    rs, rn = sim_scms(np.random.default_rng(10), rows, f, m)
    before = mvdr_weights.launches
    got = mvdr_weights(rs, rn, ref_ch)
    want = mvdr_weights_plain(rs.to(torch.complex128),
                              rn.to(torch.complex128), ref_ch)
    torch.cuda.synchronize()
    assert mvdr_weights.launches == before + 1
    assert got.shape == (rows, f, m) and got.dtype == torch.complex64
    _close(torch.view_as_real(got), torch.view_as_real(want.to(got.dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 129, 6), (8, 129, 6), (2, 257, 8)])
def test_mvdr_weights_kernel_on_unstructured_scms(cuda, shape):
    """Unstructured PD SCMs (small spectral gaps): within max(1e-3, 2x the
    complex64 plain version's own error) of complex128."""
    rows, f, m = shape
    rs, rn = pd_scms(np.random.default_rng(11), rows, f, m)
    want = mvdr_weights_plain(rs.to(torch.complex128),
                              rn.to(torch.complex128))
    scale = want.abs().max().item()
    own = (mvdr_weights_plain(rs, rn) - want).abs().max().item() / scale
    got = mvdr_weights(rs, rn)
    err = (got.to(want.dtype) - want).abs().max().item() / scale
    assert err <= max(1e-3, 2 * own), (err, own)


@pytest.mark.cuda
def test_mvdr_weights_kernel_repeats_and_guards(cuda):
    """Bit-identical repeats; a zero source SCM takes the 1/sqrt(M) start
    and keeps it (every trip's |w| is 0), as the plain version does."""
    rs, rn = sim_scms(np.random.default_rng(12), 2, 129, 6)
    assert torch.equal(mvdr_weights(rs, rn), mvdr_weights(rs, rn))
    rs[1, 5] = 0
    got = mvdr_weights(rs, rn)
    want = mvdr_weights_plain(rs.to(torch.complex128),
                              rn.to(torch.complex128))
    assert torch.isfinite(got).all()
    _close(torch.view_as_real(got), torch.view_as_real(want.to(got.dtype)))


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


# the example programs' functions (misonet_tpu_torch/examples) on the card
# at the narrow 7-level bf16 plan over 6 mics and 4,000-sample (63-frame)
# voiced utterances, with chip_smoke.py phase 23's launch counts
NARROW = ModelConfig(en_channels=(8, 8, 8, 8, 8, 16, 16),
                     de_channels=(16, 16, 8, 8, 8, 8, 8), tcn_repeats=1,
                     tcn_blocks=2, tcn_channels=16)


@pytest.fixture(scope="module")
def ladder_corpus():
    from misonet_tpu_torch.examples.common import make_corpus

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_corpus(8, 2, 4000, 6, voiced=True, device="cuda")


@pytest.mark.cuda
def test_train_separator_on_the_card(cuda, ladder_corpus):
    """train_synthetic's loop: 50 / 10 / 60 bf16 launches a step, the CUDA
    events' time, finite losses; its scorer 50 / 10 a held-out
    utterance."""
    from misonet_tpu_torch.config import StftConfig
    from misonet_tpu_torch.examples.common import (
        score_separator, train_separator)
    from misonet_tpu_torch.examples.train_synthetic import build_miso1

    model = build_miso1(NARROW, 6, cuda)
    reset_launch_counts()
    _, log = train_separator(model, StftConfig(), ladder_corpus, 3, 2,
                             every=1)
    assert launch_counts() == _counts(dense_stack_bf16=150, stencil_bf16=30,
                                      stencil_bwd_bf16=180)
    assert [it for it, _, _ in log.points] == [0, 1, 2]
    assert all(np.isfinite(loss) for _, loss, _ in log.points)
    assert log.event_ms is not None and log.step_ms > 0
    reset_launch_counts()
    base, sep = score_separator(model, StftConfig(), ladder_corpus.evals)
    assert launch_counts() == _counts(dense_stack_bf16=100, stencil_bf16=20)
    assert np.isfinite(base) and np.isfinite(sep)


@pytest.mark.cuda
@pytest.mark.parametrize("joint", [False, True], ids=["miso3", "miso2"])
def test_train_enhancer_on_the_card(cuda, ladder_corpus, joint):
    """train_cascade's stage 3: a step decodes the batch's 6 shifts in one
    forward (50 / 10), takes every speaker's MVDR weights in one launch
    and trains the enhancement net (50 / 10 / 60); eval_stages scores
    every stage."""
    from misonet_tpu_torch.config import StftConfig
    from misonet_tpu_torch.examples import train_cascade

    miso1, enh = train_cascade.build_models(NARROW, cuda, joint)
    stage2 = train_cascade.Stage2(miso1, StftConfig(), joint)
    reset_launch_counts()
    _, log = train_cascade.train_enhancer(enh, stage2, ladder_corpus, 2, 2,
                                          every=1)
    assert launch_counts() == _counts(dense_stack_bf16=200, stencil_bf16=40,
                                      stencil_bwd_bf16=120, mvdr_weights=2)
    assert all(np.isfinite(loss) for _, loss, _ in log.points)
    scores = train_cascade.eval_stages(enh, stage2, ladder_corpus.evals)
    assert list(scores) == ["mixture", "miso1", "mvdr",
                            "miso2" if joint else "miso3"]
    assert all(np.isfinite(v) for v in scores.values())


@pytest.mark.cuda
def test_demo_checkpoint_round_trip_and_int8_decode(cuda, ladder_corpus,
                                                    tmp_path):
    """train_synthetic's "demo" state saved and restored by eval_int8:
    the parameters bit for bit; the bf16 decode 50 / 10 and the int8
    decode 50 int8 / 10 bf16 launches a held-out utterance."""
    from misonet_tpu_torch.config import StftConfig
    from misonet_tpu_torch.examples import eval_int8
    from misonet_tpu_torch.examples.common import DEMO_TAG, train_separator
    from misonet_tpu_torch.examples.train_synthetic import build_miso1
    from misonet_tpu_torch.utils.checkpoint import save_checkpoint

    model = build_miso1(NARROW, 6, cuda)
    state, _ = train_separator(model, StftConfig(), ladder_corpus, 2, 2)
    save_checkpoint(tmp_path, DEMO_TAG, state, {"si_sdr": 0.5})
    m16, m8, meta = eval_int8.restore(str(tmp_path), NARROW, 6, cuda)
    assert meta == {"si_sdr": 0.5}
    for m in (m16, m8):
        saved, got = model.state_dict(), m.state_dict()
        assert saved.keys() == got.keys()
        assert all(torch.equal(saved[k], got[k]) for k in saved)
    reset_launch_counts()
    r = eval_int8.evaluate(m16, m8, StftConfig(), ladder_corpus.evals)
    assert launch_counts() == _counts(dense_stack_bf16=100, stencil_bf16=40,
                                      dense_stack_int8=100)
    assert all(np.isfinite(v) for v in r.values())
    assert r["cost"] == r["bf16"] - r["int8"]


@pytest.mark.cuda
def test_css_longform_on_the_card(cuda):
    """css_longform's passes over a 3-block voiced scene: 50 / 10 bf16 and
    1 mvdr_weights launches a block, finite scores."""
    from misonet_tpu_torch.config import DatasetConfig, StftConfig
    from misonet_tpu_torch.data.synthetic import synth_mixture
    from misonet_tpu_torch.examples import css_longform
    from misonet_tpu_torch.inference.css import StreamingCSS

    ds = DatasetConfig(chunk_time=0.5)          # 4,000-sample blocks
    n = 3 * ds.chunk_samples
    scene = synth_mixture(20_000, n, 6, voiced=True)
    model = make_miso1(NARROW, device=cuda,
                       generator=torch.Generator().manual_seed(0))
    css = StreamingCSS(model, StftConfig(), ds)
    for overlap in css_longform.passes(ds):
        hop = ds.chunk_samples - overlap
        blocks = -(-(n - overlap) // hop)
        reset_launch_counts()
        (row,) = css_longform.run_css(css, scene["mix"], scene["ref"],
                                      n / ds.fs, (overlap,))
        assert launch_counts() == _counts(dense_stack_bf16=50 * blocks,
                                          stencil_bf16=10 * blocks,
                                          mvdr_weights=blocks)
        assert all(np.isfinite(row[k]) for k in ("mixture", "miso1", "mvdr"))


def _mixes(rng, n, shape):
    return [torch.complex(_t(rng, shape), _t(rng, shape)) for _ in range(n)]


def _eager(decode, xs):
    """The eager decode of each mix and the launches of one."""
    with torch.inference_mode():
        reset_launch_counts()
        out = [decode.graphs.forward(x) for x in xs]
        counts = {k: v // len(xs) for k, v in launch_counts().items()}
    return out, counts


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,batch", [
    (ModelConfig(), 1),                             # a CSS block, bf16
    (ModelConfig(compute_dtype="float32"), 1),
    (ModelConfig(quant_int8=True), 1),
    (ModelConfig(), 2),                             # the cascade's 2 chunks
], ids=["bf16", "float32", "int8", "bucket2"])
def test_graphed_decode_equals_eager(cuda, cfg, batch, monkeypatch):
    """The SMS-WSJ plan's decode at [batch, 6, 501, 129]: the first call
    eager, the second captured and replayed, the rest replayed, each the
    eager decode's bits and one forward's launches (50 dense_stack of the
    mode, 10 bf16 or float32 stencil).  In float32 cuDNN's default engines
    for the plain levels' convs do not repeat their own bits (about 2e-6
    apart from call to call), so that case takes its deterministic ones."""
    if cfg.compute_dtype == "float32":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = make_miso1(cfg, device=cuda,
                       generator=torch.Generator().manual_seed(1))
    decode = make_full_array_decode(model, 6)
    xs = _mixes(np.random.default_rng(4), 3, (batch, 6, 501, 129))
    want, per_call = _eager(decode, xs)
    dense = ("dense_stack_int8" if cfg.quant_int8 else
             "dense_stack" if cfg.compute_dtype == "float32" else
             "dense_stack_bf16")
    stencil_mode = "stencil" if cfg.compute_dtype == "float32" else "stencil_bf16"
    assert per_call == _counts(**{dense: 50, stencil_mode: 10})
    for i, x in enumerate(xs + xs):
        reset_launch_counts()
        got = decode(x)
        assert launch_counts() == per_call, i
        assert got.shape == want[i % 3].shape and torch.equal(got, want[i % 3]), i
    (graph,) = decode.graphs.entries.values()
    assert graph.graph is not None


@pytest.mark.cuda
def test_graphed_decode_recaptures_after_new_weights(cuda):
    """A ``load_state_dict`` drops the graph: the next call runs eagerly,
    the one after captures again, and the replays give the new weights'
    decode (``decode.capture`` counted twice, ``decode.replay`` 4 times)."""
    from torch.profiler import ProfilerActivity, profile

    model = make_miso1(NARROW, device=cuda,
                       generator=torch.Generator().manual_seed(1))
    other = make_miso1(NARROW, device=cuda,
                       generator=torch.Generator().manual_seed(2)).state_dict()
    decode = make_full_array_decode(model, 6)
    (x,) = _mixes(np.random.default_rng(5), 1, (1, 6, 64, 129))
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        (old,), _ = _eager(decode, [x])
        first = [decode(x) for _ in range(3)]
        model.load_state_dict(other)
        (new,), _ = _eager(decode, [x])
        second = [decode(x) for _ in range(3)]
        counts = profiling.records()["counts"]
    profiling.reset()
    assert counts["decode.capture"] == 2 and counts["decode.replay"] == 4
    assert not torch.equal(old, new)
    assert all(torch.equal(g, old) for g in first)
    assert all(torch.equal(g, new) for g in second)


@pytest.mark.cuda
def test_graphed_decode_serves_two_threads(cuda):
    """Two threads, one on its own stream, decode their own mixes through
    the same graph 200 times each: every result is its own mix's."""
    model = make_miso1(NARROW, device=cuda,
                       generator=torch.Generator().manual_seed(1))
    decode = make_full_array_decode(model, 6)
    xs = _mixes(np.random.default_rng(6), 2, (1, 6, 64, 129))
    want, _ = _eager(decode, xs)
    streams = [None, torch.cuda.Stream()]

    def serve(i):
        with torch.cuda.stream(streams[i]):
            outs = [decode(xs[i]) for _ in range(200)]
            torch.cuda.current_stream().synchronize()
        return outs

    with ThreadPoolExecutor(max_workers=2) as tp:
        got = list(tp.map(serve, range(2)))
    for i in range(2):
        bad = sum(not torch.equal(g, want[i]) for g in got[i])
        assert bad == 0, (i, bad)
    assert len(decode.graphs.entries) == 1


@pytest.mark.cuda
def test_graphed_decode_captures_beside_eager_work(cuda):
    """The cascade's two clients at two buckets: one thread decodes its
    1-chunk mix 12 times (eager, capture, replays) while the other decodes
    2-chunk mixes at shapes it has not seen (each first call eager, each
    second a capture beside the first thread's replays), beamforms them and
    reads both back.  Every decode is its own mix's eager decode."""
    model = make_miso1(NARROW, device=cuda,
                       generator=torch.Generator().manual_seed(1))
    decode = make_full_array_decode(model, 6)
    rng = np.random.default_rng(7)
    (a,) = _mixes(rng, 1, (1, 6, 64, 129))
    bs = [_mixes(rng, 1, (2, 6, t, 129))[0] for t in range(40, 56)]
    (want_a,), _ = _eager(decode, [a])
    want_b, _ = _eager(decode, bs)
    started, finished = threading.Event(), threading.Event()

    def graphed():
        started.wait()
        outs = [decode(a).cpu() for _ in range(12)]
        finished.set()
        return outs

    def eager():
        outs, k = [], 0
        with torch.cuda.stream(torch.cuda.Stream()):
            while not finished.is_set() or k < 2 * len(bs):
                i = k % len(bs)
                est = decode(bs[i])
                y = mvdr_beamform(est[:, 0], bs[i])
                outs.append((i, est.cpu(), y.cpu()))
                started.set()
                k += 1
        return outs

    with ThreadPoolExecutor(max_workers=2) as tp:
        fa, fb = tp.submit(graphed), tp.submit(eager)
        got_a, got_b = fa.result(), fb.result()
    assert all(torch.equal(g, want_a.cpu()) for g in got_a)
    bad = [k for k, (i, est, y) in enumerate(got_b)
           if not torch.equal(est, want_b[i].cpu())
           or not torch.isfinite(torch.view_as_real(y)).all()]
    assert bad == [], (bad, len(got_b))
    assert decode.graphs.entries[decode.graphs.key(a)].graph is not None


@pytest.mark.cuda
def test_graphed_decode_survives_a_failed_capture(cuda):
    """A capture that the card refuses (here a host sync inside it) leaves
    the key clean: that call returns the eager decode with one forward's
    launches, the next call captures, and its replays match."""
    from torch.profiler import ProfilerActivity, profile

    model = make_miso1(NARROW, device=cuda,
                       generator=torch.Generator().manual_seed(1))
    decode = make_full_array_decode(model, 6)
    (x,) = _mixes(np.random.default_rng(8), 1, (1, 6, 64, 129))
    (want,), per_call = _eager(decode, [x])
    forward, fail = decode.graphs.forward, [True]

    def flaky(mix):
        out = forward(mix)
        if fail and torch.cuda.is_current_stream_capturing():
            fail.clear()
            torch.cuda.current_stream().synchronize()
        return out

    decode.graphs.forward = flaky
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got, counts = [], []
        for _ in range(5):
            reset_launch_counts()
            got.append(decode(x))
            counts.append(launch_counts())
        tally = profiling.records()["counts"]
    profiling.reset()
    assert not fail and counts == [per_call] * 5
    assert all(torch.equal(g, want) for g in got)
    assert tally["decode.capture"] == 1 and tally["decode.replay"] == 3


@pytest.mark.cuda
def test_graphed_decode_follows_the_config(cuda, monkeypatch):
    """A switch of ``model.cfg`` to the plain modules between graphed
    decodes at one shape gives the plain decode and no kernel launches, and
    the switch back the fused graph's decode and its launches (a graph
    stands for one config).  cuDNN's deterministic engines, so that the
    plain path repeats its own bits."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = make_miso1(NARROW, device=cuda,
                       generator=torch.Generator().manual_seed(1))
    decode = make_full_array_decode(model, 6)
    (x,) = _mixes(np.random.default_rng(9), 1, (1, 6, 64, 129))
    fused_cfg = model.cfg
    plain_cfg = dataclasses.replace(fused_cfg, flat_dense=False)
    (fused,), fused_launches = _eager(decode, [x])
    model.cfg = plain_cfg
    (plain,), plain_launches = _eager(decode, [x])
    assert not torch.equal(fused, plain)
    assert plain_launches == _counts()
    for cfg, want, launches in [(fused_cfg, fused, fused_launches),
                                (plain_cfg, plain, plain_launches),
                                (fused_cfg, fused, fused_launches)]:
        model.cfg = cfg
        for i in range(3):
            reset_launch_counts()
            got = decode(x)
            assert launch_counts() == launches, (cfg.flat_dense, i)
            assert torch.equal(got, want), (cfg.flat_dense, i)
    assert all(e.graph is not None for e in decode.graphs.entries.values())
    assert len(decode.graphs.entries) == 2


@pytest.mark.cuda
def test_stencil_launches_from_two_threads(cuda):
    """PERF.md's witness of the two-thread launch fault: the bf16 stencil
    up mode at 7 and 15 input bins, 20,000 launches on each of two threads,
    none refused (each kernel's shared-memory limit is set once)."""
    rng = np.random.default_rng(16)
    args = [_stencil_bf16_args(rng, "up", 32, 32, f_in, 16, b=1)
            for f_in in (7, 15)]

    def launch(a):
        failed = 0
        for _ in range(20_000):
            try:
                stencil(*a, "up")
            except RuntimeError:
                failed += 1
        return failed

    with ThreadPoolExecutor(max_workers=2) as tp:
        failed = list(tp.map(launch, args))
    torch.cuda.synchronize()
    assert failed == [0, 0]

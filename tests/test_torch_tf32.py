"""The float32 kernels' TF32 arithmetic on the CPU (csrc/conv_mma.cuh:
``tc::split_tf32`` and ``tc::mma3``), through its plain twin
``tc_pack.tf32_split``: the rounding to TF32 on hand-picked bit patterns,
the split's reconstruction, and a float64 emulation of the three TF32
products (big big + big small + small big) through the packed weights and
the dense_stack / dense_layer call's 16-channel chunks, and each mode's
dgrad and wgrad maps (Python transcriptions of tc::Geo), against the
float64 conv and backward of the float32 operands.  The three passes
stay within 1e-5 of max-abs (float32's class, the card tests' bound);
one pass misses by more than ten times that.  No JAX, no card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from misonet_tpu_torch.ops.kernels.stencil import out_bins  # noqa: E402
from misonet_tpu_torch.ops.kernels.stencil_bwd import (  # noqa: E402
    stencil_bwd_plain,
)
from misonet_tpu_torch.ops.kernels.tc_pack import (  # noqa: E402
    packed,
    tf32_round,
    tf32_split,
)

F64_BOUND = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(bits):
    return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)


def _bits(x):
    return x.view(torch.int32).item() & 0xFFFFFFFF


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),   # 1.0: already TF32
    (0x3F800FFF, 0x3F800000),   # below half of the dropped field: down
    (0x3F801000, 0x3F802000),   # exactly half: a tie, away from zero
    (0xBF801000, 0xBF802000),   # the same tie below zero: away from zero
    (0x3F803000, 0x3F804000),   # a tie with an odd kept field: away too
    (0x3F801001, 0x3F802000),   # above half: up
    (0x3FFFF000, 0x40000000),   # a tie that carries into the exponent
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x00000FFF, 0x00000000),   # a subnormal below half: to zero
])
def test_tf32_round_is_cvt_rna(bits, want):
    """Rounding to 10 explicit mantissa bits, to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: the low 13 bits end zero."""
    got = _bits(tf32_round(_f32(bits)))
    assert got == want, (hex(bits), hex(got), hex(want))
    assert got & 0x1FFF == 0


def test_tf32_split_rebuilds_x():
    """big + small is x within 2^-21 relative (the split drops the part of
    x - big below TF32's 11 bits: about 2^-22 of x); both parts are
    TF32 values, and small is at most half an ulp of big."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(20000)
                          * 10.0 ** rng.uniform(-30, 30, 20000)).astype(
                              np.float32))
    big, small = tf32_split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    xd = x.double()
    rel = ((big.double() + small.double() - xd).abs() / xd.abs()).max()
    assert rel.item() <= 2.0 ** -21
    assert ((small.double().abs() / xd.abs()).max().item()
            <= 2.0 ** -11 * (1 + 2.0 ** -10))


def test_tf32_round_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 only"):
        tf32_round(torch.zeros(3, dtype=torch.float64))


# ---- the dense_stack / dense_layer call (csrc/dense_stack.cu) ----------------

def _chunks(xn, wp, widths):
    """The float32 call's reduction as the kernel runs it: per source
    (padded to its own groups of 4) and chunk of 4 groups (16 channels),
    the normalized window split (tf32_split) times the packed planes
    ``wp`` [2, G, 9, N, 4], three passes summed in float64, then the
    chunks summed; and the one-pass (big big) sum beside it."""
    three = one = 0
    goff = 0
    for x in torch.split(xn, list(widths), dim=1):
        c = x.shape[1]
        groups = -(-c // 4)
        xb, xs = (F.pad(v, (0, 0, 0, 0, 0, 4 * groups - c)).double()
                  for v in tf32_split(x.contiguous()))
        for g0 in range(0, groups, 4):
            gs = slice(goff + g0, goff + min(g0 + 4, groups))
            # [2, g, 9, N, 4] -> conv weights [N, 4 g, 3, 3]
            wb, ws = (p.permute(2, 0, 3, 1).reshape(p.shape[2], -1, 3, 3)
                      for p in wp[:, gs].double())
            cs = slice(4 * g0, 4 * min(g0 + 4, groups))

            def conv(xv, wv):
                return F.conv2d(xv[:, cs], wv, padding=1)

            big = conv(xb, wb)
            three = three + (conv(xs, wb) + conv(xb, ws) + big)
            one = one + big
        goff += groups
    return three, one


@pytest.mark.parametrize("widths,n,with_acc", [
    ((24,), 20, False),     # one source, a chunk of 16 and one of 8
    ((8, 5), 24, False),    # two sources, each padded to its own groups
    ((12,), 16, True),      # acc_in added to the chunks' sum
    ((8, 6, 5), 24, False),  # a dense_layer call over three sources
])
def test_dense_stack_tf32_passes_compute_the_float32_call(widths, n,
                                                          with_acc):
    """The float32 dense_stack / dense_layer reduction: the weight packed
    as the kernel reads it (``packed`` of a float32 weight: two TF32
    planes, groups of 4 per source), the normalized window split, three
    passes per 16-channel chunk; within F64_BOUND of the float64 conv of
    the float32 operands (+ acc_in), one pass not."""
    rng = np.random.default_rng(300 + sum(widths) + n)
    b, t, f = 2, 7, 9
    c = sum(widths)

    def rand(shape, lo=None, hi=None):
        v = (rng.uniform(lo, hi, shape) if lo is not None
             else rng.standard_normal(shape))
        return torch.from_numpy(v.astype(np.float32))

    x, w = rand((b, c, t, f)), rand((n, c, 3, 3))
    scale, mean = rand((b, c), 0.5, 1.5), rand((b, c), -0.5, 0.5)
    acc = rand((b, n, t, f)) if with_acc else None
    xn = (x - mean[:, :, None, None]) * scale[:, :, None, None]
    wp = packed(w, widths)
    assert wp.shape == (2, sum(-(-w_ // 4) for w_ in widths), 9, n, 4)
    want = F.conv2d(xn.double(), w.double(), padding=1)
    three, one = _chunks(xn, wp, widths)
    if acc is not None:
        want, three, one = (v + acc.double() for v in (want, three, one))
    assert _within(three, want) <= F64_BOUND
    assert _within(one, want) > 10 * F64_BOUND


# ---- the dgrad and wgrad roles (csrc/stencil_bwd.cu) ------------------------

# tc::Map: (source column of column f at freq tap kf, -1 where none; the
# sign TS of the time tap: source row t + TS (kt - 1))
MAPS = {
    "same": (lambda f, kf: f + kf - 1, 1),
    "same_t": (lambda f, kf: f - kf + 1, -1),
    "shift": (lambda f, kf: f + kf, 1),
    "shift_t": (lambda f, kf: f - kf, -1),
    "double": (lambda f, kf: 2 * f + kf, 1),
    "half_t": (lambda f, kf: torch.where((f - kf) % 2 == 0,
                                         torch.div(f - kf, 2,
                                                   rounding_mode="floor"),
                                         -1), -1),
}
# stencil_bwd.cu's kDgradMap and kWgradMap
DGRAD_MAP = {"dense": "same_t", "enc0": "shift_t", "down": "half_t",
             "up": "double", "final": "shift"}
WGRAD_MAP = {"dense": "same", "enc0": "shift", "down": "double",
             "up": "half_t", "final": "shift_t"}


def _gather(src, map_name, tap, f_out):
    """src [B, R, T, Fs] read at tap through a map: [B, R, T, f_out], zero
    where the map reads outside the plane (or a tap of the other parity)."""
    col_of, ts_sign = MAPS[map_name]
    b, r, t, fs_n = src.shape
    kt, kf = divmod(tap, 3)
    fs = col_of(torch.arange(f_out), kf)
    ts = torch.arange(t) + ts_sign * (kt - 1)
    ok = (((ts >= 0) & (ts < t))[:, None]
          & ((fs >= 0) & (fs < fs_n))[None, :])
    out = src[:, :, ts.clamp(0, t - 1)][..., fs.clamp(0, fs_n - 1)]
    return out * ok


def _dgrad(g, wp, mode, f_in):
    """G [B, C, T, F_in] as dgrad_tc_kernel reduces it: over units (group
    of 4 cotangent channels, tap), g read through the mode's dgrad map,
    times the weight packed [G4, 9, C, 4] with output c and reduced n."""
    b, n, t, _ = g.shape
    groups = wp.shape[0]
    gp = F.pad(g, (0, 0, 0, 0, 0, 4 * groups - n))
    out = 0
    for tap in range(9):
        src = _gather(gp, DGRAD_MAP[mode], tap, f_in)
        out = out + torch.einsum("bgetf,gce->bctf",
                                 src.reshape(b, groups, 4, t, f_in),
                                 wp[:, tap])
    return out


def _wgrad(xn, g, mode):
    """dW in the weight's layout as wgrad_tc_kernel reduces it: for each
    (c, tap) row, xn read through the mode's wgrad map at every output
    position, times g, summed over batch and positions."""
    f_out = g.shape[-1]
    cols = torch.stack([_gather(xn, WGRAD_MAP[mode], tap, f_out)
                        for tap in range(9)], dim=2)   # [B, C, 9, T, Fo]
    dw = torch.einsum("bcjtf,bntf->ncj", cols, g)
    dw = dw.reshape(dw.shape[0], dw.shape[1], 3, 3)
    return dw.transpose(0, 1) if mode in ("up", "final") else dw


BWD_CASES = [
    ("dense", 12, 20, 9), ("dense", 5, 8, 4), ("enc0", 12, 24, 13),
    ("down", 12, 8, 15), ("down", 5, 33, 7), ("up", 16, 12, 6),
    ("up", 3, 5, 1), ("final", 12, 4, 9), ("final", 8, 2, 5),
]


def _operands(mode, c, n, f_in, seed):
    rng = np.random.default_rng(seed)
    b, t = 2, 7
    f_out = f_in if mode == "dense" else out_bins(mode, f_in)
    wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)

    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return rand((b, n, t, f_out)), rand((b, c, t, f_in)), rand(wshape)


def _within(got, want):
    """Max-abs error of got against want over want's max-abs."""
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("mode,c,n,f_in", BWD_CASES)
def test_dgrad_tf32_passes_compute_the_float32_dgrad(mode, c, n, f_in):
    """The dgrad's role: g (the window) split, and the weight packed as
    the kernel reads it, with output c and reduced n
    (``packed`` of a float32 weight: groups of 4, big and small planes); the
    three products through the dgrad map equal the float64 input
    gradient of the float32 operands within F64_BOUND, one pass does not."""
    g, x, w = _operands(mode, c, n, f_in, 100 + c + n)
    want = stencil_bwd_plain(g.double(), [x.double()], w.double(), None,
                             None, mode)[0][0]
    transpose = mode not in ("up", "final")
    gb, gs = tf32_split(g)
    wb, ws = packed(w, (n,), transpose=transpose).double()
    assert wb.shape == (-(-n // 4), 9, c, 4)

    def dgrad(gv, wp):
        return _dgrad(gv.double(), wp, mode, f_in)

    three = dgrad(gs, wb) + dgrad(gb, ws) + dgrad(gb, wb)
    assert _within(three, want) <= F64_BOUND
    assert _within(dgrad(gb, wb), want) > 10 * F64_BOUND


@pytest.mark.parametrize("mode,c,n,f_in", BWD_CASES)
def test_wgrad_tf32_passes_compute_the_float32_wgrad(mode, c, n, f_in):
    """The wgrad's role: the normalized input (A, read through the wgrad
    map) and g (B), each split; the three products equal the float64
    weight gradient of the float32 operands within F64_BOUND, in the
    weight's own layout, one pass does not."""
    g, x, w = _operands(mode, c, n, f_in, 200 + c + n)
    want = stencil_bwd_plain(g.double(), [x.double()], w.double(), None,
                             None, mode, need_dx=False)[1]
    (xb, xs), (gb, gs) = tf32_split(x), tf32_split(g)

    def wgrad(xv, gv):
        return _wgrad(xv.double(), gv.double(), mode)

    three = wgrad(xs, gb) + wgrad(xb, gs) + wgrad(xb, gb)
    assert three.shape == w.shape
    assert _within(three, want) <= F64_BOUND
    assert _within(wgrad(xb, gb), want) > 10 * F64_BOUND

"""The weight layouts of the tensor-core kernels (ops/kernels/tc_pack.py),
on the CPU: every packed element against the ``[O, R, 3, 3]`` weight it
came from (tap order, the per-source zero padding of the reduced channels,
the transposed roles of stencil_bwd's dgrad), a conv computed from the
packed layout against ``F.conv2d``, and the cache per weight tensor and
version; the int8 rows' layout (``pack_int8_rows``: every quantized weight
placed, each source padded to 16 channels, the integer conv gathered from
it equal to the plain one); the bf16 stencil's four modes gathered from
their packed weights through Python transcriptions of the kernel's maps.
Exact comparisons where packing only moves values; 1e-12 for the float64
gathers (another summation order), float32 class for the epilogue."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from misonet_tpu_torch.ops.kernels import tc_pack  # noqa: E402
from misonet_tpu_torch.ops.kernels.tc_pack import (  # noqa: E402
    pack_int8_rows,
    pack_tc_weights,
    packed,
)


def _w(rng, shape, dtype=torch.bfloat16):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dtype)


def _reduced_channel(widths, group=8):
    """For each padded group slot (g, e): the reduced channel it holds, or
    -1 for a pad slot."""
    slots, off = [], 0
    for c in widths:
        for k in range(-(-c // group) * group):
            slots.append(off + k if k < c else -1)
        off += c
    return np.array(slots).reshape(-1, group)


@pytest.mark.parametrize("o,widths", [
    (24, (24,)),          # whole groups
    (5, (13,)),           # one source padded 13 -> 16
    (7, (8, 5)),          # two sources, the second padded
    (40, (24, 24)),       # the decoder's skip concat
    (3, (3, 20, 1)),      # three ragged sources
])
def test_pack_places_every_weight(o, widths):
    w = _w(np.random.default_rng(o), (o, sum(widths), 3, 3))
    p = pack_tc_weights(w, widths)
    chan = _reduced_channel(widths)
    assert p.shape == (chan.shape[0], 9, o, 8) and p.dtype == w.dtype
    assert p.is_contiguous()
    for g in range(chan.shape[0]):
        for e in range(8):
            r = chan[g, e]
            for tap in range(9):
                want = (w[:, r, tap // 3, tap % 3] if r >= 0
                        else torch.zeros(o, dtype=w.dtype))
                assert torch.equal(p[g, tap, :, e], want), (g, e, tap)


@pytest.mark.parametrize("o,widths", [
    (24, (12,)),          # MISO1's enc0 input: 3 whole groups of 4
    (5, (3,)),            # one source padded 3 -> 4
    (33, (5,)),           # padded 5 -> 8
    (7, (8, 5)),          # two sources, the second padded
])
def test_pack_f32_places_every_weight(o, widths):
    """group=4, the float32 kernels' layout: [G4, 9, O, 4], each source
    padded to a multiple of 4 channels, every weight at its slot."""
    w = _w(np.random.default_rng(o + 50), (o, sum(widths), 3, 3),
           torch.float32)
    p = pack_tc_weights(w, widths, group=4)
    chan = _reduced_channel(widths, 4)
    assert p.shape == (chan.shape[0], 9, o, 4) and p.dtype == torch.float32
    assert p.is_contiguous()
    for g in range(chan.shape[0]):
        for e in range(4):
            r = chan[g, e]
            for tap in range(9):
                want = (w[:, r, tap // 3, tap % 3] if r >= 0
                        else torch.zeros(o))
                assert torch.equal(p[g, tap, :, e], want), (g, e, tap)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("o,widths", [
    (24, (12,)), (5, (3,)), (33, (5,)), (7, (8, 5)),
])
def test_pack_tf32_places_both_planes(o, widths, transpose):
    """pack_tf32 (on the CPU its plain twin, pack_tf32_plain): [2, G4, 9,
    O, 4], element [p, g, tap, o, e] the big (p = 0) or small (p = 1)
    TF32 part of the weight of output o and reduced channel slot (g, e),
    zero in a pad slot, from the weight as it is or transposed."""
    from misonet_tpu_torch.ops.kernels.tc_pack import (
        pack_tf32, pack_tf32_plain, tf32_split)

    w_or = _w(np.random.default_rng(o + 60), (o, sum(widths), 3, 3),
              torch.float32)
    w = w_or.transpose(0, 1).contiguous() if transpose else w_or
    p = pack_tf32(w, widths, transpose)
    assert torch.equal(p, pack_tf32_plain(w, widths, transpose))
    chan = _reduced_channel(widths, 4)
    assert p.shape == (2, chan.shape[0], 9, o, 4) and p.is_contiguous()
    big, small = tf32_split(w_or)
    for g in range(chan.shape[0]):
        for e in range(4):
            r = chan[g, e]
            for tap in range(9):
                kt, kf = divmod(tap, 3)
                for plane, part in enumerate((big, small)):
                    want = (part[:, r, kt, kf] if r >= 0
                            else torch.zeros(o))
                    assert torch.equal(p[plane, g, tap, :, e], want)


@pytest.mark.parametrize("mode_transposed", [False, True])
def test_dgrad_packing_swaps_the_roles(mode_transposed):
    """stencil_bwd's dgrad reduces over the cotangent channels n and
    outputs the input channels c: a [N, C, 3, 3] weight (dense, enc0,
    down) is packed transposed, a [C, N, 3, 3] one (up, final) as it is;
    both give element [g, tap, c, e] = W(n = 8 g + e, c, tap)."""
    rng = np.random.default_rng(4)
    n, c = 4, 48                  # MISO1's final layer: N = 4 of 8 slots
    w_nc = _w(rng, (n, c, 3, 3))
    w = w_nc.transpose(0, 1).contiguous() if mode_transposed else w_nc
    p = packed(w, (n,), transpose=not mode_transposed)
    assert p.shape == (1, 9, c, 8)
    for tap in range(9):
        kt, kf = divmod(tap, 3)
        assert torch.equal(p[0, tap, :, :n], w_nc[:, :, kt, kf].t())
    assert not p[..., n:].any()


def _conv_from_packed(xs, p, widths):
    """The SAME 3x3 conv as the tensor-core kernels reduce it: over units
    (group, tap) of 8 channels, each source's channels zero-padded to a
    multiple of 8, from the packed weights alone."""
    padded = [F.pad(x, (0, 0, 0, 0, 0, (-x.shape[1]) % 8)) for x in xs]
    x = torch.cat(padded, dim=1)                       # [B, R', T, F]
    b, r, t, f = x.shape
    cols = F.unfold(x, 3, padding=1).reshape(b, r // 8, 8, 9, t * f)
    out = torch.einsum("bgetp,gtoe->bop", cols, p)
    return out.reshape(b, -1, t, f)


def test_packed_layout_computes_the_conv():
    rng = np.random.default_rng(7)
    widths = (5, 11)
    xs = [_w(rng, (2, c, 6, 9), torch.float64) for c in widths]
    w = _w(rng, (12, sum(widths), 3, 3), torch.float64)
    got = _conv_from_packed(xs, pack_tc_weights(w, widths), widths)
    want = F.conv2d(torch.cat(xs, dim=1), w, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("group", [8, 4])
def test_pack_refuses_widths_that_do_not_sum(group):
    w = torch.zeros(4, 10, 3, 3)
    with pytest.raises(ValueError, match="do not sum"):
        pack_tc_weights(w, (4, 5), group=group)


def test_packed_is_cached_per_tensor_and_version():
    rng = np.random.default_rng(9)
    w = _w(rng, (6, 16, 3, 3))
    first = packed(w, (16,))
    assert packed(w, (16,)) is first                  # the same weights
    other = packed(w, (8, 8))                         # another layout
    assert other is not first and torch.equal(other, first)
    with torch.no_grad():
        w.mul_(2)                                     # an in-place update
    again = packed(w, (16,))
    assert again is not first
    assert torch.equal(again, pack_tc_weights(w, (16,)))
    # an equal tensor elsewhere is packed on its own
    assert packed(w.clone(), (16,)) is not again
    n_before = len(tc_pack._CACHE)
    del w
    gc.collect()
    assert len(tc_pack._CACHE) < n_before             # its entries went too


def test_packed_is_cached_per_layout():
    """A float32 weight packs in the float32 kernels' layout (two TF32
    planes of groups of 4: the split of pack_tc_weights(..., group=4)),
    its bf16 cast in the bf16 kernels' (groups of 8); the two are cached
    apart."""
    from misonet_tpu_torch.ops.kernels.tc_pack import tf32_split

    w = _w(np.random.default_rng(10), (6, 12, 3, 3), torch.float32)
    planes, eight = packed(w, (12,)), packed(w, (12,), dtype=torch.bfloat16)
    assert planes.shape == (2, 3, 9, 6, 4) and eight.shape == (2, 9, 6, 8)
    assert eight.dtype == torch.bfloat16
    big, small = tf32_split(pack_tc_weights(w, (12,), group=4))
    assert torch.equal(planes[0], big) and torch.equal(planes[1], small)
    assert packed(w, (12,)) is planes
    assert packed(w, (12,), dtype=torch.bfloat16) is eight


def test_inference_tensors_are_packed_every_call():
    with torch.inference_mode():
        w = torch.ones(3, 8, 3, 3)
        a, b = packed(w, (8,)), packed(w, (8,))
    assert a is not b and torch.equal(a, b)


def test_serving_packs_each_weight_stack_once():
    """A fused DenseBlock's cached weight stacks are built outside
    inference mode even when the model serves under it, so they keep a
    version counter and their packed copies are cached: a second forward
    packs nothing."""
    from misonet_tpu_torch.models.flat_dense import DenseBlockFlat
    from misonet_tpu_torch.models.blocks import init_parameters

    block = DenseBlockFlat(16, 8, 12)
    init_parameters(block, torch.Generator().manual_seed(3))
    with torch.inference_mode():
        stacks = block.stacked_weights(torch.bfloat16)
        assert not any(w.is_inference() for w in stacks)
        first = [packed(w, (w.shape[1],)) for w in stacks]
        again = [packed(w, (w.shape[1],))
                 for w in block.stacked_weights(torch.bfloat16)]
    assert all(a is b for a, b in zip(first, again))


# ---- the int8 rows (csrc/dense_stack_int8.cu) --------------------------------

def _int8_slots(widths):
    """For each padded 16-channel slot (g, e): the reduced channel it holds,
    or -1 for a pad slot."""
    slots, off = [], 0
    for c in widths:
        for k in range(-(-c // 16) * 16):
            slots.append(off + k if k < c else -1)
        off += c
    return np.array(slots).reshape(-1, 16)


def _qw(rng, b, n, c):
    return torch.from_numpy(rng.integers(-127, 128, (b, n, 9, c))).to(
        torch.int8)


INT8_WIDTHS = [(24,), (32,), (64,), (24, 24), (32, 32)]


@pytest.mark.parametrize("widths", INT8_WIDTHS)
def test_pack_int8_rows_places_every_weight(widths):
    rng = np.random.default_rng(sum(widths))
    b, n = 2, 5
    qw = _qw(rng, b, n, sum(widths))
    p = pack_int8_rows(qw, widths)
    slots = _int8_slots(widths)
    assert p.shape == (b, slots.shape[0], 9, n, 16)
    assert p.dtype == torch.int8 and p.is_contiguous()
    for g in range(slots.shape[0]):
        for e in range(16):
            r = slots[g, e]
            want = (qw[:, :, :, r].transpose(1, 2) if r >= 0
                    else torch.zeros(b, 9, n, dtype=torch.int8))
            assert torch.equal(p[:, g, :, :, e], want), (g, e)


def _int_conv_from_packed(qxs, p):
    """The SAME 3x3 integer conv as the int8 tensor-core kernel reduces it:
    over units (group, tap) of 16 channels, each source zero-padded to a
    multiple of 16, one weight set per batch element, from the packed rows
    alone (float64 holds every sum exactly)."""
    padded = [F.pad(x, (0, 0, 0, 0, 0, (-x.shape[1]) % 16)) for x in qxs]
    x = torch.cat(padded, dim=1)                        # [B, 16 G, T, F]
    b, r, t, f = x.shape
    cols = F.unfold(x, 3, padding=1).reshape(b, r // 16, 16, 9, t * f)
    out = torch.einsum("bgetp,bgtne->bnp", cols, p.double())
    return out.reshape(b, -1, t, f)


@pytest.mark.parametrize("widths", INT8_WIDTHS)
def test_packed_int8_rows_compute_the_conv(widths):
    """The integer conv gathered from the packed layout equals the plain
    integer conv of qw (per batch element), exactly."""
    rng = np.random.default_rng(40 + sum(widths))
    b, n, t, f = 2, 6, 5, 7
    qw = _qw(rng, b, n, sum(widths))
    qxs = [torch.from_numpy(rng.integers(-127, 128, (b, c, t, f))).double()
           for c in widths]
    got = _int_conv_from_packed(qxs, pack_int8_rows(qw, widths))
    x = torch.cat(qxs, dim=1)
    c = x.shape[1]
    wq = qw.double().permute(0, 1, 3, 2).reshape(b * n, c, 3, 3)
    want = F.conv2d(x.reshape(1, b * c, t, f), wq, padding=1,
                    groups=b).reshape(b, n, t, f)
    assert torch.equal(got, want)


def test_pack_int8_rows_refuses_widths_that_do_not_sum():
    with pytest.raises(ValueError, match="do not sum"):
        pack_int8_rows(torch.zeros(1, 2, 9, 10, dtype=torch.int8), (4, 4))


# ---- the bf16 stencil's gather geometry (csrc/stencil.cu) --------------------

# Python transcriptions of tc::Geo (csrc/conv_mma.cuh) for the stencil's
# maps and of stencil.cu's UpGeo parity planes: (TS, taps, lo(f0),
# width(tw), col(f, kf, lo)).
_ALL_TAPS = tuple(range(9))
_GEO = {
    "shift": (1, _ALL_TAPS, lambda f0: f0, lambda tw: tw + 2,
              lambda f, kf, lo: f + kf - lo),
    "double": (1, _ALL_TAPS, lambda f0: 2 * f0, lambda tw: 2 * tw + 1,
               lambda f, kf, lo: 2 * f + kf - lo),
    "shift_t": (-1, _ALL_TAPS, lambda f0: f0 - 2, lambda tw: tw + 2,
                lambda f, kf, lo: f - kf - lo),
    "up_even": (-1, (0, 2, 3, 5, 6, 8), lambda m0: m0 - 1,
                lambda tw: tw + 1, lambda m, kf, lo: m - (kf >> 1) - lo),
    "up_odd": (-1, (1, 4, 7), lambda m0: m0 - 1, lambda tw: tw + 1,
               lambda m, kf, lo: m - (kf >> 1) - lo),
}


def _planes(mode, f_in, f_out):
    """(geometry, plane columns, output column of plane column m) of each
    plane a mode's blocks tile."""
    if mode == "up":
        return [("up_even", f_in + 1, lambda m: 2 * m),
                ("up_odd", f_in, lambda m: 2 * m + 1)]
    geo = {"enc0": "shift", "down": "double", "final": "shift_t"}[mode]
    return [(geo, f_out, lambda m: m)]


def _stencil_from_packed(xn, wp, mode, f_out):
    """The stencil's conv as stencil_tc_kernel gathers it: per plane and
    column tile (tile_w's widths), each (group, tap) unit's window column
    through the geometry (held inside the window), the source row t + TS
    (kt - 1), zero outside the plane, times the packed [G, 9, N, group]
    weights."""
    b, c, t, f_in = xn.shape
    g, group = wp.shape[0], wp.shape[-1]
    x = F.pad(xn, (0, 0, 0, 0, 0, group * g - c)).reshape(b, g, group, t,
                                                          f_in)
    out = torch.zeros(b, wp.shape[2], t, f_out, dtype=xn.dtype)
    rows = torch.arange(t)
    for geo, f_pl, out_col in _planes(mode, f_in, f_out):
        ts_sign, taps, lo_of, width, col_of = _GEO[geo]
        tw = 16 if f_pl > 8 else 8
        for f0 in range(0, f_pl, tw):
            m = torch.arange(f0, min(f0 + tw, f_pl))
            lo = lo_of(f0)
            for tap in taps:
                kt, kf = divmod(tap, 3)
                col = col_of(m, kf, lo)
                assert ((col >= 0) & (col < width(tw))).all()
                fs = lo + col
                ts = rows + ts_sign * (kt - 1)
                ok = (((ts >= 0) & (ts < t))[:, None]
                      & ((fs >= 0) & (fs < f_in))[None, :])
                src = x[:, :, :, ts.clamp(0, t - 1)][..., fs.clamp(0, f_in - 1)]
                src = src * ok
                out[..., out_col(m)] += torch.einsum(
                    "bgetm,gne->bntm", src, wp[:, tap].to(xn.dtype))
    return out


STENCIL_GEOMETRIES = [
    ("enc0", 12, 24, 19), ("enc0", 5, 2, 9), ("down", 12, 33, 37),
    ("down", 5, 2, 7), ("up", 12, 2, 9), ("up", 5, 33, 4),
    ("up", 12, 24, 1), ("final", 12, 2, 19), ("final", 5, 33, 6),
]


@pytest.mark.parametrize("mode,c,n,f_in", STENCIL_GEOMETRIES)
def test_stencil_packing_and_maps_compute_the_stencil(mode, c, n, f_in):
    """For each stencil mode, ``packed(w, (C,), transpose=...)`` gathered
    through that mode's maps (Python transcriptions of tc::Geo::col and
    UpGeo) reproduces stencil_plain: the linear part in float64 against
    the plain version's conv at float64, and the epilogue (bias, ELU,
    statistics) against stencil_plain in float32."""
    from misonet_tpu_torch.ops.kernels.stencil import out_bins, stencil_plain

    rng = np.random.default_rng(c * 100 + n)
    b, t = 2, 11
    f_out = out_bins(mode, f_in)
    transpose = mode in ("up", "final")
    x = _w(rng, (b, c, t, f_in), torch.float64)
    w = _w(rng, (c, n, 3, 3) if transpose else (n, c, 3, 3), torch.float64)
    bias = _w(rng, (n,), torch.float64)
    wp = packed(w, (c,), transpose=transpose)
    z = _stencil_from_packed(x, wp, mode, f_out)
    stride = (1, 2) if mode in ("down", "up") else (1, 1)
    conv = F.conv_transpose2d if transpose else F.conv2d
    want = conv(x, w, None, stride=stride, padding=(1, 0))
    torch.testing.assert_close(z, want, rtol=1e-12, atol=1e-12)

    y = z + bias[:, None, None]
    stats = [None, None]
    if mode in ("down", "up"):
        y = F.elu(y)
        stats = [torch.ones(b, c), torch.zeros(b, c)]
    got = stencil_plain(x.float(), w.float(), bias.float(), *stats, mode)
    top = y.abs().max().item()
    torch.testing.assert_close(got[0].double(), y, rtol=0, atol=1e-6 * top)
    if mode in ("down", "up"):
        sums = y.sum(dim=(2, 3))
        torch.testing.assert_close(got[1].double(), sums, rtol=0,
                                   atol=1e-6 * sums.abs().max().item())


@pytest.mark.parametrize("mode,c,n,f_in", STENCIL_GEOMETRIES)
def test_stencil_tf32_passes_compute_the_float32_stencil(mode, c, n, f_in):
    """The float32 mode's arithmetic, emulated in float64: the input
    split by ``tf32_split`` (the kernels' ``tc::split_tf32``), the weights
    packed as the kernel reads them (``packed`` of a float32 weight:
    groups of 4, big and small planes), and the three products big big + big small
    + small big gathered through each mode's maps equal the
    float64 conv of the float32 operands within 1e-5 of max-abs; one TF32
    pass (big big alone) misses it by more than ten times that."""
    from misonet_tpu_torch.ops.kernels.stencil import out_bins
    from misonet_tpu_torch.ops.kernels.tc_pack import tf32_split

    rng = np.random.default_rng(c * 100 + n + 1)
    b, t = 2, 11
    f_out = out_bins(mode, f_in)
    transpose = mode in ("up", "final")
    x = _w(rng, (b, c, t, f_in), torch.float32)
    w = _w(rng, (c, n, 3, 3) if transpose else (n, c, 3, 3), torch.float32)
    xb, xs = tf32_split(x)
    wb, ws = packed(w, (c,), transpose=transpose).double()
    assert wb.shape == (-(-c // 4), 9, n, 4)

    def gather(xv, wp):
        return _stencil_from_packed(xv.double(), wp, mode, f_out)

    three = gather(xs, wb) + gather(xb, ws) + gather(xb, wb)
    one = gather(xb, wb)
    stride = (1, 2) if mode in ("down", "up") else (1, 1)
    conv = F.conv_transpose2d if transpose else F.conv2d
    want = conv(x.double(), w.double(), None, stride=stride, padding=(1, 0))
    top = want.abs().max().item()
    assert (three - want).abs().max().item() <= 1e-5 * top
    assert (one - want).abs().max().item() > 1e-4 * top

"""The weight layout of the bf16 tensor-core kernels (ops/kernels/tc_pack.py),
on the CPU: every packed element against the ``[O, R, 3, 3]`` weight it
came from (tap order, the per-source zero padding of the reduced channels,
the transposed roles of stencil_bwd's dgrad), a conv computed from the
packed layout against ``F.conv2d``, and the cache per weight tensor and
version.  Exact comparisons: packing only moves values."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from misonet_tpu_torch.ops.kernels import tc_pack  # noqa: E402
from misonet_tpu_torch.ops.kernels.tc_pack import (  # noqa: E402
    pack_tc_weights,
    packed,
)


def _w(rng, shape, dtype=torch.bfloat16):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dtype)


def _reduced_channel(widths):
    """For each padded group slot (g, e): the reduced channel it holds, or
    -1 for a pad slot."""
    slots, off = [], 0
    for c in widths:
        for k in range(-(-c // 8) * 8):
            slots.append(off + k if k < c else -1)
        off += c
    return np.array(slots).reshape(-1, 8)


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


def test_pack_refuses_widths_that_do_not_sum():
    w = torch.zeros(4, 10, 3, 3)
    with pytest.raises(ValueError, match="do not sum"):
        pack_tc_weights(w, (4, 5))


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

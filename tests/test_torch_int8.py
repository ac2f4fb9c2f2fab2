"""PyTorch port, kernel 2.5 (ops/kernels/dense_stack_int8.py): the int8
DenseBlock decode mode (``quant_int8=True`` on a bf16 model) against the JAX
package.

* (c) ``dense_stack_int8_plain`` against the Pallas ``dense_stack_flat``
  with ``quant=True`` in interpret mode, one call (1 and 2 sources, with and
  without partials), and ``DenseBlockFlat.flat(quant=True)`` against JAX's
  ``DenseBlockFlat`` (five calls); both also held to JAX's own error-class
  test against the float32 plain DenseBlock (tests/test_dense_stack.py:
  132-170: rms < 0.08 of the reference's rms, max < 0.4 of its max-abs,
  correlation > 0.995).
* (d) the whole fused int8 composition of MISO1 at the narrowest plan the
  JAX flat path accepts, on the CPU (the fused path is switched on inside
  this test only, so each kernel wrapper runs its plain version) against
  JAX's flat path with ``quant_int8=True`` under interpret mode.
* (e) the int8 mode refuses autograd with a clear error.

Tolerances, normalized by the reference's max-abs.  Both sides quantize the
same quantities (activations ``rint(16 x scale)`` of the same bf16 values,
the same weight rows with one row scale over weights and mean-correction
coefficients), so the integer sums agree except where an ``rint`` tie or a
last-ulp difference in the float32 coefficient sums (an einsum in another
order) flips one quantization step; y and the partials are bf16 on both
sides.  One call (c): max-abs within 1e-2 and rms within 1e-3; measured 0
for y and the partials (bit-identical integer sums) and 2e-7 for the
float32 statistics.  The five-call block: measured 2.8e-3 / 3.6e-4 (1
source) and 6.8e-3 / 4.1e-4 (2 sources), same bounds.  The 60-layer
composition (d) is chaotic at int8: its input differs from JAX's by bf16
ulps after the first stencils, a flipped quantization step changes the
next layer's statistics and so its quantization, and the flips compound.
So it is held to twice the port's own movement when its input moves by
1e-3 (a quarter of a bf16 ulp): measured 9.3e-2 max-abs / 2.2e-2 rms
against JAX, 1.5e-1 / 2.4e-2 under that perturbation (for scale: int8
against bf16 in JAX itself is 1.0e-1 / 2.2e-2), correlation above 0.99.
It takes ~55 s here, nearly all of it the compile of JAX's 60 interpret-
mode Pallas calls.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from misonet_tpu.config import ModelConfig  # noqa: E402
from misonet_tpu.models import make_miso1 as jax_miso1  # noqa: E402
from misonet_tpu.models.flat_dense import DenseBlockFlat as JaxDenseBlockFlat  # noqa: E402
from misonet_tpu.models.flat_dense import (  # noqa: E402
    from_flat_bundle,
    merge_bundles as jax_merge,
)
from misonet_tpu.ops.pallas.conv_flat import flatten_tf, unflatten_tf  # noqa: E402
from misonet_tpu.ops.pallas.dense_stack import dense_stack_flat  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch.models import make_miso1 as port_miso1  # noqa: E402
from misonet_tpu_torch.models import miso as port_miso  # noqa: E402
from misonet_tpu_torch.models.blocks import DenseBlock  # noqa: E402
from misonet_tpu_torch.models.flat_dense import (  # noqa: E402
    DenseBlockFlat,
    from_bundle,
    merge_bundles,
)
from misonet_tpu_torch.ops.kernels.dense_stack_int8 import (  # noqa: E402
    QS,
    dense_stack_int8,
    dense_stack_int8_plain,
    quantize_rows,
    quantize_rows_packed,
)
from misonet_tpu_torch.ops.kernels.flat_grad import dense_stack_int8_ad  # noqa: E402
from misonet_tpu_torch.utils.weights import load_jax_params  # noqa: E402

TILE = 256
BF16 = torch.bfloat16
CALL_MAX, CALL_RMS = 1e-2, 1e-3     # one call and one block
PERTURB = 1e-3  # relative input perturbation, a quarter of a bf16 ulp


def _errs(out, ref):
    """(max-abs error, rms error), both over the reference's max-abs."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    top = np.abs(ref).max()
    d = out - ref
    return np.abs(d).max() / top, np.sqrt((d ** 2).mean()) / top


def _close(out, ref, max_tol=CALL_MAX, rms_tol=CALL_RMS):
    e_max, e_rms = _errs(out, ref)
    assert e_max <= max_tol and e_rms <= rms_tol, (e_max, e_rms)


def _error_class(out, ref):
    """JAX's own int8 error-class test against the float32 plain block
    (tests/test_dense_stack.py:165-170)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    d = out - ref
    rms = np.sqrt((d ** 2).mean()) / (np.sqrt((ref ** 2).mean()) + 1e-9)
    assert rms < 0.08, rms
    assert np.abs(d).max() < 0.4 * np.abs(ref).max(), np.abs(d).max()
    corr = np.corrcoef(out.ravel(), ref.ravel())[0, 1]
    assert corr > 0.995, corr


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16).float().numpy()


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _flat(x):  # NCHW numpy -> JAX bf16 flat layout
    return flatten_tf(jnp.asarray(x.transpose(0, 2, 3, 1)),
                      TILE).astype(jnp.bfloat16)


def _unflat(y, t, f):  # JAX flat layout -> NCHW float32 numpy
    y = unflatten_tf(y.astype(jnp.float32), t, f, TILE)
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("widths,n,n_fin,with_acc", [
    ((8,), 24, 8, False),       # first call of an encoder block
    ((8,), 24, 8, True),        # middle call: partials in and out
    ((8, 8), 32, 8, False),     # decoder skip concat, two sources
    ((8, 8), 16, 16, True),     # last call: no partials out
])
def test_int8_call_matches_pallas(widths, n, n_fin, with_acc):
    """(c) one call: dense_stack_int8_plain (and the wrapper, which runs it
    for CPU tensors) against dense_stack_flat(quant=True)."""
    b, t, f = 2, 10, 7
    rng = np.random.default_rng(11)
    c = sum(widths)
    xs = [_bf16(rng.standard_normal((b, w, t, f)) + 0.5) for w in widths]
    acc = _bf16(rng.standard_normal((b, n, t, f))) if with_acc else None
    w = (0.2 * rng.standard_normal((n, c, 3, 3))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (b, c)).astype(np.float32)
    mean = rng.uniform(-0.5, 1.0, (b, c)).astype(np.float32)
    bias = np.linspace(-0.3, 0.3, n_fin).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj, sj, qj, aj = dense_stack_flat(
            tuple(_flat(x) for x in xs), _flat(acc) if with_acc else None,
            jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(bias),
            jnp.asarray(scale), jnp.asarray(mean),
            t=t, f=f, n_fin=n_fin, tile_m=TILE, quant=True,
        )
    args = ([_t(x, BF16) for x in xs], _t(acc, BF16) if with_acc else None,
            _t(w), _t(bias), _t(scale), _t(mean), n_fin)
    yt, st, qt, at = dense_stack_int8_plain(*args)
    for got, want in zip(dense_stack_int8(*args), (yt, st, qt, at)):
        assert (got is None and want is None) or torch.equal(got, want)
    assert yt.dtype == BF16 and st.dtype == torch.float32
    _close(yt.float(), _unflat(yj, t, f))
    _close(st, np.asarray(sj)[..., 0])
    _close(qt, np.asarray(qj)[..., 0])
    if n > n_fin:
        assert at.dtype == BF16
        _close(at.float(), _unflat(aj, t, f))
    else:
        assert at is None and aj is None


def test_quantized_rows_share_one_scale():
    """The row scale covers the weights and the mean-correction
    coefficients together (misonet_tpu/ops/pallas/dense_stack.py:371-373):
    with a zero mean the coefficients vanish and the weights alone set it
    (each row's largest |q| is 127); with a large mean the coefficients set
    it and the weights quantize coarser."""
    rng = np.random.default_rng(3)
    w = _t(0.2 * rng.standard_normal((16, 8, 3, 3)))
    scale = _t(rng.uniform(0.5, 1.5, (2, 8)))
    rows = w.permute(0, 2, 3, 1).reshape(16, 72).abs().amax(1)
    qw, corr, rq = quantize_rows(w, scale, 0 * scale)
    assert qw.dtype == torch.int8 and qw.shape == (2, 16, 9, 8)
    assert corr.dtype == torch.int32 and corr.shape == (2, 16, 16)
    assert corr.eq(0).all()
    assert qw.abs().amax(dim=(2, 3)).eq(127).all()
    torch.testing.assert_close(rq * QS, (rows / 127).expand(2, 16))
    qw, corr, rq = quantize_rows(w, scale, _t(rng.uniform(2, 3, (2, 8))))
    assert (rq * QS * 127 > rows).all()
    assert qw.abs().amax().item() < 127
    assert corr.abs().amax().item() >= 16 * 127


CALL_CASES = [
    ((8,), 24, 8, False),
    ((8,), 24, 8, True),
    ((8, 8), 32, 8, False),
    ((8, 8), 16, 16, True),
]


def _rows_float32(w_stack, scale, mean):
    """quantize_rows as it was before its sums went to float64: beta and
    the coefficients summed in float32."""
    n, c = w_stack.shape[:2]
    b = scale.shape[0]
    beta = -torch.einsum("ncij,bc->bnij", w_stack, mean * scale)
    coef = torch.stack([
        beta.sum(dim=(2, 3)),
        -beta[:, :, 0, :].sum(-1), -beta[:, :, 2, :].sum(-1),
        -beta[:, :, :, 0].sum(-1), -beta[:, :, :, 2].sum(-1),
        beta[:, :, 0, 0], beta[:, :, 0, 2], beta[:, :, 2, 0], beta[:, :, 2, 2],
    ], dim=2)
    w_rows = w_stack.permute(0, 2, 3, 1).reshape(n, 9 * c)
    row_max = torch.maximum(w_rows.abs().amax(dim=1), coef.abs().amax(dim=2))
    rs = torch.clamp(row_max, min=1e-20) / 127.0

    def q(v):
        return torch.clamp(torch.round(v / rs[..., None]), -127.0, 127.0)

    qw = q(w_rows).to(torch.int8).reshape(b, n, 9, c)
    qc = q(coef).to(torch.int32)
    fields = [[1, e & 1, e >> 1 & 1, e >> 2 & 1, e >> 3 & 1,
               (e & 1) * (e >> 2 & 1), (e & 1) * (e >> 3 & 1),
               (e >> 1 & 1) * (e >> 2 & 1), (e >> 1 & 1) * (e >> 3 & 1)]
              for e in range(16)]
    corr = (qc[:, :, None, :] * torch.tensor(fields, dtype=torch.int32)
            ).sum(-1) * int(QS)
    return qw, corr.to(torch.int32), rs / QS


@pytest.mark.parametrize("widths,n,n_fin,with_acc", CALL_CASES)
def test_float64_rows_match_the_float32_rows(widths, n, n_fin, with_acc):
    """quantize_rows takes beta and the coefficients as float64 sums of the
    float32 products (as the card's row kernel does).  On the inputs of
    test_int8_call_matches_pallas (the same draws) its quantized rows (qw,
    corr) equal those of the float32 sums it had before; the row scale rq
    moves in the rows whose max is a coefficient, by what the float32 sums
    of up to 9 rounded beta values had rounded it: a few float32 ulps
    (bound 2^-21 relative; measured at most 1.95 * 2^-23, in 15-31 of
    32-64 rows)."""
    b, t, f = 2, 10, 7
    rng = np.random.default_rng(11)
    c = sum(widths)
    for w_ in widths:
        rng.standard_normal((b, w_, t, f))              # the sources
    if with_acc:
        rng.standard_normal((b, n, t, f))               # acc_in
    w = _t((0.2 * rng.standard_normal((n, c, 3, 3))).astype(np.float32))
    scale = _t(rng.uniform(0.5, 1.5, (b, c)).astype(np.float32))
    mean = _t(rng.uniform(-0.5, 1.0, (b, c)).astype(np.float32))
    qw, corr, rq = quantize_rows(w, scale, mean)
    qw0, corr0, rq0 = _rows_float32(w, scale, mean)
    assert qw.dtype == torch.int8 and torch.equal(qw, qw0)
    assert corr.dtype == torch.int32 and torch.equal(corr, corr0)
    assert rq.dtype == torch.float32
    assert ((rq - rq0).abs() <= 2.0 ** -21 * rq0).all()


def test_quantize_rows_packed_refuses_cpu_tensors():
    """The row kernel's wrapper runs on the card only: a CPU tensor is
    refused, not sent to the plain rows (dense_stack_int8 sends CPU calls to
    dense_stack_int8_plain before it reaches the row kernel)."""
    w = torch.zeros((8, 8, 3, 3))
    scale, mean = torch.ones((1, 8)), torch.zeros((1, 8))
    with pytest.raises(ValueError, match="unsupported device cpu"):
        quantize_rows_packed(w, scale, mean, (8,))


def _stats(x):
    x = x.float()
    return (torch.rsqrt(x.var(dim=(2, 3), unbiased=False) + 1e-5),
            x.mean(dim=(2, 3)))


@pytest.mark.parametrize("sources", [1, 2])
def test_int8_dense_block_matches_pallas(sources):
    """(c) DenseBlockFlat.flat(quant=True) (five calls) against JAX's
    DenseBlockFlat(quant=True), and both against the float32 plain
    DenseBlock in JAX's int8 error class."""
    b, t, f = 2, 10, 7
    rng = np.random.default_rng(11)
    xs = [_bf16(rng.standard_normal((b, 8, t, f)) + 0.4 * i)
          for i in range(sources)]
    c = 8 * sources
    block = DenseBlockFlat(c, 8, 16)
    params = {}
    for i, conv in enumerate(block.convs):
        w = (0.3 * rng.standard_normal(tuple(conv.weight.shape))).astype(
            np.float32)
        bias = (0.1 * rng.standard_normal(conv.bias.shape)).astype(np.float32)
        conv.weight.data.copy_(_t(w))
        conv.bias.data.copy_(_t(bias))
        params[f"conv{i + 1}_kernel"] = jnp.asarray(w.transpose(2, 3, 1, 0))
        params[f"conv{i + 1}_bias"] = jnp.asarray(bias)
    txs = [_t(x, BF16) for x in xs]
    stats = [_stats(x) for x in txs]
    with torch.no_grad():
        out = from_bundle(block.flat(merge_bundles(
            *[((x,), s, m) for x, (s, m) in zip(txs, stats)]), quant=True))
        xn = torch.cat([(x.float() - m[..., None, None]) * s[..., None, None]
                        for x, (s, m) in zip(txs, stats)], dim=1)
        f32 = DenseBlock.forward(block, xn)
    assert out.dtype == BF16

    def run(p, bundle):
        y = JaxDenseBlockFlat(8, 16).apply(p, bundle, t=t, f=f, tile_m=TILE,
                                           quant=True)
        return from_flat_bundle(y, t, f, jnp.float32, TILE)

    bundles = [((_flat(x),), jnp.asarray(s.numpy()), jnp.asarray(m.numpy()))
               for x, (s, m) in zip(xs, stats)]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(run)({"params": params},
                                      jax_merge(*bundles)))
    got = out.float().numpy().transpose(0, 2, 3, 1)
    _close(got, ref)
    _error_class(got, f32.numpy().transpose(0, 2, 3, 1))
    _error_class(ref, f32.numpy().transpose(0, 2, 3, 1))


NARROW = dict(en_channels=(8, 8, 8, 8, 8, 16, 16),
              de_channels=(16, 16, 8, 8, 8, 8, 8),
              tcn_repeats=1, tcn_blocks=2, tcn_channels=16)


def test_int8_miso1_composition_matches_jax(monkeypatch):
    """(d) MISO1 at bf16 with quant_int8=True through the fused composition
    (10 int8 DenseBlocks, 10 bf16 stencils) on the CPU against JAX's flat
    path under interpret mode, at the narrowest plan it accepts (channels
    8, 7 levels, F = 129; B = 1, T = 4).  The fused path is switched on
    here only: on the CPU the port runs the plain modules."""
    cfg = ModelConfig(**NARROW, compute_dtype="bfloat16", flat_dense=True,
                      quant_int8=True)
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((1, 6, 4, 129))
           + 1j * rng.standard_normal((1, 6, 4, 129))).astype(np.complex64)
    jmodel = jax_miso1(cfg)
    shapes = jax.eval_shape(
        jax_miso1(dataclasses.replace(cfg, flat_dense=False)).init,
        jax.random.key(0), jnp.asarray(mix))
    prng = np.random.default_rng(1)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 0
        std = 1.0 / np.sqrt(fan_in) if fan_in > 1 else 0.1
        return jnp.asarray((std * prng.standard_normal(s.shape))
                           .astype(np.float32))

    params = jax.tree.map(draw, shapes)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(mix)))

    model = load_jax_params(
        port_miso1(tcfg.ModelConfig(**dataclasses.asdict(cfg)),
                   device="cpu"), params)
    monkeypatch.setattr(port_miso, "resolve_flat", lambda *a, **k: True)
    noise = np.random.default_rng(5).standard_normal(mix.shape)
    moved = (mix * (1 + PERTURB * noise)).astype(np.complex64)
    with torch.no_grad():
        out = model(torch.from_numpy(mix)).numpy()
        out_moved = model(torch.from_numpy(moved)).numpy()
    assert out.dtype == np.complex64

    def parts(z):
        return np.stack([z.real, z.imag])

    got, want = parts(out), parts(ref)
    sens_max, sens_rms = _errs(parts(out_moved), got)
    _close(got, want, 2 * sens_max, 2 * sens_rms)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99


def test_int8_refuses_autograd():
    """(e) the int8 mode is decode-only: a call where autograd records
    raises a clear ValueError, and a fused int8 DenseBlock under autograd
    (weights that require grad) does too."""
    x = torch.zeros(1, 8, 4, 7, dtype=BF16)
    w = torch.zeros(8, 8, 3, 3, requires_grad=True)
    s = torch.ones(1, 8)
    with pytest.raises(ValueError, match="decode-only"):
        dense_stack_int8_ad([x], None, w, torch.zeros(8), s, s * 0, 8)
    block = DenseBlockFlat(8, 8, 8)
    bundle = ((x,), s, s * 0)
    with pytest.raises(ValueError, match="torch.no_grad"):
        block.flat(bundle, quant=True)
    with torch.no_grad():
        y, _, _ = block.flat(bundle, quant=True)
    assert y[0].dtype == BF16

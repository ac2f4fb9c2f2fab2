"""PyTorch port, training at bf16 (the JAX package's default compute dtype)
on the CPU.

1. One wave train step of MISO1 at ``compute_dtype="bfloat16"`` (the small
   plan of tests/test_torch_train.py, weights moved from JAX by the
   bridge) against the JAX package's step at the same dtype (its loss and
   gradients, jitted as the step jits them): the loss and
   the gradient norm within 2e-2 relative (JAX's bf16 class: XLA and the
   port round their bf16 convs at other points, PERF.md / ROADMAP §3), and
   every gradient tensor within max(FLOOR, 2x JAX bf16's own distance to
   the float32 gradients) of JAX's float32 gradients.
2. The fused modules (DenseBlockFlat, TrunkDownFlat, DeconvUpFlat,
   Enc0Flat, FinalDeconvFlat) at bf16 under autograd, through the Functions
   of ops/kernels/flat_grad.py over the bf16 plain versions of the kernels
   (the CUDA kernels on the card, tests/test_torch_cuda.py): each gradient
   within max(FLOOR, 2x the plain bf16 module's own distance) of the plain
   module's float32 gradients.  Gradients of float32 parameters stay
   float32, those of the bf16 sources bf16.

FLOOR = 2e-2 of each gradient's max-abs (floored at 1e-3 of the largest
gradient, as tests/test_torch_train.py): a few bf16 ulps, for gradients
that the bf16 reference happens to get almost exactly."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from misonet_tpu import config as jcfg  # noqa: E402
from misonet_tpu import losses as jlosses  # noqa: E402
from misonet_tpu import models as jmodels  # noqa: E402
from misonet_tpu.ops.stft import stft_scaled as jstft  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch import models as tmodels  # noqa: E402
from misonet_tpu_torch.models.blocks import (  # noqa: E402
    ConvBlock,
    ConvTranspose2dTorch,
    DeconvBlock,
    DenseBlock,
    InstanceNorm,
    init_parameters,
)
from misonet_tpu_torch.models.flat_dense import (  # noqa: E402
    DeconvUpFlat,
    DenseBlockFlat,
    Enc0Flat,
    FinalDeconvFlat,
    TrunkDownFlat,
    from_bundle,
    merge_bundles,
)
from misonet_tpu_torch.ops.kernels.stencil import out_bins  # noqa: E402
from misonet_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_optimizer,
    make_separate_wave_train_step,
)
from misonet_tpu_torch.utils.weights import (  # noqa: E402
    jax_to_state_dict,
    load_jax_params,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLOOR = 2e-2
STEP_RTOL = 2e-2
BF16 = torch.bfloat16


def _port(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _errs(got: dict, want: dict) -> dict:
    """Each tensor's max-abs error over its max-abs, floored at 1e-3 of
    the largest."""
    floor = 1e-3 * max(np.abs(v).max() for v in want.values())
    return {k: np.abs(got[k] - want[k]).max()
            / max(np.abs(want[k]).max(), floor) for k in want}


def _within_class(port: dict, bf16_ref: dict, f32: dict):
    e_port, e_ref = _errs(port, f32), _errs(bf16_ref, f32)
    bad = {k: (e_port[k], e_ref[k]) for k in f32
           if not e_port[k] <= max(FLOOR, 2 * e_ref[k])}
    assert not bad, bad


SMALL = jcfg.ModelConfig(
    num_bottleneck=4, en_channels=(8, 8, 8, 16), de_channels=(16, 8, 8, 8),
    tcn_repeats=1, tcn_blocks=2, tcn_channels=16,
)
STFT = jcfg.StftConfig(fs=8000, length=32, overlap=24)   # 17 bins, hop 8
B, C, S = 8, 3, 120


def test_bf16_wave_train_step_matches_jax():
    assert SMALL.compute_dtype == "bfloat16"
    rng = np.random.default_rng(3)
    src = rng.standard_normal((B, 2, S)).astype(np.float32)
    gains = rng.uniform(0.3, 1.0, (B, 2, C)).astype(np.float32)
    mix = np.einsum("bks,bkc->bsc", src, gains)
    mix = (mix + 0.05 * rng.standard_normal(mix.shape)).astype(np.float32)

    def jgrads(cfg):
        """JAX's wave train step's loss and gradients (its STFT, forward
        and uPIT loss, misonet_tpu/train/steps.py:109-123)."""
        jmodel = jmodels.make_miso1(cfg)

        def loss_fn(p):
            m = jstft(jnp.asarray(mix).transpose(0, 2, 1), STFT)
            r = jstft(jnp.asarray(src), STFT)
            return jlosses.loss_upit(jmodel.apply(p, m), r)

        loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
        return float(loss), float(optax.global_norm(g)), jax.tree.map(
            np.asarray, g)

    params = jmodels.make_miso1(SMALL).init(
        jax.random.key(1), jnp.zeros((B, C, 16, 17), jnp.complex64))
    jloss, jnorm, g_bf16 = jgrads(SMALL)
    _, _, g_f32 = jgrads(dataclasses.replace(SMALL, compute_dtype="float32"))

    model = load_jax_params(
        tmodels.make_miso1(_port(SMALL), num_mics=C, device="cpu"), params)
    opt = make_optimizer(tcfg.OptimizerConfig(), model.parameters())
    step = make_separate_wave_train_step(model, opt, _port(STFT))
    _, m = step(create_train_state(model, opt), torch.from_numpy(mix),
                torch.from_numpy(src))
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=STEP_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=STEP_RTOL)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    port = {k: p.grad.numpy() for k, p in model.named_parameters()}
    want = {k: v.numpy() for k, v in jax_to_state_dict(g_f32, model).items()}
    ref = {k: v.numpy() for k, v in jax_to_state_dict(g_bf16, model).items()}
    _within_class(port, ref, want)


# ---------------------------------------------------------------------------
# 2. fused modules at bf16 against the plain modules
# ---------------------------------------------------------------------------


def _in_stats(x):
    """float32 1/sigma and mean of an InstanceNorm over (T, F)."""
    x = x.float()
    var = x.var(dim=(2, 3), unbiased=False)
    return torch.rsqrt(var + 1e-5), x.mean(dim=(2, 3))


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    init_parameters(module, gen)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.2, 0.2, generator=gen)
    return module


def _grads(module, loss, xs):
    module.zero_grad(set_to_none=True)
    for x in xs:
        x.grad = None
    loss().backward()
    out = {k: p.grad for k, p in module.named_parameters()}
    out.update({f"x{i}": x.grad for i, x in enumerate(xs)})
    return out


def _as_np(grads):
    return {k: v.float().numpy() for k, v in grads.items()}


def _leaves(rng, shapes, shift=0.0):
    x32 = [torch.from_numpy((rng.standard_normal(s) + shift).astype(
        np.float32)).to(BF16).float().requires_grad_() for s in shapes]
    return x32, [x.detach().to(BF16).requires_grad_() for x in x32]


def _dense(rng):
    b, t, f = 2, 6, 9
    x32, x16 = _leaves(rng, [(b, 8, t, f), (b, 8, t, f)], 0.3)
    probe = torch.from_numpy(rng.standard_normal((b, 16, t, f))
                             .astype(np.float32))
    block = _seeded(DenseBlockFlat(16, 8, 16), 0)

    def fused():
        bundle = merge_bundles(((x16[0],), *_in_stats(x16[0])),
                               ((x16[1],), *_in_stats(x16[1])))
        return (from_bundle(block.flat(bundle)).float() * probe).sum()

    def plain(xs):
        norm = InstanceNorm()
        xn = torch.cat([norm(xs[0]), norm(xs[1])], dim=1)
        return (DenseBlock.forward(block, xn).float() * probe).sum()

    return block, x32, x16, fused, plain


def _stencil(kind):
    def make(rng):
        b, t, c = 2, 8, 8
        f_in = {"down": 15, "up": 7, "enc0": 17, "final": 15}[kind]
        c = 12 if kind == "enc0" else c
        n = {"down": 16, "up": 16, "enc0": 8, "final": 4}[kind]
        f_out = {"down": out_bins("down", f_in), "up": out_bins("up", f_in),
                 "enc0": f_in - 2, "final": f_in + 2}[kind]
        x32, x16 = _leaves(rng, [(b, c, t, f_in)], 0.2)
        probe = torch.from_numpy(rng.standard_normal((b, n, t, f_out))
                                 .astype(np.float32))
        if kind == "down":
            mod, base = _seeded(TrunkDownFlat(c, n, stride=(1, 2)), 1), ConvBlock
        elif kind == "up":
            mod, base = _seeded(DeconvUpFlat(c, n, stride=(1, 2)), 2), DeconvBlock
        elif kind == "enc0":
            mod, base = _seeded(Enc0Flat(c, n, act_norm=False), 3), ConvBlock
        else:
            mod = _seeded(FinalDeconvFlat(c, n, stride=(1, 1)), 4)
            base = ConvTranspose2dTorch

        def fused():
            x = x16[0]
            arg = x if kind == "enc0" else ((x,), *_in_stats(x))
            y = mod.flat(arg)
            y = y if kind == "final" else from_bundle(y)
            return (y.float() * probe).sum()

        def plain(xs):
            x = xs[0] if kind == "enc0" else InstanceNorm()(xs[0])
            return (base.forward(mod, x).float() * probe).sum()

        return mod, x32, x16, fused, plain
    return make


@pytest.mark.parametrize("make", [_dense, _stencil("down"), _stencil("up"),
                                  _stencil("enc0"), _stencil("final")],
                         ids=["dense", "down", "up", "enc0", "final"])
def test_bf16_fused_module_grads_within_class(make):
    module, x32, x16, fused, plain = make(np.random.default_rng(41))
    got = _grads(module, fused, x16)
    assert all(got[f"x{i}"].dtype == BF16 for i in range(len(x16)))
    assert all(p.grad.dtype == torch.float32 for p in module.parameters())
    want = _grads(module, lambda: plain(x32), x32)
    ref = _grads(module, lambda: plain(x16), x16)
    _within_class(_as_np(got), _as_np(ref), _as_np(want))

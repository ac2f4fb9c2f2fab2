"""PyTorch port, training (misonet_tpu_torch/train): optimizer, NaN guard,
schedule and train steps against the JAX package's misonet_tpu/train.

* Optimizers: ``make_optimizer`` (adam, adam with weight decay = AdamW,
  rmsprop, sgd; with and without clipping; the NaN guard rejecting and
  giving up) against optax on identical gradient sequences.  Bound 1e-6
  absolute on the parameters (float32, values ~1).
* Steps at the SMALL plan of tests/test_train_step.py (4 levels, 17 bins,
  B = 8), weights moved from JAX by ``load_jax_params`` and JAX's
  gradients mapped by the same bridge: one wave train step gives the loss
  (1e-5 relative), ``grad_norm`` (1e-4 relative) and every gradient
  tensor (1e-4 of its max-abs, floored at 1e-3 of the largest) of JAX.  uPIT's permutation is checked to
  be clear in every utterance first: a near tie would flip between
  frameworks.  Parameters after Adam are compared only under identical
  gradients (the optimizer tests), because Adam's first step is about
  lr * sign(g).  The other steps match JAX's loss and gradient norm over
  one step.
"""

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
from misonet_tpu import train as jtrain  # noqa: E402
from misonet_tpu.ops.stft import stft_scaled as jstft  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch import models as tmodels  # noqa: E402
from misonet_tpu_torch.train import (  # noqa: E402
    PlateauScheduler,
    create_train_state,
    make_enhance_joint_train_step,
    make_enhance_train_step,
    make_optimizer,
    make_separate_eval_step,
    make_separate_train_step,
    make_separate_wave_eval_step,
    make_separate_wave_train_step,
)
from misonet_tpu_torch.train.state import (  # noqa: E402
    current_learning_rate,
    set_learning_rate,
)
from misonet_tpu_torch.utils.weights import (  # noqa: E402
    jax_to_state_dict,
    load_jax_params,
)


def _port(cfg):
    """The port's copy of a JAX package config."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# optimizers on identical gradient sequences
# ---------------------------------------------------------------------------

SHAPES = {"a": (4, 5), "b": (7,), "c": (2, 3, 3)}


def _run_both(cfg, grad_seq):
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}

    opt = jtrain.make_optimizer(cfg)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(params)
    for grads in grad_seq:
        updates, state = opt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    topt = make_optimizer(_port(cfg), tparams.values())
    norms = []
    for grads in grad_seq:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        norms.append(float(topt.update()))
    return params, tparams, topt, norms


def _grad_seq(scales, nan_at=()):
    rng = np.random.default_rng(1)
    seq = []
    for i, s in enumerate(scales):
        g = {k: (s * rng.standard_normal(sh)).astype(np.float32)
             for k, sh in SHAPES.items()}
        if i in nan_at:
            g["b"][3] = np.nan
        seq.append(g)
    return seq


@pytest.mark.parametrize("clipping", [False, True])
@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 0.01),
                                     ("rmsprop", 0.0), ("sgd", 0.0)])
def test_optimizer_matches_optax(name, wd, clipping):
    cfg = jcfg.OptimizerConfig(name=name, lr=0.01, weight_decay=wd,
                               clipping=clipping, max_norm=1.0)
    # gradient norms ~8, ~0.03 and ~2.6: clipping acts on steps 1 and 3
    seq = _grad_seq([2.0, 0.01, 0.7])
    want, got, _, norms = _run_both(cfg, seq)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=1e-6)
    want_norms = [float(optax.global_norm(
        {k: jnp.asarray(v) for k, v in g.items()})) for g in seq]
    np.testing.assert_allclose(norms, want_norms, rtol=1e-6)


@pytest.mark.parametrize("max_misses,applied", [(5, False), (0, True)])
def test_nan_guard_matches_optax(max_misses, applied):
    """A NaN gradient in step 2 of 3: rejected (parameters and Adam's state
    untouched) while at most ``max_consecutive_nan_steps`` misses in a row
    have been seen, applied once there are more (optax's code; the JAX
    package's comment says it raises)."""
    cfg = jcfg.OptimizerConfig(lr=0.01, max_consecutive_nan_steps=max_misses)
    want, got, topt, _ = _run_both(cfg, _grad_seq([1.0, 1.0, 1.0],
                                                   nan_at=(1,)))
    for k in SHAPES:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=1e-6)
    assert np.isnan(got["b"].detach().numpy()).any() == applied
    steps = {int(s["step"]) for s in topt.inner.state.values()}
    assert steps == {3 if applied else 2}


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------


def test_plateau_scheduler():
    sch = PlateauScheduler(lr=1e-3, factor=0.5, patience=2, min_lr=1e-5)
    lrs = [sch.step(1.0) for _ in range(6)]  # no improvement after first
    assert lrs[0] == 1e-3 and min(lrs) < 1e-3
    for _ in range(20):
        sch.step(2.0)
    assert sch.lr >= 1e-5 and sch.should_stop
    jsch = jtrain.PlateauScheduler(lr=1e-3, factor=0.5, patience=2,
                                   min_lr=1e-5)
    tsch = PlateauScheduler(lr=1e-3, factor=0.5, patience=2, min_lr=1e-5)
    for v in [3.0, 2.0, 2.5, 2.5, 2.5, 1.0, 1.5, 1.5, 1.5, 1.5]:
        assert tsch.step(v) == jsch.step(v)
        assert tsch.should_stop == jsch.should_stop


# ---------------------------------------------------------------------------
# train steps at the SMALL plan
# ---------------------------------------------------------------------------

SMALL = jcfg.ModelConfig(
    num_bottleneck=4, en_channels=(8, 8, 8, 16), de_channels=(16, 8, 8, 8),
    tcn_repeats=1, tcn_blocks=2, tcn_channels=16, compute_dtype="float32",
)
STFT = jcfg.StftConfig(fs=8000, length=32, overlap=24)   # 17 bins, hop 8
B, C, S, T, F = 8, 3, 120, 16, 17                        # 120 samples -> 16


def _complex(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _waves(seed):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, 2, S)).astype(np.float32)
    gains = rng.uniform(0.3, 1.0, (B, 2, C)).astype(np.float32)
    mix = np.einsum("bks,bkc->bsc", src, gains)
    mix += 0.05 * rng.standard_normal(mix.shape).astype(np.float32)
    return mix.astype(np.float32), src


def _jax_params(jmodel, x, seed):
    return jmodel.init(jax.random.key(seed), jnp.asarray(x))


def _port_model(factory, params, **kw):
    return load_jax_params(factory(_port(SMALL), device="cpu", **kw), params)


def _port_state(model, lr=1e-3):
    opt = make_optimizer(tcfg.OptimizerConfig(lr=lr), model.parameters())
    return create_train_state(model, opt), opt


def _jax_state(params):
    opt = jtrain.make_optimizer(jcfg.OptimizerConfig(lr=1e-3))
    params = jax.tree.map(jnp.copy, params)  # the step donates its state
    return jtrain.create_train_state(params, opt), opt


def _rel(got, want, rtol):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


@pytest.fixture(scope="module")
def miso1_params():
    jmodel = jmodels.make_miso1(SMALL)
    return jmodel, _jax_params(jmodel, np.zeros((B, C, T, F), np.complex64),
                               1)


def test_wave_train_step_matches_jax(miso1_params):
    jmodel, params = miso1_params
    mix_wave, ref_wave = _waves(3)

    def jloss(p):
        mix = jstft(jnp.asarray(mix_wave).transpose(0, 2, 1), STFT)
        ref = jstft(jnp.asarray(ref_wave), STFT)
        est = jmodel.apply(p, mix)
        pair = jlosses._pairwise_l1(est, ref)
        per_perm = jnp.einsum("bij,pij->bp", pair,
                              jnp.asarray(jlosses._perm_one_hot(2)))
        return jlosses.loss_upit(est, ref), per_perm

    (jval, per_perm), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    per_perm = np.asarray(per_perm)
    gap = np.abs(per_perm[:, 0] - per_perm[:, 1]) / per_perm.min(axis=1)
    assert gap.min() > 1e-4, gap  # a clear best permutation everywhere

    jstate, jopt = _jax_state(params)
    jstep = jtrain.make_separate_wave_train_step(jmodel, jopt, STFT)
    _, jmetrics = jstep(jstate, jnp.asarray(mix_wave), jnp.asarray(ref_wave))

    model = _port_model(tmodels.make_miso1, params, num_mics=C)
    state, opt = _port_state(model)
    step = make_separate_wave_train_step(model, opt, _port(STFT))
    state, metrics = step(state, torch.from_numpy(mix_wave),
                          torch.from_numpy(ref_wave))
    assert state.step == 1
    _rel(metrics["loss"], jval, 1e-5)
    _rel(metrics["loss"], jmetrics["loss"], 1e-5)
    _rel(metrics["grad_norm"], jmetrics["grad_norm"], 1e-4)

    want = jax_to_state_dict(jax.tree.map(np.asarray, jgrads), model)
    # a leaf that is zero in exact arithmetic (the gLN shift of each
    # dsconv1, which the next InstanceNorm cancels) holds rounding noise
    # only: each leaf's max-abs is floored at 1e-3 of the largest one's
    floor = 1e-3 * max(np.abs(v.numpy()).max() for v in want.values())
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        scale = max(np.abs(ref).max(), floor)
        np.testing.assert_allclose(p.grad.numpy() / scale, ref / scale,
                                   atol=1e-4, err_msg=name)


def _spectral_batch(seed, c_in, spks):
    rng = np.random.default_rng(seed)
    return (_complex(rng, (B, c_in, T, F)),
            _complex(rng, (B, spks, T, F), 0.1))


@pytest.mark.parametrize("kind", ["separate", "wave_overest", "enhance",
                                  "enhance_joint"])
def test_other_train_steps_match_jax(kind, miso1_params):
    if kind == "enhance":
        jmodel, factory, kw = jmodels.make_miso3(SMALL), tmodels.make_miso3, {}
        x, ref = _spectral_batch(5, C + 2, 1)
    elif kind == "enhance_joint":
        jmodel, factory = jmodels.make_miso2(SMALL), tmodels.make_miso2
        kw = {"num_spks": 2}
        x, ref = _spectral_batch(6, C + 4, 2)
    else:
        jmodel, factory, kw = miso1_params[0], tmodels.make_miso1, {}
        x, ref = _spectral_batch(4, C, 2)
    params = (miso1_params[1] if factory is tmodels.make_miso1
              else _jax_params(jmodel, x, 2))
    model = _port_model(factory, params, num_mics=C, **kw)
    state, opt = _port_state(model)
    jstate, jopt = _jax_state(params)
    args = (x, ref)
    if kind == "separate":
        jstep = jtrain.make_separate_train_step(jmodel, jopt, ref_ch=1)
        step = make_separate_train_step(model, opt, ref_ch=1)
    elif kind == "wave_overest":
        args = (*_waves(7), 0.3)
        jstep = jtrain.make_separate_wave_train_step(jmodel, jopt, STFT,
                                                     overest=True)
        step = make_separate_wave_train_step(model, opt, _port(STFT),
                                             overest=True)
    elif kind == "enhance":
        jstep = jtrain.make_enhance_train_step(jmodel, jopt)
        step = make_enhance_train_step(model, opt)
    else:
        jstep = jtrain.make_enhance_joint_train_step(jmodel, jopt)
        step = make_enhance_joint_train_step(model, opt)
    _, jm = jstep(jstate, *(jnp.asarray(a) for a in args[:2]), *args[2:])
    _, m = step(state, *(torch.as_tensor(a) for a in args[:2]), *args[2:])
    _rel(m["loss"], jm["loss"], 1e-5)
    _rel(m["grad_norm"], jm["grad_norm"], 1e-4)


def test_eval_steps_match_jax(miso1_params):
    jmodel, params = miso1_params
    model = _port_model(tmodels.make_miso1, params, num_mics=C)
    x, ref = _spectral_batch(8, C, 2)
    jloss, jest = jtrain.make_separate_eval_step(jmodel, ref_ch=2)(
        params, jnp.asarray(x), jnp.asarray(ref))
    loss, est = make_separate_eval_step(model, ref_ch=2)(
        torch.from_numpy(x), torch.from_numpy(ref))
    _rel(loss, jloss, 1e-5)
    assert est.shape == (B, 2, T, F) and not est.requires_grad
    mix_wave, ref_wave = _waves(9)
    jloss, _ = jtrain.make_separate_wave_eval_step(jmodel, STFT)(
        params, jnp.asarray(mix_wave), jnp.asarray(ref_wave))
    loss, _ = make_separate_wave_eval_step(model, _port(STFT))(
        torch.from_numpy(mix_wave), torch.from_numpy(ref_wave))
    _rel(loss, jloss, 1e-5)


def _small_model(seed=0):
    return tmodels.make_miso1(_port(SMALL), num_mics=C, device="cpu",
                              generator=torch.Generator().manual_seed(seed))


def test_loss_falls_on_a_repeated_batch():
    model = _small_model()
    state, opt = _port_state(model, lr=3e-3)
    step = make_separate_wave_train_step(model, opt, _port(STFT))
    mix, ref = (torch.from_numpy(a) for a in _waves(10))
    losses = []
    for _ in range(5):
        state, metrics = step(state, mix, ref)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
    assert losses[-1] < losses[0], losses
    assert state.step == 5


def _spectral_step(cfg):
    model = _small_model(1)
    opt = make_optimizer(cfg, model.parameters())
    state = create_train_state(model, opt)
    return model, opt, state, make_separate_train_step(model, opt)


def test_nan_batch_skips_update():
    """As tests/test_nan_guard.py: a NaN batch leaves the parameters (and
    Adam's state) untouched, and a clean batch after it updates them."""
    model, opt, state, step = _spectral_step(tcfg.OptimizerConfig())
    x, ref = (torch.from_numpy(a) for a in _spectral_batch(11, C, 2))
    bad = x.clone()
    bad[0, 0, 0, 0] = complex(float("nan"), 0.0)
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = step(state, bad, ref)
    assert not np.isfinite(float(metrics["loss"]))
    for a, p in zip(before, model.parameters()):
        torch.testing.assert_close(p.detach(), a, rtol=0, atol=0)
    assert not opt.inner.state and opt.nan_steps == 1
    state, metrics = step(state, x, ref)
    assert np.isfinite(float(metrics["loss"])) and opt.nan_steps == 0
    assert any(not torch.equal(a, p.detach())
               for a, p in zip(before, model.parameters()))
    assert state.step == 2


def test_nan_guard_gives_up_after_max_misses():
    """With max_consecutive_nan_steps = 1 the first NaN batch is rejected
    and the second, a second miss in a row, is applied."""
    model, opt, state, step = _spectral_step(
        tcfg.OptimizerConfig(max_consecutive_nan_steps=1))
    x, ref = (torch.from_numpy(a) for a in _spectral_batch(12, C, 2))
    x[0, 0, 0, 0] = complex(float("nan"), 0.0)
    state, _ = step(state, x, ref)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    state, _ = step(state, x, ref)
    assert opt.nan_steps == 2
    assert not all(torch.isfinite(p).all() for p in model.parameters())


def test_learning_rate_injection():
    model, opt, state, step = _spectral_step(tcfg.OptimizerConfig(lr=1e-3))
    assert current_learning_rate(state) == pytest.approx(1e-3)
    state = set_learning_rate(state, 5e-4)
    assert current_learning_rate(state) == pytest.approx(5e-4)
    assert all(g["lr"] == 5e-4 for g in opt.inner.param_groups)
    x, ref = (torch.from_numpy(a) for a in _spectral_batch(13, C, 2))
    state, metrics = step(state, x, ref)  # still runs after the change
    assert np.isfinite(float(metrics["loss"]))


def test_step_refuses_another_state():
    model, opt, state, step = _spectral_step(tcfg.OptimizerConfig())
    other = create_train_state(_small_model(2), opt)
    x, ref = (torch.from_numpy(a) for a in _spectral_batch(14, C, 2))
    with pytest.raises(ValueError, match="another model"):
        step(other, x, ref)

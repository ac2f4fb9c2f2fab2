"""PyTorch port, the example programs' functions
(``misonet_tpu_torch/examples/``) against the JAX package's calls composed
as its examples compose them, float32 on the CPU (bf16 for the int8
script's decode), at tests/test_torch_trainer.py's small plan (4 levels,
STFT 32/24, 3 mics, 512 samples, an 8-utterance voiced corpus, batch 2).

The weights start as JAX's (its initial params, moved by the bridge), and
the batches come from the same index streams (``default_rng(0)`` for
MISO1, ``default_rng(1)`` for stage 3):

* 3 MISO1 steps (train_synthetic.py:133-138), 2 MISO3 and 2 joint MISO2
  steps over the frozen stages (train_cascade.py:185-199): loss per step
  within 1e-3 relative, the trainer test's bound and reason (after the
  first step the losses follow Adam updates, and an update is about lr *
  sign(g), so a gradient element near zero whose sign the frameworks
  round apart moves its parameter by 2 lr);
* stage 2's features (mix, ref_al, m1, bf; train_cascade.py:141-160) on
  the same frozen MISO1 within 1e-4 of max-abs;
* the stage-wise PIT SI-SDRs (train_cascade.py:203-227) with the same
  trained weights on both sides within 1e-2 dB;
* eval_int8's bf16 decode against JAX's bf16 MISO1 on the same weights,
  the separated waves within bf16's error class as tests/test_torch_bf16.py
  states it (4e-2 of max-abs, correlation above 0.999), and its score
  within 0.2 dB of the score of JAX's waves;
* one css_longform pass of two blocks against JAX's StreamingCSS within
  1e-3 dB.

JAX compiles: the MISO1, MISO3 and MISO2 inits, train steps and applies,
the features function and the CSS block step, jitted as the JAX programs
jit them (an eager init took three times a compiled one).
"""

import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu import config as jcfg  # noqa: E402
from misonet_tpu import models as jmodels  # noqa: E402
from misonet_tpu import train as jtrain  # noqa: E402
from misonet_tpu.beamforming.mvdr import mvdr_beamform  # noqa: E402
from misonet_tpu.inference import css as jcss  # noqa: E402
from misonet_tpu.inference.separate import (  # noqa: E402
    align_slots as jalign_slots,
    make_full_array_decode as jdecode,
)
from misonet_tpu.losses import magnitude_distance as jdist  # noqa: E402
from misonet_tpu.metrics import numpy_si_sdr  # noqa: E402
from misonet_tpu.ops.stft import istft_scaled, stft_scaled  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch import models as tmodels  # noqa: E402
from misonet_tpu_torch.data.synthetic import synth_mixture  # noqa: E402
from misonet_tpu_torch.examples import css_longform, eval_int8  # noqa: E402
from misonet_tpu_torch.examples import train_cascade as tcascade  # noqa: E402
from misonet_tpu_torch.examples.common import (  # noqa: E402
    DEMO_TAG,
    make_corpus,
    separate,
    train_separator,
)
from misonet_tpu_torch.inference.css import StreamingCSS  # noqa: E402
from misonet_tpu_torch.train import create_train_state, make_optimizer  # noqa: E402
from misonet_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from misonet_tpu_torch.utils.weights import load_jax_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STFT = jcfg.StftConfig(fs=8000, length=32, overlap=24)
SMALL = jcfg.ModelConfig(
    num_bottleneck=4, en_channels=(8, 8, 8, 16), de_channels=(16, 8, 8, 8),
    tcn_repeats=1, tcn_blocks=2, tcn_channels=16, compute_dtype="float32",
)
DS = jcfg.DatasetConfig(num_ch=3, num_ch_utilize=3, num_spks=2, ref_ch=0,
                        chunk_time=0.25, least_time=0.125)  # 2000 samples
MICS, SAMPLES, N_TRAIN, N_EVAL, BATCH = 3, 512, 8, 2, 2
STEPS1, STEPS3 = 3, 2
RTOL = 1e-3          # losses, relative
FEATURE_TOL = 1e-4   # stage-2 features, of max-abs
DB_TOL = 1e-2        # stage-wise SI-SDR, dB
CSS_DB_TOL = 1e-3    # the CSS pass's SI-SDRs, dB
MODEL_TOL = 4e-2     # bf16 MISO1 against JAX's (tests/test_torch_bf16.py)
# eval_int8's bf16 score against the score of JAX's bf16 waves, dB: the
# waves differ by bf16's class (about 2e-2 of their rms here), which moves
# the 3-step separator's score (about -26 dB) by 0.019-0.052 dB
BF16_DB_TOL = 0.2


def _port(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _bridge(model, params):
    return load_jax_params(model, jax.tree.map(np.asarray, params))


def _jax_pit(est, refs):
    """examples/train_cascade.py:51 of the JAX package."""
    best = -np.inf
    for perm in itertools.permutations(range(refs.shape[0])):
        best = max(best, np.mean([numpy_si_sdr(est[perm[s]], refs[s])
                                  for s in range(refs.shape[0])]))
    return float(best)


def _max_abs_close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if np.iscomplexobj(want):
        got, want = got.view(np.float32), want.view(np.float32)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, (name, err)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(N_TRAIN, N_EVAL, SAMPLES, MICS, voiced=True)


@pytest.fixture(scope="module")
def stage1(corpus):
    """MISO1 from JAX's initial params: JAX's wave train step over the
    stream of default_rng(0), and the port's ``train_separator``.
    Returns (JAX model, JAX params after the steps, JAX losses, port
    log)."""
    mix_all, ref_all = corpus.mix.numpy(), corpus.ref.numpy()
    jm = jmodels.make_miso1(SMALL)
    probe = stft_scaled(jnp.asarray(mix_all[:BATCH]).transpose(0, 2, 1), STFT)
    params = jax.jit(jm.init)(jax.random.key(0), probe)
    port = _bridge(tmodels.make_miso1(_port(SMALL), MICS, device="cpu"),
                   params)
    opt = jtrain.make_optimizer(jcfg.OptimizerConfig(lr=1e-3))
    state = jtrain.create_train_state(params, opt)
    step = jtrain.make_separate_wave_train_step(jm, opt, STFT)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(STEPS1):
        idx = rng.integers(0, N_TRAIN, BATCH)
        state, metrics = step(state, jnp.asarray(mix_all[idx]),
                              jnp.asarray(ref_all[idx]))
        losses.append(float(metrics["loss"]))
    _, log = train_separator(port, _port(STFT), corpus, STEPS1, BATCH,
                             every=1)
    return jm, state.params, losses, log


def _trained_miso1(stage1, cfg=SMALL):
    """A port MISO1 holding JAX's MISO1 params after its steps."""
    return _bridge(tmodels.make_miso1(_port(cfg), MICS, device="cpu"),
                   stage1[1])


@pytest.fixture(scope="module")
def jax_features(stage1):
    """train_cascade.py:141-160 over the JAX MISO1's trained params."""
    jm, params1 = stage1[:2]
    decode = jdecode(jm, MICS, 0)

    @jax.jit
    def features(mix_wave, ref_wave):
        mix = stft_scaled(mix_wave.transpose(0, 2, 1), STFT)
        ref = stft_scaled(ref_wave, STFT)
        full = decode(params1, mix)
        m1 = full[:, :, 0]
        idx = jalign_slots(jdist(m1, ref))
        ref_al = jnp.take_along_axis(ref, idx[..., None, None], axis=1)
        bf = jax.vmap(lambda s: mvdr_beamform(s, mix, ref_ch=0),
                      in_axes=1, out_axes=1)(full)
        return mix, ref_al, m1, bf

    return features


def _jax_enh_inputs(mix, ref_al, m1, bf, joint):
    """train_cascade.py:182-193."""
    b, s, t, f = m1.shape
    if joint:
        return jmodels.enhance_input(mix, m1, bf), ref_al
    x = jmodels.enhance_input(jnp.repeat(mix, s, axis=0),
                              m1.reshape(b * s, 1, t, f),
                              bf.reshape(b * s, 1, t, f))
    return x, ref_al.reshape(b * s, 1, t, f)


@pytest.fixture(scope="module")
def stage3(corpus, stage1, jax_features):
    """Per mode (MISO3, joint MISO2): JAX's enhancement net from
    key(1) trained over JAX's features on the stream of default_rng(1),
    and the port's ``train_enhancer`` from the same params over the port's
    frozen stages with the same MISO1 weights.  Returns (JAX model, JAX
    params after the steps, JAX losses, port log, port Stage2)."""
    cache = {}
    mix_all, ref_all = corpus.mix.numpy(), corpus.ref.numpy()

    def run(joint):
        if joint in cache:
            return cache[joint]
        jenh = (jmodels.make_miso2 if joint else jmodels.make_miso3)(SMALL)
        opt = jtrain.make_optimizer(jcfg.OptimizerConfig(lr=1e-3))
        step = (jtrain.make_enhance_joint_train_step if joint
                else jtrain.make_enhance_train_step)(jenh, opt)
        rng = np.random.default_rng(1)
        state, losses, port = None, [], None
        for _ in range(STEPS3):
            idx = rng.integers(0, N_TRAIN, BATCH)
            x, y = _jax_enh_inputs(*jax_features(jnp.asarray(mix_all[idx]),
                                                 jnp.asarray(ref_all[idx])),
                                   joint)
            if state is None:
                params = jax.jit(jenh.init)(jax.random.key(1), x)
                make = tmodels.make_miso2 if joint else tmodels.make_miso3
                port = _bridge(make(_port(SMALL), MICS, device="cpu"), params)
                state = jtrain.create_train_state(params, opt)
            state, metrics = step(state, x, y)
            losses.append(float(metrics["loss"]))
        stage2 = tcascade.Stage2(_trained_miso1(stage1), _port(STFT), joint,
                                 num_ch=MICS)
        _, log = tcascade.train_enhancer(port, stage2, corpus, STEPS3, BATCH,
                                         every=1)
        cache[joint] = (jenh, state.params, losses, log, stage2)
        return cache[joint]

    return run


def _losses(log):
    return [loss for _, loss, _ in log.points]


def test_miso1_steps_match_jax(stage1):
    _, _, want, log = stage1
    assert [it for it, _, _ in log.points] == list(range(STEPS1))
    assert log.steps == STEPS1 and log.event_ms is None
    np.testing.assert_allclose(_losses(log), want, rtol=RTOL)


def test_stage2_features_match_jax(corpus, stage3, jax_features):
    """The first stage-3 batch's features: the port's Stage2 (the trainer's
    ``enhance_features``) against JAX's composition."""
    stage2 = stage3(False)[4]
    idx = np.random.default_rng(1).integers(0, N_TRAIN, BATCH)
    mix, ref = corpus.mix.numpy()[idx], corpus.ref.numpy()[idx]
    want = jax_features(jnp.asarray(mix), jnp.asarray(ref))
    got = stage2.features(torch.from_numpy(mix), torch.from_numpy(ref))
    for name, g, w in zip(("mix", "ref_al", "m1", "bf"), got, want):
        _max_abs_close(g.numpy(), w, FEATURE_TOL, name)


@pytest.mark.parametrize("joint", [False, True], ids=["miso3", "miso2"])
def test_stage3_steps_match_jax(stage3, joint):
    _, _, want, log, _ = stage3(joint)
    assert log.steps == STEPS3
    np.testing.assert_allclose(_losses(log), want, rtol=RTOL)


@pytest.mark.parametrize("joint", [False, True], ids=["miso3", "miso2"])
def test_eval_stages_match_jax(corpus, stage3, jax_features, joint):
    """train_cascade.py:203-227 with JAX's trained enhancement params on
    both sides: the port's ``eval_stages`` per utterance against JAX's
    stages of the held-out utterances (batched: every stage is per
    utterance)."""
    jenh, params3, _, _, stage2 = stage3(joint)
    make = tmodels.make_miso2 if joint else tmodels.make_miso3
    got = tcascade.eval_stages(
        _bridge(make(_port(SMALL), MICS, device="cpu"), params3), stage2,
        corpus.evals)

    mix_w = np.stack([d["mix"] for d in corpus.evals])
    ref_w = np.stack([d["ref"] for d in corpus.evals])
    mix, ref_al, m1, bf = jax_features(jnp.asarray(mix_w), jnp.asarray(ref_w))
    x, _ = _jax_enh_inputs(mix, ref_al, m1, bf, joint)
    enh = jax.jit(jenh.apply)(params3, x)
    if not joint:
        enh = enh.reshape(m1.shape)
    waves = {k: np.asarray(istft_scaled(v, STFT, SAMPLES))
             for k, v in (("miso1", m1), ("mvdr", bf),
                          ("miso2" if joint else "miso3", enh))}
    want = {"mixture": np.mean([_jax_pit(np.stack([d["mix"][:, 0]] * 2),
                                         d["ref"]) for d in corpus.evals])}
    for k, w in waves.items():
        want[k] = np.mean([_jax_pit(w[i], d["ref"])
                           for i, d in enumerate(corpus.evals)])
    assert list(got) == ["mixture", "miso1", "mvdr",
                         "miso2" if joint else "miso3"]
    for k in got:
        assert abs(got[k] - want[k]) <= DB_TOL, (k, got[k], want[k])


def test_eval_int8_bf16_decode_matches_jax(tmp_path, corpus, stage1):
    """eval_int8's restore of a saved "demo" state and its bf16 decode
    against JAX's bf16 MISO1 on the same weights: the waves, and the
    score against the score of JAX's waves; on the CPU the int8 model runs
    the same plain bf16 modules, so its cost is 0."""
    model = _trained_miso1(stage1)
    opt = make_optimizer(_port(jcfg.OptimizerConfig(lr=1e-3)),
                         model.parameters())
    save_checkpoint(tmp_path, DEMO_TAG, create_train_state(model, opt),
                    {"si_sdr": 1.0})
    bf16 = dataclasses.replace(SMALL, compute_dtype="bfloat16")
    m16, m8, meta = eval_int8.restore(str(tmp_path), _port(bf16), MICS, "cpu")
    assert meta == {"si_sdr": 1.0} and m8.cfg.quant_int8
    for a, b in zip(model.state_dict().values(), m16.state_dict().values()):
        assert torch.equal(a, b)

    apply = jax.jit(jmodels.make_miso1(bf16).apply)
    got = eval_int8.evaluate(m16, m8, _port(STFT), corpus.evals)
    want, own = [], []
    for d in corpus.evals:
        mix = stft_scaled(jnp.asarray(d["mix"][None]).transpose(0, 2, 1),
                          STFT)
        est = np.asarray(istft_scaled(apply(stage1[1], mix), STFT,
                                      SAMPLES))[0]
        port = separate(m16, _port(STFT), d["mix"])
        _max_abs_close(port, est, MODEL_TOL, "bf16 waves")
        assert np.corrcoef(port.ravel(), est.ravel())[0, 1] > 0.999
        want.append(_jax_pit(est, d["ref"]))
        own.append(_jax_pit(port, d["ref"]))
    assert got["bf16"] == pytest.approx(np.mean(own), abs=1e-9)
    assert abs(got["bf16"] - np.mean(want)) <= BF16_DB_TOL
    assert got["int8"] == got["bf16"] and got["cost"] == 0.0


def test_css_longform_pass_matches_jax(stage1):
    """Two 2000-sample blocks of a voiced scene, edge to edge: the port's
    ``run_css`` against JAX's StreamingCSS and the JAX program's score."""
    n = 2 * DS.chunk_samples
    scene = synth_mixture(20_000, n, MICS, voiced=True)
    mix, refs = scene["mix"], scene["ref"]
    css = StreamingCSS(_trained_miso1(stage1), _port(STFT), _port(DS))
    (got,) = css_longform.run_css(css, mix, refs, n / DS.fs)
    out = jcss.StreamingCSS(stage1[0], stage1[1], STFT, DS).process(mix, 0)
    want = {"mixture": _jax_pit(np.stack([mix[:, 0]] * 2), refs),
            "miso1": _jax_pit(np.asarray(out["miso1"]), refs),
            "mvdr": _jax_pit(np.asarray(out["beamformed"]), refs)}
    assert got["overlap"] == 0 and got["audio_s_per_s"] > 0
    for k, w in want.items():
        assert abs(got[k] - w) <= CSS_DB_TOL, (k, got[k], w)
    assert css_longform.passes(_port(DS)) == (0, DS.chunk_samples // 4)

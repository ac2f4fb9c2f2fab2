"""PyTorch port: the MISO1 -> MVDR -> MISO2/MISO3 cascade against the JAX
package on the CPU, with the same weights (moved by the bridge) and the
same seeded inputs: the enhancement nets' forward, ``make_cascade`` and
``CascadeEvaluator.process`` in every mode, and ``evaluate_corpus``.

Tolerances, normalized by the JAX output's max-abs: forwards 1e-4 (float32
on both sides, the JAX plain path); beamformed and enhanced spectrograms
and waves 1e-3 (the JAX package's CPU MVDR solves by LAPACK LU, the port
by kernel 4's Cholesky, after 100 power-iteration steps on each side);
per-stage SI-SDR within 1e-2 dB."""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu.config import DatasetConfig, ModelConfig, StftConfig  # noqa: E402
from misonet_tpu.data.extraction import discover_smswsj  # noqa: E402
from misonet_tpu.data.synthetic import synth_shard_dir  # noqa: E402
from misonet_tpu.inference.cascade import make_cascade as jax_make_cascade  # noqa: E402
from misonet_tpu.inference.evaluate import CascadeEvaluator as JaxEvaluator  # noqa: E402
from misonet_tpu.models import make_miso1 as jax_miso1  # noqa: E402
from misonet_tpu.models import make_miso2 as jax_miso2  # noqa: E402
from misonet_tpu.models import make_miso3 as jax_miso3  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch.data.wavio import read_wav  # noqa: E402
from misonet_tpu_torch.inference.cascade import make_cascade  # noqa: E402
from misonet_tpu_torch.inference.evaluate import CascadeEvaluator  # noqa: E402
from misonet_tpu_torch.models import make_miso1, make_miso2, make_miso3  # noqa: E402
from misonet_tpu_torch.utils.weights import load_jax_params  # noqa: E402

STFT = StftConfig(fs=8000, length=32, overlap=24)  # 17 bins
SMALL = ModelConfig(
    num_bottleneck=4, en_channels=(8, 8, 8, 16), de_channels=(16, 8, 8, 8),
    tcn_repeats=1, tcn_blocks=2, tcn_channels=16, compute_dtype="float32",
)
DS = DatasetConfig(num_ch=3, num_ch_utilize=3, num_spks=2, ref_ch=0,
                   chunk_time=0.25, least_time=0.125)  # 2000-sample chunks
MICS = 3


def _port(cfg):
    """The port's copy of a JAX package config."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.iscomplexobj(want):
        got, want = got.view(np.float32), want.view(np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _random_params(model, x, seed):
    """JAX params of ``model`` with random values (shapes traced only):
    LeCun-scaled kernels, small random biases and affine terms."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), x)
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 0
        std = 1.0 / np.sqrt(fan_in) if fan_in > 1 else 0.1
        return jnp.asarray((std * rng.standard_normal(s.shape))
                           .astype(np.float32))

    return jax.tree.map(draw, shapes)


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pair(kind, cfg, seed, t=16, f=17):
    """(JAX model, its random params, the port's model with those params)
    for ``kind`` in miso1 / miso2 / miso3 at MICS mics."""
    jmake, tmake, ch = {
        "miso1": (jax_miso1, make_miso1, MICS),
        "miso2": (jax_miso2, make_miso2, MICS + 4),
        "miso3": (jax_miso3, make_miso3, MICS + 2),
    }[kind]
    jmodel = jmake(cfg)
    probe = jax.lax.complex(jnp.zeros((1, ch, t, f)), jnp.zeros((1, ch, t, f)))
    params = _random_params(jmodel, probe, seed)
    model = tmake(_port(cfg), num_mics=MICS, device="cpu")
    return jmodel, params, load_jax_params(model, params).eval()


# the narrow 7-level plan of tests/test_torch_slice.py at F = 129: the
# enhancement nets' own depth (MISO2 / MISO3 at 3 mics: enc0 in-channels
# 14 / 10, final transpose conv N = 4 / 2)
NARROW = ModelConfig(
    en_channels=(8, 8, 8, 8, 8, 16, 16), de_channels=(16, 16, 8, 8, 8, 8, 8),
    tcn_repeats=1, tcn_blocks=3, tcn_channels=16, compute_dtype="float32",
    flat_dense=False,
)


@pytest.mark.parametrize("kind", ["miso2", "miso3"])
def test_enhance_forward_matches_jax(kind):
    """The SMALL plan's MISO2/3 forwards are held to JAX below, inside the
    cascade."""
    jmodel, params, model = _pair(kind, NARROW, 11, t=8, f=129)
    ch = MICS + (4 if kind == "miso2" else 2)
    x = _complex(np.random.default_rng(1), (2, ch, 8, 129))
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2 if kind == "miso2" else 1, 8, 129)
    _close(got, want, 1e-4)


@pytest.fixture(scope="module")
def nets():
    return {k: _pair(k, SMALL, seed) for k, seed in
            [("miso1", 2), ("miso2", 3), ("miso3", 4)]}


@pytest.mark.parametrize("joint", [False, True])
def test_make_cascade_matches_jax(nets, joint):
    j1, p1, m1 = nets["miso1"]
    je, pe, me = nets["miso2" if joint else "miso3"]
    mix = _complex(np.random.default_rng(5), (2, MICS, 16, 17))
    want = jax_make_cascade(j1, je, MICS, joint=joint)(p1, pe,
                                                       jnp.asarray(mix))
    got = make_cascade(m1, me, MICS, joint=joint)(torch.from_numpy(mix))
    assert set(got) == set(want)
    for k in ("miso1", "miso1_full"):
        _close(got[k].numpy(), np.asarray(want[k]), 1e-4)
    for k in ("bf", "enhanced"):
        assert got[k].shape == (2, 2, 16, 17)
        _close(got[k].numpy(), np.asarray(want[k]), 1e-3)


# (beamform_utterance, enhance net): the JAX package's modes
MODES = {
    "utterance-miso3": (True, "miso3"),
    "chunk-miso3": (False, "miso3"),
    "chunk-miso2-joint": (False, "miso2"),
    "utterance-bf-only": (True, None),
}


@pytest.fixture(scope="module")
def evaluators(nets):
    """One (JAX, port) evaluator pair per mode, built on first use."""
    cache = {}

    def get(mode):
        if mode not in cache:
            utt, enh = MODES[mode]
            j1, p1, m1 = nets["miso1"]
            je, pe, me = nets[enh] if enh else (None, None, None)
            joint = enh == "miso2"
            cache[mode] = (
                JaxEvaluator(j1, p1, STFT, DS, enhance_model=je,
                             enhance_params=pe, joint=joint,
                             beamform_utterance=utt),
                CascadeEvaluator(m1, _port(STFT), _port(DS),
                                 enhance_model=me, joint=joint,
                                 beamform_utterance=utt),
            )
        return cache[mode]

    return get


def _request(n=4500):
    """Three chunks (the last one padded), a bucket of four."""
    rng = np.random.default_rng(7)
    src = rng.standard_normal((2, n)).astype(np.float32)
    mix = (np.stack([src[0] + 0.5 * src[1], 0.7 * src[0] + src[1],
                     src[0] - src[1]], axis=1)
           + 0.05 * rng.standard_normal((n, MICS))).astype(np.float32)
    return mix, src


@pytest.mark.parametrize("with_refs", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_evaluator_matches_jax(evaluators, mode, with_refs):
    jev, tev = evaluators(mode)
    mix, src = _request()
    refs = src if with_refs else None
    want = jev.process(mix, refs)
    got = tev.process(mix, refs)
    for stage in ("separated", "beamformed", "enhanced"):
        g, w = getattr(got, stage), getattr(want, stage)
        assert (g is None) == (w is None), stage
        if w is not None:
            assert g.shape == (2, mix.shape[0]) and np.isfinite(g).all()
            _close(g, w, 1e-4 if stage == "separated" else 1e-3)
    assert got.beamformed is not None
    assert (got.enhanced is None) == (MODES[mode][1] is None)
    assert set(got.si_sdr) == set(want.si_sdr)
    for k in want.si_sdr:
        assert abs(got.si_sdr[k] - want.si_sdr[k]) < 1e-2, (k, got.si_sdr,
                                                            want.si_sdr)


def test_default_evaluator_beamforms_the_utterance(nets):
    """The constructor's defaults (utterance-mode MVDR, no enhance net) run."""
    _, _, m1 = nets["miso1"]
    ev = CascadeEvaluator(m1, _port(STFT), _port(DS))
    res = ev.process(*_request(2500))
    assert res.beamformed.shape == (2, 2500) and res.enhanced is None
    assert set(res.si_sdr) == {"miso1", "beamform"}


def test_evaluate_corpus_writes_every_stage(evaluators, tmp_path):
    root = tmp_path / "corpus"
    synth_shard_dir(root, num_utts=2, num_samples=4500, num_ch=MICS,
                    chunk=2000, least=1000)
    specs = discover_smswsj(root / "wav", root / "wav", num_spks=2)
    jev, tev = evaluators("utterance-miso3")
    scores = tev.evaluate_corpus(specs, tmp_path / "out", workers=2)
    assert set(scores) == {"miso1", "beamform", "enhanced"}
    assert all(np.isfinite(v) for v in scores.values())
    for stage in ["MISO1", "Beamforming", "Enhanced"]:
        wavs = sorted((tmp_path / "out" / stage).glob("*.wav"))
        assert [w.name for w in wavs] == sorted(
            f"{s.utt_id}_{k}.wav" for s in specs for k in range(2))
        wave, fs = read_wav(wavs[0])
        assert fs == 8000 and wave.shape == (4500,)
    # the thread pool changes the schedule, not the numbers
    want = jev.evaluate_corpus(specs, tmp_path / "jax", write=False,
                               workers=1)
    for k in want:
        assert abs(scores[k] - want[k]) < 1e-2, (k, scores, want)

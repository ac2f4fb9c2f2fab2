"""PyTorch port, the trainers (misonet_tpu_torch/train/trainer.py) against
the JAX package's misonet_tpu/train/trainer.py, float32 on the CPU, at the
small plan of tests/test_trainer.py (4 levels, 17 bins).

* One epoch of ``SeparationTrainer`` and of ``EnhanceTrainer`` (MISO3, the
  frozen MISO1's decode and the MVDR in its feature step) from the same
  weights (JAX's initial params, moved by the bridge) and the same batches:
  the epoch's train and validation losses within 1e-3 relative.  The
  first step's loss agrees to float32 rounding; the later ones follow an
  Adam update, whose first step is about lr * sign(g), so a gradient
  element near zero whose sign the two frameworks round apart moves its
  parameter by 2 lr; that bounds how far the epoch means can drift.
* Resume: 1 epoch, then a new trainer resuming from ``epoch000`` for a
  second, gives the same parameters, optimizer state and history as 2
  epochs straight, bit for bit.
* The writer's tags (a recording writer, as tests/test_trainer.py), the
  overest penalty, checkpoints, and the refusal of what is not a mesh.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu import config as jcfg  # noqa: E402
from misonet_tpu import models as jmodels  # noqa: E402
from misonet_tpu.train import trainer as jtrainer  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch import models as tmodels  # noqa: E402
from misonet_tpu_torch.losses import magnitude_distance  # noqa: E402
from misonet_tpu_torch.train.trainer import (  # noqa: E402
    EnhanceTrainer,
    SeparationTrainer,
)
from misonet_tpu_torch.utils.checkpoint import latest_checkpoint  # noqa: E402
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
DS = jcfg.DatasetConfig(num_ch=3, num_ch_utilize=3, num_spks=2, ref_ch=0)
SAMPLES = 512
RTOL = 1e-3


def _port(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _batches(seed, n=2, b=2):
    """Two sources mixed to 3 mics with per-mic gains, plus noise (as
    tests/test_torch_train.py), so uPIT's permutation is clear."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        src = 0.1 * rng.standard_normal((b, 2, SAMPLES)).astype(np.float32)
        gains = rng.uniform(0.3, 1.0, (b, 2, 3)).astype(np.float32)
        mix = np.einsum("bks,bkc->bsc", src, gains)
        mix += 0.005 * rng.standard_normal(mix.shape).astype(np.float32)
        out.append({"mix": mix.astype(np.float32), "ref": src})
    return out


def _trainer_cfg(tmp_path, name, **kw):
    return jcfg.TrainerConfig(epochs=1, save_folder=str(tmp_path / name),
                              checkpoint_every=1, print_freq=100, **kw)


def _bridge(factory, params, **kw):
    return load_jax_params(factory(_port(SMALL), num_mics=3, device="cpu",
                                   **kw), jax.tree.map(np.asarray, params))


def _close(got: dict, want: dict):
    for k in ("train", "val"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def test_separation_epoch_matches_jax(tmp_path):
    train, val = _batches(0), _batches(1, n=1)
    jtr = jtrainer.SeparationTrainer(
        jmodels.make_miso1(SMALL), _trainer_cfg(tmp_path, "jax"),
        jcfg.OptimizerConfig(), STFT, DS, train_data=train, val_data=val)
    jtr._init_state(train[0])   # JAX's initial params, before any step
    model = _bridge(tmodels.make_miso1, jtr.state.params)
    want = jtr.train()

    tr = SeparationTrainer(
        model, _port(_trainer_cfg(tmp_path, "port")),
        _port(jcfg.OptimizerConfig()), _port(STFT), _port(DS),
        train_data=train, val_data=val)
    got = tr.train()
    assert len(got["train"]) == len(got["val"]) == 1
    _close(got, want)
    assert tr.state.step == 2
    names = {p.name for p in (tmp_path / "port").iterdir()}
    assert {"epoch000", "epoch000.meta.json", "best", "best.meta.json"} <= names


def test_enhance_epoch_matches_jax(tmp_path):
    """MISO3 over the frozen MISO1's features (decode + MVDR on the
    device), speakers folded into the batch."""
    train, val = _batches(4, n=1), _batches(5, n=1)
    jmiso1 = jmodels.make_miso1(SMALL)
    probe = jax.lax.complex(jax.numpy.zeros((1, 3, 16, 17)),
                            jax.numpy.zeros((1, 3, 16, 17)))
    p1 = jmiso1.init(jax.random.key(1), probe)
    jtr = jtrainer.EnhanceTrainer(
        jmodels.make_miso3(SMALL), jmiso1, p1, _trainer_cfg(tmp_path, "jax"),
        jcfg.OptimizerConfig(), STFT, DS, train_data=train, val_data=val)
    jtr._init_state(train[0])
    miso3 = _bridge(tmodels.make_miso3, jtr.state.params)
    miso1 = _bridge(tmodels.make_miso1, p1)
    want = jtr.train()

    tr = EnhanceTrainer(
        miso3, miso1, _port(_trainer_cfg(tmp_path, "port")),
        _port(jcfg.OptimizerConfig()), _port(STFT), _port(DS),
        train_data=train, val_data=val)
    got = tr.train()
    _close(got, want)
    # the feature step's speaker alignment is clear (the other assignment
    # costs well beyond rounding more), so both frameworks pair alike
    _, ref_aligned, miso1_ref, bf = tr.feature_step(train[0]["mix"],
                                                    train[0]["ref"])
    t = STFT.num_frames(SAMPLES)
    assert miso1_ref.shape == bf.shape == ref_aligned.shape == (2, 2, t, 17)
    assert not miso1_ref.requires_grad and not miso1_ref.is_inference()
    d = magnitude_distance(miso1_ref, ref_aligned)           # [B, S, S]
    kept = d.diagonal(dim1=1, dim2=2).sum(-1)
    swapped = d[:, 0, 1] + d[:, 1, 0]
    assert ((swapped - kept) / kept).min() > 1e-3


def _sep_trainer(tmp_path, epochs, resume="", writer=None, alpha=0.0,
                 seed=2):
    model = tmodels.make_miso1(_port(SMALL), num_mics=3, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
    cfg = tcfg.TrainerConfig(epochs=epochs, save_folder=str(tmp_path),
                             checkpoint_every=1, print_freq=100,
                             resume=resume, overest_alpha=alpha)
    return SeparationTrainer(model, cfg, tcfg.OptimizerConfig(),
                             _port(STFT), _port(DS), _batches(6),
                             _batches(7, n=1), writer=writer)


def test_resume_equals_straight_run(tmp_path):
    straight = _sep_trainer(tmp_path / "a", 2)
    hist = straight.train()
    first = _sep_trainer(tmp_path / "b", 1)
    first.train()
    assert latest_checkpoint(tmp_path / "b") == "epoch000"
    resumed = _sep_trainer(tmp_path / "b", 2, resume="epoch000", seed=9)
    got = resumed.train()
    assert resumed.start_epoch == 1 and resumed.state.step == 4
    assert got == hist
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa = straight.optimizer.inner.state_dict()["state"]
    sb = resumed.optimizer.inner.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][key], sb[k][key]), (k, key)
    assert resumed.scheduler.best == straight.scheduler.best


class RecordingWriter:
    def __init__(self):
        self.scalars, self.specs, self.audios = [], [], []

    def scalar(self, tag, value, step):
        self.scalars.append(tag)

    def spectrogram(self, tag, spec, step):
        self.specs.append(tag)

    def audio(self, tag, spec, step, num_samples):
        self.audios.append(tag)

    def step_start(self):
        pass

    def step_end(self, step, audio_seconds=None):
        pass


def test_writer_tags(tmp_path):
    """The JAX trainers' logging set: per-step loss (and grad norm for
    MISO1), epoch losses and lr, and the first validation batch's
    spectrograms and audio (MISO1's estimate; every cascade stage for the
    enhancement trainer, trainer.py:445-497)."""
    writer = RecordingWriter()
    _sep_trainer(tmp_path / "sep", 1, writer=writer).train()
    assert {"train/loss", "train/grad_norm", "train/epoch_loss",
            "val/epoch_loss", "train/lr"} <= set(writer.scalars)
    assert writer.specs == writer.audios == ["val/est_s0"]

    writer = RecordingWriter()
    miso1 = tmodels.make_miso1(_port(SMALL), num_mics=3, device="cpu")
    miso3 = tmodels.make_miso3(_port(SMALL), num_mics=3, device="cpu")
    cfg = tcfg.TrainerConfig(epochs=1, save_folder=str(tmp_path / "enh"),
                             checkpoint_every=1, print_freq=100)
    EnhanceTrainer(miso3, miso1, cfg, tcfg.OptimizerConfig(), _port(STFT),
                   _port(DS), _batches(8, n=1, b=1), _batches(9, n=1, b=1),
                   writer=writer).train()
    stages = [f"val/{t}" for t in ("mix", "clean_s0", "miso1_s0", "bf_s0",
                                   "enhanced_s0")]
    assert writer.specs == writer.audios == stages
    assert {"train/loss", "val/epoch_loss"} <= set(writer.scalars)


def test_overest_alpha(tmp_path):
    """overest_alpha trains with loss_upit_overest at alpha = (epoch + 1)
    * overest_alpha: on the same weights and data its epoch loss is at
    least plain uPIT's (the penalty is non-negative), finite."""
    losses = {}
    for alpha in (0.0, 0.05):
        hist = _sep_trainer(tmp_path / f"ck{alpha}", 1, alpha=alpha).train()
        assert np.isfinite(hist["train"]).all()
        losses[alpha] = hist["train"][0]
    assert losses[0.05] > losses[0.0]


def test_trainers_refuse_a_mesh(tmp_path):
    """The trainers take a ``parallel.Mesh`` (tests/test_torch_parallel.py
    trains on two ranks) and refuse anything else as one."""
    model = tmodels.make_miso1(_port(SMALL), num_mics=3, device="cpu")
    cfg = tcfg.TrainerConfig(save_folder=str(tmp_path))
    with pytest.raises(TypeError, match="parallel.Mesh"):
        SeparationTrainer(model, cfg, tcfg.OptimizerConfig(), _port(STFT),
                          _port(DS), [], [], mesh=object())

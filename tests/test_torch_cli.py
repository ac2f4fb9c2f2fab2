"""PyTorch port, the command line (``python -m misonet_tpu_torch``) on the
CPU: tests/test_cli.py's tiny YAML and synthetic corpus through
Extraction -> Train MISO1 -> Test MISO1 and CSS, each a fresh
``python -m misonet_tpu_torch ... --device cpu`` process, at the YAML's
precision (bfloat16, the default, on the plain modules); and the port's
``load_yaml`` against the JAX package's, field by field, on that YAML and
on the repo's configs."""

import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from misonet_tpu import config as jcfg  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch.data.synthetic import synth_mixture  # noqa: E402
from misonet_tpu_torch.data.wavio import read_wav, write_wav  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300   # seconds a CLI command may take (~5 s alone)

TINY = """
SMS_WSJ:
  rootdir: {root}/corpus/
  fs: 8000
  chunk_time: 0.25
  least_time: 0.125
  num_spks: 2
  num_ch: 3
  num_ch_utilize: 3
  ref_ch: 0
  saved_tr_pickle_dir: {root}/shards/
  saved_dt_pickle_dir: {root}/shards/
STFT:
  fs: 8000
  window: hann
  length: 32
  overlap: 24
dataloader:
  Train:
    batch_size: 2
MISO_1:
  num_bottleneck: 4
  en_bottleneck_channels: [8, 8, 8, 16]
  de_bottleneck_channels: [16, 8, 8, 8]
  norm_type: IN
MISO_3:
  num_bottleneck: 4
  en_bottleneck_channels: [8, 8, 8, 16]
  de_bottleneck_channels: [16, 8, 8, 8]
  norm_type: IN
trainer_sp:
  epochs: 1
  print_freq: 100
  save_folder: {root}/model_result/miso1
  check_point: [True, 1]
trainer_en:
  epochs: 1
  print_freq: 100
  MISO1_path: {root}/model_result/miso1/best
  save_folder: {root}/model_result/miso3
  check_point: [True, 1]
optimizer:
  name: Adam
  lr: 0.001
scheduler:
  name: plateau
  factor: 0.5
  patience: 3
  min_lr: 0.000005
"""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    obs = root / "corpus" / "observation"
    src = root / "corpus" / "speech_source"
    obs.mkdir(parents=True)
    src.mkdir(parents=True)
    for u in range(3):
        d = synth_mixture(u, num_samples=2500, num_ch=3)
        write_wav(obs / f"utt{u}.wav", d["mix"], 8000)
        for s in range(2):
            write_wav(src / f"utt{u}_{s}.wav", d["ref"][s], 8000)
    cfg = root / "tiny.yml"
    cfg.write_text(TINY.format(root=root))
    return root, cfg


def _cli(cfg, *args):
    """One ``python -m misonet_tpu_torch`` process (and its extraction
    workers) with one intra-op thread, as it runs beside the suite's other
    test processes.  Past TIMEOUT its process group gets SIGABRT, so the
    fault handler prints every thread's stack into the failure."""
    proc = subprocess.Popen(
        [sys.executable, "-X", "faulthandler", "-m", "misonet_tpu_torch",
         "-c", str(cfg), *args, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"}, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGABRT)
        out, err = proc.communicate()
        pytest.fail(f"{args} ran past {TIMEOUT} s:\n{err[-8000:]}")
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.mark.parametrize("name", ["tiny", "smswsj", "reverb_2mix"])
def test_load_yaml_matches_jax(name, tmp_path):
    path = (ROOT / "configs" / f"{name}.yml" if name != "tiny" else
            tmp_path / "tiny.yml")
    if name == "tiny":
        path.write_text(TINY.format(root=tmp_path))
    want = dataclasses.asdict(jcfg.load_yaml(path))
    got = dataclasses.asdict(tcfg.load_yaml(path))
    assert got == want
    assert got["miso1"]["compute_dtype"] == "bfloat16"   # the default


def test_config_refuses_a_mesh():
    """A data-parallel mesh of any size is taken (parallel/ is ported);
    only a negative device count is refused."""
    with pytest.raises(ValueError, match="num_devices=-1"):
        tcfg.Config(mesh=tcfg.MeshConfig(num_devices=-1))
    assert tcfg.Config(mesh=tcfg.MeshConfig(num_devices=2)).mesh.num_devices


def test_cli_extraction_train_test(corpus):
    """Extraction -> Train MISO1 (bf16, 1 epoch) -> Test MISO1 (PCM_24
    wavs) -> Test CSS, through the port's CLI processes."""
    root, cfg = corpus
    out = _cli(cfg, "-m", "Extraction")
    assert "extracted 6 chunks from 3 utterances" in out
    assert len(list((root / "shards").glob("*.npz"))) == 6

    out = _cli(cfg, "-m", "Train", "-t", "MISO1", "-n", str(root / "logs"))
    loss = float(out.split("epoch 0: train ")[1].split()[0])
    assert np.isfinite(loss)
    ck = root / "model_result" / "miso1"
    assert {"best", "epoch000", "best.meta.json"} <= {
        p.name for p in ck.iterdir()}

    out = _cli(cfg, "-m", "Test", "-t", "MISO1", "-n", str(root / "eval"),
               "--max-utts", "1", "--wav-subtype", "PCM_24")
    assert "mean SI-SDR per stage" in out
    wavs = sorted((root / "eval" / "wav_out").rglob("*.wav"))
    assert len(wavs) == 2     # 1 utterance x 2 speakers, MISO1 stage
    data, sr = read_wav(wavs[0])
    assert np.isfinite(data).all() and sr == 8000 and data.shape == (2500,)

    out = _cli(cfg, "-m", "Test", "-t", "CSS", "-n", str(root / "css"),
               "--max-utts", "2", "--css-overlap", "500")
    assert "mean PIT-SI-SDR per stage" in out
    # 2 utts x 2 speakers x 2 stages (miso1 + beamformed)
    assert len(list((root / "css" / "wav_out").rglob("*.wav"))) == 8

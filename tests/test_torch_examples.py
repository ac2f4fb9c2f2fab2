"""PyTorch port, the example programs' entry points (``python -m
misonet_tpu_torch.examples.<name>``) as processes on the CPU, at
tests/test_cli.py's tiny YAML plan: train_synthetic trains 2 steps and
saves its "demo" state, eval_int8 and css_longform restore it; every
printed result line parses.  Asked for the card where there is none,
each program exits non-zero with its message and prints no result."""

import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_cli import TINY  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300   # seconds a program may take (~5-10 s alone)
NUM = r"(-?\d+(?:\.\d+)?)"
PROGRAMS = ("train_synthetic", "train_cascade", "eval_int8", "css_longform")


def _run(name, *args, ok=True):
    """One ``python -m misonet_tpu_torch.examples.<name>`` process with one
    intra-op thread; past TIMEOUT its process group gets SIGABRT, so the
    fault handler prints every thread's stack into the failure."""
    proc = subprocess.Popen(
        [sys.executable, "-X", "faulthandler", "-m",
         f"misonet_tpu_torch.examples.{name}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"}, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGABRT)
        out, err = proc.communicate()
        pytest.fail(f"{name} {args} ran past {TIMEOUT} s:\n{err[-8000:]}")
    if ok:
        assert proc.returncode == 0, err[-4000:]
    return proc.returncode, out, err


def _values(out, pattern):
    """The numbers of the one line that matches ``pattern``."""
    found = [m.groups() for m in map(re.compile(pattern).fullmatch,
                                     out.splitlines()) if m]
    assert len(found) == 1, (pattern, out)
    return [float(v) for v in found[0]]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_synthetic, 2 steps at the tiny plan, saved under ``ckpt``."""
    root = tmp_path_factory.mktemp("examples")
    cfg = root / "tiny.yml"
    cfg.write_text(TINY.format(root=root))
    _, out, _ = _run("train_synthetic", "--device", "cpu", "--config",
                     str(cfg), "--steps", "2", "--train-utts", "4",
                     "--eval-utts", "2", "--samples", "2000", "--save",
                     str(root / "ckpt"))
    return root, cfg, out


def test_train_synthetic_prints_and_saves(trained):
    root, _, out = trained
    assert out.splitlines()[0] == "platform=cpu compute=float32 ch=3 F=17"
    losses = [float(m.group(1)) for m in
              re.finditer(r"^step \d+: loss (\S+) \(\d+s\)$", out, re.M)]
    assert len(losses) == 2
    base, = _values(out, rf"mixture SI-SDR: {NUM} dB")
    sep, = _values(out, rf"MISO1 separated SI-SDR: {NUM} dB")
    gain, = _values(out, rf"improvement: {NUM} dB")
    assert gain == pytest.approx(sep - base, abs=0.011)
    assert f"checkpoint saved to {root / 'ckpt'}/demo" in out
    assert (root / "ckpt" / "demo" / "state.pt").exists()
    assert (root / "ckpt" / "demo.meta.json").exists()


def test_eval_int8_restores_and_prints(trained):
    root, cfg, _ = trained
    _, out, _ = _run("eval_int8", "--device", "cpu", "--config", str(cfg),
                     "--ckpt", str(root / "ckpt"), "--eval-utts", "2",
                     "--samples", "2000")
    assert out.startswith(f"restored {root / 'ckpt'}/demo meta=")
    base, = _values(out, rf"mixture SI-SDR: +{NUM} dB")
    s16, = _values(out, rf"bf16 decode SI-SDR: +{NUM} dB")
    s8, cost = _values(out, rf"int8 decode SI-SDR: +{NUM} dB  "
                            rf"\(cost \+?{NUM} dB\)")
    # on the CPU the int8 model runs the plain bf16 modules: no cost
    assert s8 == s16 and cost == 0.0


def test_css_longform_restores_and_prints(trained):
    root, cfg, _ = trained
    _, out, _ = _run("css_longform", "--device", "cpu", "--config", str(cfg),
                     "--ckpt", str(root / "ckpt"), "--seconds", "0.5")
    assert out.splitlines()[0] == "platform=cpu scene=0s x 3ch"
    rows = {}
    for overlap in (0, 500):
        tag = re.escape(f"overlap={overlap}"
                        + (" (cross-fade)" if overlap else ""))
        rows[overlap] = _values(
            out, rf"{tag} *: mixture +{NUM}  miso1 +{NUM}  mvdr +{NUM} dB "
                 rf"+\({NUM} audio-s/s\)")
    assert rows[0][0] == rows[500][0]   # one scene, one mixture score


@pytest.mark.parametrize("name", PROGRAMS)
def test_programs_refuse_a_missing_card(name):
    """``--device cuda`` (the default) on a machine without a card: a
    non-zero exit with the message, no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = _run(name, ok=False)
    assert rc != 0
    assert "--device cuda: no CUDA device is available" in err
    assert "SI-SDR" not in out and "step" not in out

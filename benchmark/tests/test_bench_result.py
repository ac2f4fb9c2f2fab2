"""The result line's keys, and run.py's refusal to run without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_keys_on_the_cpu(tmp_path):
    root = tiny.make_root(tmp_path)
    r = harness.run_cell(harness.Bench(root, root / "benchmark"), "tiny.train",
                         11, 0.3, False, "cpu", 0.0)
    assert list(r) == KEYS + ["checks"]          # the compared numbers last
    assert set(r["metrics"]) == {"train_step_ms", "setup_s"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_run_exits_nonzero_without_a_card():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "smswsj.css",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


@pytest.mark.cuda
def test_traced_line_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "smswsj.css",
         "--seed", "3", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert line["correct"]

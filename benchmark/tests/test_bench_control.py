"""The controls that the correctness limits' upper readings come from read
above the sound program: the fp8 reference in a training step's place (on
the CPU, tiny plan), and the program's int8 decode in a serving cell (on
the card only: the int8 path is a CUDA kernel)."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.drivers import cascade, train
from benchmark.tests import tiny

FOLDER = Path(__file__).resolve().parents[1]


def test_fp8_reference_reads_above_the_bf16_program():
    cell = tiny.CELLS["tiny.train"]
    cfg = dict(tiny.CONFIG, nets=["miso1"])
    s = train.Session(cell, cfg, 13, "cpu")
    ref = s.reference()
    sound = train.compare(s, ref)
    got = s.reference(quant="fp8")
    s.losses, s.grad1, s.params3 = got["loss"], got["grad1"], got["params"]
    control = train.compare(s, ref)
    ratios = [control[k] / sound[k] for k in sound if sound[k]]
    assert max(ratios) > 3, (sound, control)


@pytest.mark.cuda
def test_int8_decode_reads_above_the_bf16_program():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = json.loads((FOLDER / "workloads" / "smswsj.cascade.json").read_text())
    cell["traffic"].update(pool=3, min_s=2.0, max_s=6.0)
    cell["check"]["requests"] = 3
    cfg = json.loads((FOLDER / "configs" / "miso_smswsj_bf16.json").read_text())
    out = {}
    for quant in (False, True):
        s = cascade.Session(cell, cfg, 17, "cuda", quant_int8=quant)
        s.window(1.0)
        out[quant] = {k: v for k, v, _ in s.check()}
    assert any(out[True][k] > out[False][k] for k in out[False]), out

"""The benchmark's FLOP count against torch's FlopCounterMode on the plain
reference, for both configurations' plans and the tiny one."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference.nets import MISONet
from benchmark.tests import tiny

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cases():
    for path in sorted(CONFIGS.glob("*.json")):
        yield json.loads(path.read_text())
    yield tiny.CONFIG


@pytest.mark.parametrize("cfg", list(_cases()), ids=lambda c: c["name"])
def test_forward_flops_match_flop_counter(cfg):
    for name, net in work.nets(cfg).items():
        ref = MISONet(cfg["model"], net["in_channels"], net["num_spks"])
        x = torch.zeros(1, net["in_channels"], 3, net["f"], dtype=torch.complex64)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            ref(x)
        assert fc.get_total_flops() == work.forward_flops(net, 3), name


def test_groups_partition_the_forward_and_fused_plan():
    cfg = json.loads((CONFIGS / "miso_smswsj_bf16.json").read_text())
    net = work.nets(cfg)["miso1"]
    parts = sum(work.forward_flops(net, 501, [g])
                for g in ("dense_stack", "stencil", "other"))
    assert parts == work.forward_flops(net, 501)
    groups = [ly.group for ly in work.layers(**{k: net[k] for k in
                                               ("plan", "in_channels", "num_spks", "f")})]
    assert groups.count("dense_stack") == 50 and groups.count("stencil") == 10
    assert round(work.forward_flops(net, 501) / 1e9, 1) == 75.2


def test_backward_counts_one_input_gradient_less():
    net = work.nets(tiny.CONFIG)["miso1"]
    fwd = work.forward_flops(net, 5)
    first = work.layers(net["plan"], net["in_channels"], net["num_spks"], net["f"])[0]
    assert work.backward_flops(net, 5) == 2 * fwd - 2 * first.macs(5)

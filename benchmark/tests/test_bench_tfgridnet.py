"""The TF-GridNet configuration's files: ``work_tfgridnet.py``'s count
against ``torch.utils.flop_counter`` over the plain reference's forward,
the reference's recurrence against torch's LSTM, the cell and its metrics
found by the harness with no edit, the metric readers on a hand-built run,
and the cell's driver end to end at a tiny size on the CPU."""

import json
import math
import shutil
import types
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, work_tfgridnet
from benchmark.reference import tfgridnet as ref

ROOT = Path(__file__).resolve().parents[2]
CELL = "tfgridnet.train_b8"
CONFIG = json.loads(
    (ROOT / "benchmark/configs/tfgridnet/tfgridnet_smswsj_bf16.json").read_text())
NEW = ("tfgridnet_lstm_roofline.train", "tfgridnet_lstm_ms_per_step",
       "tfgridnet_attn_ms_per_step")


def tiny_config(**model) -> dict:
    """The configuration at D = 8, H = 8, 2 blocks, 2 heads, F = 17, 3 mics
    and 0.125 s chunks (T = 17 frames)."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg.update(name="tinygrid", stft={"fs": 8000, "length": 32, "overlap": 24})
    cfg["dataset"].update(chunk_time=0.125, num_ch=3)
    cfg["model"].update(n_layers=2, emb_dim=8, lstm_hidden_units=8,
                        attn_n_head=2, **model)
    return cfg


@pytest.mark.parametrize("model", [{}, {"emb_hs": 2}, {"emb_ks": 3}])
def test_forward_count_equals_flop_counter(model):
    cfg = tiny_config(**model)
    s = work_tfgridnet.shape(cfg)
    net = ref.TFGridNet(cfg["model"], s["m"], s["s"], s["f"])
    net.load_state_dict(ref.make_state_dict(net, 1, "cpu"))
    x = torch.randn(2, s["m"], s["t"], s["f"], dtype=torch.complex64)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(x)
    assert fc.get_total_flops() == 2 * work_tfgridnet.forward_flops(cfg)


def test_published_count_and_lstm_share():
    """One 4 s item: 522.4 GMAC (1.045 TFLOP) forward, 86 % of it the
    twelve BLSTMs; a step of batch 8 is 25.1 TFLOP."""
    item = work_tfgridnet.forward_item(CONFIG)
    total = work_tfgridnet.forward_flops(CONFIG)
    assert round(total / 2e9, 1) == 522.4
    assert round(item["lstm"][0] / total, 2) == 0.86
    assert round(3 * 8 * total / 1e12, 1) == 25.1
    fl, nb = work_tfgridnet.of_passes(
        CONFIG, [{"net": "miso1", "items": 8, "backward": True}] * 2, "lstm",
        backward=True)
    assert fl == 2 * 2 * 8 * item["lstm"][0] and nb == 2 * 2 * 8 * item["lstm"][1]


def test_recurrence_matches_torch_lstm():
    """The reference's BLSTM against ``nn.LSTM`` holding the same weights."""
    rec = ref.BLSTM(12, 6)
    rec.load_state_dict(ref.make_state_dict(rec, 4, "cpu"))
    lstm = torch.nn.LSTM(12, 6, batch_first=True, bidirectional=True)
    lstm.load_state_dict(rec.state_dict())
    x = torch.randn(5, 9, 12)
    with torch.no_grad():
        torch.testing.assert_close(rec(x), lstm(x)[0], rtol=1e-5, atol=1e-6)


def test_fp8_control_moves_the_output():
    cfg = tiny_config()
    s = work_tfgridnet.shape(cfg)
    net = ref.TFGridNet(cfg["model"], s["m"], s["s"], s["f"])
    net.load_state_dict(ref.make_state_dict(net, 2, "cpu"))
    x = torch.randn(2, s["m"], s["t"], s["f"], dtype=torch.complex64)
    with torch.no_grad():
        want = net(x)
        net.set_quant("fp8")
        got = net(x)
    gap = float((got - want).abs().norm() / want.abs().norm())
    assert 0.01 < gap < 0.5


def test_cell_and_metrics_are_found():
    bench = harness.Bench(ROOT)
    e2e = {m["name"] for m in bench.metrics_for(CELL, False)}
    assert {"setup_s", "train_step_ms", "peak_gib"} <= e2e
    layer = {m["name"]: m for m in bench.metrics_for(CELL, True)}
    assert set(NEW) <= set(layer)
    assert not {"glue_ms_per_step", "stencil_bwd_roofline.train"} & set(layer)
    for m in layer.values():
        assert m["moves"] in e2e
        assert bench.metric(m["name"]).read is not None
    cell = bench.cell(CELL)
    assert cell["traffic"]["batch"] == CONFIG["batch_size"] == 8
    assert bench.driver(cell["driver"]).Session


def _traced(ranges, steps=4):
    run = harness.Run({}, CONFIG, json.loads(
        (ROOT / "benchmark/peaks.json").read_text()))
    run.trace = types.SimpleNamespace(ranges=dict(ranges))
    run.trace.range_seconds = (lambda names: sum(
        run.trace.ranges[n] for n in names if n in run.trace.ranges)
        if any(n in run.trace.ranges for n in names) else None)
    run.stretch = {"count": steps, "passes": [
        {"net": "miso1", "items": 8, "backward": True}] * steps}
    return run


def test_metric_readers_on_a_hand_built_trace():
    bench = harness.Bench(ROOT)
    read = {n: bench.metric(n).read for n in NEW}
    run = _traced({"tfgridnet.rnn": 0.4, "tfgridnet.rnn_bwd": 0.8,
                   "tfgridnet.attn": 0.02})
    assert math.isclose(read["tfgridnet_lstm_ms_per_step"](run), 300.0)
    assert math.isclose(read["tfgridnet_attn_ms_per_step"](run), 5.0)
    flops = 3 * 4 * 8 * work_tfgridnet.forward_item(CONFIG)["lstm"][0]
    assert math.isclose(read["tfgridnet_lstm_roofline.train"](run),
                        100 * flops / 989e12 / 1.2)
    # a program without the backward's span (or without TF-GridNet): nothing
    for ranges in ({"tfgridnet.rnn": 0.4}, {}):
        run = _traced(ranges)
        assert read["tfgridnet_lstm_ms_per_step"](run) is None
        assert read["tfgridnet_lstm_roofline.train"](run) is None
    assert read["tfgridnet_attn_ms_per_step"](_traced({})) is None
    untraced = _traced({})
    untraced.trace = None
    assert all(r(untraced) is None for r in read.values())


def _tiny_root(tmp: Path) -> Path:
    """``tmp`` as a checkout root holding the benchmark and a tiny TF-GridNet
    cell that reports what ``tfgridnet.train_b8`` reports."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = tiny_config()
    (tmp / "benchmark/configs/tinygrid.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tinygrid", "source": "tests",
                            "file": "benchmark/configs/tinygrid.json",
                            "reduced": [], "why": "tiny"})
    cell = json.loads((ROOT / f"benchmark/workloads/{CELL}.json").read_text())
    cell.update(name="tiny.grid", config="tinygrid", trace={"count": 2},
                traffic={"kind": "batches", "pool": 4, "batch": 4,
                         "chunk_s": 0.125})
    cell["check"]["limits"] = {"loss": 0.003, "grad": 0.1, "change": 0.3,
                               "frozen": 0}
    (tmp / "benchmark/workloads/tiny.grid.json").write_text(json.dumps(cell))
    spec["workloads"].append({"name": "tiny.grid", "config": "tinygrid",
                              "traffic": "tiny", "chips": 1, "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny.grid")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.mark.parametrize("traced", [False, True])
def test_driver_runs_a_tiny_cell(tmp_path, traced):
    torch.set_num_threads(1)
    root = _tiny_root(tmp_path)
    bench = harness.Bench(root, root / "benchmark")
    result = harness.run_cell(bench, "tiny.grid", 2**33 + 5, 0.5, traced,
                              "cpu", 0.0)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss", "grad", "change", "frozen"}
    if traced:
        assert "syncs_per_step" in result["metrics"]
        # the CPU runs no card kernel: the roofline says nothing, never 0
        assert "tfgridnet_lstm_roofline.train" not in result["metrics"]
    else:
        assert {"train_step_ms", "setup_s"} <= set(result["metrics"])

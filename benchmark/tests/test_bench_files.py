"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration, a cell and a metric added as new files with no edit."""

import json
import types
import re
from pathlib import Path

from benchmark import harness
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_files():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in SPEC["workloads"]] \
        + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json").exists()
        assert w["chips"] == 1
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_its_metrics_move():
    bench = harness.Bench(ROOT)
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.metrics_for(w["name"], False)}
        layer = bench.metrics_for(w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_new_config_cell_and_metric_are_found_as_files(tmp_path):
    root = tiny.make_root(tmp_path)
    folder = root / "benchmark"
    (folder / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(run.window.get('requests', 0))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["tiny.css"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root, folder)
    result = harness.run_cell(bench, "tiny.css", 3, 0.5, False, "cpu", 0.0)
    assert result["correct"]
    assert result["metrics"]["requests_done"]["value"] >= 1
    assert {"audio_s_per_s", "p95_ms", "setup_s"} <= set(result["metrics"])


ROOFLINE = '''"""stencil_roofline.serve: a kernel the benchmark had no metric of."""

from benchmark import trace, work

KERNELS = ("stencil_tc_kernel",)


def work_of(run):
    return work.of_passes(run.cfg, run.stretch["passes"], "stencil")


def read(run):
    return trace.roofline(run, KERNELS, (), *work_of(run))
'''

RANGE = '''"""power_iter_spans_per_req: a program range no metric read before."""


def read(run):
    if run.trace is None:
        return None
    n = run.trace.spans.get("bench.request", 0)
    got = run.trace.spans.get("mvdr.power_iteration")
    return got / n if n and got else None
'''


def test_new_per_layer_metrics_are_found_as_files(tmp_path):
    """A roofline of a new kernel and a metric over a new profiler range,
    each one new file and one entry, read in a traced run with no edit to
    the harness, the trace's aggregate or a driver."""
    root = tiny.make_root(tmp_path)
    folder = root / "benchmark"
    (folder / "metrics" / "stencil_roofline.serve.py").write_text(ROOFLINE)
    (folder / "metrics" / "power_iter_spans_per_req.py").write_text(RANGE)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, unit in (("stencil_roofline.serve", "%"),
                       ("power_iter_spans_per_req", "spans")):
        spec["per_layer"].append({"name": name, "unit": unit, "better": "higher",
                                  "source": "device_trace", "layer": "kernels",
                                  "moves": "p95_ms", "workloads": ["tiny.cascade"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root, folder)
    result = harness.run_cell(bench, "tiny.cascade", 5, 0.3, True, "cpu", 0.0)
    assert result["correct"]
    assert result["metrics"]["power_iter_spans_per_req"]["value"] > 0
    # the CPU runs no card kernel: the roofline says nothing, never 0
    assert "stencil_roofline.serve" not in result["metrics"]

    # on a trace in which the kernel ran, the metric counts its own work
    roofline = bench.metric("stencil_roofline.serve")
    run = harness.Run({}, bench.config("miso_smswsj_bf16"),
                      json.loads((folder / "peaks.json").read_text()))
    run.stretch = {"passes": [{"net": "miso1", "items": 6, "backward": False}]}
    run.trace = types.SimpleNamespace(
        kernel_seconds=lambda names, trailing: 1e-3 if KERNEL in names else 0.0)
    flops, nbytes = roofline.work_of(run)
    assert flops > 0 and nbytes > 0
    want = 100 * max(flops / run.peaks["bfloat16"],
                     nbytes / run.peaks["hbm_bytes_per_s"]) / 1e-3
    assert roofline.read(run) == want


KERNEL = "stencil_tc_kernel"

"""One run of one cell: find the cell, its configuration, its driver and its
metrics by name, set up, measure, check, and build the result line.

Everything that belongs to one configuration, cell or metric is a file of
its own under the benchmark's folder, found by the name that
``BENCHMARK.json`` gives it:

  configs/<config>.json     the configuration as it is run
  workloads/<cell>.json     the cell: its driver, traffic, trace stretch
                            and the limits of its correctness check
  drivers/<driver>.py       a ``Session`` class (set-up in ``__init__``,
                            ``window``, ``stretch``, ``check``)
  metrics/<metric>.py       ``read(run) -> float | None``, which takes what it
                            needs from the window's and the stretch's raw
                            records, the trace's aggregate (every kernel and
                            every profiler range) and ``work.py``

A cell reports the ``end_to_end`` metrics of ``BENCHMARK.json`` with
``--trace 0`` and the ``per_layer`` ones with ``--trace 1``: those whose
``workloads`` name it, or every cell's where a metric has no such key.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "misonet_tpu")


class Bench:
    """The benchmark's files under ``root`` (the checkout's root)."""

    def __init__(self, root: Path, folder: Path = HERE):
        self.root = Path(root)
        self.folder = Path(folder)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        names = [w["name"] for w in self.spec["workloads"]]
        if name not in names:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {names}")
        return json.loads((self.folder / "workloads" / f"{name}.json").read_text())

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def driver(self, name: str):
        return _load(self.folder / "drivers" / f"{name}.py", f"driver_{name}")

    def metric(self, name: str):
        return _load(self.folder / "metrics" / f"{name}.py",
                     "metric_" + name.replace(".", "_"))

    def metrics_for(self, cell: str, traced: bool) -> list[dict]:
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if "workloads" not in m or cell in m["workloads"]]


def _load(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """What a metric reader sees: the cell, its configuration, the set-up
    time, the window's record, the traced stretch's aggregate and record,
    and the table of peaks."""

    def __init__(self, cell, cfg, peaks):
        self.cell, self.cfg, self.peaks = cell, cfg, peaks
        self.setup_s = None
        self.window = None
        self.peak_bytes = None
        self.trace = None
        self.stretch = None


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             traced: bool, device, t_start: float) -> dict:
    """Set up, measure, check; returns the result line as a dict."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    peaks = json.loads((bench.folder / "peaks.json").read_text())
    run = Run(cell, cfg, peaks)
    session = bench.driver(cell["driver"]).Session(cell, cfg, seed, device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start
    run.window = session.window(seconds)
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if traced:
        from benchmark import trace

        with trace.profiled(on_card) as out:
            run.stretch = session.stretch(cell["trace"]["count"])
        run.trace = trace.Aggregate(out["prof"], out["window_s"])
    checks = session.check()
    metrics = {}
    for m in bench.metrics_for(workload, traced):
        value = bench.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = run.window["failed"] + (run.stretch or {}).get("failed", 0)
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    result = {
        "correct": correct,
        "attempted": run.window["attempted"],
        "failed": run.window["failed"],
        "metrics": metrics,
        "device": _device(torch, device, run),
    }
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    notes = dict(getattr(session, "notes", {}))
    for key in ("errors", "slices"):
        if run.window.get(key):
            notes[key] = run.window[key]
    if run.trace is not None:
        notes.update(stretch=run.stretch["count"], spans=run.trace.spans,
                     launches=run.trace.launches,
                     device_events_lost=run.trace.device_events_lost)
    for key, val in notes.items():
        print(f"note {key}: {val!r}", file=sys.stderr)
    return result


def _device(torch, device, run: Run) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": run.peak_bytes}
    if run.trace is not None:
        out["busy_s"] = run.trace.busy_s
        out["window_s"] = run.trace.window_s
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})

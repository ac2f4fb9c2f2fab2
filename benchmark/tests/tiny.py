"""A copy of the benchmark's folder under a temporary root, with a tiny
configuration and tiny cells that the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

PLAN = {"num_bottleneck": 4, "en_channels": [8, 8, 8, 16],
        "de_channels": [16, 8, 8, 8], "norm_type": "IN", "tcn_repeats": 1,
        "tcn_blocks": 2, "tcn_channels": 16, "flat_dense": "auto"}

CONFIG = {
    "name": "tiny", "source": "tests", "precision": "bfloat16",
    "nets": ["miso1", "miso3"], "reduced": [],
    "stft": {"fs": 8000, "length": 32, "overlap": 24},
    "dataset": {"fs": 8000, "chunk_time": 0.25, "least_time": 0.125,
                "num_spks": 2, "num_ch": 6, "ref_ch": 0},
    "model": PLAN, "mvdr": {"power_iters": 100, "diag_load": 1e-6},
    "optimizer": {"name": "adam", "lr": 0.001, "clipping": True, "max_norm": 5.0},
}

CELLS = {
    "tiny.cascade": {"driver": "cascade", "traffic": {
        "kind": "utterances", "clients": 2, "pool": 6, "min_s": 0.125,
        "max_s": 0.9, "passes": 3}, "trace": {"count": 4},
        "check": {"requests": 3, "limits": {"separated": 0.04, "beamformed": 0.04,
                                            "enhanced": 0.05},
                  "stat": {"beamformed": "second"}}},
    "tiny.css": {"driver": "css", "traffic": {"kind": "scene", "scene_s": 1.0,
                                             "forget": 1.0},
                 "trace": {"count": 3},
                 "check": {"limits": {"miso1": 0.04, "beamformed": 0.04}}},
    "tiny.train": {"driver": "train", "traffic": {
        "kind": "batches", "pool": 4, "batch": 4, "chunk_s": 0.25},
        "trace": {"count": 2},
        "check": {"rows_per_block": 2,
                  "limits": {"loss": 0.003, "grad": 0.1, "change": 0.3,
                             "frozen": 0}}},
}


LIKE = {"cascade": "smswsj.css", "css": "smswsj.css",
        "train": "smswsj.train_b20"}


def make_root(tmp: Path, cells=CELLS, config=CONFIG) -> Path:
    """``tmp`` as a checkout root: a copy of the benchmark's folder (tests
    left out) and a BENCHMARK.json naming the tiny configuration and cells
    beside the real ones."""
    folder = tmp / "benchmark"
    shutil.copytree(HERE, folder,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    (folder / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    spec["configs"].append({"name": config["name"], "source": "tests",
                            "file": f"benchmark/configs/{config['name']}.json",
                            "reduced": [], "why": "tiny"})
    for name, cell in cells.items():
        body = {"name": name, "config": config["name"], "why": name, **cell}
        (folder / "workloads" / f"{name}.json").write_text(json.dumps(body))
        spec["workloads"].append({"name": name, "config": config["name"],
                                  "traffic": name, "chips": 1, "why": name})
        # the tiny cell reports what a real cell of its kind reports (the
        # serving cells' metrics are CSS's)
        like = LIKE[cell["driver"]]
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp

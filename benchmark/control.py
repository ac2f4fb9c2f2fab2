"""The readings that a cell's correctness limits are set from, in one process
on the card: the program's sound runs over many seeds (the lower reading),
and the control, one precision below the configuration's bfloat16, over a
few (the upper reading):

  serving cells   the program's own int8 decode path (``quant_int8``) in its
                  place, at the cell's own load for ``--seconds``
  training cells  the plain reference computed with fp8 (e4m3) conv inputs
                  and weights in the program's place; and the planted fault
                  of a step fed half its batch

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 7 8 9 --seconds 6

Prints one JSON line per run: {seed, mode, readings}.  The benchmark's own
runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(session) -> dict:
    return {name: value for name, value, _ in session.check()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    driver = bench.driver(cell["driver"])
    train = cell["driver"] == "train"
    runs = [(s, "program") for s in args.seeds]
    runs += [(s, "control") for s in args.control_seeds]
    if train:
        runs += [(s, "half_batch") for s in args.control_seeds]
    for seed, mode in runs:
        t0 = time.perf_counter()
        if train:
            s = driver.Session(cell, cfg, seed, args.device,
                               half_batch=mode == "half_batch")
            if mode == "control":
                ref = s.reference()
                got = s.reference(quant="fp8")
                s.losses, s.grad1, s.params3 = got["loss"], got["grad1"], got["params"]
                out = driver.compare(s, ref, s.notes)
            else:
                s.window(args.seconds)
                out = readings(s)
        else:
            s = driver.Session(cell, cfg, seed, args.device,
                               quant_int8=mode == "control")
            s.window(args.seconds)
            out = readings(s)
        notes = getattr(s, "notes", {})
        print(json.dumps({"seed": seed, "mode": mode, "readings": out,
                          "notes": {k: v for k, v in notes.items()
                                    if k != "sample"},
                          "seconds": time.perf_counter() - t0}), flush=True)
        del s
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

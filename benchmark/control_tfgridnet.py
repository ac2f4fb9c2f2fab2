"""The readings that the TF-GridNet training cell's correctness limits are set
from (``control.py``'s training readings for the ``train_tfgridnet``
driver), in one process on the card: the program's sound runs over many
seeds (the lower reading), and over a few seeds the control, the plain
reference computed with fp8 (e4m3) matmul and conv operands in the
program's place, and the planted fault of a step fed half its batch (the
upper readings).

    python3 benchmark/control_tfgridnet.py --workload tfgridnet.train_b8 \\
        --seeds 1 2 3 4 5 6 --control-seeds 7 8 9 --seconds 6

Prints one JSON line per run: {seed, mode, readings, notes, seconds}.  The
benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    from benchmark.control import readings

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    driver = bench.driver(cell["driver"])
    runs = [(s, "program") for s in args.seeds]
    runs += [(s, m) for m in ("control", "half_batch") for s in args.control_seeds]
    for seed, mode in runs:
        t0 = time.perf_counter()
        s = driver.Session(cell, cfg, seed, args.device,
                           half_batch=mode == "half_batch")
        if mode == "control":
            s.state = s.step = None
            if args.device == "cuda":
                torch.cuda.empty_cache()
            ref = s.reference()
            got = s.reference(quant="fp8")
            s.losses, s.grad1, s.params3 = got["loss"], got["grad1"], got["params"]
            out = driver.compare(s, ref, s.notes)
        else:
            s.window(args.seconds)
            out = readings(s)
        print(json.dumps({"seed": seed, "mode": mode, "readings": out,
                          "notes": s.notes,
                          "seconds": time.perf_counter() - t0}, default=str),
              flush=True)
        del s
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

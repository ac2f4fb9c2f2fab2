"""Run one cell of the benchmark once on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, the last of standard output, and each
compared number beside its limit as the last lines of standard error.
Exits non-zero, printing no result, without a CUDA card, when the checkout
lacks the measured program, or when JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches inside the checkout, at fixed paths; no library loads Flax
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("run.py: no CUDA card is available; the benchmark does not run "
              "on the CPU", file=sys.stderr)
        return 2
    from benchmark import harness

    result = harness.run_cell(harness.Bench(ROOT), args.workload, args.seed,
                              args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    checks = result["checks"]
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"{name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

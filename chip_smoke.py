"""Drive the PyTorch port's MISO1 separation serving path once on one GPU.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):

  1. device   card name and power limit; TF32 off for cuDNN and matmuls
  2. build    nvcc-build the CUDA kernels from misonet_tpu_torch/csrc
  3. kernels  each kernel against its plain PyTorch version at the main
              path's shapes (B = 6 shifts x T = 501 frames), error bound
              1e-4 normalized by max-abs, CUDA-event times of both
  4. forward  full default-width MISO1 forward [6, 6, 501, 129] (seeded
              weights, non-zero biases): fused kernel path against the
              plain path, exactly 50 dense_stack and 10 stencil launches
  5. serve    3 synthetic 6-mic 8 kHz requests (~5, 9, 12 s, 2 references
              each) through CascadeEvaluator.process in MISO1-only mode,
              launch counts of that run, per-request latency, and the
              shortest request again on the plain path for agreement

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA device; exits 1
without one.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

BOUND = 1e-4   # kernel vs plain, normalized by the plain output's max-abs
B, T = 6, 501  # M = 6 circular shifts of one 4 s chunk
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def norm_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max abs of ``want``)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` in ms from CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rand(rng, shape, lo=None, hi=None, scale=1.0) -> torch.Tensor:
    v = (rng.uniform(lo, hi, shape) if lo is not None
         else scale * rng.standard_normal(shape))
    return torch.from_numpy(v.astype(np.float32)).cuda()


def check_kernel(name, kernel, plain, args, record):
    """Compare one kernel call with its plain version; time both."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    errs = []
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            fail(f"{name}: kernel and plain version disagree on outputs")
        if w is not None:
            if g.shape != w.shape or not torch.isfinite(g).all():
                fail(f"{name}: bad kernel output {tuple(g.shape)}")
            errs.append(norm_err(g, w))
    err = errs[0][0]                 # the activations y (sums are ~1e5)
    rel = max(e[1] for e in errs)    # every output, normalized
    t_plain = cuda_ms(lambda: plain(*args))
    t_kernel = cuda_ms(lambda: kernel(*args))
    print(json.dumps({"phase": "kernels", "case": name, "max_abs_err": err,
                      "max_norm_err": rel, "bound": BOUND, "ms": t_kernel,
                      "plain_ms": t_plain}), flush=True)
    if not rel <= BOUND:
        fail(f"{name}: normalized error {rel} above {BOUND}")
    record["max_abs_err"] = max(record["max_abs_err"], err)
    record["max_norm_err"] = max(record["max_norm_err"], rel)
    record["ms"] += t_kernel
    record["plain_ms"] += t_plain


def phase_kernels(records):
    from misonet_tpu_torch.ops.kernels.dense_stack import (
        dense_stack, dense_stack_plain)
    from misonet_tpu_torch.ops.kernels.stencil import stencil, stencil_plain

    rng = np.random.default_rng(SEED)
    # (name, source widths, N, n_fin, F, partials in): calls of the
    # encoder and decoder DenseBlocks at their real widths
    for name, widths, n, n_fin, f, with_acc in [
        ("enc0 call 0", (24,), 120, 24, 127, False),
        ("enc0 call 1", (24,), 96, 24, 127, True),
        ("enc1 call 0", (32,), 160, 32, 63, False),
        ("enc1 call 2", (32,), 96, 32, 63, True),
        ("dec2 call 0", (32, 32), 192, 32, 7, False),
        ("dec6 call 0", (24, 24), 144, 24, 127, False),
        ("dec6 call 4", (24,), 48, 48, 127, True),
    ]:
        c = sum(widths)
        args = (
            [rand(rng, (B, w, T, f)) for w in widths],
            rand(rng, (B, n, T, f)) if with_acc else None,
            rand(rng, (n, c, 3, 3), scale=1.0 / np.sqrt(9 * c)),
            rand(rng, (n_fin,), scale=0.1),
            rand(rng, (B, c), 0.5, 1.5),
            rand(rng, (B, c), -0.5, 0.5),
            n_fin,
        )
        check_kernel(f"dense_stack {name}", dense_stack, dense_stack_plain,
                     args, records["dense_stack"])

    # (name, mode, C, N, F_in): the four instances at their real widths
    for name, mode, c, n, f_in in [
        ("enc0", "enc0", 12, 24, 129),
        ("enc1", "down", 24, 32, 127),
        ("enc4", "down", 32, 32, 15),
        ("dec2", "up", 64, 32, 7),
        ("dec5", "up", 64, 24, 63),
        ("dec6", "final", 48, 4, 127),
    ]:
        wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
        stats = ([None, None] if mode == "enc0" else
                 [rand(rng, (B, c), 0.5, 1.5), rand(rng, (B, c), -0.5, 0.5)])
        args = [rand(rng, (B, c, T, f_in)),
                rand(rng, wshape, scale=1.0 / np.sqrt(9 * c)),
                rand(rng, (n,), scale=0.1), *stats, mode]
        check_kernel(f"stencil {name}", stencil, stencil_plain, args,
                     records["stencil"])


def seeded_model(cfg, device):
    from misonet_tpu_torch.models import make_miso1

    gen = torch.Generator().manual_seed(SEED)
    model = make_miso1(cfg, device=device, generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):  # non-zero biases exercise the epilogues
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model.eval()


def phase_forward(model, cfg):
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(SEED + 1)
    x = torch.complex(rand(rng, (B, 6, T, 129)), rand(rng, (B, 6, T, 129)))
    plain_cfg = dataclasses.replace(cfg, flat_dense=False)
    with torch.inference_mode():
        reset_launch_counts()
        fused = model(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts != {"dense_stack": 50, "stencil": 10}:
            fail(f"forward launched {counts}, expected 50 dense_stack and "
                 "10 stencil")
        t_fused = cuda_ms(lambda: model(x), reps=5)
        model.cfg = plain_cfg
        plain = model(x)
        t_plain = cuda_ms(lambda: model(x), reps=5)
        model.cfg = cfg
    if fused.shape != (B, 2, T, 129) or not torch.isfinite(
            torch.view_as_real(fused)).all():
        fail(f"forward output {tuple(fused.shape)} not finite/expected")
    err, rel = norm_err(torch.view_as_real(fused), torch.view_as_real(plain))
    print(json.dumps({"phase": "forward", "shape": list(x.shape),
                      "params": sum(p.numel() for p in model.parameters()),
                      "launches_per_forward": counts, "max_abs_err": err,
                      "max_norm_err": rel, "bound": BOUND,
                      "fused_ms": t_fused, "plain_ms": t_plain}), flush=True)
    if not rel <= BOUND:
        fail(f"forward: fused vs plain normalized error {rel} above {BOUND}")


def synth_request(rng, seconds, fs=8000, mics=6):
    """Two seeded sources, mixed to 6 mics with per-mic gains, small
    delays and noise.  Returns (mix [samples, mics], refs [2, samples])."""
    n = int(seconds * fs)
    t = np.arange(n) / fs
    srcs = []
    for _ in range(2):
        f0 = rng.uniform(100, 300)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
        tone = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6))
                   / k for k in range(1, 8))
        srcs.append(env * tone + 0.1 * rng.standard_normal(n))
    refs = np.stack(srcs).astype(np.float32)
    mix = np.zeros((n, mics), np.float32)
    for m in range(mics):
        for s in range(2):
            mix[:, m] += rng.uniform(0.5, 1.0) * np.roll(
                refs[s], rng.integers(0, 8))
    mix += 0.01 * rng.standard_normal(mix.shape).astype(np.float32)
    return mix, refs


def phase_serve(model, cfg, device_line, records):
    from misonet_tpu_torch.config import DatasetConfig, StftConfig
    from misonet_tpu_torch.inference.evaluate import CascadeEvaluator
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    ds = DatasetConfig()
    ev = CascadeEvaluator(model, StftConfig(), ds, beamform_utterance=False)
    rng = np.random.default_rng(SEED + 2)
    requests = [synth_request(rng, s) for s in (5.0, 9.0, 12.3)]

    reset_launch_counts()
    results = []
    for mix, refs in requests:
        t0 = time.perf_counter()
        res = ev.process(mix, refs)
        torch.cuda.synchronize()
        results.append((res, time.perf_counter() - t0))
    counts = launch_counts()

    for (mix, refs), (res, dt) in zip(requests, results):
        secs = mix.shape[0] / ds.fs
        score = res.si_sdr.get("miso1")
        ok = (res.separated.shape == refs.shape
              and bool(np.isfinite(res.separated).all())
              and score is not None and bool(np.isfinite(score)))
        print(json.dumps({"phase": "serve", "audio_s": secs,
                          "chunks": -(-mix.shape[0] // ds.chunk_samples),
                          "latency_s": dt, "audio_s_per_s": secs / dt,
                          "pit_si_sdr_db": score, "device": device_line}),
              flush=True)
        if not ok:
            fail(f"serve: request of {secs} s gave shape "
                 f"{res.separated.shape}, score {score}")
    n_req = len(requests)
    if counts != {"dense_stack": 50 * n_req, "stencil": 10 * n_req}:
        fail(f"serve launched {counts}, expected {50 * n_req} dense_stack "
             f"and {10 * n_req} stencil ({n_req} requests)")
    for name, n in counts.items():
        records[name]["launches"] = n

    # the shortest request again on the plain path: same separated waves
    model.cfg = dataclasses.replace(cfg, flat_dense=False)
    plain = ev.process(*requests[0])
    model.cfg = cfg
    err, rel = norm_err(torch.from_numpy(results[0][0].separated),
                        torch.from_numpy(plain.separated))
    print(json.dumps({"phase": "serve", "check": "fused vs plain, 5 s",
                      "max_abs_err": err, "max_norm_err": rel,
                      "bound": BOUND,
                      "si_sdr_fused": results[0][0].si_sdr["miso1"],
                      "si_sdr_plain": plain.si_sdr["miso1"]}), flush=True)
    if not rel <= BOUND:
        fail(f"serve: fused vs plain normalized error {rel} above {BOUND}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1

    from misonet_tpu_torch.config import ModelConfig
    from misonet_tpu_torch.ops.kernels import build

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | TF32 off", flush=True)
    device = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    report = lib.with_suffix(".log").read_text().splitlines()
    print(json.dumps({"phase": "build", "library": str(lib),
                      "sources": [p.name for p in build.sources()],
                      "seconds": time.perf_counter() - t0,
                      "ptxas": [ln.split(":", 1)[1].strip() for ln in report
                                if "registers" in ln]}), flush=True)

    # 3. kernels
    records = {
        name: {"name": name, "route": "cuda",
               "source": f"misonet_tpu_torch/csrc/{name}.cu",
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "max_norm_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
        for name, replaces in [
            ("dense_stack", "misonet_tpu/ops/pallas/dense_stack.py:316"),
            ("stencil", "misonet_tpu/ops/pallas/stencil_flat.py:242"),
        ]
    }
    phase_kernels(records)

    # 4. forward
    cfg = ModelConfig(compute_dtype="float32")
    model = seeded_model(cfg, device)
    phase_forward(model, cfg)

    # 5. serve
    phase_serve(model, cfg, smi, records)

    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

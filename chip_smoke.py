"""Drive the PyTorch port's MISO1 serving and training paths on one GPU.

    python3 chip_smoke.py

Phases (one or more JSON lines each; any failure exits non-zero):

  1. device   card name and power limit; TF32 off for cuDNN and matmuls
  2. build    nvcc-build the CUDA kernels from misonet_tpu_torch/csrc
  3. kernels  each forward kernel against its plain PyTorch version at
              the serving path's shapes (B = 6 shifts x T = 501 frames),
              error bound 1e-4 normalized by max-abs, CUDA-event times of
              both and of the cuDNN conv (library_ms), and the bound
  4. forward  full default-width MISO1 forward [6, 6, 501, 129] (seeded
              weights, non-zero biases): fused kernel path against the
              plain path, exactly 50 dense_stack and 10 stencil launches
  5. serve    3 synthetic 6-mic 8 kHz requests (~5, 9, 12 s, 2 references
              each) through CascadeEvaluator.process in MISO1-only mode,
              launch counts of that run, per-request latency, and the
              shortest request again on the plain path for agreement
  6. bwd-kernels  stencil_bwd against stencil_bwd_plain at the train
              path's shapes (B = 8 utterances x T = 501), the cases of
              phase 3, bound 1e-4; times of both and of the cuDNN
              backward pair (conv2d_input + conv2d_weight) as library_ms
  7. train    the full-width wave train step [8, 6, 501, 129] (seeded
              synthetic 2-speaker 4 s mixtures, Adam lr 1e-3, NaN guard
              on): fused vs plain loss and gradients from the same weights
              (bound 1e-3), bit-identical repeat gradients, 5 fused steps
              on the repeated batch with exactly 50 dense_stack, 10
              stencil and 60 stencil_bwd launches per step and a falling
              loss, step times and peak memory of both paths, and a
              torch.profiler breakdown of one fused step

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA device; exits 1
without one.  Bounds (``bound_ms``) are the larger of the call's FLOPs
over the H100's float32 CUDA-core peak and its bytes (each input read
once, each output written once) over its memory rate.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

BOUND = 1e-4   # kernel vs plain, normalized by the plain output's max-abs
TRAIN_BOUND = 1e-3  # fused vs plain train-step gradients (60 layers deep)
B, T = 6, 501  # M = 6 circular shifts of one 4 s chunk
TRAIN_B = 8    # utterances of 4 s per train step (bench.py --train)
TRAIN_STEPS = 5
PERTURB = 3e-6  # relative input perturbation of the sensitivity probe
# the parameters whose gradients come out of stencil_bwd (the fused body)
BODY = re.compile(r"^(enc[0-4]|enc[0-4]_dense|dec[2-6]|dec[2-6]_dense)\.")
SEED = 0
# H100 SXM data sheet at 700 W: float32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def tensors_of(values):
    """The tensors among ``values``, lists and tuples opened up."""
    for v in values:
        if isinstance(v, (list, tuple)):
            yield from tensors_of(v)
        elif isinstance(v, torch.Tensor):
            yield v


def bound_ms(flops: float, inputs, outputs) -> tuple[float, float, float]:
    """(bound, operations time, bytes time) in ms: each input read once,
    each output written once."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*tensors_of(inputs), *tensors_of(outputs)))
    t_ops = flops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def new_record(name, replaces):
    return {"name": name, "route": "cuda",
            "source": f"misonet_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "max_norm_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": None, "library_ms": 0.0, "ops_ms": 0.0,
            "bytes_ms": 0.0}


def output_errs(name, got, want):
    """(abs, normalized) errors of each output of ``got`` against ``want``."""
    errs = []
    for g, w in zip(tensors_or_none(got), tensors_or_none(want)):
        if (g is None) != (w is None):
            fail(f"{name}: kernel and plain version disagree on outputs")
        if w is not None:
            if g.shape != w.shape or not torch.isfinite(g).all():
                fail(f"{name}: bad output {tuple(g.shape)}")
            errs.append(norm_err(g.to(w.dtype), w))
    return errs


def check_kernel(name, kernel, plain, args, record, flops, library,
                 in_float64=False):
    """Compare one kernel call with its plain version; time both and the
    library call ``library`` (a PyTorch call computing the same function);
    add the call's bound.  ``in_float64``: the plain version runs on the
    inputs cast to float64 for the comparison (its float32 run, through
    cuDNN's reductions, is then reported beside the kernel)."""
    got = kernel(*args)
    extra = {}
    if in_float64:
        want = plain(*[a.double() if isinstance(a, torch.Tensor) else
                       [x.double() for x in a] if isinstance(a, list) else a
                       for a in args])
        extra["plain_f32_max_norm_err"] = max(
            e[1] for e in output_errs(name, plain(*args), want))
    else:
        want = plain(*args)
    torch.cuda.synchronize()
    errs = output_errs(name, got, want)
    err = errs[0][0]                 # the first output (sums are ~1e5)
    rel = max(e[1] for e in errs)    # every output, normalized
    t_plain = cuda_ms(lambda: plain(*args))
    t_kernel = cuda_ms(lambda: kernel(*args))
    t_lib = cuda_ms(library)
    if record["name"] == "stencil_bwd":
        # the wgrad half alone: the same call without input gradients
        extra["wgrad_ms"] = cuda_ms(lambda: kernel(*args[:-1], False))
    bound, t_ops, t_bytes = bound_ms(flops, args, got)
    phase = "bwd-kernels" if record["name"] == "stencil_bwd" else "kernels"
    print(json.dumps({"phase": phase, "case": name,
                      "max_abs_err": err, "max_norm_err": rel,
                      "bound": BOUND, "ms": t_kernel, "plain_ms": t_plain,
                      "library_ms": t_lib, "gflop": flops / 1e9,
                      "bound_ms": bound,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", **extra}), flush=True)
    if not rel <= BOUND:
        fail(f"{name}: normalized error {rel} above {BOUND}")
    record["max_abs_err"] = max(record["max_abs_err"], err)
    record["max_norm_err"] = max(record["max_norm_err"], rel)
    record["ms"] += t_kernel
    record["plain_ms"] += t_plain
    record["library_ms"] += t_lib
    record["bound_ms"] += bound
    record["ops_ms"] += t_ops
    record["bytes_ms"] += t_bytes


def tensors_or_none(out):
    """A kernel's outputs as a flat list, keeping None placeholders."""
    flat = []
    for v in out:
        if isinstance(v, (list, tuple)):
            flat.extend(v)
        else:
            flat.append(v)
    return flat


def normalized(xs, scale, mean):
    x = torch.cat(list(xs), dim=1)
    if scale is None:
        return x
    return (x - mean[:, :, None, None]) * scale[:, :, None, None]


# (name, source widths, N, n_fin, F, partials in): calls of the encoder and
# decoder DenseBlocks at their real widths
DENSE_CASES = [
    ("enc0 call 0", (24,), 120, 24, 127, False),
    ("enc0 call 1", (24,), 96, 24, 127, True),
    ("enc1 call 0", (32,), 160, 32, 63, False),
    ("enc1 call 2", (32,), 96, 32, 63, True),
    ("dec2 call 0", (32, 32), 192, 32, 7, False),
    ("dec6 call 0", (24, 24), 144, 24, 127, False),
    ("dec6 call 4", (24,), 48, 48, 127, True),
]
# (name, mode, C, N, F_in): the four stencil instances at their real widths
STENCIL_CASES = [
    ("enc0", "enc0", 12, 24, 129),
    ("enc1", "down", 24, 32, 127),
    ("enc4", "down", 32, 32, 15),
    ("dec2", "up", 64, 32, 7),
    ("dec5", "up", 64, 24, 63),
    ("dec6", "final", 48, 4, 127),
]


def conv_macs(mode, b, c, n, t, f_in):
    """Multiply-adds of one conv call as cuDNN computes it (transpose convs:
    per input position)."""
    from misonet_tpu_torch.ops.kernels.stencil import out_bins

    f = f_in if mode in ("dense", "up", "final") else out_bins(mode, f_in)
    return b * t * f * n * c * 9


def phase_kernels(records):
    import torch.nn.functional as F

    from misonet_tpu_torch.ops.kernels.dense_stack import (
        dense_stack, dense_stack_plain)
    from misonet_tpu_torch.ops.kernels.stencil import stencil, stencil_plain
    from misonet_tpu_torch.ops.kernels.stencil_bwd import geometry

    rng = np.random.default_rng(SEED)
    for name, widths, n, n_fin, f, with_acc in DENSE_CASES:
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
        xn = normalized(args[0], args[4], args[5])
        check_kernel(f"dense_stack {name}", dense_stack, dense_stack_plain,
                     args, records["dense_stack"],
                     2 * conv_macs("dense", B, c, n, T, f),
                     lambda: F.conv2d(xn, args[2], padding=1))

    for name, mode, c, n, f_in in STENCIL_CASES:
        wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
        stats = ([None, None] if mode == "enc0" else
                 [rand(rng, (B, c), 0.5, 1.5), rand(rng, (B, c), -0.5, 0.5)])
        args = [rand(rng, (B, c, T, f_in)),
                rand(rng, wshape, scale=1.0 / np.sqrt(9 * c)),
                rand(rng, (n,), scale=0.1), *stats, mode]
        xn = normalized([args[0]], *stats)
        stride, padding = geometry(mode)
        conv = (F.conv_transpose2d if mode in ("up", "final") else F.conv2d)
        check_kernel(f"stencil {name}", stencil, stencil_plain, args,
                     records["stencil"],
                     2 * conv_macs(mode, B, c, n, T, f_in),
                     lambda: conv(xn, args[1], args[2], stride=stride,
                                  padding=padding))


def phase_bwd_kernels(records):
    """stencil_bwd against its plain version at the train step's shapes:
    the cotangents of the phase-3 calls at B = 8."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from misonet_tpu_torch.ops.kernels.stencil import out_bins
    from misonet_tpu_torch.ops.kernels.stencil_bwd import (
        geometry, stencil_bwd, stencil_bwd_plain)

    rng = np.random.default_rng(SEED + 4)
    cases = [(f"dense {name}", "dense", widths, n, f)
             for name, widths, n, _, f, _ in DENSE_CASES]
    cases += [(f"stencil {name}", mode, (c,), n, f_in)
              for name, mode, c, n, f_in in STENCIL_CASES]
    for name, mode, widths, n, f_in in cases:
        c = sum(widths)
        b = TRAIN_B
        f_out = f_in if mode == "dense" else out_bins(mode, f_in)
        wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
        stats = ([None, None] if mode == "enc0" else
                 [rand(rng, (b, c), 0.5, 1.5), rand(rng, (b, c), -0.5, 0.5)])
        need_dx = mode != "enc0"   # the train step asks enc0 for no dx
        args = (rand(rng, (b, n, T, f_out)),
                [rand(rng, (b, w, T, f_in)) for w in widths],
                rand(rng, wshape, scale=1.0 / np.sqrt(9 * c)), *stats, mode,
                need_dx)
        g, xs, w = args[:3]
        xn = normalized(xs, *stats)
        stride, padding = geometry(mode)
        if mode in ("up", "final"):
            def library():
                F.conv2d(g, w, stride=stride, padding=padding)
                conv2d_weight(g, w.shape, xn, stride=stride, padding=padding)
        else:
            def library():
                if need_dx:
                    conv2d_input(xn.shape, w, g, stride=stride,
                                 padding=padding)
                conv2d_weight(xn, w.shape, g, stride=stride, padding=padding)
        macs = conv_macs(mode, b, c, n, T, f_in)
        # the reference is the plain version in float64: cuDNN's float32
        # weight gradient, summing ~500,000 products, is off by up to ~1e-4
        # of max-abs at these shapes, the kernel by ~1e-6
        check_kernel(f"stencil_bwd {name}", stencil_bwd, stencil_bwd_plain,
                     args, records["stencil_bwd"],
                     2 * macs * (2 if need_dx else 1), library,
                     in_float64=True)


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
        if counts != {"dense_stack": 50, "stencil": 10, "stencil_bwd": 0}:
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
    if counts != {"dense_stack": 50 * n_req, "stencil": 10 * n_req,
                  "stencil_bwd": 0}:
        fail(f"serve launched {counts}, expected {50 * n_req} dense_stack "
             f"and {10 * n_req} stencil ({n_req} requests)")
    for name, n in counts.items():
        records[name]["launches_serve"] = n

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


def train_batch():
    """TRAIN_B seeded synthetic 4 s 6-mic mixtures and their 2 references:
    (mix_wave [B, 32000, 6], ref_wave [B, 2, 32000]) on the card."""
    rng = np.random.default_rng(SEED + 3)
    reqs = [synth_request(rng, 4.0) for _ in range(TRAIN_B)]
    mix = np.stack([m for m, _ in reqs])
    ref = np.stack([r for _, r in reqs])
    return torch.from_numpy(mix).cuda(), torch.from_numpy(ref).cuda()


def step_ms(step, state, batch, n):
    """Run ``n`` train steps; CUDA-event ms and metrics of each."""
    times, metrics = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, *batch)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        metrics.append({k: float(v) for k, v in m.items()})
    return times, metrics


def profile_step(step, state, batch):
    """torch.profiler over one warm train step: device time by kernel
    group, device busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = {"dense_stack": 0.0, "stencil": 0.0, "stencil_bwd": 0.0,
              "reduce_stats": 0.0, "other": 0.0}
    other = {}
    kernels = 0
    for e in prof.key_averages():
        # device work only: kernels, copies, fills; not user annotations
        # such as Optimizer.step#Adam.step, which span kernels counted on
        # their own
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels += e.count
        name = e.key
        if "dense_stack_kernel" in name:
            groups["dense_stack"] += us
        elif "stencil_kernel" in name:
            groups["stencil"] += us
        elif "dgrad_kernel" in name or "wgrad_" in name:
            groups["stencil_bwd"] += us
        elif "reduce_stats_kernel" in name:
            groups["reduce_stats"] += us
        else:
            groups["other"] += us
            other[name[:60]] = other.get(name[:60], 0.0) + us
    busy = sum(groups.values()) / 1e3
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall if wall else None,
            "kernels": kernels,
            "ms": {k: v / 1e3 for k, v in groups.items()},
            "share": {k: v / 1e3 / busy if busy else None
                      for k, v in groups.items()},
            "top_other_ms": {k: v / 1e3 for k, v in top}}


def body_macs(model, b, t):
    """Multiply-adds of the fused U-Net body's forward at batch ``b`` and
    ``t`` frames, from the model's weights: (dense_stack, stencil, the enc0
    stencil's share).  Levels 0-4 run at F = 127, 63, 31, 15, 7; the
    transpose convs count per input position, as cuDNN computes them."""
    f_lvl = [127, 63, 31, 15, 7]
    dense = 0
    for name, f in [*((f"enc{i}_dense", f_lvl[i]) for i in range(5)),
                    *((f"dec{i}_dense", f_lvl[6 - i]) for i in range(2, 7))]:
        blk = getattr(model, name)
        for s in range(5):
            c = blk.in_ch if s == 0 else blk.g1
            dense += b * t * f * c * sum(blk.widths[s:]) * 9
    enc0 = b * t * 127 * model.enc0.conv.weight[0].numel() * 24
    stencil = enc0 + sum(
        b * t * f_lvl[i] * getattr(model, f"enc{i}").conv.weight.numel()
        for i in range(1, 5))
    stencil += sum(
        b * t * f_lvl[6 - i] * getattr(model, f"dec{i}").deconv.weight.numel()
        for i in range(2, 6))
    stencil += b * t * 127 * model.dec6.weight.numel()
    return dense, stencil, enc0


def phase_train(cfg, device, records):
    from misonet_tpu_torch.config import OptimizerConfig, StftConfig
    from misonet_tpu_torch.losses import loss_upit
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from misonet_tpu_torch.ops.stft import stft_scaled
    from misonet_tpu_torch.train import (
        create_train_state, make_optimizer, make_separate_wave_train_step)

    stft_cfg = StftConfig()
    batch = train_batch()
    fused = seeded_model(cfg, device).train()
    plain = seeded_model(dataclasses.replace(cfg, flat_dense=False),
                         device).train()

    mix = stft_scaled(batch[0].transpose(1, 2), stft_cfg)
    ref = stft_scaled(batch[1], stft_cfg)

    def loss_and_grads(model, x):
        model.zero_grad(set_to_none=True)
        loss = loss_upit(model(x), ref)
        loss.backward()
        return loss.item(), {k: p.grad.clone()
                             for k, p in model.named_parameters()}

    # cuDNN's default algorithms for the plain layers' backward are not
    # deterministic: the plain path's gradients from run to run
    _, nd1 = loss_and_grads(plain, mix)
    _, nd2 = loss_and_grads(plain, mix)
    floor = 1e-3 * max(g.abs().max().item() for g in nd1.values())
    spread = max((nd1[k] - nd2[k]).abs().max().item()
                 / max(nd1[k].abs().max().item(), floor) for k in nd1)
    del nd1, nd2
    # agreement and determinism, from the same weights, before any step;
    # cuDNN's own reductions (enc5-6, TCN, dec0-1) made deterministic
    torch.backends.cudnn.deterministic = True
    loss_f, grads_f = loss_and_grads(fused, mix)
    _, again = loss_and_grads(fused, mix)
    loss_p, grads_p = loss_and_grads(plain, mix)
    # the plain path's own sensitivity: its gradients again, from the input
    # perturbed by PERTURB relative noise (the size of the fused-vs-plain
    # forward difference, phase 4)
    noise = torch.randn(mix.shape, generator=torch.Generator().manual_seed(
        SEED + 5)).to(device)
    _, grads_q = loss_and_grads(plain, mix * (1 + PERTURB * noise))
    identical = all(torch.equal(grads_f[k], again[k]) for k in grads_f)
    # each tensor's error over its max-abs, floored at 1e-3 of the largest
    # (leaves that are zero in exact arithmetic hold rounding noise only)
    floor = 1e-3 * max(g.abs().max().item() for g in grads_p.values())

    def err(a, k):
        return ((a[k] - grads_p[k]).abs().max().item()
                / max(grads_p[k].abs().max().item(), floor))

    groups = {}
    for k in grads_p:
        grp = "body" if BODY.match(k) else "plain_modules"
        e = groups.setdefault(grp, {"tensors": 0, "within_bound": 0,
                                    "max_err": 0.0, "max_sensitivity": 0.0,
                                    "worst": None})
        ek, sk = err(grads_f, k), err(grads_q, k)
        e["tensors"] += 1
        e["within_bound"] += ek <= TRAIN_BOUND
        if ek > e["max_err"]:
            e["max_err"], e["worst"] = ek, k
        e["max_sensitivity"] = max(e["max_sensitivity"], sk)
    loss_err = abs(loss_f - loss_p) / abs(loss_p)
    del again, grads_f, grads_p, grads_q
    print(json.dumps({"phase": "train", "check": "fused vs plain, step 1",
                      "shape": [TRAIN_B, 6, T, 129],
                      "loss_fused": loss_f, "loss_plain": loss_p,
                      "loss_rel_err": loss_err, "bound": TRAIN_BOUND,
                      "perturbation": PERTURB, "gradients": groups,
                      "plain_nondeterministic_spread": spread,
                      "repeat_bit_identical": identical}), flush=True)
    if not (np.isfinite(loss_f) and loss_err <= TRAIN_BOUND):
        fail(f"train: fused vs plain loss error {loss_err}")
    for grp, e in groups.items():
        # a gradient may differ as much as the plain path's own does under
        # a rounding-sized perturbation of its input, within a factor 2
        if not e["max_err"] <= max(TRAIN_BOUND, 2 * e["max_sensitivity"]):
            fail(f"train: {grp} gradients differ by {e['max_err']} "
                 f"({e['worst']}), the plain path's sensitivity is "
                 f"{e['max_sensitivity']}")
    if not identical:
        fail("train: a second backward gave other fused gradients")

    # the main path: TRAIN_STEPS fused wave train steps
    opt_cfg = OptimizerConfig(lr=1e-3)
    opt = make_optimizer(opt_cfg, fused.parameters())
    state = create_train_state(fused, opt)
    step = make_separate_wave_train_step(fused, opt, stft_cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, metrics = step_ms(step, state, batch, TRAIN_STEPS)
    counts = launch_counts()
    peak_fused = torch.cuda.max_memory_allocated() / 2**30
    want = {"dense_stack": 50 * TRAIN_STEPS, "stencil": 10 * TRAIN_STEPS,
            "stencil_bwd": 60 * TRAIN_STEPS}
    losses = [m["loss"] for m in metrics]
    print(json.dumps({"phase": "train", "path": "fused", "steps": TRAIN_STEPS,
                      "launches": counts, "losses": losses,
                      "grad_norms": [m["grad_norm"] for m in metrics],
                      "step_ms": times, "peak_gib": peak_fused}), flush=True)
    if counts != want:
        fail(f"train launched {counts}, expected {want}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"train: loss not finite and falling: {losses}")
    for name, n in counts.items():
        records[name]["launches"] = n

    # the plain path's step time and memory
    popt = make_optimizer(opt_cfg, plain.parameters())
    pstate = create_train_state(plain, popt)
    pstep = make_separate_wave_train_step(plain, popt, stft_cfg)
    step_ms(pstep, pstate, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    ptimes, _ = step_ms(pstep, pstate, batch, 3)
    peak_plain = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps({"phase": "train", "path": "plain", "step_ms": ptimes,
                      "peak_gib": peak_plain}), flush=True)

    dense, sten, enc0 = body_macs(fused, TRAIN_B, T)
    bwd_flop = 2 * (2 * (dense + sten) - enc0)  # dgrad + wgrad, no enc0 dx
    print(json.dumps({"phase": "train", "work": "per step, fused body",
                      "forward_gflop": 2 * (dense + sten) / 1e9,
                      "stencil_bwd_gflop": bwd_flop / 1e9,
                      "stencil_bwd_bound_ms": bwd_flop / PEAK_FLOPS * 1e3}),
          flush=True)

    prof = profile_step(step, state, batch)
    print(json.dumps({"phase": "train", "profile": "one fused step", **prof}),
          flush=True)


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
    print(smi, flush=True)
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
        name: new_record(name, replaces)
        for name, replaces in [
            ("dense_stack", "misonet_tpu/ops/pallas/dense_stack.py:316"),
            ("stencil", "misonet_tpu/ops/pallas/stencil_flat.py:242"),
            ("stencil_bwd", "misonet_tpu/ops/pallas/stencil_bwd.py:300"),
        ]
    }
    phase_kernels(records)

    # 4. forward
    cfg = ModelConfig(compute_dtype="float32")
    model = seeded_model(cfg, device)
    phase_forward(model, cfg)

    # 5. serve
    phase_serve(model, cfg, smi, records)
    del model

    # 6. bwd-kernels
    phase_bwd_kernels(records)

    # 7. train
    phase_train(cfg, device, records)

    # every time is the sum over that kernel's cases in phase 3 or 6;
    # launches are those of the train path's run (phase 7)
    for r in records.values():
        r["bound_by"] = ("operations" if r.pop("ops_ms") >= r.pop("bytes_ms")
                         else "bytes")
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

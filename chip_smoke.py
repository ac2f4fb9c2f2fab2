"""Drive the PyTorch port's serving, training, cascade and CSS paths on one
GPU, in float32 and in the JAX package's default bfloat16 (with its int8
DenseBlock decode mode), the REVERB plan, and data- and sequence-parallel
training over NCCL at world size 1.

    python3 chip_smoke.py

Phases (one or more JSON lines each; any failure exits non-zero):

  1. device   card name and power limit; TF32 off for cuDNN and matmuls
  2. build    nvcc-build the CUDA kernels from misonet_tpu_torch/csrc;
              count each kernel mode's tensor-core instructions (HMMA /
              HGMMA for bf16 and TF32, and IMMA / IGMMA for int8, in the
              SASS, ``cuobjdump -sass``) into its record's tensor_core_ops
  3. kernels  each forward kernel against its plain PyTorch version at
              the serving path's shapes (B = 6 shifts x T = 501 frames),
              and the enhancement nets' own stencil shapes (MISO3 / MISO2
              enc0 at C = 16 / 20, MISO3 final at N = 2), error bound 1e-4
              normalized by max-abs, CUDA-event times of both and of the
              cuDNN conv (library_ms), and the bound; the float32
              dense_stack and stencil (three TF32 passes on the tensor
              cores; each fails without HMMA) also within 1e-5 of their
              float64 runs (dense_stack_f64, stencil_f64); each float32
              dense and stencil weight packed and split on the card
              (pack_tf32, the float32 kernels' weight planes) against its
              plain twin, bit for bit
  4. forward  full default-width MISO1 forward [6, 6, 501, 129] (seeded
              weights, non-zero biases): fused kernel path against the
              plain path, exactly 50 dense_stack and 10 stencil launches
  5. serve    3 synthetic 6-mic 8 kHz requests (~5, 9, 12 s, 2 references
              each) through CascadeEvaluator.process in MISO1-only mode,
              launch counts of that run, per-request latency, and the
              shortest request again on the plain path for agreement
  6. bwd-kernels  stencil_bwd against stencil_bwd_plain at the train
              path's shapes (B = 8 utterances x T = 501), the cases of
              phase 3, bound 1e-4, and against the plain version run in
              float64, bound 1e-5; times of both, of the wgrad half alone
              and of the cuDNN backward pair (conv2d_input +
              conv2d_weight) as library_ms; fails if its kernels have no
              tensor-core instructions; the dgrad's weight planes
              (pack_tf32) against their plain twin, bit for bit
  7. train    the full-width wave train step [8, 6, 501, 129] (seeded
              synthetic 2-speaker 4 s mixtures, Adam lr 1e-3, NaN guard
              on): fused vs plain loss and gradients from the same weights
              (bound 1e-3 per tensor and per group in relative L2, or 2x
              the plain path's movement under the probe), bit-identical
              repeat gradients, 5 fused steps on the repeated batch with
              exactly 50 dense_stack, 10 stencil and 60 stencil_bwd
              launches per step (and pack_tf32's launches, one per new
              weight version and role: the 50 dense stacks rebuilt in the
              graph every step, the stencils' and the dgrads' weights)
              and a falling loss, step times and
              peak memory of both paths, and a torch.profiler breakdown of
              one fused step
  8. solve-kernel  hermitian_solve against hermitian_solve_plain run in
              float64, M = 6, 258 / 1,032 / 262,144 seeded PD systems (the
              utterance- and chunk-mode MVDR of a 12.3 s request, and a
              throughput size), bound 1e-4; times of both and of
              torch.linalg.solve (library_ms); then mvdr_weights (one MVDR
              call's weights: steering, phase correction, loaded solve)
              against mvdr_weights_plain run in complex128 at [rows, F, M]
              = [2, 129, 6] (utterance mode), [8, 129, 6] (chunk mode),
              [2, 257, 8] and [128, 129, 6] (a throughput size), on
              near-rank-1 source SCMs with diffuse noise (bound 1e-4) and
              on unstructured PD SCMs (bound max(1e-3, 2x the complex64
              plain version's own distance)), the worst bin's spectral gap;
              device ms (profiler; queued CUDA events beside it) and wall
              ms of the kernel, its dependent-latency floor (an estimate,
              printed on the phase's own lines), of the path it replaced
              (the eager loop and the hermitian_solve launch) and of
              torch.linalg.eigh + solve (a reference, not a yardstick)
  9. cascade  full-width MISO1 + MISO3 through CascadeEvaluator.process
              over the phase-5 requests in utterance and chunk mode, and
              MISO1 + MISO2 (joint) in chunk mode: exactly 100 dense_stack,
              20 stencil, 1 mvdr_weights and 0 hermitian_solve launches per
              request, latency, audio-s/s and per-stage PIT SI-SDR; the 5 s
              request again on the plain path (plain modules and
              mvdr_weights_plain), beamformed and enhanced waves within
              1e-3; a torch.profiler breakdown of one 12.3 s
              utterance-mode request; the MVDR call's host and device ms
              (the "mvdr.weights" range) beside the replaced path's
 10. css      StreamingCSS over the 12.3 s request, overlap 0 and 8,000:
              exactly 50 dense_stack, 10 stencil and 1 mvdr_weights
              launches per block (0 hermitian_solve), per-block latency
 11. lowp-kernels  the bf16 modes of dense_stack and stencil and the int8
              kernel dense_stack_int8 against their plain versions at the
              phase-3 shapes (and the bf16 stencil at the enhancement
              nets' and the REVERB plan's enc0 / final shapes, reported
              apart), in the working type: bf16-stored outputs within
              1e-2 of max-abs (two bf16 ulps), float32 statistics within
              1e-4; int8: acc_out bit-identical (the same integer sums), y
              within one bf16 ulp; times of kernel, plain version and
              library (cuDNN's bf16 conv; torch._int_mm over the call's
              im2col matrices for int8, the product only); the int8
              weight-row kernel (quantize_rows) against its plain twin,
              bit for bit (qw, corr, rq), and the kernels of one int8 call
              (the earlier version's 34 on a line of its own); fails if the
              bf16 dense_stack or stencil kernel has no HMMA, the int8
              kernel no IMMA, or a call launches the row kernel other than
              once
 12. bf16-forward  the full-width forward of ModelConfig() (bf16): fused
              vs the plain bf16 path, exactly 50 dense_stack_bf16 and 10
              stencil_bf16 launches, bound max(4e-2, 2x the plain path's
              movement under the 3e-6 perturbation probe); its kernels per
              forward (the FMA-stencil version's 1,447 on a line of its own)
 13. int8-forward  the same model with quant_int8=True: exactly 50
              dense_stack_int8, 50 quantize_rows and 10 stencil_bf16
              launches; against the same composition over the kernels'
              plain versions (swapped in here only), bound
              max(INT8_FORWARD_BOUND, 2x that composition's movement under
              the probe); int8 vs bf16 rms and correlation; its kernels per
              forward (the 3,246 of the version with the rows quantized in
              PyTorch on a line of its own)
 14. serve    the phase-5 requests through the bf16 and the int8 model
 15. cascade  the bf16 cascade (MISO3 utterance and chunk mode, MISO2
              joint): 100 dense_stack_bf16, 20 stencil_bf16 and 1
              mvdr_weights launches per request
 16. css      bf16 StreamingCSS blocks: 50 / 10 / 1 launches per block
 17. bf16-bwd-kernels  the bf16 mode of stencil_bwd at phase 6's cases
              and the enhancement nets' enc0 and final layers, against its
              roundings with float64 sums (bwd_reference): dx (bf16)
              within 1e-2 of max-abs, the float32 outputs (dW, dbias,
              dscale, dmean) within 1e-4; times of kernel, plain version
              (float32 convs of the bf16 operands) and cuDNN's bf16
              backward pair; the bound at the bf16 tensor-core rate;
              fails if its kernels have no tensor-core instructions
 18. bf16-train  phase 7 for ModelConfig() (bf16): fused vs plain bf16
              gradients per group, as one vector, within max(1e-2, 2x the
              plain path's movement under the probe) in relative L2 (per
              tensor max-abs reported only), 5 fused steps with exactly 50
              dense_stack_bf16, 10 stencil_bf16 and 60 stencil_bwd_bf16
              launches each and a falling loss, step times, peak memory
              and a profile, the step's device busy time beside its wall
              time
 19. cli      the port's command line (misonet_tpu_torch/cli.py) on a
              synthetic 8-utterance corpus at configs/smswsj.yml's plan
              (bf16): Extraction, Train MISO1, a resumed second epoch,
              Train MISO3, Test MISO3, Test CSS; finite losses,
              checkpoints, wavs, and the kernels' launches in each command
 20. dense-layer  kernel 2.6 (dense_layer, one whole DenseBlock layer over
              1-6 raw sources; no serving or training path runs it) in
              float32 and bf16 at ModelConfig()'s enc0 and dec6 DenseBlock
              layers and its two switches (fuse_elu=False, want_stats=
              False), B = 6, T = 501: every case once with the counts reset
              (exact launches), then against dense_layer_plain (1e-4; bf16
              outputs 1e-2), times of kernel, plain version and cuDNN's
              conv, and the bound; float32 (three TF32 passes) also
              within 1e-5 of its float64 run (dense_layer_f64), each
              float32 weight's planes bit for bit against pack_tf32_plain;
              fails if either mode's kernel has no tensor-core
              instructions
 21. reverb   the REVERB plan (configs/reverb_2mix.yml: 8 levels, F = 257,
              8 mics, 384-channel TCN, bf16) at full width: the forward of
              one 4 s chunk's 8 circular shifts, fused vs plain (phase 12's
              bound), exactly 50 dense_stack_bf16 + 10 stencil_bf16
              launches; one train step at the YAML's batch of 16 (or the
              largest power of two whose plain step fits): fused vs plain
              gradients with phase 18's gate, 50 / 10 / 60 launches a step,
              step times and peak memory; the device busy time of one
              forward and one step of each path
 22. parallel parallel/ over NCCL at world size 1 (the mechanism, not
              scaling): the data-parallel bf16 MISO1 wave train step [8, 6,
              501, 129] bit-identical to the step without a mesh (50 / 10 /
              60 launches), its step time beside that step's;
              chunked_scm over the group against the unsharded SCM; the
              full-width float32 MISO1 with the sequence-parallel TCN
              against the local model (1e-4); dryrun_multichip(1)
 23. ladder   the example programs' functions
              (misonet_tpu_torch/examples) at ModelConfig()'s full width
              (bf16) on 64 voiced 4 s utterances: 300 MISO1 steps at batch
              8 (50 / 10 / 60 launches a step; the loss points, the step
              time from CUDA events, host seconds), MISO1 on 4 held-out
              utterances above the mixture by LADDER_MARGIN dB; the
              float32, bf16 and int8 decodes of the trained weights scored
              (the int8 cost), and phases 12-13's fused-vs-plain gates
              rerun on them with a held-out utterance's decode input; 50
              MISO3 steps on the trained MISO1's features (100 / 20 / 60
              launches and 1 mvdr_weights a step, 0 hermitian_solve), the
              stage-wise SI-SDRs, one feature batch's beamformed features
              against mvdr_weights_plain's within CASCADE_BOUND and its
              weights against complex128 within phase 8's unstructured
              bound, the worst spectral gap of the trained SCMs beside
              phase 8's simulated ones at the same shape; a 20 s scene
              through StreamingCSS edge to edge and cross-faded over a
              quarter block (50 / 10 launches and 1 mvdr_weights a block),
              MISO1 above the mixture

``python3 chip_smoke.py --trained <dir>/<tag>`` runs phase 23's second
part alone on a MISO1 train state that the example programs saved
(train_synthetic's "demo", train_cascade's "miso1"), over eval_int8's 8
voiced held-out utterances: the decodes scored and phases 12-13's gates
on those weights.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA device; exits 1
without one.  Bounds (``bound_ms``) are the larger of the call's FLOPs
over the H100's peak for the kernel's type and its bytes (each input
read once, each output written once) over its memory rate.  The peaks:
for every float32 conv, a third of the dense TF32 tensor-core rate (three
TF32 passes, the card's fastest float32-accurate route, which the
float32 stencil and stencil_bwd take), with the bound at the float32
CUDA-core rate beside it on each case's line as fma_bound_ms; the float32 CUDA-core rate for
hermitian_solve and mvdr_weights; the dense bf16 and int8 tensor-core rates for the bf16
and int8 modes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

BOUND = 1e-4   # kernel vs plain, normalized by the plain output's max-abs
# a float32 kernel on the tensor cores (three TF32 passes) vs its plain
# version run in float64: float32's class (one TF32 pass is ~1e-3)
F64_BOUND = 1e-5
BF16_BOUND = 1e-2  # a bf16-stored kernel output vs plain: two bf16 ulps
# full-width bf16 forward, fused vs plain bf16 path (JAX's own bf16 class,
# tests/test_dense_stack.py:127), unless the plain path's own movement
# under the PERTURB probe is larger
BF16_FORWARD_BOUND = 4e-2
# full-width int8 forward, kernels vs the same composition over the plain
# versions: the integer sums agree, but a bf16 stencil output one ulp apart
# flips a quantization step downstream, so two runs differ like two draws
# of the int8 rounding noise (the int8-vs-bf16 class, reported beside it)
INT8_FORWARD_BOUND = 2e-1
CASCADE_BOUND = 1e-3  # fused vs plain beamformed / enhanced waves
TRAIN_BOUND = 1e-3  # fused vs plain train-step gradients (60 layers deep)
BF16_TRAIN_BOUND = 1e-2  # the same at bf16: two bf16 ulps
B, T = 6, 501  # M = 6 circular shifts of one 4 s chunk
TRAIN_B = 8    # utterances of 4 s per train step (bench.py --train)
TRAIN_STEPS = 5
REQUEST_S = (5.0, 9.0, 12.3)  # synthetic requests of phases 5 and 9
SOLVE_BATCHES = (258, 1032, 262144)  # systems per hermitian_solve call
# [rows, F, M] of mvdr_weights calls: utterance and chunk mode of a 12.3 s
# request (the main path's), M = 8 at F = 257, a throughput size (16,512
# bins: cuSOLVER's batched eigh, the reference route, refused 32,250)
WEIGHT_SHAPES = ((2, 129, 6), (8, 129, 6), (2, 257, 8), (128, 129, 6))
WEIGHT_MAIN = WEIGHT_SHAPES[:2]
SIM_BOUND = 1e-4  # mvdr_weights vs complex128 on near-rank-1 SCMs
PD_BOUND = 1e-3   # the same on unstructured SCMs, or 2x complex64's error
PERTURB = 3e-6  # relative input perturbation of the sensitivity probe
# the parameters whose gradients come out of stencil_bwd (the fused body)
BODY = re.compile(r"^(enc[0-4]|enc[0-4]_dense|dec[2-6]|dec[2-6]_dense)\.")
SEED = 0
# H100 SXM data sheet at 700 W: float32 outside the tensor cores, dense
# bf16 and int8 tensor-core rates, HBM3
PEAK_FLOPS = 67e12
PEAK_BF16 = 989e12
# float32 products as three TF32 passes (big big + big small + small big)
# on the dense TF32 tensor-core rate, 495 TFLOP/s
PEAK_TF32X3 = 495e12 / 3
PEAK_INT8 = 1979e12
PEAK_FP64 = 34e12  # float64 outside the tensor cores (same data sheet)
PEAK_BYTES = 3.35e12
# the counted kernel modes of each precision's forward
MODES = {"float32": ("dense_stack", "stencil"),
         "bfloat16": ("dense_stack_bf16", "stencil_bf16"),
         "int8": ("dense_stack_int8", "stencil_bf16")}


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
    """The tensors among ``values`` (a tensor, or a list or tuple, opened
    up recursively)."""
    if isinstance(values, torch.Tensor):
        yield values
        return
    for v in values:
        if isinstance(v, (list, tuple)):
            yield from tensors_of(v)
        elif isinstance(v, torch.Tensor):
            yield v


def bound_ms(flops: float, inputs, outputs,
             peak: float = PEAK_FLOPS) -> tuple[float, float, float]:
    """(bound, operations time, bytes time) in ms: each input read once,
    each output written once; operations at ``peak`` per second."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*tensors_of(inputs), *tensors_of(outputs)))
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def expect(mode="float32", dense=0, stencil=0, **other):
    """The launch counts of a run that launched ``dense`` DenseBlock and
    ``stencil`` stencil kernels of ``mode`` and ``other``, nothing else."""
    from misonet_tpu_torch.ops.kernels import COUNTERS

    counts = dict.fromkeys((name for name, _, _ in COUNTERS), 0)
    d, st = MODES[mode]
    counts[d] += dense
    counts[st] += stencil
    counts.update(other)
    return counts


# the kernel functions of each counted mode, as substrings of their SASS
# names (every mode runs the tensor-core kernels of csrc/conv_mma.cuh,
# float32 as TF32 passes; the float32 and bf16 modes of dense_stack and
# dense_layer are instances of one kernel template)
KERNEL_FUNCTIONS = {
    "dense_stack": ("dense_stack_tc_kernel",),
    "dense_stack_bf16": ("dense_stack_tc_kernel",),
    "dense_layer": ("dense_stack_tc_kernel",),
    "dense_layer_bf16": ("dense_stack_tc_kernel",),
    "stencil": ("stencil_tc_kernel",),
    "stencil_bf16": ("stencil_tc_kernel",),
    "stencil_bwd": ("dgrad_tc_kernel", "wgrad_tc_kernel"),
    "stencil_bwd_bf16": ("dgrad_tc_kernel", "wgrad_tc_kernel"),
    "hermitian_solve": ("hermitian_solve_kernel",),
    "mvdr_weights": ("mvdr_weights_kernel",),
    "dense_stack_int8": ("dense_stack_int8_tc_kernel",),
    "quantize_rows": ("quantize_rows_kernel",),
    "pack_tf32": ("pack_tf32_kernel",),
}
# the SASS opcodes of the tensor cores: bf16 / fp16 / TF32 (HMMA, wgmma
# HGMMA) and integer (IMMA, IGMMA)
TENSOR_CORE_OPS = ("HMMA", "HGMMA", "IMMA", "IGMMA")


def tensor_core_ops(lib) -> dict[str, int]:
    """{counted mode: HMMA / HGMMA / IMMA / IGMMA instructions in the SASS
    of its kernel functions}, from ``cuobjdump -sass`` of the built library
    (the bf16 and float32 instances of a shared template are told apart by
    their mangled storage type)."""
    import os

    from misonet_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    per_function, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            per_function[name] = 0
        elif name and any(op in line for op in TENSOR_CORE_OPS):
            per_function[name] += 1
    counts = {}
    for mode, parts in KERNEL_FUNCTIONS.items():
        # a template with float32 and bf16 instances: the mode's own
        shared = mode.removesuffix("_bf16") in ("dense_stack", "dense_layer",
                                                "stencil", "stencil_bwd")
        counts[mode] = sum(
            n for fn, n in per_function.items()
            if any(p in fn for p in parts)
            and (("__nv_bfloat16" in fn) == mode.endswith("_bf16")
                 or not shared))
    return counts


def check_tensor_cores(record) -> None:
    """Fail unless the kernels of a mode that must run on the tensor cores
    have tensor-core instructions."""
    if not record["tensor_core_ops"]:
        fail(f"{record['name']}: no tensor-core instructions in its kernels")


def new_record(name, replaces, source=None):
    return {"name": name, "route": "cuda",
            "source": f"misonet_tpu_torch/csrc/{source or name}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "max_norm_err": 0.0, "f64_max_norm_err": None, "ms": 0.0,
            "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None, "library_ms": 0.0, "ops_ms": 0.0,
            "bytes_ms": 0.0, "tensor_core_ops": 0}


def output_errs(name, got, want):
    """(abs, normalized) errors of each output of ``got`` against ``want``."""
    errs = []
    for g, w in zip(tensors_or_none(got), tensors_or_none(want)):
        if (g is None) != (w is None):
            fail(f"{name}: kernel and plain version disagree on outputs")
        if w is not None:
            if g.shape != w.shape or not torch.isfinite(g).all():
                fail(f"{name}: bad output {tuple(g.shape)}")
            if not (w.is_floating_point() or w.is_complex()):
                g, w = g.double(), w.double()   # integers: no wrap-around
            errs.append(norm_err(g.to(w.dtype), w))
    return errs


def widen(t: torch.Tensor) -> torch.Tensor:
    """float32 -> float64, complex64 -> complex128."""
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def check_kernel(name, kernel, plain, args, record, flops, library,
                 in_float64=False, phase="kernels", to_record=True,
                 peak=PEAK_FLOPS, extra=None, reps=10, reference=None,
                 f64=None):
    """Compare one kernel call with its plain version; time both and the
    library call ``library`` (a PyTorch call computing the same function,
    or None where there is none); add the call's bound at ``peak``
    operations per second.  Each output is held to BOUND, a bf16-stored
    one to BF16_BOUND.  ``in_float64``: the plain version runs on the
    inputs widened to float64 for the comparison; ``reference``: a
    function of ``args`` that gives the comparison's outputs (float64
    sums) in place of the plain version; either way the plain version's
    own run is reported beside the kernel.  ``f64`` (a float32 kernel on
    the tensor cores): every output is also held to F64_BOUND against the
    float64 run of the function, which is the comparison's own reference
    where ``f64`` is True (``in_float64``), else the run of ``f64``, a
    function of ``args`` (and the plain version's own error against it
    is reported).  A float32 conv takes its bound at PEAK_TF32X3, the
    fastest float32-accurate route of the card; its bound at the FMA peak
    is printed on the case's line as fma_bound_ms (not in the record).
    ``to_record``: add the times to the kernel's record (its main-path
    cases).  ``extra``: more numbers for the case's line; ``reps``: timed
    calls of the plain version."""
    got = kernel(*args)
    extra = dict(extra or {})
    if in_float64:
        reference = widened(plain)
    if reference is not None:
        want = reference(*args)
        extra["plain_f32_max_norm_err"] = max(
            e[1] for e in output_errs(name, plain(*args), want))
    else:
        want = plain(*args)
    f64_errs = []
    if callable(f64):
        ref = f64(*args)
        f64_errs = [e[1] for e in output_errs(name, got, ref)]
        extra["plain_f64_max_norm_err"] = max(
            e[1] for e in output_errs(name, want, ref))
        del ref
    torch.cuda.synchronize()
    errs = output_errs(name, got, want)
    if f64 is True:
        f64_errs = [e[1] for e in errs]
    if f64 is not None:
        extra["f64_norm_errs"] = f64_errs
        extra["f64_max_norm_err"] = max(f64_errs)
    err = errs[0][0]                 # the first output (sums are ~1e5)
    rel = max(e[1] for e in errs)    # every output, normalized
    bounds = [BF16_BOUND if w.dtype == torch.bfloat16 else BOUND
              for w in tensors_or_none(want) if w is not None]
    t_plain = cuda_ms(lambda: plain(*args), reps)
    t_kernel = cuda_ms(lambda: kernel(*args))
    t_lib = None if library is None else cuda_ms(library)
    if record["name"].startswith("stencil_bwd"):
        # the wgrad half alone: the same call without input gradients
        extra["wgrad_ms"] = cuda_ms(lambda: kernel(*args[:-1], False))
    bound, t_ops, t_bytes = bound_ms(flops, args, got, peak)
    if peak == PEAK_TF32X3:
        extra["fma_bound_ms"] = bound_ms(flops, args, got)[0]
    print(json.dumps({"phase": phase, "case": name,
                      "max_abs_err": err, "max_norm_err": rel,
                      "norm_errs": [e[1] for e in errs], "bounds": bounds,
                      "ms": t_kernel, "plain_ms": t_plain,
                      "library_ms": t_lib, "gflop": flops / 1e9,
                      "bound_ms": bound,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", **extra}), flush=True)
    if not all(e[1] <= b for e, b in zip(errs, bounds)):
        fail(f"{name}: normalized errors {[e[1] for e in errs]} above "
             f"{bounds}")
    if not all(e <= F64_BOUND for e in f64_errs):
        fail(f"{name}: normalized errors against the float64 run "
             f"{f64_errs} above {F64_BOUND}")
    if not to_record:
        return got, want
    record["max_abs_err"] = max(record["max_abs_err"], err)
    record["max_norm_err"] = max(record["max_norm_err"], rel)
    if f64 is not None:
        record["f64_max_norm_err"] = max(record["f64_max_norm_err"] or 0.0,
                                         max(f64_errs))
    record["ms"] += t_kernel
    record["plain_ms"] += t_plain
    if t_lib is None or record["library_ms"] is None:
        record["library_ms"] = None
    else:
        record["library_ms"] += t_lib
    record["bound_ms"] += bound
    record["ops_ms"] += t_ops
    record["bytes_ms"] += t_bytes
    return got, want


def widened(fn):
    """``fn`` run on its arguments widened to float64 (tensors, and lists
    of them)."""
    def run(*a):
        return fn(*[widen(v) if isinstance(v, torch.Tensor) else
                    [widen(x) for x in v] if isinstance(v, list) else v
                    for v in a])
    return run


def stencil_f64(x, w, bias, scale, mean, mode):
    """stencil's function in float64 from the same arguments (its plain
    version computes in float32): (y, sums, sqs)."""
    import torch.nn.functional as F

    from misonet_tpu_torch.ops.kernels.stencil_bwd import geometry

    f64 = torch.float64
    xn = x.to(f64)
    if scale is not None:
        xn = ((xn - mean.to(f64)[:, :, None, None])
              * scale.to(f64)[:, :, None, None])
    stride, padding = geometry(mode)
    conv = F.conv_transpose2d if mode in ("up", "final") else F.conv2d
    y = conv(xn, w.to(f64), bias.to(f64), stride=stride, padding=padding)
    if mode not in ("down", "up"):
        return y, None, None
    y = F.elu(y)
    return y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))


def dense_layer_f64(xs, w, bias, scale, mean, fuse_elu=True,
                    want_stats=True):
    """dense_layer's function in float64 from the same arguments (its plain
    version computes in float32): (y, sums, sqs), the sums None without
    ``want_stats``."""
    import torch.nn.functional as F

    f64 = torch.float64
    xn = normalized([x.to(f64) for x in xs], scale.to(f64), mean.to(f64))
    y = F.conv2d(xn, w.to(f64), bias.to(f64), padding=1)
    if fuse_elu:
        y = F.elu(y)
    if not want_stats:
        return y, None, None
    return y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))


def dense_stack_f64(xs, acc_in, w_stack, bias, scale, mean, n_fin):
    """dense_stack's function in float64 from the same arguments: (y, sums,
    sqs, acc_out)."""
    import torch.nn.functional as F

    f64 = torch.float64
    xn = normalized([x.to(f64) for x in xs], scale.to(f64), mean.to(f64))
    z = F.conv2d(xn, w_stack.to(f64), padding=1)
    if acc_in is not None:
        z = z + acc_in.to(f64)
    y = F.elu(z[:, :n_fin] + bias.to(f64)[None, :, None, None])
    acc_out = z[:, n_fin:] if z.shape[1] > n_fin else None
    return y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3)), acc_out


def check_pack(name, w, widths, transpose, records):
    """pack_tf32 (the float32 weight planes, one launch) against its plain
    twin on one weight of a float32 dense_stack, dense_layer, stencil or
    dgrad, bit for bit; its bound is its bytes (no arithmetic but the
    split)."""
    from misonet_tpu_torch.ops.kernels.tc_pack import (
        pack_tf32, pack_tf32_plain)

    got, want = check_kernel(f"pack_tf32 {name}", pack_tf32, pack_tf32_plain,
                             (w, widths, transpose), records["pack_tf32"], 0,
                             None, phase="pack")
    if not torch.equal(got, want):
        fail(f"pack_tf32 {name}: the card's planes differ from "
             "pack_tf32_plain")


def tensors_or_none(out):
    """A kernel's outputs (one tensor, or a tuple) as a flat list, keeping
    None placeholders."""
    if isinstance(out, torch.Tensor):
        return [out]
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
# (name, mode, C, N, F_in, batch): the enhancement nets' own stencil shapes
# at a 12.3 s request's batch (4 chunks; MISO3 runs chunks x 2 speakers)
ENHANCE_STENCIL_CASES = [
    ("miso3 enc0", "enc0", 16, 24, 129, 8),
    ("miso2 enc0", "enc0", 20, 24, 129, 4),
    ("miso3 dec6", "final", 48, 2, 127, 8),
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

    check_tensor_cores(records["dense_stack"])
    check_tensor_cores(records["stencil"])
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
                     lambda: F.conv2d(xn, args[2], padding=1),
                     peak=PEAK_TF32X3, f64=dense_stack_f64)
        check_pack(f"dense_stack {name}", args[2], widths, False, records)

    for name, mode, c, n, f_in, b in [*(case + (B,) for case in STENCIL_CASES),
                                      *ENHANCE_STENCIL_CASES]:
        wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
        stats = ([None, None] if mode == "enc0" else
                 [rand(rng, (b, c), 0.5, 1.5), rand(rng, (b, c), -0.5, 0.5)])
        args = [rand(rng, (b, c, T, f_in)),
                rand(rng, wshape, scale=1.0 / np.sqrt(9 * c)),
                rand(rng, (n,), scale=0.1), *stats, mode]
        xn = normalized([args[0]], *stats)
        stride, padding = geometry(mode)
        conv = (F.conv_transpose2d if mode in ("up", "final") else F.conv2d)
        check_kernel(f"stencil {name}", stencil, stencil_plain, args,
                     records["stencil"],
                     2 * conv_macs(mode, b, c, n, T, f_in),
                     lambda: conv(xn, args[1], args[2], stride=stride,
                                  padding=padding),
                     peak=PEAK_TF32X3, f64=stencil_f64)
        check_pack(f"stencil {name}", args[1], (c,), mode in ("up", "final"),
                   records)


def int8_library(xs, w, scale, mean):
    """The yardstick of one int8 call: ``torch._int_mm`` of the call's
    im2col matrix of quantized activations [B*T*F, 9C] with one batch
    element's quantized weights [9C, N] (the product only: no
    quantization, correction, dequantization or epilogue).  Returns (the
    call, None), or (None, the error) where the library refuses it."""
    import torch.nn.functional as F

    from misonet_tpu_torch.ops.kernels.dense_stack_int8 import (
        QS, quantize_rows)

    x = torch.cat([v.float() for v in xs], dim=1)
    b, c, t, f = x.shape
    qx = torch.clamp(torch.round(x * scale[:, :, None, None] * QS), -127, 127)
    a = F.unfold(qx, 3, padding=1).transpose(1, 2).reshape(b * t * f, 9 * c)
    a = a.to(torch.int8).contiguous()
    qw, _, _ = quantize_rows(w, scale, mean)
    m = qw[0].reshape(qw.shape[1], 9 * c).t()    # [9C, N], column-major
    try:
        torch._int_mm(a, m)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return (lambda: torch._int_mm(a, m)), None


def bf16_ulps(got, want):
    """Largest distance of two bf16 tensors in bf16 ulps (adjacent bf16
    numbers of one sign differ by one in their 16-bit pattern)."""
    return (got.view(torch.int16).int() - want.view(torch.int16).int()).abs(
    ).max().item()


def phase_lowp_kernels(records):
    """The bf16 modes of dense_stack and stencil and the int8 decode kernel
    against their plain versions at the phase-3 shapes, in the working
    type.  bf16: bf16-stored outputs within BF16_BOUND, float32 statistics
    within BOUND.  int8: the same integer sums (acc_out bit-identical), y
    within one bf16 ulp, statistics within BOUND.  Library: cuDNN's bf16
    conv; for int8 torch._int_mm over the call's im2col matrices."""
    import torch.nn.functional as F

    from misonet_tpu_torch.ops.kernels.dense_stack import (
        dense_stack, dense_stack_plain)
    from misonet_tpu_torch.ops.kernels.dense_stack_int8 import (
        dense_stack_int8, dense_stack_int8_plain, quantize_rows,
        quantize_rows_packed)
    from misonet_tpu_torch.ops.kernels.stencil import stencil, stencil_plain
    from misonet_tpu_torch.ops.kernels.stencil_bwd import geometry
    from misonet_tpu_torch.ops.kernels.tc_pack import pack_int8_rows

    def rows_plain(w, scale, mean, widths):
        qw, corr, rq = quantize_rows(w, scale, mean)
        return pack_int8_rows(qw, widths), corr, rq

    for name in ("dense_stack_bf16", "stencil_bf16", "dense_stack_int8"):
        check_tensor_cores(records[name])
    bf = torch.bfloat16
    rng = np.random.default_rng(SEED + 11)
    rec8 = records["dense_stack_int8"]
    rec8.update(library_error=None, launches_per_call=None)
    print(json.dumps({"phase": "lowp-kernels",
                      "earlier_pr_figures": EARLIER_FIGURES["int8_call"]}),
          flush=True)
    for name, widths, n, n_fin, f, with_acc in DENSE_CASES:
        c = sum(widths)
        xs = [rand(rng, (B, w, T, f)).to(bf) for w in widths]
        acc = rand(rng, (B, n, T, f)).to(bf) if with_acc else None
        w = rand(rng, (n, c, 3, 3), scale=1.0 / np.sqrt(9 * c))
        bias = rand(rng, (n_fin,), scale=0.1)
        scale = rand(rng, (B, c), 0.5, 1.5)
        mean = rand(rng, (B, c), -0.5, 0.5)
        wb = w.to(bf)
        xn = normalized(xs, scale, mean).to(bf)
        flops = 2 * conv_macs("dense", B, c, n, T, f)
        check_kernel(f"dense_stack bf16 {name}", dense_stack,
                     dense_stack_plain, (xs, acc, wb, bias, scale, mean,
                                         n_fin),
                     records["dense_stack_bf16"], flops,
                     lambda: F.conv2d(xn, wb, padding=1),
                     phase="lowp-kernels", peak=PEAK_BF16)
        del xn
        lib, lib_err = int8_library(xs, w, scale, mean)
        # the row kernel against its plain twin: the same rows, bit for bit
        # (float64 sums of B * N * 9 * C products)
        rows, rows_want = check_kernel(
            f"quantize_rows {name}", quantize_rows_packed, rows_plain,
            (w, scale, mean, widths), records["quantize_rows"],
            2 * B * n * 9 * c, None, phase="lowp-kernels", peak=PEAK_FP64)
        if not all(map(torch.equal, rows, rows_want)):
            fail(f"quantize_rows {name}: the card's rows (qw, corr, rq) "
                 "differ from quantize_rows + pack_int8_rows")
        got, want = check_kernel(
            f"dense_stack_int8 {name}", dense_stack_int8,
            dense_stack_int8_plain, (xs, acc, w, bias, scale, mean, n_fin),
            rec8, flops, lib, phase="lowp-kernels", peak=PEAK_INT8,
            extra={"library_error": lib_err}, reps=3)
        rec8["library_error"] = rec8["library_error"] or lib_err
        # the row launches of one call; the kernels' own device time (the
        # wrapper's time above includes its host work) and the kernels of
        # one call
        rows_before = quantize_rows_packed.launches
        dense_stack_int8(xs, acc, w, bias, scale, mean, n_fin)
        row_launches = quantize_rows_packed.launches - rows_before
        prof = profile_call(lambda: dense_stack_int8(xs, acc, w, bias, scale,
                                                     mean, n_fin))
        ms = prof["ms"]
        dev_ms = ms["dense_stack_int8"] + ms["int8_rows"] + ms["reduce_stats"]
        # device times only from windows that kept all their device events
        for key, v in (("device_ms", dev_ms),
                       ("conv_device_ms", ms["dense_stack_int8"])):
            total = rec8.get(key, 0.0)
            rec8[key] = (None if total is None or prof["device_events_lost"]
                         else total + v)
        rec8["launches_per_call"] = max(rec8["launches_per_call"] or 0,
                                        prof["kernels"])
        ulps = bf16_ulps(got[0], want[0])
        same = got[3] is None or torch.equal(got[3], want[3])
        print(json.dumps({"phase": "lowp-kernels", "case": f"int8 {name}",
                          "kernel_device_ms": dev_ms,
                          "conv_device_ms": ms["dense_stack_int8"],
                          "rows_device_ms": ms["int8_rows"],
                          "launches_per_call": prof["kernels"],
                          "device_events_lost": prof["device_events_lost"],
                          "row_launches_per_call": row_launches,
                          "padded_channels": sum(-(-c // 16) * 16
                                                 for c in widths),
                          "channels": c, "y_max_ulps": ulps,
                          "acc_out_identical": same}), flush=True)
        if ulps > 1 or not same:
            fail(f"dense_stack_int8 {name}: y {ulps} ulps apart, acc_out "
                 f"identical: {same}")
        if row_launches != 1:
            fail(f"dense_stack_int8 {name}: {row_launches} row quantization "
                 "launches in one call, expected 1")

    # the main path's cases (recorded), then the enhancement nets' and the
    # REVERB plan's narrow and wide shapes (reported only)
    for name, mode, c, n, f_in, b, to_record in [
            *(case + (B, True) for case in STENCIL_CASES),
            *(case + (False,) for case in ENHANCE_STENCIL_CASES),
            ("reverb enc0", "enc0", 16, 24, 257, 8, False)]:
        wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
        stats = ([None, None] if mode == "enc0" else
                 [rand(rng, (b, c), 0.5, 1.5), rand(rng, (b, c), -0.5, 0.5)])
        x = rand(rng, (b, c, T, f_in)).to(bf)
        wt = rand(rng, wshape, scale=1.0 / np.sqrt(9 * c)).to(bf)
        bias = rand(rng, (n,), scale=0.1)
        xn = normalized([x], *stats).to(bf)
        stride, padding = geometry(mode)
        conv = (F.conv_transpose2d if mode in ("up", "final") else F.conv2d)
        check_kernel(f"stencil bf16 {name}", stencil, stencil_plain,
                     [x, wt, bias, *stats, mode], records["stencil_bf16"],
                     2 * conv_macs(mode, b, c, n, T, f_in),
                     lambda: conv(xn, wt, bias.to(bf), stride=stride,
                                  padding=padding),
                     phase="lowp-kernels", peak=PEAK_BF16,
                     to_record=to_record)


def bwd_reference(g, xs, w, scale, mean, mode, need_dx=True):
    """The bf16 mode of stencil_bwd with exact sums: its bf16 operands (g,
    w and the rounded normalized input bf16((x - mean) * scale)) widened to
    float64, the dgrad G and the wgrad summed in float64 by the plain
    version, then dx = bf16(scale * G), dscale = sum G (x - mean) and
    dmean = -scale sum G in float64."""
    from misonet_tpu_torch.ops.kernels.stencil_bwd import stencil_bwd_plain

    f64 = torch.float64
    widths = [int(x.shape[1]) for x in xs]
    xn = normalized(xs, scale, mean).to(g.dtype).to(f64)
    big_gs, dw, dbias, _, _ = stencil_bwd_plain(
        g.to(f64), torch.split(xn, widths, dim=1), w.to(f64), None, None,
        mode, need_dx, False)
    if not need_dx:
        return None, dw, dbias, None, None
    big_g = torch.cat(big_gs, dim=1)
    dscale = dmean = None
    if scale is not None:
        x = torch.cat(xs, dim=1).to(f64) - mean.to(f64)[:, :, None, None]
        dscale = (big_g * x).sum(dim=(2, 3))
        dmean = -scale.to(f64) * big_g.sum(dim=(2, 3))
        big_g = big_g * scale.to(f64)[:, :, None, None]
    dxs = tuple(d.to(g.dtype) for d in torch.split(big_g, widths, dim=1))
    return dxs, dw, dbias, dscale, dmean


def phase_bwd_kernels(records, dtype=torch.float32):
    """stencil_bwd against its plain version at the train step's shapes:
    the cotangents of the phase-3 calls at B = 8.  float32 (phase 6): the
    reference is the plain version run in float64.  bfloat16 (phase 17):
    bf16 g, sources and weights, the reference ``bwd_reference`` (the
    mode's roundings with float64 sums); dx within BF16_BOUND, the float32
    outputs within BOUND; the library is cuDNN's bf16 backward pair."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from misonet_tpu_torch.ops.kernels.stencil import out_bins
    from misonet_tpu_torch.ops.kernels.stencil_bwd import (
        geometry, stencil_bwd, stencil_bwd_plain)

    bf16 = dtype == torch.bfloat16
    check_tensor_cores(records["stencil_bwd_bf16" if bf16 else "stencil_bwd"])
    rng = np.random.default_rng(SEED + (17 if bf16 else 4))
    cases = [(f"dense {name}", "dense", widths, n, f)
             for name, widths, n, _, f, _ in DENSE_CASES]
    cases += [(f"stencil {name}", mode, (c,), n, f_in)
              for name, mode, c, n, f_in in STENCIL_CASES]
    if bf16:
        # the enhancement nets' enc0 and final layers, as their trainers
        # call them at the default precision (EnhanceTrainer folds the
        # speakers into the batch; phase 19 trains MISO3 so)
        cases += [(f"stencil {name}", mode, (c,), n, f_in)
                  for name, mode, c, n, f_in, _ in ENHANCE_STENCIL_CASES]
    for name, mode, widths, n, f_in in cases:
        c = sum(widths)
        b = TRAIN_B
        f_out = f_in if mode == "dense" else out_bins(mode, f_in)
        wshape = (c, n, 3, 3) if mode in ("up", "final") else (n, c, 3, 3)
        stats = ([None, None] if mode == "enc0" else
                 [rand(rng, (b, c), 0.5, 1.5), rand(rng, (b, c), -0.5, 0.5)])
        need_dx = mode != "enc0"   # the train step asks enc0 for no dx
        args = (rand(rng, (b, n, T, f_out)).to(dtype),
                [rand(rng, (b, w, T, f_in)).to(dtype) for w in widths],
                rand(rng, wshape, scale=1.0 / np.sqrt(9 * c)).to(dtype),
                *stats, mode, need_dx)
        g, xs, w = args[:3]
        xn = normalized(xs, *stats).to(dtype)
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
        # float32: the reference is the plain version run in float64 (at
        # BOUND, and at F64_BOUND: f64=True): cuDNN's float32 weight gradient,
        # summing ~500,000 products, is off by up to ~1e-4 of max-abs at
        # these shapes
        check_kernel(f"stencil_bwd{' bf16' if bf16 else ''} {name}",
                     stencil_bwd, stencil_bwd_plain, args,
                     records["stencil_bwd_bf16" if bf16 else "stencil_bwd"],
                     2 * macs * (2 if need_dx else 1), library,
                     in_float64=not bf16,
                     reference=bwd_reference if bf16 else None,
                     f64=None if bf16 else True,
                     phase="bf16-bwd-kernels" if bf16 else "bwd-kernels",
                     peak=PEAK_BF16 if bf16 else PEAK_TF32X3)
        if not bf16 and need_dx:
            # the dgrad's weight: output channel c, reduced channel n
            check_pack(f"dgrad {name}", w, (n,),
                       mode not in ("up", "final"), records)


def seeded_model(cfg, device, kind="miso1", seed=SEED, **factory):
    from misonet_tpu_torch import models

    gen = torch.Generator().manual_seed(seed)
    model = getattr(models, f"make_{kind}")(cfg, device=device, generator=gen,
                                           **factory)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):  # non-zero biases exercise the epilogues
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model.eval()


def forward_input():
    """The seeded full-width MISO1 input [6, 6, 501, 129] on the card."""
    rng = np.random.default_rng(SEED + 1)
    return torch.complex(rand(rng, (B, 6, T, 129)), rand(rng, (B, 6, T, 129)))


def moved(x):
    """``x`` perturbed by PERTURB relative noise (the sensitivity probe)."""
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        SEED + 5)).to(x.device)
    return x * (1 + PERTURB * noise)


def agreement(got, want):
    """Max-abs and rms error over the reference's max-abs, correlation."""
    g = torch.view_as_real(got).double()
    w = torch.view_as_real(want).double()
    top = w.abs().max().item()
    corr = torch.corrcoef(torch.stack([g.ravel(), w.ravel()]))[0, 1].item()
    return {"max_norm_err": (g - w).abs().max().item() / top,
            "rms_norm_err": (g - w).square().mean().sqrt().item() / top,
            "corr": corr}


def phase_forward(model, cfg, mode="float32", records=None, x=None,
                  phase="forward"):
    """The full-width forward: fused against the plain path, exact launch
    counts.  float32: within BOUND.  bfloat16: within BF16_FORWARD_BOUND,
    or twice the plain path's own movement under the PERTURB probe where
    that is larger.  ``x`` (default: the seeded forward_input) of shape
    [B, 6, T, 129]; a phase other than "forward" (a rerun on trained
    weights) skips the profile.  Returns the fused output."""
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    x = forward_input() if x is None else x
    plain_cfg = dataclasses.replace(cfg, flat_dense=False)
    with torch.inference_mode():
        reset_launch_counts()
        fused = model(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts != expect(mode, 50, 10):
            fail(f"{mode} forward launched {counts}, expected "
                 f"{expect(mode, 50, 10)}")
        t_fused = cuda_ms(lambda: model(x), reps=5)
        model.cfg = plain_cfg
        plain = model(x)
        t_plain = cuda_ms(lambda: model(x), reps=5)
        sens = (None if mode == "float32" else
                norm_err(torch.view_as_real(model(moved(x))),
                         torch.view_as_real(plain))[1])
        model.cfg = cfg
    if (fused.shape != (B, 2, T, 129) or fused.dtype != torch.complex64
            or not torch.isfinite(torch.view_as_real(fused)).all()):
        fail(f"forward output {tuple(fused.shape)} {fused.dtype} not "
             "finite/expected")
    err, rel = norm_err(torch.view_as_real(fused), torch.view_as_real(plain))
    bound = BOUND if sens is None else max(BF16_FORWARD_BOUND, 2 * sens)
    print(json.dumps({"phase": phase, "precision": mode,
                      "shape": list(x.shape),
                      "params": sum(p.numel() for p in model.parameters()),
                      "launches_per_forward": counts, "max_abs_err": err,
                      "max_norm_err": rel, "bound": bound,
                      "plain_sensitivity": sens, "perturbation": PERTURB,
                      **agreement(fused, plain),
                      "fused_ms": t_fused, "plain_ms": t_plain}), flush=True)
    if not rel <= bound:
        fail(f"{mode} forward: fused vs plain normalized error {rel} above "
             f"{bound}")
    if records is not None:
        for name in MODES[mode]:
            records[name]["launches"] = counts[name]
    if phase != "forward":
        return fused
    with torch.inference_mode():
        prof = profile_call(lambda: model(x))
    print(json.dumps({"phase": "forward", "precision": mode,
                      "profile": "one fused forward", **prof}), flush=True)
    if mode in EARLIER_FIGURES:
        print(json.dumps({"phase": "forward", "precision": mode,
                          "earlier_pr_figures": EARLIER_FIGURES[mode]}),
              flush=True)
    return fused


# figures of the versions that the tensor-core stencil and the int8 row
# kernel replaced, from earlier chip runs recorded in PERF.md §5-6, printed
# on lines of their own beside this run's numbers: none is measured here
EARLIER_FIGURES = {
    "bfloat16": {"kernels_per_forward": 1447,
                 "version": "bf16 stencil on the FMA loop (PERF.md §5)"},
    "int8": {"kernels_per_forward": 3246,
             "version": "weight rows quantized in PyTorch (PERF.md §5)"},
    "int8_call": {"launches_per_call": 34,
                  "version": "weight rows quantized in PyTorch "
                             "(PERF.md §6)"},
}


@contextlib.contextmanager
def plain_kernels():
    """The fused modules over the kernels' plain versions (the reference
    composition of the int8 forward on the card)."""
    from misonet_tpu_torch.ops.kernels import flat_grad
    from misonet_tpu_torch.ops.kernels.dense_stack_int8 import (
        dense_stack_int8_plain)
    from misonet_tpu_torch.ops.kernels.stencil import stencil_plain

    saved = flat_grad.dense_stack_int8, flat_grad.stencil
    flat_grad.dense_stack_int8 = dense_stack_int8_plain
    flat_grad.stencil = stencil_plain
    try:
        yield
    finally:
        flat_grad.dense_stack_int8, flat_grad.stencil = saved


def phase_forward_int8(model, cfg, bf16_out, records, x=None,
                       phase="forward"):
    """The full-width forward with quant_int8=True: exactly 50
    dense_stack_int8 and 10 bf16 stencil launches; against the same
    composition over the kernels' plain versions, within INT8_FORWARD_BOUND
    or twice that composition's own movement under the PERTURB probe; its
    distance to the bf16 forward reported.  ``x`` and ``phase`` as in
    phase_forward; ``records`` None on a rerun."""
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from misonet_tpu_torch.ops.kernels.dense_stack_int8 import (
        quantize_rows_packed)

    x = forward_input() if x is None else x
    model.cfg = dataclasses.replace(cfg, quant_int8=True)
    with torch.inference_mode():
        reset_launch_counts()
        quantize_rows_packed.launches = 0
        fused = model(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        rows = quantize_rows_packed.launches
        if counts != expect("int8", 50, 10) or rows != 50:
            fail(f"int8 forward launched {counts} and {rows} row "
                 f"quantizations, expected {expect('int8', 50, 10)} and 50")
        t_fused = cuda_ms(lambda: model(x), reps=5)
        with plain_kernels():
            reset_launch_counts()
            plain = model(x)
            sens = norm_err(torch.view_as_real(model(moved(x))),
                            torch.view_as_real(plain))[1]
            if any(launch_counts().values()):
                fail(f"the int8 reference composition launched "
                     f"{launch_counts()}")
    model.cfg = cfg
    if (fused.dtype != torch.complex64
            or not torch.isfinite(torch.view_as_real(fused)).all()):
        fail("int8 forward output not finite/complex64")
    err, rel = norm_err(torch.view_as_real(fused), torch.view_as_real(plain))
    bound = max(INT8_FORWARD_BOUND, 2 * sens)
    print(json.dumps({"phase": phase, "precision": "int8",
                      "launches_per_forward": {**counts,
                                               "quantize_rows": rows},
                      "max_abs_err": err,
                      "max_norm_err": rel, "bound": bound,
                      "plain_sensitivity": sens, "perturbation": PERTURB,
                      **agreement(fused, plain),
                      "int8_vs_bf16": agreement(fused, bf16_out),
                      "fused_ms": t_fused}), flush=True)
    if not rel <= bound:
        fail(f"int8 forward: kernels vs plain composition normalized error "
             f"{rel} above {bound}")
    if records is None:
        return
    records["dense_stack_int8"]["launches"] = counts["dense_stack_int8"]
    records["quantize_rows"]["launches"] = rows
    model.cfg = dataclasses.replace(cfg, quant_int8=True)
    with torch.inference_mode():
        prof = profile_call(lambda: model(x))
    model.cfg = cfg
    print(json.dumps({"phase": "forward", "precision": "int8",
                      "profile": "one fused forward", **prof}), flush=True)
    print(json.dumps({"phase": "forward", "precision": "int8",
                      "earlier_pr_figures": EARLIER_FIGURES["int8"]}),
          flush=True)


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


def phase_serve(model, cfg, device_line, records, mode="float32"):
    from misonet_tpu_torch.config import DatasetConfig, StftConfig
    from misonet_tpu_torch.inference.evaluate import CascadeEvaluator
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    """The three synthetic requests through CascadeEvaluator.process in
    MISO1-only mode at ``mode``'s precision: exact launch counts, latency;
    in float32 also the 5 s request on the plain path."""
    ds = DatasetConfig()
    ev = CascadeEvaluator(model, StftConfig(), ds, beamform_utterance=False)
    rng = np.random.default_rng(SEED + 2)
    requests = [synth_request(rng, s) for s in REQUEST_S]

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
        print(json.dumps({"phase": "serve", "precision": mode,
                          "audio_s": secs,
                          "chunks": -(-mix.shape[0] // ds.chunk_samples),
                          "latency_s": dt, "audio_s_per_s": secs / dt,
                          "pit_si_sdr_db": score, "device": device_line}),
              flush=True)
        if not ok:
            fail(f"serve: request of {secs} s gave shape "
                 f"{res.separated.shape}, score {score}")
    n_req = len(requests)
    print(json.dumps({"phase": "serve", "precision": mode,
                      "launches": counts}), flush=True)
    if counts != expect(mode, 50 * n_req, 10 * n_req):
        fail(f"{mode} serve launched {counts}, expected "
             f"{expect(mode, 50 * n_req, 10 * n_req)} ({n_req} requests)")
    for name in MODES[mode]:
        records[name].setdefault("launches_serve", counts[name])
    if mode != "float32":
        return

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


# the port's torch.profiler ranges (ops/stft.py, beamforming/mvdr.py)
RANGES = ("stft", "istft", "mvdr.scm", "mvdr.power_iteration",
          "mvdr.weights")


# the host-side CUDA calls that put work on the device (kernel launches,
# copies, fills), as torch.profiler records them
LAUNCH_CALLS = ("LaunchKernel", "Memcpy", "Memset")
# the marker kernels that open a window (torch.cuda._sleep's), launched in
# a range of this name and left out of every count
MARKER, MARKER_RANGE, MARKERS = "spin_kernel", "profile_markers", 3
PROFILE_PAUSE_S = 0.05  # host pause between the markers and the call
PROFILE_TRIES = 3


def profile_call(fn):
    """torch.profiler over one warm call of ``fn``: device time by kernel
    group and inside each of the port's ranges (the host time spent in
    them beside it), device busy share of the call's wall time.

    On the card's machine the profiler's device timestamps stray from the
    host's as a run goes on (kernels dated before their own launch), and
    it drops device events: a window's first ones, late in a run whole
    short windows.  So ``kernels`` counts the host's records of the call's
    launches, copies and fills (host clock, none dropped), and
    ``device_events_lost`` those of them whose device event is missing.
    A window opens with a warm-up step (discarded), then MARKERS marker
    kernels (to be lost in place of the call's) and a PROFILE_PAUSE_S
    host pause before the call; one that lost device events of the call
    is taken again, up to PROFILE_TRIES windows, and the last is reported
    as it is: its device times are then short by the lost events."""
    for tries in range(1, PROFILE_TRIES + 1):
        out = profile_window(fn)
        if not out["device_events_lost"]:
            break
    return {**out, "windows": tries}


def profile_window(fn):
    """profile_call's one window."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in range(2):
            if step:
                with record_function(MARKER_RANGE):
                    for _ in range(MARKERS):
                        torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAUSE_S)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            prof.step()
    # the call's host records of device work, and the correlation ids of
    # the device events kept (each carries its host call's)
    events = prof.profiler.kineto_results.events()
    marks = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
             for ev in events if ev.name() == MARKER_RANGE
             and ev.device_type() == DeviceType.CPU]
    launched, seen = {}, {}
    for ev in events:
        if ev.device_type() == DeviceType.CUDA:
            seen[ev.correlation_id()] = ev.start_ns()
        elif (any(c in ev.name() for c in LAUNCH_CALLS)
              and not any(a <= ev.start_ns() <= b for a, b in marks)):
            launched[ev.correlation_id()] = ev.start_ns()
    # device start - host launch, in the profiler's clock (< 0: the device
    # timestamps stray)
    gaps = [(seen[c] - t) / 1e3 for c, t in launched.items() if c in seen]
    groups = {"dense_stack": 0.0, "dense_stack_int8": 0.0, "int8_rows": 0.0,
              "stencil": 0.0, "stencil_bwd": 0.0, "hermitian_solve": 0.0,
              "mvdr_weights": 0.0,
              "reduce_stats": 0.0, "pack_tf32": 0.0, "other": 0.0}
    calls = dict.fromkeys(groups, 0)
    other = {}
    ranges = {}
    device_events = 0
    for e in prof.key_averages():
        if (e.key in RANGES
                and getattr(e, "device_type", None) == DeviceType.CPU):
            dev = getattr(e, "device_time_total", None)
            ranges[e.key] = {
                "calls": e.count,
                "device_ms": (dev if dev is not None
                              else e.cuda_time_total) / 1e3,
                "host_ms": e.cpu_time_total / 1e3}
        # device work only: kernels, copies, fills; not user annotations
        # such as Optimizer.step#Adam.step, which span kernels counted on
        # their own
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        if MARKER in e.key:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        device_events += e.count
        name = e.key
        if "dense_stack_int8_tc_kernel" in name:
            group = "dense_stack_int8"
        elif "quantize_rows_kernel" in name:
            group = "int8_rows"
        elif "dense_stack_tc_kernel" in name:
            group = "dense_stack"
        elif "stencil_tc_kernel" in name:
            group = "stencil"
        elif "dgrad_tc_kernel" in name or "wgrad_" in name:
            group = "stencil_bwd"
        elif "hermitian_solve_kernel" in name:
            group = "hermitian_solve"
        elif "mvdr_weights_kernel" in name:
            group = "mvdr_weights"
        elif "reduce_stats_kernel" in name:
            group = "reduce_stats"
        elif "pack_tf32_kernel" in name:
            group = "pack_tf32"
        else:
            group = "other"
            other[name[:60]] = other.get(name[:60], 0.0) + us
        groups[group] += us
        calls[group] += e.count
    busy = sum(groups.values()) / 1e3
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall if wall else None,
            "idle_share": 1 - busy / wall if wall else None,
            "kernels": len(launched), "device_events": device_events,
            "device_events_lost": len(launched.keys() - seen.keys()),
            "launch_to_start_us_min": min(gaps, default=None),
            "ms": {k: v / 1e3 for k, v in groups.items()},
            "calls": calls,
            "share": {k: v / 1e3 / busy if busy else None
                      for k, v in groups.items()},
            "ranges": ranges,
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


def check_gradients(phase, mode, fused, plain, mix, ref, shape, body=BODY):
    """Fused vs plain loss and gradients of one uPIT step from the same
    weights (``mode``'s bound, or twice the plain path's movement under
    the PERTURB probe: each group's relative L2, and in float32 each
    tensor's max-abs), and bit-identical repeat gradients of the fused
    path.  Leaves cuDNN deterministic."""
    from misonet_tpu_torch.losses import loss_upit

    bound = TRAIN_BOUND if mode == "float32" else BF16_TRAIN_BOUND
    device = mix.device

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
    loss_q, grads_q = loss_and_grads(plain, mix * (1 + PERTURB * noise))
    identical = all(torch.equal(grads_f[k], again[k]) for k in grads_f)
    # each tensor's error over its max-abs, floored at 1e-3 of the largest
    # (leaves that are zero in exact arithmetic hold rounding noise only)
    floor = 1e-3 * max(g.abs().max().item() for g in grads_p.values())

    def err(a, k):
        return ((a[k] - grads_p[k]).abs().max().item()
                / max(grads_p[k].abs().max().item(), floor))

    groups = {}
    sq = {}   # squared norms per group: fused - plain, probe - plain, plain
    for k in grads_p:
        grp = "body" if body.match(k) else "plain_modules"
        e = groups.setdefault(grp, {"tensors": 0, "within_bound": 0,
                                    "max_err": 0.0, "max_sensitivity": 0.0,
                                    "worst": None})
        ek, sk = err(grads_f, k), err(grads_q, k)
        e["tensors"] += 1
        e["within_bound"] += ek <= bound
        if ek > e["max_err"]:
            e["max_err"], e["worst"] = ek, k
        e["max_sensitivity"] = max(e["max_sensitivity"], sk)
        acc = sq.setdefault(grp, [0.0, 0.0, 0.0])
        for i, d in enumerate((grads_f[k] - grads_p[k], grads_q[k] - grads_p[k],
                               grads_p[k])):
            acc[i] += d.double().square().sum().item()
    for grp, (df, dq, p2) in sq.items():
        # the group's gradients as one vector: relative L2 distances
        groups[grp]["l2_rel_err"] = (df / p2) ** 0.5
        groups[grp]["l2_sensitivity"] = (dq / p2) ** 0.5
    loss_err = abs(loss_f - loss_p) / abs(loss_p)
    loss_sens = abs(loss_q - loss_p) / abs(loss_p)
    del again, grads_f, grads_p, grads_q
    print(json.dumps({"phase": phase, "check": "fused vs plain, step 1",
                      "precision": mode, "shape": shape,
                      "loss_fused": loss_f, "loss_plain": loss_p,
                      "loss_rel_err": loss_err,
                      "loss_sensitivity": loss_sens, "bound": bound,
                      "perturbation": PERTURB, "gradients": groups,
                      "plain_nondeterministic_spread": spread,
                      "repeat_bit_identical": identical}), flush=True)
    if not (np.isfinite(loss_f) and loss_err <= bound):
        fail(f"{phase}: fused vs plain loss error {loss_err}")
    for grp, e in groups.items():
        # a gradient may differ as much as the plain path's own does under
        # a rounding-sized perturbation of its input, within a factor 2: the
        # group as one vector (relative L2) in both modes, and each tensor's
        # max-abs in float32 (at bf16 single elements move by more than
        # their tensor's typical value, so there they are reported only)
        if not e["l2_rel_err"] <= max(bound, 2 * e["l2_sensitivity"]):
            fail(f"{phase}: {grp} gradients differ by {e['l2_rel_err']} "
                 f"(relative L2), the plain path's sensitivity is "
                 f"{e['l2_sensitivity']}")
        if mode == "float32" and not (
                e["max_err"] <= max(bound, 2 * e["max_sensitivity"])):
            fail(f"{phase}: {grp} gradients differ by {e['max_err']} "
                 f"({e['worst']}), the plain path's sensitivity is "
                 f"{e['max_sensitivity']}")
    if not identical:
        fail(f"{phase}: a second backward gave other fused gradients")


def phase_train(cfg, device, records, mode="float32"):
    """The full-width wave train step at ``mode``'s precision (phase 7:
    float32, phase 18: bfloat16, ``ModelConfig()``): fused vs plain loss
    and gradients from the same weights, each group within the mode's
    bound or twice the plain path's movement under the PERTURB probe,
    bit-identical repeat gradients, TRAIN_STEPS fused steps with exact
    launch counts and a falling loss, step times and peak memory of both
    paths, and a profile of one fused step."""
    from misonet_tpu_torch.config import OptimizerConfig, StftConfig
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from misonet_tpu_torch.ops.kernels.tc_pack import pack_tf32
    from misonet_tpu_torch.ops.stft import stft_scaled
    from misonet_tpu_torch.train import (
        create_train_state, make_optimizer, make_separate_wave_train_step)

    phase = "train" if mode == "float32" else "bf16-train"
    bwd = "stencil_bwd" if mode == "float32" else "stencil_bwd_bf16"
    stft_cfg = StftConfig()
    batch = train_batch()
    fused = seeded_model(cfg, device).train()
    plain = seeded_model(dataclasses.replace(cfg, flat_dense=False),
                         device).train()

    mix = stft_scaled(batch[0].transpose(1, 2), stft_cfg)
    ref = stft_scaled(batch[1], stft_cfg)
    check_gradients(phase, mode, fused, plain, mix, ref, [TRAIN_B, 6, T, 129])
    del mix, ref

    # the main path: TRAIN_STEPS fused wave train steps
    opt_cfg = OptimizerConfig(lr=1e-3)
    opt = make_optimizer(opt_cfg, fused.parameters())
    state = create_train_state(fused, opt)
    step = make_separate_wave_train_step(fused, opt, stft_cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    pack_tf32.launches = 0
    step_packs = []  # pack_tf32 launches of each step

    def counted_step(state, *batch):
        before = pack_tf32.launches
        out = step(state, *batch)
        step_packs.append(pack_tf32.launches - before)
        return out

    times, metrics = step_ms(counted_step, state, batch, TRAIN_STEPS)
    counts = launch_counts()
    packs = pack_tf32.launches
    peak_fused = torch.cuda.max_memory_allocated() / 2**30
    want = expect(mode, 50 * TRAIN_STEPS, 10 * TRAIN_STEPS,
                  **{bwd: 60 * TRAIN_STEPS})
    losses = [m["loss"] for m in metrics]
    print(json.dumps({"phase": phase, "path": "fused", "steps": TRAIN_STEPS,
                      "launches": counts, "pack_tf32_launches": packs,
                      "pack_tf32_launches_by_step": step_packs,
                      "losses": losses,
                      "grad_norms": [m["grad_norm"] for m in metrics],
                      "step_ms": times, "peak_gib": peak_fused}), flush=True)
    if counts != want:
        fail(f"{phase} launched {counts}, expected {want}")
    if (packs > 0) != (mode == "float32"):
        fail(f"{phase}: {packs} pack_tf32 launches (float32 packs each new "
             "weight version on the card; bf16 never)")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"{phase}: loss not finite and falling: {losses}")
    # the bf16 forward modes keep the launches of their forward (phase 12)
    for name in ((*MODES[mode], bwd) if mode == "float32" else (bwd,)):
        records[name]["launches"] = counts[name]
    if mode == "float32":
        records["pack_tf32"]["launches"] = packs

    # the plain path's step time and memory
    popt = make_optimizer(opt_cfg, plain.parameters())
    pstate = create_train_state(plain, popt)
    pstep = make_separate_wave_train_step(plain, popt, stft_cfg)
    step_ms(pstep, pstate, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    ptimes, _ = step_ms(pstep, pstate, batch, 3)
    peak_plain = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps({"phase": phase, "path": "plain", "step_ms": ptimes,
                      "peak_gib": peak_plain}), flush=True)

    dense, sten, enc0 = body_macs(fused, TRAIN_B, T)
    bwd_flop = 2 * (2 * (dense + sten) - enc0)  # dgrad + wgrad, no enc0 dx
    peak = PEAK_TF32X3 if mode == "float32" else PEAK_BF16
    fma = ({"stencil_bwd_fma_bound_ms": bwd_flop / PEAK_FLOPS * 1e3}
           if mode == "float32" else {})
    print(json.dumps({"phase": phase, "work": "per step, fused body",
                      "forward_gflop": 2 * (dense + sten) / 1e9,
                      "stencil_bwd_gflop": bwd_flop / 1e9,
                      "stencil_bwd_bound_ms": bwd_flop / peak * 1e3, **fma}),
          flush=True)

    prof = profile_call(lambda: step(state, *batch))
    print(json.dumps({"phase": phase, "profile": "one fused step", **prof}),
          flush=True)
    # the device's own time beside the host-paced wall time of the step
    print(json.dumps({"phase": phase, "check": "fused step device time",
                      "step_ms": times, "wall_ms": prof["wall_ms"],
                      "device_busy_ms": prof["device_busy_ms"],
                      "stencil_bwd_device_ms": prof["ms"]["stencil_bwd"],
                      "dense_stack_device_ms": prof["ms"]["dense_stack"]}),
          flush=True)


def solve_flops(m: int) -> int:
    """Floating-point operations of one M x M system in the solve kernel:
    Cholesky pivots (diag add, j complex squares, max, sqrt, reciprocal),
    its off-diagonal entries (j complex multiply-subtracts and a scaling
    each), then forward and back substitution."""
    pivots = sum(4 + 4 * j for j in range(m))
    lower = sum((m - 1 - j) * (8 * j + 2) for j in range(m))
    subst = 2 * sum(8 * j + 2 for j in range(m))
    return pivots + lower + subst


def pd_systems(rng, n, m=6):
    """n seeded Hermitian positive-definite systems (R = A A^H + 0.1 I) and
    right-hand sides, complex64 on the card."""
    a = rng.standard_normal((n, m, m)) + 1j * rng.standard_normal((n, m, m))
    r = np.einsum("nij,nkj->nik", a, a.conj()) + 0.1 * np.eye(m)
    r = 0.5 * (r + np.conj(r.swapaxes(-1, -2)))
    d = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    return (torch.from_numpy(np.ascontiguousarray(r, np.complex64)).cuda(),
            torch.from_numpy(np.ascontiguousarray(d, np.complex64)).cuda())


def phase_solve(records):
    """hermitian_solve against its plain version run in float64 at the MVDR
    batches of a 12.3 s request (utterance mode 2 x 129, chunk mode
    4 x 2 x 129) and at a throughput size; the library yardstick is
    torch.linalg.solve on (R + 1e-6 I)."""
    from misonet_tpu_torch.ops.kernels.hermitian_solve import (
        hermitian_solve, hermitian_solve_plain)

    rng = np.random.default_rng(SEED + 6)
    m = 6
    eye = 1e-6 * torch.eye(m, dtype=torch.complex64, device="cuda")
    for n in SOLVE_BATCHES:
        r, d = pd_systems(rng, n, m)
        check_kernel(f"hermitian_solve n={n}", hermitian_solve,
                     hermitian_solve_plain, (r, d), records["hermitian_solve"],
                     n * solve_flops(m),
                     lambda: torch.linalg.solve(r + eye, d[..., None]),
                     in_float64=True, phase="solve-kernel",
                     to_record=n != SOLVE_BATCHES[-1])
        # at serving sizes the CUDA-event time of back-to-back calls is the
        # wrapper's host time; the profiler gives the kernel's own
        prof = profile_call(lambda: [hermitian_solve(r, d) for _ in range(10)])
        dev_ms = prof["ms"]["hermitian_solve"] / 10
        lost = prof["device_events_lost"]
        print(json.dumps({"phase": "solve-kernel", "case": f"n={n}",
                          "kernel_device_ms": dev_ms,
                          "device_events_lost": lost}), flush=True)
        if n != SOLVE_BATCHES[-1]:
            # device time only from windows that kept all their events
            total = records["hermitian_solve"].get("device_ms", 0.0)
            records["hermitian_solve"]["device_ms"] = (
                None if total is None or lost else total + dev_ms)


def weights_flops(m: int, iters: int = 100) -> int:
    """Floating-point operations of one bin in mvdr_weights_kernel: the
    start R 1 with its norm and scaling, each trip (the M x M complex
    matvec at 8 a complex multiply-add, |w|^2, square root, reciprocal,
    scaling), the normalization (M complex divisions at 11 each, the norm,
    the square roots, scaling), the phasor (M complex multiply-adds, |s|,
    reciprocal, scaling, one complex product of the scan), the correction
    (M complex products), the solve (solve_flops), d^H x and the final
    divisions."""
    start = 2 * m * (m - 1) + 4 * m + 2 + 2 * m
    trip = 8 * m * m + 4 * m + 2 + 2 * m
    normalize = 11 * m + 4 * m + 3 + 2 * m
    phasor = 8 * m + 3 + 2 + 6
    return (start + iters * trip + normalize + phasor + 6 * m
            + solve_flops(m) + 8 * m + 11 * m)


def weights_latency_ms(m: int, clock_mhz: float, iters: int = 100) -> float:
    """An estimate of the dependent-latency floor of one bin's power
    iteration, which no number of SMs shortens: per trip one matvec output
    (a complex product and M - 1 dependent adds, M + 1 steps), |w|^2 summed
    over the M outputs (2M dependent FMAs), at 4 cycles a step, plus ~40
    cycles for the IEEE square root and ~30 for the reciprocal, and 2 steps
    of scaling and select; at the card's maximum SM clock."""
    cycles = 4 * ((m + 1) + 2 * m + 2) + 40 + 30
    return iters * cycles / (clock_mhz * 1e3)


def queued_ms(fn, reps: int = 20, spin_cycles: int = 2_000_000) -> float:
    """Median device time of one call of ``fn`` from CUDA events recorded
    behind a spinning kernel, so that the events, the call's launches and
    nothing else sit queued back to back when the device reaches them:
    the host's launch time is left out (``spin_cycles`` must outlast it)."""
    start = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    stop = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    fn()
    for a, b in zip(start, stop):
        torch.cuda._sleep(spin_cycles)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(start, stop)]))


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time of one call of ``fn`` through its synchronize."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def sim_scms(rng, rows, f, m, frames=16):
    """Hermitized source and noise SCMs [rows, F, M, M] on the card of the
    simulation of tests/test_mvdr.py: one far-field source with random
    steering (near-rank-1 source SCMs) + diffuse noise at 0.1."""
    from misonet_tpu_torch.beamforming.mvdr import spatial_covariance

    def c(shape, scale=1.0):
        return torch.complex(rand(rng, shape, scale=scale),
                             rand(rng, shape, scale=scale))

    steer = c((rows, f, m))
    steer = steer / (steer[..., :1].abs()
                     * torch.sign(steer[..., :1].real + 1e-9))
    source = torch.einsum("nfc,ntf->nctf", steer, c((rows, frames, f)))
    return (spatial_covariance(source),
            spatial_covariance(c((rows, m, frames, f), 0.1)))


def pd_scms(rng, rows, f, m):
    """Unstructured Hermitian PD source and noise SCMs [rows, F, M, M]
    (pd_systems' matrices), whose spectral gaps are often small."""
    return tuple(pd_systems(rng, rows * f, m)[0].reshape(rows, f, m, m)
                 for _ in range(2))


def replaced_weights(rs, rn, ref_ch=0):
    """The MVDR weights as the port computed them before mvdr_weights: the
    eager power iteration, normalization, phase correction and one
    hermitian_solve launch (beamforming/mvdr.py's four functions)."""
    from misonet_tpu_torch.beamforming import mvdr

    with torch.profiler.record_function("mvdr.weights"):
        d = mvdr.principal_eigenvector(rs)
        d = mvdr.normalize_steering(d, ref_ch)
        d = mvdr.phase_correct(d)
        return mvdr.mvdr_weights(d, rn)


def lapack_weights(rs, rn, ref_ch=0, diag=1e-6):
    """The reference's route (tester.py: eigh, gesv) for the same function:
    the top eigenvector from torch.linalg.eigh, the port's normalization
    and phase correction, torch.linalg.solve.  Timed as a reference only:
    no single PyTorch call computes the weights."""
    from misonet_tpu_torch.beamforming import mvdr

    d = torch.linalg.eigh(rs)[1][..., -1]
    d = mvdr.phase_correct(mvdr.normalize_steering(d, ref_ch))
    eye = diag * torch.eye(rs.shape[-1], dtype=rs.dtype, device=rs.device)
    x = torch.linalg.solve(rn + eye, d[..., None])[..., 0]
    return x / (d.conj() * x).sum(-1, keepdim=True)


def phase_weights(records, device_line):
    """mvdr_weights against mvdr_weights_plain run in complex128 at
    WEIGHT_SHAPES, on near-rank-1 (sim) and unstructured (pd) SCMs; times
    of the kernel, of the path it replaced and of the LAPACK route.  The
    record takes the main path's shapes (WEIGHT_MAIN) and sim SCMs."""
    from misonet_tpu_torch.ops.kernels.mvdr_weights import (
        mvdr_weights, mvdr_weights_plain)

    rec = records["mvdr_weights"]
    rec["library_ms"] = None   # no single PyTorch call computes it
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    # the events' own floor: a one-element add queued the same way
    one = torch.zeros(1, device="cuda")
    floor_q = queued_ms(lambda: one.add_(1))
    rng = np.random.default_rng(SEED + 11)
    for rows, f, m in WEIGHT_SHAPES:
        for seeding in ("sim", "pd"):
            rs, rn = (sim_scms if seeding == "sim" else pd_scms)(
                rng, rows, f, m)
            want = widened(mvdr_weights_plain)(rs, rn)
            plain32 = mvdr_weights_plain(rs, rn)
            own = norm_err(plain32.to(want.dtype), want)[1]
            bound = SIM_BOUND if seeding == "sim" else max(PD_BOUND, 2 * own)
            lam = torch.linalg.eigvalsh(widen(rs).cpu())
            gap = ((lam[..., -1] - lam[..., -2])
                   / lam[..., -1].clamp(min=1e-300)).min().item()
            case = f"mvdr_weights [{rows}, {f}, {m}] {seeding}"
            got = mvdr_weights(rs, rn)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{case}: bad output {tuple(got.shape)}")
            err = norm_err(got.to(want.dtype), want)
            print(json.dumps({
                "phase": "weights-kernel", "case": case,
                "max_norm_err": err[1], "max_abs_err": err[0],
                "bound": bound, "plain_f32_max_norm_err": own,
                "worst_spectral_gap": gap}), flush=True)
            if err[1] > bound:
                fail(f"{case}: normalized error {err[1]} above {bound}")
            if seeding == "pd":
                continue
            main = (rows, f, m) in WEIGHT_MAIN
            # queued CUDA events with 100 trips and with none (what the
            # trips cost); the kernel's own duration from the profiler
            # (the events add the launch's own device time)
            times = queued_ms(lambda: mvdr_weights(rs, rn))
            no_trips = queued_ms(
                lambda: mvdr_weights(rs, rn, power_iters=0))
            prof = profile_call(
                lambda: [mvdr_weights(rs, rn) for _ in range(10)])
            kernel_ms = prof["ms"]["mvdr_weights"] / 10
            if prof["device_events_lost"] or not kernel_ms:
                kernel_ms = times   # the events' upper bound
            kernel_wall = wall_ms(lambda: mvdr_weights(rs, rn), reps=20)
            plain_ms = cuda_ms(lambda: mvdr_weights_plain(rs, rn), reps=3)
            bound_t, t_ops, t_bytes = bound_ms(
                rows * f * weights_flops(m), (rs, rn), want.to(rs.dtype))
            floor = weights_latency_ms(m, clock)
            old = {"wall_ms": wall_ms(lambda: replaced_weights(rs, rn),
                                      reps=3),
                   "device_ms": profile_call(
                       lambda: replaced_weights(rs, rn))["device_busy_ms"]}
            lapack = lapack_weights(rs, rn)
            ref = {"ms": cuda_ms(lambda: lapack_weights(rs, rn), reps=3),
                   "max_norm_err": norm_err(lapack.to(want.dtype), want)[1]}
            print(json.dumps({
                "phase": "weights-kernel", "case": case,
                "kernel_device_ms": kernel_ms,
                "device_events_lost": prof["device_events_lost"],
                "queued_ms": times,
                "queued_ms_0_trips": no_trips, "queued_floor_ms": floor_q,
                "kernel_wall_ms": kernel_wall, "plain_ms": plain_ms,
                "bound_ms": bound_t,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "latency_floor_ms": floor, "sm_clock_max_mhz": clock,
                "gflop": rows * f * weights_flops(m) / 1e9,
                "replaced_path": old, "eigh_solve": ref,
                "device": device_line}), flush=True)
            if main:
                rec["max_abs_err"] = max(rec["max_abs_err"], err[0])
                rec["max_norm_err"] = max(rec["max_norm_err"], err[1])
                rec["ms"] += kernel_ms
                rec["queued_ms"] = rec.get("queued_ms", 0.0) + times
                rec["plain_ms"] += plain_ms
                rec["bound_ms"] += bound_t
                rec["ops_ms"] += t_ops
                rec["bytes_ms"] += t_bytes


@contextlib.contextmanager
def plain_path(models):
    """``models`` on their plain modules and the MVDR on its plain weights
    (and plain solve), for a reference run on the card."""
    from misonet_tpu_torch.beamforming import mvdr
    from misonet_tpu_torch.ops.kernels.hermitian_solve import (
        hermitian_solve_plain)
    from misonet_tpu_torch.ops.kernels.mvdr_weights import mvdr_weights_plain

    cfgs = [m.cfg for m in models]
    solve, weights = mvdr.hermitian_solve, mvdr.fused_weights
    for m in models:
        m.cfg = dataclasses.replace(m.cfg, flat_dense=False)
    mvdr.hermitian_solve = hermitian_solve_plain
    mvdr.fused_weights = mvdr_weights_plain
    try:
        yield
    finally:
        mvdr.hermitian_solve, mvdr.fused_weights = solve, weights
        for m, c in zip(models, cfgs):
            m.cfg = c


def check_result(name, res, refs, stages):
    """Fail unless every stage's wave is finite, of the references' shape,
    and scored."""
    for stage, key in stages:
        est = getattr(res, stage)
        if (est is None or est.shape != refs.shape
                or not np.isfinite(est).all()
                or not np.isfinite(res.si_sdr.get(key, np.nan))):
            fail(f"{name}: {stage} is {None if est is None else est.shape}, "
                 f"score {res.si_sdr.get(key)}")


def phase_cascade(cfg, device, device_line, records, mode="float32"):
    """The cascade at full width: MISO1 + MISO3 in both beamforming modes
    over the phase-5 requests, MISO1 + MISO2 (joint) in chunk mode, exact
    launch counts per request; in float32 also the plain path on the 5 s
    request and a profile of one 12.3 s utterance-mode request."""
    from misonet_tpu_torch.beamforming.mvdr import (
        principal_eigenvector, steering_weights)
    from misonet_tpu_torch.config import DatasetConfig, StftConfig
    from misonet_tpu_torch.inference.evaluate import CascadeEvaluator
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    ds, stft_cfg = DatasetConfig(), StftConfig()
    miso1 = seeded_model(cfg, device)
    miso3 = seeded_model(cfg, device, "miso3", SEED + 7)
    miso2 = seeded_model(cfg, device, "miso2", SEED + 8)
    rng = np.random.default_rng(SEED + 2)
    requests = [synth_request(rng, s) for s in REQUEST_S]
    stages = [("separated", "miso1"), ("beamformed", "beamform"),
              ("enhanced", "enhanced")]
    want = expect(mode, 100, 20, mvdr_weights=1)
    runs = [("utterance", "miso3", miso3, False, requests),
            ("chunk", "miso3", miso3, False, requests),
            ("chunk", "miso2", miso2, True, requests[-1:])]
    evaluators = {}
    weights = 0
    for bf_mode, enh_name, enh, joint, reqs in runs:
        ev = CascadeEvaluator(miso1, stft_cfg, ds, enhance_model=enh,
                              joint=joint,
                              beamform_utterance=bf_mode == "utterance")
        evaluators[bf_mode, enh_name] = ev
        ev.process(*requests[0])   # warm-up: cuFFT plans, allocator
        torch.cuda.synchronize()
        for mix, refs in reqs:
            secs = mix.shape[0] / ds.fs
            reset_launch_counts()
            t0 = time.perf_counter()
            res = ev.process(mix, refs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launch_counts()
            weights += counts["mvdr_weights"]
            print(json.dumps({"phase": "cascade", "precision": mode,
                              "mode": bf_mode,
                              "enhance": enh_name, "audio_s": secs,
                              "chunks": -(-mix.shape[0] // ds.chunk_samples),
                              "latency_s": dt, "audio_s_per_s": secs / dt,
                              "pit_si_sdr_db": res.si_sdr,
                              "launches": counts, "device": device_line}),
                  flush=True)
            check_result(f"cascade {mode} {bf_mode} {enh_name} {secs} s",
                         res, refs, stages)
            if counts != want:
                fail(f"cascade {mode} {bf_mode} {enh_name}: launched "
                     f"{counts}, expected {want}")
    if mode != "float32":
        return
    records["mvdr_weights"]["launches"] = weights

    # the 5 s request on the plain path: plain modules, plain MVDR weights
    mix, refs = requests[0]
    for bf_mode in ("utterance", "chunk"):
        ev = evaluators[bf_mode, "miso3"]
        fused = ev.process(mix, refs)
        with plain_path([miso1, miso3]):
            reset_launch_counts()
            plain = ev.process(mix, refs)
            plain_counts = launch_counts()
            # the plain path's own sensitivity: the same run from the
            # mixture perturbed by PERTURB relative noise
            noise = np.random.default_rng(SEED + 9).standard_normal(
                mix.shape).astype(np.float32)
            shifted = ev.process(mix * (1 + PERTURB * noise), refs)
        errs, sens = {}, {}
        for stage in ("separated", "beamformed", "enhanced"):
            ref = torch.from_numpy(getattr(plain, stage))
            errs[stage] = norm_err(torch.from_numpy(getattr(fused, stage)),
                                   ref)[1]
            sens[stage] = norm_err(torch.from_numpy(getattr(shifted, stage)),
                                   ref)[1]
        print(json.dumps({"phase": "cascade", "check": f"fused vs plain, "
                          f"5 s, {bf_mode} mode", "max_norm_err": errs,
                          "bound": CASCADE_BOUND,
                          "plain_sensitivity": sens,
                          "perturbation": PERTURB,
                          "plain_launches": plain_counts,
                          "si_sdr_fused": fused.si_sdr,
                          "si_sdr_plain": plain.si_sdr}), flush=True)
        if any(plain_counts.values()):
            fail(f"cascade: the plain path launched {plain_counts}")
        if not max(errs.values()) <= CASCADE_BOUND:
            fail(f"cascade {bf_mode}: fused vs plain {errs} above "
                 f"{CASCADE_BOUND}")

    # where one 12.3 s utterance-mode request's time goes
    ev = evaluators["utterance", "miso3"]
    prof = profile_call(lambda: ev.process(*requests[-1]))
    print(json.dumps({"phase": "cascade", "profile": "one 12.3 s "
                      "utterance-mode request", **prof}), flush=True)
    # the power iteration alone at that request's SCM batch (2 speakers x
    # 129 bins): host time and device time of the 100-step loop
    r, _ = pd_systems(np.random.default_rng(SEED + 10), 2 * 129)
    r = r.reshape(2, 129, 6, 6)
    principal_eigenvector(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    principal_eigenvector(r)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"phase": "cascade", "power_iteration": "100 steps, "
                      "[2, 129, 6, 6]", "wall_ms": wall,
                      "device_ms": cuda_ms(lambda: principal_eigenvector(r),
                                           reps=5)}), flush=True)
    # the MVDR call's weights at that batch, before (the eager loop and a
    # hermitian_solve launch) and after (one mvdr_weights launch): host and
    # device ms of the "mvdr.weights" range
    rn, _ = pd_systems(np.random.default_rng(SEED + 12), 2 * 129)
    rn = rn.reshape(2, 129, 6, 6)
    for path, fn in (("before", lambda: replaced_weights(r, rn)),
                     ("after", lambda: steering_weights(r, rn))):
        prof = profile_call(fn)
        print(json.dumps({"phase": "cascade", "mvdr_weights_call": path,
                          "shape": [2, 129, 6, 6],
                          **prof["ranges"].get("mvdr.weights", {}),
                          "kernels": prof["kernels"],
                          "device_busy_ms": prof["device_busy_ms"],
                          "wall_ms": prof["wall_ms"],
                          "device_events_lost": prof["device_events_lost"],
                          "device": device_line}), flush=True)


def phase_css(cfg, device, device_line, mode="float32"):
    """StreamingCSS over the 12.3 s request, edge to edge and cross-faded:
    exactly 50 dense_stack, 10 stencil (of ``mode``) and 1 mvdr_weights
    launches per block."""
    from misonet_tpu_torch.config import DatasetConfig, StftConfig
    from misonet_tpu_torch.inference.css import StreamingCSS
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    ds = DatasetConfig()
    css = StreamingCSS(seeded_model(cfg, device), StftConfig(), ds)
    rng = np.random.default_rng(SEED + 2)
    mix, _ = [synth_request(rng, s) for s in REQUEST_S][-1]
    css.process(mix[: ds.chunk_samples])   # warm-up
    for overlap in (0, 8000):
        hop = ds.chunk_samples - overlap
        blocks = (-(-mix.shape[0] // ds.chunk_samples) if overlap == 0 else
                  max(1, -(-max(mix.shape[0] - overlap, 1) // hop)))
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = css.process(mix, overlap=overlap)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        want = expect(mode, 50 * blocks, 10 * blocks, mvdr_weights=blocks)
        print(json.dumps({"phase": "css", "precision": mode,
                          "overlap": overlap,
                          "blocks": blocks, "audio_s": mix.shape[0] / ds.fs,
                          "latency_s": dt, "block_latency_s": dt / blocks,
                          "launches": counts, "device": device_line}),
              flush=True)
        for k, v in out.items():
            if v.shape != (2, mix.shape[0]) or not np.isfinite(v).all():
                fail(f"css overlap {overlap}: {k} {v.shape} not finite/"
                     "expected")
        if counts != want:
            fail(f"css {mode} overlap {overlap}: launched {counts}, "
                 f"expected {want}")


CLI_UTTS, CLI_SECONDS = 8, 6.0  # phase 19's synthetic corpus


def phase_cli(device_line):
    """The port's command line end to end on the card (``cli.main`` in
    this process; the extraction as ``python -m misonet_tpu_torch``): a
    synthetic corpus made with
    the port's synth_mixture (CLI_UTTS 6-mic utterances of CLI_SECONDS s,
    2 speakers), configs/smswsj.yml's full-width plan at bf16 with
    batch 4 and one epoch, then Extraction -> Train MISO1 -> a resume for
    a second epoch -> Train MISO3 -> Test MISO3 (2 utterances) -> Test CSS
    (1 utterance).  Checks finite losses, the checkpoints, the written
    wavs, stencil_bwd_bf16 launches in both trainings and mvdr_weights
    launches in MISO3's feature step; times each command."""
    import tempfile
    from pathlib import Path

    import yaml

    from misonet_tpu_torch import cli
    from misonet_tpu_torch.data.synthetic import synth_mixture
    from misonet_tpu_torch.data.wavio import write_wav
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    with tempfile.TemporaryDirectory(prefix="misonet_cli_") as tmp:
        root = Path(tmp)
        for sub in ("observation", "speech_source"):
            (root / "corpus" / sub).mkdir(parents=True)
        for u in range(CLI_UTTS):
            d = synth_mixture(SEED + u, int(CLI_SECONDS * 8000), 6,
                              voiced=True)
            write_wav(root / "corpus" / "observation" / f"utt{u}.wav",
                      d["mix"], 8000)
            for s in range(2):
                write_wav(root / "corpus" / "speech_source" / f"utt{u}_{s}.wav",
                          d["ref"][s], 8000)
        raw = yaml.safe_load(Path("configs/smswsj.yml").read_text())
        raw["SMS_WSJ"].update(rootdir=f"{root}/corpus/",
                              saved_tr_pickle_dir=f"{root}/shards/",
                              saved_dt_pickle_dir=f"{root}/shards/")
        raw["dataloader"]["Train"]["batch_size"] = 4
        raw["trainer_sp"].update(epochs=1, print_freq=1, check_point=[True, 1],
                                 save_folder=f"{root}/miso1")
        raw["trainer_en"].update(epochs=1, print_freq=1, check_point=[True, 1],
                                 save_folder=f"{root}/miso3",
                                 MISO1_path=f"{root}/miso1/best")
        yml = root / "run.yml"

        def run(name, *argv, own_process=False, **updates):
            for section, values in updates.items():
                raw[section].update(values)
            yml.write_text(yaml.safe_dump(raw))
            argv = ["-c", str(yml), *argv, "-n", str(root / name)]
            reset_launch_counts()
            t0 = time.perf_counter()
            if own_process:
                # as a user runs it: the extraction's spawned workers then
                # import the CLI, not this script (which imports torch)
                subprocess.run([sys.executable, "-m", "misonet_tpu_torch",
                                *argv], check=True, timeout=600,
                               cwd=Path(__file__).resolve().parent)
            else:
                cli.main(argv)
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: v for k, v in launch_counts().items() if v}
            print(json.dumps({"phase": "cli", "command": name,
                              "argv": argv[2:-2], "seconds": dt,
                              "launches": counts, "device": device_line}),
                  flush=True)
            return counts

        def history(folder, tag):
            meta = json.loads((root / folder / f"{tag}.meta.json").read_text())
            return meta["history"]

        run("extraction", "-m", "Extraction", own_process=True)
        shards = len(list((root / "shards").glob("*.npz")))
        counts = run("train_miso1", "-m", "Train", "-t", "MISO1")
        hist1 = history("miso1", "epoch000")
        if not counts.get("stencil_bwd_bf16"):
            fail(f"cli: MISO1 training launched {counts}")
        resume = run("resume_miso1", "-m", "Train", "-t", "MISO1",
                     trainer_sp={"epochs": 2, "model_load": [True, "epoch000"]})
        hist2 = history("miso1", "epoch001")
        counts3 = run("train_miso3", "-m", "Train", "-t", "MISO3")
        hist3 = history("miso3", "epoch000")
        if not (counts3.get("stencil_bwd_bf16")
                and counts3.get("mvdr_weights")):
            fail(f"cli: MISO3 training launched {counts3}")
        run("test_miso3", "-m", "Test", "-t", "MISO3", "--max-utts", "2")
        run("test_css", "-m", "Test", "-t", "CSS", "--max-utts", "1")
        wavs = {name: len(list((root / name / "wav_out").rglob("*.wav")))
                for name in ("test_miso3", "test_css")}
        losses = [*hist1["train"], *hist1["val"], *hist2["train"],
                  *hist2["val"], *hist3["train"], *hist3["val"]]
        print(json.dumps({"phase": "cli", "shards": shards,
                          "miso1_history": hist2, "miso3_history": hist3,
                          "resume_launches": resume, "wavs": wavs}),
              flush=True)
        if shards != CLI_UTTS * 3:
            fail(f"cli: extraction wrote {shards} shards")
        if not (len(hist2["train"]) == 2 and hist2["train"][0]
                == hist1["train"][0] and all(np.isfinite(losses))):
            fail(f"cli: histories {hist1} {hist2} {hist3}")
        # 2 utterances x 2 speakers x (MISO1, Beamforming, Enhanced); CSS:
        # 1 utterance x 2 speakers x (miso1, beamformed)
        if wavs != {"test_miso3": 12, "test_css": 4}:
            fail(f"cli: wrote {wavs} wavs")

# (name, source widths, N): the layers of one encoder block (enc0, F = 127)
# and one decoder block (dec6: its input is the decoder tensor and the skip,
# two sources of 24) of ModelConfig(), each layer over all its raw sources
DENSE_LAYER_F = 127
DENSE_LAYER_CASES = [
    *((f"enc0 layer {s}", (24,) * s, 24) for s in range(1, 6)),
    *((f"dec6 layer {s}", (24,) * (s + 1), 48 if s == 5 else 24)
      for s in range(1, 6)),
]
# (name, fuse_elu, want_stats) of the two switch cases, on dec6's layer 2
DENSE_LAYER_SWITCHES = [("dec6 layer 2 no ELU", False, True),
                        ("dec6 layer 2 no statistics", True, False)]


def phase_dense_layer(records):
    """Kernel 2.6 at ModelConfig()'s DenseBlock shapes, B = 6, T = 501, in
    float32 and bf16.  No serving or training path calls it, so its main
    path is its entry point: every case once with the counts reset, then
    each case against dense_layer_plain (BOUND; bf16 outputs BF16_BOUND)
    with the times of kernel, plain version and cuDNN's conv of the
    normalized concat (library_ms) and the bound from MACs = B T F N 9 C."""
    import torch.nn.functional as F

    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from misonet_tpu_torch.ops.kernels.dense_layer import (
        dense_layer, dense_layer_plain)

    check_tensor_cores(records["dense_layer"])
    check_tensor_cores(records["dense_layer_bf16"])
    rng = np.random.default_rng(SEED + 20)
    f = DENSE_LAYER_F
    cases = []
    for dtype, peak in ((torch.float32, PEAK_TF32X3),
                        (torch.bfloat16, PEAK_BF16)):
        for name, widths, n, *switch in [
                *((nm, w, n, True, True) for nm, w, n in DENSE_LAYER_CASES),
                *((nm, (24,) * 3, 24, elu, st)
                  for nm, elu, st in DENSE_LAYER_SWITCHES)]:
            c = sum(widths)
            args = ([rand(rng, (B, w, T, f)).to(dtype) for w in widths],
                    rand(rng, (n, c, 3, 3), scale=1.0 / np.sqrt(9 * c)).to(
                        dtype),
                    rand(rng, (n,), scale=0.1),
                    rand(rng, (B, c), 0.5, 1.5),
                    rand(rng, (B, c), -0.5, 0.5))
            cases.append((name, dtype, peak, args, n, c, switch))

    reset_launch_counts()
    for _, _, _, args, _, _, (elu, stats) in cases:
        dense_layer(*args, fuse_elu=elu, want_stats=stats)
    torch.cuda.synchronize()
    counts = launch_counts()
    per_mode = len(cases) // 2
    want = expect(dense_layer=per_mode, dense_layer_bf16=per_mode)
    print(json.dumps({"phase": "dense-layer", "launches": counts}),
          flush=True)
    if counts != want:
        fail(f"dense-layer launched {counts}, expected {want}")
    for name in ("dense_layer", "dense_layer_bf16"):
        records[name]["launches"] = counts[name]

    for name, dtype, peak, args, n, c, (elu, stats) in cases:
        xn = normalized(args[0], args[3], args[4]).to(dtype)
        bf16 = dtype == torch.bfloat16
        check_kernel(
            f"dense_layer {'bf16 ' if bf16 else ''}{name}",
            lambda *a: dense_layer(*a, fuse_elu=elu, want_stats=stats),
            lambda *a: dense_layer_plain(*a, fuse_elu=elu, want_stats=stats),
            args, records["dense_layer_bf16" if bf16 else "dense_layer"],
            2 * B * T * f * n * 9 * c,
            lambda: F.conv2d(xn, args[1], args[2].to(dtype), padding=1),
            phase="dense-layer", peak=peak,
            f64=None if bf16 else (lambda *a: dense_layer_f64(
                *a, fuse_elu=elu, want_stats=stats)))
        del xn
        if not bf16:
            check_pack(f"dense_layer {name}", args[1],
                       [int(x.shape[1]) for x in args[0]], False, records)


REVERB_CONFIG = "configs/reverb_2mix.yml"
# the fused body of the 8-level plan: enc0-4 and their mirrors dec3-7
REVERB_BODY = re.compile(
    r"^(enc[0-4]|enc[0-4]_dense|dec[3-7]|dec[3-7]_dense)\.")


def reverb_batch(n, fs, mics, seconds=4.0):
    """``n`` seeded synthetic ``mics``-mic mixtures at ``fs`` and their 2
    references on the card."""
    rng = np.random.default_rng(SEED + 21)
    reqs = [synth_request(rng, seconds, fs, mics) for _ in range(n)]
    return (torch.from_numpy(np.stack([m for m, _ in reqs])).cuda(),
            torch.from_numpy(np.stack([r for _, r in reqs])).cuda())


def phase_reverb(device):
    """The REVERB 2-mix plan (configs/reverb_2mix.yml: 8 levels, F = 257,
    8 mics, 384-channel TCN, bf16) at full width on the card.  Forward at
    the decode batch of one 4 s chunk (8 circular shifts): fused vs plain
    within phase 12's bound, exactly 50 dense_stack_bf16 and 10
    stencil_bf16 launches.  One bf16 train step at the YAML's batch of 16
    (or the largest power of two whose plain step fits the card): fused vs
    plain gradients with phase 18's gate, exactly 60 stencil_bwd_bf16
    launches with the forward's 50 and 10, step times and peak memory."""
    from misonet_tpu_torch.config import load_yaml
    from misonet_tpu_torch.losses import loss_upit
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from misonet_tpu_torch.ops.stft import stft_scaled
    from misonet_tpu_torch.train import (
        create_train_state, make_optimizer, make_separate_wave_train_step)

    cfg = load_yaml(REVERB_CONFIG)
    mcfg, stft_cfg, mics = cfg.miso1, cfg.stft, cfg.dataset.num_ch
    if (mcfg.num_bottleneck, stft_cfg.num_bins, mics) != (8, 257, 8):
        fail(f"reverb: unexpected plan {mcfg}")
    plain_cfg = dataclasses.replace(mcfg, flat_dense=False)
    model = seeded_model(mcfg, device, num_mics=mics)
    wave, _ = reverb_batch(1, stft_cfg.fs, mics)
    chunk = stft_scaled(wave.transpose(1, 2), stft_cfg)     # [1, 8, T, 257]
    x = torch.cat([torch.roll(chunk, -m, dims=1) for m in range(mics)])
    with torch.inference_mode():
        reset_launch_counts()
        fused = model(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        t_fused = cuda_ms(lambda: model(x), reps=3)
        busy = {"fused": profile_call(lambda: model(x))["device_busy_ms"]}
        model.cfg = plain_cfg
        plain = model(x)
        t_plain = cuda_ms(lambda: model(x), reps=3)
        busy["plain"] = profile_call(lambda: model(x))["device_busy_ms"]
        sens = norm_err(torch.view_as_real(model(moved(x))),
                        torch.view_as_real(plain))[1]
        model.cfg = mcfg
    err, rel = norm_err(torch.view_as_real(fused), torch.view_as_real(plain))
    bound = max(BF16_FORWARD_BOUND, 2 * sens)
    print(json.dumps({"phase": "reverb", "check": "forward",
                      "shape": list(x.shape), "precision": mcfg.compute_dtype,
                      "params": sum(p.numel() for p in model.parameters()),
                      "launches_per_forward": counts, "max_abs_err": err,
                      "max_norm_err": rel, "bound": bound,
                      "plain_sensitivity": sens, **agreement(fused, plain),
                      "fused_ms": t_fused, "plain_ms": t_plain,
                      "device_busy_ms": busy}), flush=True)
    if counts != expect("bfloat16", 50, 10):
        fail(f"reverb forward launched {counts}")
    if (fused.shape != (mics, 2, x.shape[2], 257)
            or not torch.isfinite(torch.view_as_real(fused)).all()):
        fail(f"reverb forward output {tuple(fused.shape)} not finite/expected")
    if not rel <= bound:
        fail(f"reverb forward: fused vs plain {rel} above {bound}")
    del model, fused, plain

    # one train step: the YAML's batch if the plain path's step fits
    fused = seeded_model(mcfg, device, num_mics=mics).train()
    plain = seeded_model(plain_cfg, device, num_mics=mics).train()
    batch_size = cfg.trainer_sp.batch_size
    while True:
        batch = reverb_batch(batch_size, stft_cfg.fs, mics)
        mix = stft_scaled(batch[0].transpose(1, 2), stft_cfg)
        ref = stft_scaled(batch[1], stft_cfg)
        try:
            plain.zero_grad(set_to_none=True)
            loss_upit(plain(mix), ref).backward()
            break
        except torch.cuda.OutOfMemoryError:
            plain.zero_grad(set_to_none=True)
            del batch, mix, ref
            torch.cuda.empty_cache()
            batch_size //= 2
            if batch_size < 1:
                fail("reverb: no batch of the plain step fits the card")
    print(json.dumps({"phase": "reverb", "train_batch": batch_size,
                      "yaml_batch": cfg.trainer_sp.batch_size}), flush=True)
    check_gradients("reverb", "bfloat16", fused, plain, mix, ref,
                    list(mix.shape), REVERB_BODY)
    del mix, ref
    peaks, times, launches, step_busy = {}, {}, None, {}
    for name, model in (("fused", fused), ("plain", plain)):
        opt = make_optimizer(cfg.optimizer, model.parameters())
        step = make_separate_wave_train_step(
            model, opt, stft_cfg, ref_ch=cfg.dataset.ref_ch)
        state = create_train_state(model, opt)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times[name], metrics = step_ms(step, state, batch, 2)
        counts = launch_counts()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        prof = profile_call(lambda: step(state, *batch))
        step_busy[name] = {k: prof[k] for k in ("wall_ms", "device_busy_ms")}
        step_busy[name]["stencil_bwd_device_ms"] = prof["ms"]["stencil_bwd"]
        step_busy[name]["dense_stack_device_ms"] = prof["ms"]["dense_stack"]
        if name == "fused":
            launches = counts
            want = expect("bfloat16", 100, 20, stencil_bwd_bf16=120)
            if counts != want or not all(np.isfinite(m["loss"])
                                         for m in metrics):
                fail(f"reverb: two train steps launched {counts} (expected "
                     f"{want}), losses {metrics}")
    print(json.dumps({"phase": "reverb", "check": "train step",
                      "batch": batch_size, "launches_two_steps": launches,
                      "step_ms": times, "peak_gib": peaks,
                      "profile_one_step": step_busy}), flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_parallel(device):
    """parallel/ over NCCL at world size 1 (one card shows the mechanism,
    not scaling): the data-parallel bf16 MISO1 wave train step at [8, 6,
    501, 129] against the same step without a mesh (gradients and updated
    parameters bit-identical, 50 / 10 / 60 launches each), its step time
    beside the plain one; chunked_scm over the group against the
    unsharded SCM; the full-width float32 MISO1 with the sequence-parallel
    TCN against the local model (BOUND); dryrun_multichip(1)."""
    import torch.distributed as dist

    from misonet_tpu_torch.beamforming.scm import chunked_scm
    from misonet_tpu_torch.config import ModelConfig, OptimizerConfig, StftConfig
    from misonet_tpu_torch.dryrun import dryrun_multichip
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from misonet_tpu_torch.parallel import (
        distributed, make_mesh, replicate, shard_batch)
    from misonet_tpu_torch.train import (
        create_train_state, make_optimizer, make_separate_wave_train_step)

    distributed.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                           device="cuda", force=True)
    try:
        mesh = make_mesh()
        print(json.dumps({"phase": "parallel", "backend":
                          dist.get_backend(), "world_size": mesh.size,
                          "note": "one card runs the collectives (NCCL) at "
                          "world size 1: it shows the mechanism, not "
                          "scaling"}), flush=True)
        cfg, stft_cfg = ModelConfig(), StftConfig()
        batch = train_batch()
        steps, states, models = {}, {}, {}
        for name, m in (("single", None), ("dp", mesh)):
            model = seeded_model(cfg, device).train()
            if m is not None:
                replicate(model, m)
            opt = make_optimizer(OptimizerConfig(lr=1e-3), model.parameters())
            states[name] = create_train_state(model, opt)
            steps[name] = make_separate_wave_train_step(model, opt, stft_cfg,
                                                        mesh=m)
            models[name] = model
        reset_launch_counts()
        _, m_single = step_ms(steps["single"], states["single"], batch, 1)
        counts_single = launch_counts()
        reset_launch_counts()
        _, m_dp = step_ms(steps["dp"], states["dp"], shard_batch(batch, mesh),
                          1)
        counts_dp = launch_counts()
        want = expect("bfloat16", 50, 10, stencil_bwd_bf16=60)
        pairs = list(zip(models["single"].named_parameters(),
                         models["dp"].parameters()))
        same_grads = all(torch.equal(p.grad, q.grad) for (_, p), q in pairs)
        same_params = all(torch.equal(p, q) for (_, p), q in pairs)
        t_single, _ = step_ms(steps["single"], states["single"], batch, 3)
        t_dp, _ = step_ms(steps["dp"], states["dp"],
                          shard_batch(batch, mesh), 3)
        print(json.dumps({"phase": "parallel", "check": "dp train step",
                          "shape": [TRAIN_B, 6, T, 129], "precision":
                          cfg.compute_dtype, "launches": counts_dp,
                          "grads_bit_identical": same_grads,
                          "params_bit_identical": same_params,
                          "loss": [m_single[0]["loss"], m_dp[0]["loss"]],
                          "step_ms_dp": t_dp, "step_ms_single": t_single}),
              flush=True)
        if counts_dp != want or counts_single != want:
            fail(f"parallel: the steps launched {counts_dp} / "
                 f"{counts_single}, expected {want}")
        if not (same_grads and same_params
                and m_single[0]["loss"] == m_dp[0]["loss"]):
            fail("parallel: the data-parallel step differs from the "
                 "step without a mesh")
        del models, states, steps, batch

        rng = np.random.default_rng(SEED + 22)
        blocks = torch.complex(rand(rng, (4, 6, T, 129)),
                               rand(rng, (4, 6, T, 129)))
        full = chunked_scm(blocks)
        sharded = chunked_scm(shard_batch(blocks, mesh), mesh)
        scm_err = norm_err(torch.view_as_real(sharded),
                           torch.view_as_real(full))[1]
        print(json.dumps({"phase": "parallel", "check": "chunked_scm",
                          "max_norm_err": scm_err,
                          "identical": torch.equal(sharded, full)}),
              flush=True)
        if not scm_err <= BOUND:
            fail(f"parallel: collective SCM differs by {scm_err}")

        cfg32 = ModelConfig(compute_dtype="float32")
        local = seeded_model(cfg32, device)
        sp = seeded_model(dataclasses.replace(cfg32, sequence_parallel=True),
                          device, sp_mesh=make_mesh(axis="seq"))
        sp.load_state_dict(local.state_dict())
        x = forward_input()
        with torch.inference_mode():
            want_out = local(x)
            reset_launch_counts()
            got = sp(x)
            torch.cuda.synchronize()
            counts = launch_counts()
        sp_err = norm_err(torch.view_as_real(got),
                          torch.view_as_real(want_out))[1]
        print(json.dumps({"phase": "parallel", "check": "sequence-parallel "
                          "TCN, full-width MISO1", "shape": list(x.shape),
                          "max_norm_err": sp_err, "launches": counts}),
              flush=True)
        if counts != expect("float32", 50, 10) or not sp_err <= BOUND:
            fail(f"parallel: SP MISO1 differs by {sp_err}, launched {counts}")
        del local, sp, x, got, want_out

        loss = dryrun_multichip(1, device=device)
        if not np.isfinite(loss):
            fail(f"parallel: dryrun_multichip(1) loss {loss}")
    finally:
        dist.destroy_process_group()


# phase 23: the example programs' functions on a small voiced corpus
LADDER_UTTS, LADDER_EVAL = 64, 4      # 4 s utterances
LADDER_STEPS, LADDER_BATCH = 300, 8   # MISO1 steps
LADDER_STEPS3 = 50                    # MISO3 steps on MISO1's features
LADDER_CSS_S = 20.0                   # the CSS scene's seconds
# MISO1 after LADDER_STEPS must beat the mixture by this much (dB): half
# the smallest improvement of three runs of the phase on one H100 (2.056
# dB in each, PERF.md §6 "Quality ladder")
LADDER_MARGIN = 1.0


def trained_scms(full, mix):
    """The source and noise SCMs that mvdr_beamform forms from decoded
    images ``full`` [B, S, C, T, F] and ``mix`` [B, C, T, F]."""
    from misonet_tpu_torch.beamforming.mvdr import spatial_covariance

    return (spatial_covariance(full).contiguous(),
            spatial_covariance(mix[:, None] - full).contiguous())


def spectral_gap(rs):
    """The smallest (lambda_1 - lambda_2) / lambda_1 over the SCMs."""
    lam = torch.linalg.eigvalsh(widen(rs).cpu())
    return ((lam[..., -1] - lam[..., -2])
            / lam[..., -1].clamp(min=1e-300)).min().item()


def trained_decodes(model, cfg, stft_cfg, evals, base, device,
                    device_line):
    """The float32, bf16 and int8 decodes of a trained bf16 MISO1 scored
    on ``evals`` (``base``: the mixture's SI-SDR), and phases 12-13's
    fused-vs-plain agreement rerun on its weights with their gates, over
    the first held-out utterance's full-array decode input."""
    from misonet_tpu_torch.examples.common import score_separator
    from misonet_tpu_torch.models import make_miso1
    from misonet_tpu_torch.ops.stft import stft_scaled

    model.eval()
    decodes = {"bfloat16": model}
    for name, c in (("float32", dataclasses.replace(cfg,
                                                    compute_dtype="float32")),
                    ("int8", dataclasses.replace(cfg, quant_int8=True))):
        decodes[name] = make_miso1(c, 6, device=device)
        decodes[name].load_state_dict(model.state_dict())
    scores = {k: score_separator(m, stft_cfg, evals)[1]
              for k, m in decodes.items()}
    print(json.dumps({"phase": "ladder", "stage": "decodes",
                      "mixture_db": base, "si_sdr_db": scores,
                      "int8_cost_db": scores["bfloat16"] - scores["int8"],
                      "device": device_line}), flush=True)
    wave = torch.from_numpy(evals[0]["mix"]).to(device)
    spec = stft_scaled(wave.T, stft_cfg)
    x = torch.stack([torch.roll(spec, -sh, dims=0) for sh in range(6)])
    bf16_out = phase_forward(model, cfg, "bfloat16", x=x,
                             phase="ladder-forward")
    phase_forward_int8(model, cfg, bf16_out, None, x=x,
                       phase="ladder-forward")


def phase_ladder(device, device_line):
    """The example programs' functions at ModelConfig()'s full width (bf16)
    on a voiced corpus of LADDER_UTTS utterances: MISO1 training (exact
    launches a step, MISO1 above the mixture by LADDER_MARGIN); the
    float32, bf16 and int8 decodes of the trained weights scored, and
    phases 12-13's fused-vs-plain agreement rerun on them with their gates;
    MISO3 training on the trained MISO1's features (exact launches a
    step; the beamformed features against mvdr_weights_plain within
    CASCADE_BOUND, the trained SCMs' spectral gap); a LADDER_CSS_S scene
    through StreamingCSS (MISO1 above the mixture, one mvdr_weights a
    block)."""
    from misonet_tpu_torch.beamforming import mvdr
    from misonet_tpu_torch.config import DatasetConfig, ModelConfig, StftConfig
    from misonet_tpu_torch.data.synthetic import synth_mixture
    from misonet_tpu_torch.examples import css_longform, train_cascade
    from misonet_tpu_torch.examples.common import (
        make_corpus, score_separator, train_separator)
    from misonet_tpu_torch.examples.train_synthetic import build_miso1
    from misonet_tpu_torch.inference.cascade import beamform_sources
    from misonet_tpu_torch.inference.css import StreamingCSS
    from misonet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from misonet_tpu_torch.ops.kernels.mvdr_weights import mvdr_weights_plain
    from misonet_tpu_torch.ops.stft import stft_scaled

    stft_cfg, ds, cfg = StftConfig(), DatasetConfig(), ModelConfig()
    corpus = make_corpus(LADDER_UTTS, LADDER_EVAL, ds.chunk_samples, 6,
                         voiced=True, device=device)

    # 1. MISO1 training (train_synthetic's functions)
    model = build_miso1(cfg, 6, device)
    reset_launch_counts()
    _, log = train_separator(model, stft_cfg, corpus, LADDER_STEPS,
                             LADDER_BATCH, every=50)
    counts = launch_counts()
    want = expect("bfloat16", 50 * LADDER_STEPS, 10 * LADDER_STEPS,
                  stencil_bwd_bf16=60 * LADDER_STEPS)
    base, sep = score_separator(model, stft_cfg, corpus.evals)
    print(json.dumps({"phase": "ladder", "stage": "miso1-train",
                      "steps": LADDER_STEPS, "batch": LADDER_BATCH,
                      "utterances": LADDER_UTTS, "loss_points": log.points,
                      "step_ms_events": log.step_ms,
                      "host_seconds": log.seconds, "launches": counts,
                      "mixture_db": base, "miso1_db": sep,
                      "improvement_db": sep - base, "margin": LADDER_MARGIN,
                      "device": device_line}), flush=True)
    if counts != want:
        fail(f"ladder MISO1 training launched {counts}, expected {want}")
    if not sep - base > LADDER_MARGIN:
        fail(f"ladder: MISO1 {sep} dB is not {LADDER_MARGIN} dB above the "
             f"mixture's {base} dB")

    # 2. the decodes of the trained weights, scored and held to plain
    trained_decodes(model, cfg, stft_cfg, corpus.evals, base, device,
                    device_line)

    # 3. MISO3 training on the trained MISO1's features (train_cascade's)
    _, enh = train_cascade.build_models(cfg, device, joint=False)
    stage2 = train_cascade.Stage2(model, stft_cfg, joint=False)
    reset_launch_counts()
    _, log3 = train_cascade.train_enhancer(enh, stage2, corpus, LADDER_STEPS3,
                                           LADDER_BATCH, every=10)
    counts = launch_counts()
    want = expect("bfloat16", 100 * LADDER_STEPS3, 20 * LADDER_STEPS3,
                  stencil_bwd_bf16=60 * LADDER_STEPS3,
                  mvdr_weights=LADDER_STEPS3)
    stages = train_cascade.eval_stages(enh, stage2, corpus.evals)
    mix_b, ref_b = next(corpus.batches(LADDER_BATCH, 1, seed=1))
    with torch.inference_mode():
        mix = stft_scaled(mix_b.transpose(1, 2), stft_cfg)
        full = stage2.decode(mix)
        bf = beamform_sources(full, mix)
        fused_weights, mvdr.fused_weights = (mvdr.fused_weights,
                                             mvdr_weights_plain)
        try:
            bf_plain = beamform_sources(full, mix)
        finally:
            mvdr.fused_weights = fused_weights
        rs, rn = trained_scms(full, mix)
        w_fused = fused_weights(rs, rn)
        w_want = widened(mvdr_weights_plain)(rs, rn)
        own = norm_err(mvdr_weights_plain(rs, rn).to(w_want.dtype),
                       w_want)[1]
    bf_err = norm_err(torch.view_as_real(bf), torch.view_as_real(bf_plain))
    w_err = norm_err(w_fused.to(w_want.dtype), w_want)[1]
    w_bound = max(PD_BOUND, 2 * own)
    gap = spectral_gap(rs)
    rows, f = rs.shape[0] * rs.shape[1], rs.shape[2]
    sim_gap = spectral_gap(sim_scms(np.random.default_rng(SEED + 11), rows,
                                    f, rs.shape[-1])[0])
    print(json.dumps({"phase": "ladder", "stage": "miso3-train",
                      "steps": LADDER_STEPS3, "loss_points": log3.points,
                      "step_ms_events": log3.step_ms,
                      "host_seconds": log3.seconds, "launches": counts,
                      "stages_db": stages,
                      "beamformed_max_norm_err": bf_err[1],
                      "bound": CASCADE_BOUND,
                      "weights_vs_complex128": w_err,
                      "weights_bound": w_bound,
                      "plain_f32_max_norm_err": own,
                      "scm_shape": list(rs.shape),
                      "worst_spectral_gap_trained": gap,
                      "worst_spectral_gap_sim": sim_gap,
                      "device": device_line}), flush=True)
    if counts != want:
        fail(f"ladder MISO3 training launched {counts}, expected {want}")
    if not bf_err[1] <= CASCADE_BOUND:
        fail(f"ladder: beamformed features {bf_err[1]} from the plain "
             f"weights' (bound {CASCADE_BOUND})")
    if not w_err <= w_bound:
        fail(f"ladder: weights on the trained SCMs {w_err} from complex128 "
             f"(bound {w_bound})")

    # 4. CSS over a LADDER_CSS_S scene (css_longform's functions)
    n = int(LADDER_CSS_S * ds.fs)
    scene = synth_mixture(20_000, n, 6, voiced=True)
    css = StreamingCSS(model, stft_cfg, ds)
    css.process(scene["mix"][: ds.chunk_samples])   # warm-up
    for overlap in css_longform.passes(ds):
        hop = ds.chunk_samples - overlap
        blocks = max(1, -(-max(n - overlap, 1) // hop))
        reset_launch_counts()
        (row,) = css_longform.run_css(css, scene["mix"], scene["ref"],
                                      LADDER_CSS_S, (overlap,))
        counts = launch_counts()
        want = expect("bfloat16", 50 * blocks, 10 * blocks,
                      mvdr_weights=blocks)
        print(json.dumps({"phase": "ladder", "stage": "css", **row,
                          "blocks": blocks, "launches": counts,
                          "device": device_line}), flush=True)
        if counts != want:
            fail(f"ladder CSS overlap {overlap}: launched {counts}, "
                 f"expected {want}")
        if not row["miso1"] > row["mixture"]:
            fail(f"ladder CSS overlap {overlap}: MISO1 {row['miso1']} dB "
                 f"not above the mixture's {row['mixture']} dB")


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
        name: new_record(name, replaces, source)
        for name, replaces, source in [
            ("dense_stack", "misonet_tpu/ops/pallas/dense_stack.py:316",
             None),
            ("stencil", "misonet_tpu/ops/pallas/stencil_flat.py:242", None),
            ("stencil_bwd", "misonet_tpu/ops/pallas/stencil_bwd.py:300",
             None),
            ("hermitian_solve", "misonet_tpu/ops/pallas/mvdr_solve.py:93",
             None),
            ("dense_stack_bf16", "misonet_tpu/ops/pallas/dense_stack.py:316",
             "dense_stack"),
            ("stencil_bf16", "misonet_tpu/ops/pallas/stencil_flat.py:242",
             "stencil"),
            ("dense_stack_int8", "misonet_tpu/ops/pallas/dense_stack.py:357",
             None),
            ("quantize_rows", "misonet_tpu/ops/pallas/dense_stack.py:357",
             "dense_stack_int8"),
            ("pack_tf32", "misonet_tpu/ops/pallas/stencil_bwd.py:419",
             "tc_pack"),
            ("stencil_bwd_bf16", "misonet_tpu/ops/pallas/stencil_bwd.py:300",
             "stencil_bwd"),
            ("dense_layer", "misonet_tpu/ops/pallas/dense_flat.py:240",
             "dense_stack"),
            ("dense_layer_bf16", "misonet_tpu/ops/pallas/dense_flat.py:240",
             "dense_stack"),
            ("mvdr_weights", "misonet_tpu/ops/pallas/mvdr_solve.py:93",
             None),
        ]
    }
    tc_ops = tensor_core_ops(lib)
    for name, r in records.items():
        r["tensor_core_ops"] = tc_ops[name]
    print(json.dumps({"phase": "build", "tensor_core_ops": tc_ops}),
          flush=True)
    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t
        return out

    timed("kernels", phase_kernels, records)

    # 4. forward
    cfg = ModelConfig(compute_dtype="float32")
    model = seeded_model(cfg, device)
    timed("forward", phase_forward, model, cfg)

    # 5. serve
    timed("serve", phase_serve, model, cfg, smi, records)
    del model

    # 6. bwd-kernels
    timed("bwd-kernels", phase_bwd_kernels, records)

    # 7. train
    timed("train", phase_train, cfg, device, records)

    # 8. solve-kernel, then the MVDR weights kernel
    timed("solve-kernel", phase_solve, records)
    timed("weights-kernel", phase_weights, records, smi)

    # 9. cascade
    timed("cascade", phase_cascade, cfg, device, smi, records)

    # 10. css
    timed("css", phase_css, cfg, device, smi)

    # 11. lowp-kernels: the bf16 modes and the int8 kernel
    timed("lowp-kernels", phase_lowp_kernels, records)

    # 12-13. the JAX package's default model (bf16) and its int8 decode
    bf16_cfg = ModelConfig()
    model = seeded_model(bf16_cfg, device)
    bf16_out = timed("bf16-forward", phase_forward, model, bf16_cfg,
                     "bfloat16", records)
    timed("int8-forward", phase_forward_int8, model, bf16_cfg, bf16_out,
          records)
    del bf16_out

    # 14. serving in bf16 and int8
    timed("bf16-serve", phase_serve, model, bf16_cfg, smi, records,
          "bfloat16")
    int8_cfg = ModelConfig(quant_int8=True)
    model.cfg = int8_cfg
    timed("int8-serve", phase_serve, model, int8_cfg, smi, records, "int8")
    del model

    # 15-16. the bf16 cascade and CSS
    timed("bf16-cascade", phase_cascade, bf16_cfg, device, smi, records,
          "bfloat16")
    timed("bf16-css", phase_css, bf16_cfg, device, smi, "bfloat16")

    # 17-18. bf16 training: the bf16 mode of stencil_bwd, then the step
    timed("bf16-bwd-kernels", phase_bwd_kernels, records, torch.bfloat16)
    timed("bf16-train", phase_train, bf16_cfg, device, records, "bfloat16")

    # 19. the port's CLI end to end
    timed("cli", phase_cli, smi)

    # 20. kernel 2.6, dense_layer, through its own entry point
    timed("dense-layer", phase_dense_layer, records)

    # 21. the REVERB plan: 8 levels, F = 257, 8 mics
    timed("reverb", phase_reverb, device)

    # 22. parallel/ over NCCL at world size 1
    timed("parallel", phase_parallel, device)

    # 23. the example programs on a small voiced corpus: trained weights
    timed("ladder", phase_ladder, device, smi)
    print(json.dumps({"phase": "timing", "seconds": seconds}), flush=True)

    # every time is the sum over that kernel's main-path cases in phase 3,
    # 6, 8, 11, 17 or 20 (mvdr_weights: the kernel's duration from the
    # profiler, queued CUDA events where the profiler lost it); launches
    # are those of the train path's run (phase 7 for the float32 modes and
    # pack_tf32, and phase 18 for stencil_bwd_bf16), of the cascade's
    # requests (phase 9) for mvdr_weights (hermitian_solve: 0, no path
    # runs it since the weights kernel took its solve), of the bf16 and
    # int8 forwards (phases 12-13) for their forward modes and
    # quantize_rows, and of phase 20's driven run for dense_layer
    for r in records.values():
        r["bound_by"] = ("operations" if r.pop("ops_ms") >= r.pop("bytes_ms")
                         else "bytes")
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def trained_main(ckpt: str) -> int:
    """``--trained <dir>/<tag>``: trained_decodes on a saved MISO1."""
    from misonet_tpu_torch.config import ModelConfig, StftConfig
    from misonet_tpu_torch.examples.common import make_corpus, score_separator
    from misonet_tpu_torch.examples.train_cascade import restore_miso1
    from misonet_tpu_torch.models import make_miso1

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device, cfg, stft_cfg = torch.device("cuda", 0), ModelConfig(), StftConfig()
    model = make_miso1(cfg, 6, device=device)
    restore_miso1(model, ckpt)
    evals = make_corpus(0, 8, 32000, 6, voiced=True).evals
    base = score_separator(model, stft_cfg, evals)[0]
    trained_decodes(model, cfg, stft_cfg, evals, base, device, smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--trained"]:
        sys.exit(trained_main(sys.argv[2]))
    sys.exit(main())

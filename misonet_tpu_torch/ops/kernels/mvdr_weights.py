"""Kernel 4, redesigned: the weights of one MVDR call in one launch.

Replaces misonet_tpu/ops/pallas/mvdr_solve.py::hermitian_solve_pallas
together with the chain that XLA fused around it in
misonet_tpu/beamforming/mvdr.py::mvdr_beamform: from the source and noise
SCMs, power-iteration steering, reference-mic normalization, phase
correction across frequency, the diagonally loaded Hermitian solve and the
MVDR normalization.  CUDA source: ``misonet_tpu_torch/csrc/mvdr_weights.cu``
(one thread block cluster a row of F bins, 2-8 lanes a bin; what bounds it
on the H100 and how the design answers that is written there).  Its solve
is ``hermitian_solve``'s, from the shared ``csrc/hermitian_chol.cuh``.

``mvdr_weights`` launches the kernel for CUDA tensors and runs
``mvdr_weights_plain`` for CPU tensors; it raises on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from misonet_tpu_torch.ops.kernels import build
from misonet_tpu_torch.ops.kernels.hermitian_solve import (
    M_RANGE,
    hermitian_solve_plain,
)

_P = ctypes.c_void_p


def mvdr_weights_plain(source_scm: torch.Tensor, noise_scm: torch.Tensor,
                       ref_ch: int = 0, diag_load: float = 1e-6,
                       power_iters: int = 100) -> torch.Tensor:
    """Plain PyTorch version, in the inputs' precision (complex64 or
    complex128): ``beamforming/mvdr.py``'s principal_eigenvector ->
    normalize_steering -> phase_correct, then ``hermitian_solve_plain`` and
    w = x / (d^H x), as ``mvdr.mvdr_weights`` normalizes.

    source_scm, noise_scm [..., F, M, M] -> weights [..., F, M]."""
    # beamforming/mvdr.py imports this package: import it here, not above
    from misonet_tpu_torch.beamforming import mvdr

    d = mvdr.principal_eigenvector(source_scm, power_iters)
    d = mvdr.normalize_steering(d, ref_ch)
    d = mvdr.phase_correct(d)
    numer = hermitian_solve_plain(noise_scm, d, diag_load)
    denom = (d.conj() * numer).sum(-1, keepdim=True)
    return numer / denom


def _check(rs: torch.Tensor, rn: torch.Tensor, ref_ch: int,
           power_iters: int) -> None:
    for name, t in (("source_scm", rs), ("noise_scm", rn)):
        if t.dtype != torch.complex64:
            raise ValueError(f"mvdr_weights: {name} must be complex64, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mvdr_weights: {name} must be contiguous")
    if rs.device != rn.device:
        raise ValueError(f"mvdr_weights: source_scm on {rs.device}, "
                         f"noise_scm on {rn.device}")
    if rs.ndim < 3 or rs.shape[-1] != rs.shape[-2]:
        raise ValueError(f"mvdr_weights: source_scm must be [..., F, M, M], "
                         f"got {tuple(rs.shape)}")
    if rn.shape != rs.shape:
        raise ValueError(f"mvdr_weights: noise_scm shape {tuple(rn.shape)}, "
                         f"expected {tuple(rs.shape)}")
    m = rs.shape[-1]
    if m not in M_RANGE:
        raise ValueError(f"mvdr_weights: M = {m} outside "
                         f"{M_RANGE.start}..{M_RANGE.stop - 1}")
    if rs.shape[-3] < 1:
        raise ValueError("mvdr_weights: F must be at least 1")
    if not 0 <= ref_ch < m:
        raise ValueError(f"mvdr_weights: ref_ch {ref_ch} outside 0..{m - 1}")
    if power_iters < 0:
        raise ValueError(f"mvdr_weights: power_iters {power_iters} < 0")


def mvdr_weights(source_scm: torch.Tensor, noise_scm: torch.Tensor,
                 ref_ch: int = 0, diag_load: float = 1e-6,
                 power_iters: int = 100) -> torch.Tensor:
    """MVDR weights from hermitized SCMs, every row and bin in one launch.

    source_scm, noise_scm  complex64 [..., F, M, M], 2 <= M <= 8, F >= 1
    -> weights complex64 [..., F, M]

    On the card F may reach ~130,000 (the kernel's shared memory holds a
    block's phasors); past that the launch fails with a RuntimeError."""
    _check(source_scm, noise_scm, ref_ch, power_iters)
    device = source_scm.device
    if device.type == "cpu":
        return mvdr_weights_plain(source_scm, noise_scm, ref_ch, diag_load,
                                  power_iters)
    if device.type != "cuda":
        raise ValueError(f"mvdr_weights: unsupported device {device}")
    m, f = source_scm.shape[-1], source_scm.shape[-3]
    w = torch.empty(source_scm.shape[:-1], dtype=source_scm.dtype,
                    device=device)
    n = w.numel() // (f * m)
    if n == 0:
        return w
    lib = library()
    with torch.cuda.device(device):
        err = lib.misonet_mvdr_weights(
            m, source_scm.data_ptr(), noise_scm.data_ptr(), w.data_ptr(), n,
            f, ref_ch, float(diag_load), power_iters,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"mvdr_weights kernel launch failed: CUDA error {err}")
    build.count_launch(mvdr_weights, "launches")
    return w


mvdr_weights.launches = 0


def library() -> ctypes.CDLL:
    lib = build.library()
    lib.misonet_mvdr_weights.argtypes = [
        ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, _P,
    ]
    lib.misonet_mvdr_weights.restype = ctypes.c_int
    return lib

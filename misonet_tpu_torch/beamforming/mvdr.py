"""MVDR beamforming, batched and on the tensor's device
(misonet_tpu/beamforming/mvdr.py; reference Apply_Beamforming,
tester.py:637-794).

  source SCM, noise SCM      complex contraction over frames
  steering                   fixed-count power iteration (the reference's
                             eigh keeps only the top eigenvector)
  phase correction           cumulative product of unit phasors over F
  weights                    one batched Hermitian solve (kernel 4,
                             ``ops/kernels/hermitian_solve.py``)

On the card ``steering_weights`` runs steering, phase correction and
weights in one launch (``ops/kernels/mvdr_weights.py``); the functions of
each stage stay for the CPU path and the tests.

Spectrograms are [..., C, T, F]; every leading axis is a batch axis, and
the mixture may broadcast against the source (one mixture, S speakers), so
a request's speakers and chunks ride one call and one launch.

TF32 is kept out of the complex contractions.  The SCMs sum 500-8,000
frames per entry: they contract in complex128 (``frame_outer_sum``) and
are rounded to complex64 once, and TF32, which only float32 matmuls may
take, cannot reach a float64 product whatever
``torch.backends.cuda.matmul`` says.  The small contractions (6 x 6
matvecs, w^H d, w^H y) are elementwise products and sums, which no matmul
setting touches.  On the card the solve is the CUDA kernel; nothing here
calls ``torch.linalg`` or falls back to another solver.
"""

from __future__ import annotations

import torch

from misonet_tpu_torch.ops.kernels.hermitian_solve import hermitian_solve
from misonet_tpu_torch.ops.kernels.mvdr_weights import (
    mvdr_weights as fused_weights,
)
from misonet_tpu_torch.utils import profiling


def frame_outer_sum(x: torch.Tensor) -> torch.Tensor:
    """sum_t x[..., c, t, f] conj(x[..., d, t, f]) -> [..., F, C, C],
    accumulated in complex128 and returned in ``x``'s dtype."""
    with profiling.span("mvdr.scm"):
        x2 = x.to(torch.complex128)
        s = torch.einsum("...ctf,...dtf->...fcd", x2, x2.conj())
        return s.to(x.dtype)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, kept: sqrt(sum |v|^2)."""
    return torch.sqrt((v.real**2 + v.imag**2).sum(-1, keepdim=True))


def _matvec(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., M, M] @ [..., M] as an elementwise product and sum."""
    return (r * v[..., None, :]).sum(-1)


def spatial_covariance(x: torch.Tensor) -> torch.Tensor:
    """Time-averaged spatial covariance per frequency.

    x: complex [..., C, T, F] -> R: complex [..., F, C, C],
    R[f] = (1/T) sum_t x[:, t, f] x[:, t, f]^H (tester.py:704-718)."""
    t = x.shape[-2]
    return hermitize(frame_outer_sum(x) / t)


def hermitize(r: torch.Tensor) -> torch.Tensor:
    """0.5 * (R + R^H) (tester.py:658)."""
    return 0.5 * (r + r.transpose(-1, -2).conj())


def principal_eigenvector(r: torch.Tensor,
                          iterations: int = 100) -> torch.Tensor:
    """Principal eigenvector of batched Hermitian PSD matrices
    [..., M, M] -> [..., M] by ``iterations`` power-iteration steps from
    R @ 1 (the JAX package's fixed trip count; its docstring has the
    convergence measurements).  The global phase is arbitrary: the caller
    normalizes by the reference-mic component."""
    m = r.shape[-1]
    with profiling.span("mvdr.power_iteration"):
        v = r.sum(-1)
        norm = _norm(v)
        v = torch.where(norm > 0, v / torch.clamp(norm, min=1e-30),
                        torch.ones_like(v) / m**0.5)
        for _ in range(iterations):
            w = _matvec(r, v)
            n = _norm(w)
            v = torch.where(n > 1e-30, w / torch.clamp(n, min=1e-30), v)
        return v


def normalize_steering(d: torch.Tensor, ref_ch: int = 0) -> torch.Tensor:
    """Divide by the reference-mic component, then scale by
    sqrt(M / ||d||) (tester.py:685-689: norm, not norm^2)."""
    m = d.shape[-1]
    d = d / d[..., ref_ch : ref_ch + 1]
    return d * torch.sqrt(m / _norm(d))


def phase_correct(d: torch.Tensor) -> torch.Tensor:
    """Inter-frequency phase correction (reference PhaseCorrection,
    tester.py:720-733).  The reference's sequential recursion telescopes to
    p[f] = p[f-1] * conj(unit(s[f])), s[f] = sum(d[f] * conj(d[f-1])) from
    the uncorrected vectors: a cumulative product over frequency
    (``lax.associative_scan`` in the JAX package, ``torch.cumprod`` here).

    d: [..., F, M] -> [..., F, M]."""
    s = (d[..., 1:, :] * d[..., :-1, :].conj()).sum(-1)      # [..., F-1]
    mag = s.abs()
    unit = torch.where(mag > 0, s / torch.clamp(mag, min=1e-30),
                       torch.ones_like(s))
    # p[0] = 1 (its own shape: with F = 1, s has no entry to copy one from)
    first = torch.ones(s.shape[:-1] + (1,), dtype=s.dtype, device=s.device)
    factors = torch.cat([first, unit.conj()], dim=-1)
    return d * torch.cumprod(factors, dim=-1)[..., None]


def mvdr_weights(steering: torch.Tensor, noise_scm: torch.Tensor,
                 diag_load: float = 1e-6) -> torch.Tensor:
    """w = (Phi_n + delta I)^-1 d / (d^H (Phi_n + delta I)^-1 d)
    (reference get_mvdr_beamformer, tester.py:777-791).

    steering [..., F, M], noise_scm [..., F, M, M] -> weights [..., F, M].
    Every system of the batch goes to one ``hermitian_solve`` call."""
    numer = hermitian_solve(noise_scm.contiguous(), steering.contiguous(),
                            diag=diag_load)
    denom = (steering.conj() * numer).sum(-1, keepdim=True)
    return numer / denom


def steering_weights(source_scm: torch.Tensor, noise_scm: torch.Tensor,
                     ref_ch: int = 0, diag_load: float = 1e-6,
                     power_iters: int = 100) -> torch.Tensor:
    """The MVDR weights from hermitized SCMs [..., F, M, M] -> [..., F, M]:
    principal_eigenvector -> normalize_steering -> phase_correct ->
    mvdr_weights, as one ``mvdr_weights`` kernel launch on the card (the
    same four functions on the CPU)."""
    with profiling.span("mvdr.weights"):
        return fused_weights(source_scm.contiguous(), noise_scm.contiguous(),
                             ref_ch, diag_load, power_iters)


def condition_covariance(r: torch.Tensor, gamma: float) -> torch.Tensor:
    """(R + gamma * tr(R) / M * I) / (1 + gamma): the reference's unused
    alternative to plain diagonal loading (tester.py:735-742)."""
    m = r.shape[-1]
    tr = torch.diagonal(r, dim1=-2, dim2=-1).sum(-1).real[..., None, None]
    eye = torch.eye(m, dtype=r.dtype, device=r.device)
    return (r + (gamma * tr / m) * eye) / (1.0 + gamma)


def blind_analytic_normalization(w: torch.Tensor, noise_scm: torch.Tensor,
                                 eps: float = 0.0) -> torch.Tensor:
    """BAN post-scaling of beamformer weights (tester.py:752-774):
    w * sqrt(|w^H Rn Rn w|) / |w^H Rn w|."""
    rn_w = _matvec(noise_scm, w)
    rn_rn_w = _matvec(noise_scm, rn_w)
    nominator = torch.sqrt((w.conj() * rn_rn_w).sum(-1)).abs()
    denominator = (w.conj() * rn_w).sum(-1).abs()
    return w * (nominator / (denominator + eps))[..., None]


def normalize_unit_power(d: torch.Tensor) -> torch.Tensor:
    """Divide the steering vector by d^H d (the reference's unused
    `normalize`, tester.py:744-750)."""
    return d / (d.abs() ** 2).sum(-1, keepdim=True)


def mvdr_beamform(source: torch.Tensor, mixture: torch.Tensor,
                  ref_ch: int = 0, diag_load: float = 1e-6,
                  power_iters: int = 100) -> torch.Tensor:
    """Full MVDR stage (reference Apply_Beamforming, tester.py:637-702).

    source   per-speaker multi-channel estimate, complex [..., C, T, F]
    mixture  observed mixture, complex, broadcastable to ``source``
    -> beamformed single-channel estimate, complex [..., T, F]

    Source SCM, noise SCM from (mixture - source), power-iteration
    steering, ref-mic and sqrt(M/||d||) normalization, phase correction,
    diagonally loaded Hermitian solve (``steering_weights``), y = w^H x."""
    source_scm = spatial_covariance(source)
    noise_scm = spatial_covariance(mixture - source)
    w = steering_weights(source_scm, noise_scm, ref_ch, diag_load,
                         power_iters)
    return apply_weights(w, mixture)


def apply_weights(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[..., t, f] = sum_c conj(w[..., f, c]) x[..., c, t, f]
    (tester.py:793-794): weights [..., F, C], spectrogram [..., C, T, F]
    broadcastable against them -> [..., T, F]."""
    return (w.conj().transpose(-1, -2)[..., None, :] * x).sum(-3)

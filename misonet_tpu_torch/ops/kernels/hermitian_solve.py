"""Kernel 4: batched small complex Hermitian solves for the MVDR weights.

Replaces misonet_tpu/ops/pallas/mvdr_solve.py::hermitian_solve_pallas.
Solves (R + diag I) x = d for a batch of M x M complex Hermitian positive-
definite systems (M = 6 mics on the MVDR path) by an unrolled complex
Cholesky and forward / back substitution, reading only the real part of
R's diagonal and its strict lower triangle.  CUDA source:
``misonet_tpu_torch/csrc/hermitian_solve.cu`` (one thread per system; what
bounds it on the H100 and how the design answers that is written there).

``hermitian_solve`` launches the kernel for CUDA tensors and runs
``hermitian_solve_plain`` for CPU tensors; it raises on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from misonet_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
M_RANGE = range(2, 9)   # the kernel's template instances


def hermitian_solve_plain(r: torch.Tensor, d: torch.Tensor,
                          diag: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: the kernel's unrolled Cholesky and
    substitutions as elementwise ops over the batch, in ``r``'s precision
    (complex64 or complex128).  r [..., M, M], d [..., M] -> x [..., M]."""
    m = r.shape[-1]
    rr, ri = r.real, r.imag
    dr, di = d.real, d.imag
    lr: dict[tuple[int, int], torch.Tensor] = {}
    li: dict[tuple[int, int], torch.Tensor] = {}
    inv: dict[int, torch.Tensor] = {}
    for j in range(m):
        ajj = rr[..., j, j] + diag
        for k in range(j):
            ajj = ajj - (lr[j, k] ** 2 + li[j, k] ** 2)
        inv[j] = 1.0 / torch.sqrt(torch.clamp(ajj, min=1e-30))
        for i in range(j + 1, m):
            sr, si = rr[..., i, j], ri[..., i, j]
            for k in range(j):
                # s -= L[i,k] * conj(L[j,k])
                sr = sr - (lr[i, k] * lr[j, k] + li[i, k] * li[j, k])
                si = si - (li[i, k] * lr[j, k] - lr[i, k] * li[j, k])
            lr[i, j] = sr * inv[j]
            li[i, j] = si * inv[j]
    yr, yi = {}, {}
    for j in range(m):                        # L y = d
        sr, si = dr[..., j], di[..., j]
        for k in range(j):
            sr = sr - (lr[j, k] * yr[k] - li[j, k] * yi[k])
            si = si - (lr[j, k] * yi[k] + li[j, k] * yr[k])
        yr[j], yi[j] = sr * inv[j], si * inv[j]
    xr, xi = {}, {}
    for i in range(m - 1, -1, -1):            # L^H x = y
        sr, si = yr[i], yi[i]
        for k in range(i + 1, m):
            # s -= conj(L[k,i]) * x[k]
            sr = sr - (lr[k, i] * xr[k] + li[k, i] * xi[k])
            si = si - (lr[k, i] * xi[k] - li[k, i] * xr[k])
        xr[i], xi[i] = sr * inv[i], si * inv[i]
    return torch.complex(torch.stack([xr[j] for j in range(m)], dim=-1),
                         torch.stack([xi[j] for j in range(m)], dim=-1))


def _check(r: torch.Tensor, d: torch.Tensor) -> None:
    for name, t in (("r", r), ("d", d)):
        if t.dtype != torch.complex64:
            raise ValueError(f"hermitian_solve: {name} must be complex64, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"hermitian_solve: {name} must be contiguous")
    if r.device != d.device:
        raise ValueError(f"hermitian_solve: r on {r.device}, d on {d.device}")
    if r.ndim < 2 or r.shape[-1] != r.shape[-2]:
        raise ValueError(f"hermitian_solve: r must be [..., M, M], got "
                         f"{tuple(r.shape)}")
    if tuple(d.shape) != tuple(r.shape[:-1]):
        raise ValueError(f"hermitian_solve: d shape {tuple(d.shape)}, "
                         f"expected {tuple(r.shape[:-1])}")
    if r.shape[-1] not in M_RANGE:
        raise ValueError(f"hermitian_solve: M = {r.shape[-1]} outside "
                         f"{M_RANGE.start}..{M_RANGE.stop - 1}")


def hermitian_solve(r: torch.Tensor, d: torch.Tensor,
                    diag: float = 1e-6) -> torch.Tensor:
    """Solve (r + diag I) x = d for every system of the batch.

    r  complex64 [..., M, M] Hermitian positive definite, 2 <= M <= 8
    d  complex64 [..., M]
    -> x complex64 [..., M]

    Reads the real part of r's diagonal and its strict lower triangle only,
    as the TPU kernel does."""
    _check(r, d)
    device = r.device
    if device.type == "cpu":
        return hermitian_solve_plain(r, d, diag)
    if device.type != "cuda":
        raise ValueError(f"hermitian_solve: unsupported device {device}")
    m = r.shape[-1]
    n = d.numel() // m
    x = torch.empty_like(d)
    if n == 0:
        return x
    lib = library()
    with torch.cuda.device(device):
        err = lib.misonet_hermitian_solve(
            m, r.data_ptr(), d.data_ptr(), x.data_ptr(), float(diag), n,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"hermitian_solve kernel launch failed: CUDA error {err}")
    build.count_launch(hermitian_solve, "launches")
    return x


hermitian_solve.launches = 0


def library() -> ctypes.CDLL:
    lib = build.library()
    lib.misonet_hermitian_solve.argtypes = [
        ctypes.c_int, _P, _P, _P, ctypes.c_float, ctypes.c_longlong, _P,
    ]
    lib.misonet_hermitian_solve.restype = ctypes.c_int
    return lib

"""PyTorch port, kernel 4: the batched Hermitian solve's plain version
(the CPU path of ``hermitian_solve`` and the card's reference) against the
JAX package's Pallas kernel in interpret mode, at the cases of
tests/test_pallas_mvdr.py, and both against a float64 numpy oracle.

Tolerance: the port and the Pallas kernel run the same unrolled Cholesky
in float32, in the same order, so they agree to 1e-4 of max-abs; against
the float64 LAPACK oracle both are held to atol/rtol 1e-3 as
tests/test_pallas_mvdr.py holds the kernel."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from misonet_tpu.ops.pallas.mvdr_solve import hermitian_solve_pallas  # noqa: E402
from misonet_tpu_torch.ops.kernels.hermitian_solve import (  # noqa: E402
    hermitian_solve,
    hermitian_solve_plain,
)

DIAG = 1e-6
CASES = [((2, 129), 6), ((7,), 6), ((300,), 4)]


def _systems(rng, shape, m):
    """Seeded Hermitian PD systems, as tests/test_pallas_mvdr.py makes."""
    a = (rng.standard_normal(shape + (m, m))
         + 1j * rng.standard_normal(shape + (m, m))).astype(np.complex64)
    r = np.einsum("...ij,...kj->...ik", a, a.conj()) + 0.1 * np.eye(m)
    r = 0.5 * (r + np.conj(r.swapaxes(-1, -2)))
    d = (rng.standard_normal(shape + (m,))
         + 1j * rng.standard_normal(shape + (m,))).astype(np.complex64)
    return np.ascontiguousarray(r, np.complex64), d


def _oracle(r, d, m):
    return np.linalg.solve(r.astype(np.complex128) + DIAG * np.eye(m),
                           d[..., None])[..., 0]


@pytest.mark.parametrize("shape,m", CASES)
def test_plain_matches_pallas_and_oracle(shape, m):
    r, d = _systems(np.random.default_rng(0), shape, m)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(hermitian_solve_pallas(jnp.asarray(r),
                                                 jnp.asarray(d), diag=DIAG))
    got = hermitian_solve_plain(torch.from_numpy(r), torch.from_numpy(d),
                                DIAG).numpy()
    assert got.shape == want.shape == shape + (m,)
    assert got.dtype == np.complex64
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)
    ref = _oracle(r, d, m)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(want, ref, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("shape,m", CASES)
def test_wrapper_on_cpu_is_the_plain_version(shape, m):
    r, d = _systems(np.random.default_rng(1), shape, m)
    rt, dt = torch.from_numpy(r), torch.from_numpy(d)
    before = hermitian_solve.launches
    got = hermitian_solve(rt, dt, DIAG)
    assert hermitian_solve.launches == before  # nothing launched
    assert torch.equal(got, hermitian_solve_plain(rt, dt, DIAG))


def test_plain_in_float64_matches_oracle():
    """The card's reference: the plain version on complex128 inputs."""
    r, d = _systems(np.random.default_rng(2), (258,), 6)
    got = hermitian_solve_plain(torch.from_numpy(r).to(torch.complex128),
                                torch.from_numpy(d).to(torch.complex128),
                                DIAG).numpy()
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, _oracle(r, d, 6), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("m", [4, 6])
def test_reads_only_the_lower_triangle(m):
    """The real diagonal and the strict lower triangle are the only entries
    read: changing the upper triangle and the diagonal's imaginary part
    leaves x as it was."""
    rng = np.random.default_rng(3)
    r, d = _systems(rng, (50,), m)
    bent = r.copy()
    upper = np.triu(np.ones((m, m), bool), 1)
    bent[:, upper] += (rng.standard_normal((50, upper.sum()))
                       + 1j * rng.standard_normal((50, upper.sum())))
    idx = np.arange(m)
    bent[:, idx, idx] += 1j * rng.standard_normal((50, m)).astype(np.float32)
    dt = torch.from_numpy(d)
    got = hermitian_solve(torch.from_numpy(bent), dt, DIAG)
    assert torch.equal(got, hermitian_solve(torch.from_numpy(r), dt, DIAG))


def test_wrapper_raises_on_bad_input():
    r, d = (torch.from_numpy(v) for v in
            _systems(np.random.default_rng(4), (5,), 6))
    with pytest.raises(ValueError, match="complex64"):
        hermitian_solve(r.to(torch.complex128), d)
    with pytest.raises(ValueError, match="complex64"):
        hermitian_solve(r, d.real.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        hermitian_solve(r.transpose(-1, -2), d)
    with pytest.raises(ValueError, match="d shape"):
        hermitian_solve(r, d[:4])
    with pytest.raises(ValueError, match=r"\[\.\.\., M, M\]"):
        hermitian_solve(r[..., :5].contiguous(), d)
    for m in (1, 9):
        rm = torch.eye(m, dtype=torch.complex64).expand(3, m, m).contiguous()
        with pytest.raises(ValueError, match="outside 2..8"):
            hermitian_solve(rm, torch.ones(3, m, dtype=torch.complex64))
    with pytest.raises(ValueError, match="unsupported device"):
        hermitian_solve(r.to("meta"), d.to("meta"))
    with pytest.raises(ValueError, match="r on"):
        hermitian_solve(r.to("meta"), d)


def test_empty_batch():
    r = torch.zeros((0, 6, 6), dtype=torch.complex64)
    d = torch.zeros((0, 6), dtype=torch.complex64)
    assert hermitian_solve(r, d).shape == (0, 6)

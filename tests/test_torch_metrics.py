"""PyTorch port, metrics.py: SI-SDR, plain SDR, PIT and the PESQ hook
against the JAX package's (tests/test_metrics.py's cases and the numpy
oracle).  float32 sums over 8,000 samples in another order: 1e-3 dB."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu import metrics as jm  # noqa: E402
from misonet_tpu_torch import metrics as tm  # noqa: E402

DB = 1e-3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_si_sdr_perfect_reconstruction_high():
    x = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
    assert float(tm.si_sdr(_t(x), _t(x))) > 60


def test_si_sdr_scale_invariance():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(8000).astype(np.float32)
    noisy = x + 0.1 * rng.standard_normal(8000).astype(np.float32)
    a = float(tm.si_sdr(_t(noisy), _t(x)))
    b = float(tm.si_sdr(_t(3.7 * noisy), _t(x)))
    np.testing.assert_allclose(a, b, atol=DB)
    np.testing.assert_allclose(a, tm.numpy_si_sdr(noisy, x), atol=DB)
    np.testing.assert_allclose(a, float(jm.si_sdr(jnp.asarray(noisy),
                                                  jnp.asarray(x))), atol=DB)


@pytest.mark.parametrize("gain", [1.0, 3.7])
def test_sdr_matches_jax_and_is_scale_dependent(gain):
    """Plain SDR over a batch [2, 3, T]: JAX's values; scaling the estimate
    changes it (SI-SDR would not move)."""
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((2, 3, 8000)).astype(np.float32)
    est = gain * (ref + 0.1 * rng.standard_normal(ref.shape)).astype(
        np.float32)
    got = tm.sdr(_t(est), _t(ref)).numpy()
    want = np.asarray(jm.sdr(jnp.asarray(est), jnp.asarray(ref)))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, atol=DB)
    noise = est - ref
    oracle = 10 * np.log10((ref.astype(np.float64) ** 2).sum(-1)
                           / (noise.astype(np.float64) ** 2).sum(-1))
    np.testing.assert_allclose(got, oracle, atol=DB)
    if gain != 1.0:
        assert (got < tm.sdr(_t(est / gain), _t(ref)).numpy()).all()


def test_si_sdr_pit_picks_best_permutation():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((2, 4000)).astype(np.float32)
    est = s[::-1] + 0.01 * rng.standard_normal((2, 4000)).astype(np.float32)
    swapped = float(tm.si_sdr_pit(_t(est), _t(s)))
    assert swapped > 30
    batched = tm.si_sdr_pit(_t(est[None]), _t(s[None]))
    np.testing.assert_allclose(float(batched[0]), swapped, atol=1e-4)
    np.testing.assert_allclose(
        swapped, float(jm.si_sdr_pit(jnp.asarray(est), jnp.asarray(s))),
        atol=DB)


@pytest.mark.parametrize("fs", [8000, 16000])
def test_pesq_hook_follows_the_package(fs):
    """Neither environment of the port has the ``pesq`` package: both
    hooks return None; where it imports, both give its score."""
    x = np.random.default_rng(4).standard_normal(fs).astype(np.float32)
    got = tm.pesq(x, x, fs)
    assert got == jm.pesq(x, x, fs)
    try:
        import pesq  # noqa: F401
    except ImportError:
        assert got is None
    else:
        assert isinstance(got, float)

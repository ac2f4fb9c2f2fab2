"""PyTorch port: kernel 4's redesign, ``ops/kernels/mvdr_weights.py`` (the
MVDR weights of one call in one launch: power-iteration steering,
normalization, phase correction, loaded Cholesky solve, MVDR
normalization) on the CPU, where the wrapper runs ``mvdr_weights_plain``.

  mvdr_weights_plain vs the JAX package's composition principal_eigenvector
  -> normalize_steering -> phase_correct -> mvdr_weights, from the same
  seeded SCMs: 1e-3 of max-abs, the tolerance tests/test_torch_mvdr.py
  holds the weights to (JAX's CPU solve is LAPACK LU on the full matrix,
  the port's the Cholesky of kernel 4), at its _sim shapes (B, C, T, F =
  2, 6, 40, 17), a chunks x speakers batch and M = 8.
  steering_weights vs the four calls it replaced: bit-identical on the CPU,
  which ties the parity tests of the MVDR, the cascade and CSS to it.

The JAX side compiles twice, once a channel count and reference mic: the
cases that share them ride one call, their rows side by side.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu.beamforming import mvdr as jmvdr  # noqa: E402
from misonet_tpu_torch.beamforming import mvdr as tmvdr  # noqa: E402
from misonet_tpu_torch.ops.kernels.mvdr_weights import (  # noqa: E402
    mvdr_weights,
    mvdr_weights_plain,
)

T, F = 40, 17


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_c(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _scms(seed, lead, c, f=F):
    """Hermitized source and noise SCMs [*lead, F, C, C] (complex64) of the
    simulation of tests/test_mvdr.py: one far-field source with random
    steering + diffuse noise, so each source SCM is near rank 1."""
    rng = np.random.default_rng(seed)
    steer = _rand_c(rng, lead + (f, c))
    steer /= np.abs(steer[..., :1]) * np.sign(steer[..., :1].real + 1e-9)
    sig = _rand_c(rng, lead + (T, f))
    source = np.einsum("...fc,...tf->...ctf", steer, sig)
    noise = _rand_c(rng, lead + (c, T, f), scale=0.1)

    def scm(x):
        x = x.astype(np.complex128)
        s = np.einsum("...ctf,...dtf->...fcd", x, x.conj()) / T
        return np.ascontiguousarray(
            0.5 * (s + np.conj(np.swapaxes(s, -1, -2))), np.complex64)

    return scm(source), scm(noise)


@functools.partial(jax.jit, static_argnames=("ref_ch",))
def _jax_weights(rs, rn, ref_ch):
    """The JAX package's chain of mvdr_beamform from the SCMs [B, F, M, M]
    on (its phase_correct takes [B, F, M])."""
    d = jmvdr.principal_eigenvector(rs, 100)
    d = jmvdr.normalize_steering(d, ref_ch)
    d = jmvdr.phase_correct(d)
    return jmvdr.mvdr_weights(d, rn)


def _close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _four_calls(rs, rn, ref_ch=0, diag_load=1e-6, power_iters=100):
    """The MVDR weights as mvdr_beamform and StreamingCSS.step computed
    them before steering_weights."""
    d = tmvdr.principal_eigenvector(rs, power_iters)
    d = tmvdr.normalize_steering(d, ref_ch)
    d = tmvdr.phase_correct(d)
    return tmvdr.mvdr_weights(d, rn, diag_load)


# (utterance mode: 2 speakers; chunk mode: 3 chunks x 2 speakers; M = 8)
CASES = {"utterance": ((2,), 6, 0), "chunks_x_speakers": ((3, 2), 6, 0),
         "m8": ((2,), 8, 3)}


@pytest.fixture(scope="module")
def jax_cases():
    """{case: (rs, rn, JAX's weights)}: the rows of the cases of one
    channel count and reference mic flattened into one JAX call."""
    scms = {name: _scms(1, lead, c) for name, (lead, c, _) in CASES.items()}
    out = {}
    for key in {v[1:] for v in CASES.values()}:
        names = [n for n in sorted(CASES) if CASES[n][1:] == key]
        flat = [np.concatenate([a.reshape((-1,) + a.shape[-3:])
                                for a in (scms[n][i] for n in names)])
                for i in (0, 1)]
        w = np.asarray(_jax_weights(*flat, ref_ch=key[1]))
        start = 0
        for n in names:
            rs, rn = scms[n]
            rows = int(np.prod(rs.shape[:-3]))
            out[n] = (rs, rn, w[start:start + rows].reshape(rs.shape[:-1]))
            start += rows
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_composition(case, jax_cases):
    ref_ch = CASES[case][2]
    rs, rn, want = jax_cases[case]
    got = mvdr_weights_plain(torch.from_numpy(rs), torch.from_numpy(rn),
                             ref_ch)
    assert got.dtype == torch.complex64
    _close(got.numpy(), want, 1e-3)
    # and in complex128, the card's reference
    wide = mvdr_weights_plain(torch.from_numpy(rs).to(torch.complex128),
                              torch.from_numpy(rn).to(torch.complex128),
                              ref_ch)
    assert wide.dtype == torch.complex128
    _close(wide.numpy(), want, 1e-3)


@pytest.mark.parametrize("lead,c,ref_ch,iters,f", [
    ((2,), 6, 0, 100, F),
    ((3, 2), 6, 2, 30, F),
    ((2,), 8, 7, 100, F),
    ((1,), 4, 1, 0, 1),        # one bin, no trips
])
def test_steering_weights_is_the_four_calls(lead, c, ref_ch, iters, f):
    rs, rn = (torch.from_numpy(a) for a in _scms(2, lead, c, f))
    got = tmvdr.steering_weights(rs, rn, ref_ch, 1e-6, iters)
    assert torch.equal(got, _four_calls(rs, rn, ref_ch, 1e-6, iters))
    assert torch.equal(got, mvdr_weights_plain(rs, rn, ref_ch, 1e-6, iters))


def test_mvdr_beamform_goes_through_steering_weights(monkeypatch):
    """mvdr_beamform's weights are steering_weights' (one launch on the
    card), with its ref_ch, diag_load and power_iters."""
    calls = []
    real = tmvdr.steering_weights

    def spy(*args):
        calls.append(args[2:])
        return real(*args)

    monkeypatch.setattr(tmvdr, "steering_weights", spy)
    rng = np.random.default_rng(3)
    src = torch.from_numpy(_rand_c(rng, (2, 6, T, F)))
    mix = src + torch.from_numpy(_rand_c(rng, (2, 6, T, F), 0.1))
    tmvdr.mvdr_beamform(src, mix, ref_ch=1, diag_load=1e-5, power_iters=9)
    assert calls == [(1, 1e-5, 9)]


def test_wrapper_runs_plain_on_cpu():
    rs, rn = (torch.from_numpy(a) for a in _scms(4, (2,), 6))
    before = mvdr_weights.launches
    got = mvdr_weights(rs, rn, 2, 1e-6, 50)
    assert mvdr_weights.launches == before  # nothing launched
    assert torch.equal(got, mvdr_weights_plain(rs, rn, 2, 1e-6, 50))
    assert mvdr_weights(rs[:0], rn[:0]).shape == (0, F, 6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rs, rn = (torch.from_numpy(a) for a in _scms(5, (2,), 6))
    with pytest.raises(ValueError, match="complex64"):
        mvdr_weights(rs.to(torch.complex128), rn)
    with pytest.raises(ValueError, match="complex64"):
        mvdr_weights(rs, rn.real.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        mvdr_weights(rs.transpose(-1, -2), rn)
    with pytest.raises(ValueError, match="shape"):
        mvdr_weights(rs, rn[:1])
    with pytest.raises(ValueError, match=r"\[\.\.\., F, M, M\]"):
        mvdr_weights(rs[0, 0], rn[0, 0])
    with pytest.raises(ValueError, match=r"\[\.\.\., F, M, M\]"):
        mvdr_weights(rs[..., :5].contiguous(), rn[..., :5].contiguous())
    for m in (1, 9):
        r = torch.eye(m, dtype=torch.complex64).expand(2, 3, m, m)
        with pytest.raises(ValueError, match="M = "):
            mvdr_weights(r.contiguous(), r.contiguous())
    with pytest.raises(ValueError, match="F must be"):
        mvdr_weights(rs[:, :0], rn[:, :0])
    for ref_ch in (-1, 6):
        with pytest.raises(ValueError, match="ref_ch"):
            mvdr_weights(rs, rn, ref_ch)
    with pytest.raises(ValueError, match="power_iters"):
        mvdr_weights(rs, rn, power_iters=-1)
    with pytest.raises(ValueError, match="noise_scm on"):
        mvdr_weights(rs, rn.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        mvdr_weights(rs.to("meta"), rn.to("meta"))


def test_phase_correct_of_one_bin_matches_jax():
    """F = 1: the one phasor is 1 (the port's phase_correct once broadcast
    its empty factors to F = 0)."""
    d = _rand_c(np.random.default_rng(6), (3, 1, 6))
    got = tmvdr.phase_correct(torch.from_numpy(d))
    assert got.shape == (3, 1, 6)
    _close(got.numpy(), np.asarray(jmvdr.phase_correct(d)), 1e-6)

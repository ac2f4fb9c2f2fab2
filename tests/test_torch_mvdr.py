"""PyTorch port: MVDR beamforming and the streaming SCMs
(``beamforming/mvdr.py``, ``beamforming/scm.py``) against the JAX package
on the CPU, at the ``_sim`` shapes of tests/test_mvdr.py (B, C, T, F =
2, 6, 40, 17), from the same seeded numpy inputs.

Tolerances, normalized by the JAX output's max-abs:
  SCMs 1e-5          the port sums the frames in complex128, JAX in
                     complex64: they differ by float32 rounding only
  steering 1e-4      power iteration (100 steps), ref-mic normalization and
                     phase correction (``torch.cumprod`` vs JAX's
                     associative scan), compared up to global phase
  weights, output    1e-3: the JAX package's CPU solve is LAPACK LU on the
                     full matrix, the port's is the Cholesky of kernel 4
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu.beamforming import mvdr as jmvdr  # noqa: E402
from misonet_tpu.beamforming import scm as jscm  # noqa: E402
from misonet_tpu_torch.beamforming import mvdr as tmvdr  # noqa: E402
from misonet_tpu_torch.beamforming import scm as tscm  # noqa: E402

B, C, T, F = 2, 6, 40, 17


def _rand_c(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _sim(rng, b=B):
    """Two far-field sources with random steering + diffuse noise (the
    simulation of tests/test_mvdr.py)."""
    steer = _rand_c(rng, (b, F, C))
    steer /= np.abs(steer[..., :1]) * np.sign(steer[..., :1].real + 1e-9)
    sig = _rand_c(rng, (b, T, F))
    source = np.einsum("bfc,btf->bctf", steer, sig).astype(np.complex64)
    noise = _rand_c(rng, (b, C, T, F), scale=0.1)
    return source, source + noise


def _close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _psd(rng, shape, m):
    a = _rand_c(rng, shape + (m, m))
    return np.einsum("...ij,...kj->...ik", a, a.conj()).astype(np.complex64)


def test_spatial_covariance_matches_jax():
    source, mixture = _sim(np.random.default_rng(0))
    for x in (source, mixture - source):
        want = np.asarray(jmvdr.spatial_covariance(jnp.asarray(x)))
        got = tmvdr.spatial_covariance(_t(x))
        assert got.dtype == torch.complex64
        _close(got.numpy(), want, 1e-5)
    r = _rand_c(np.random.default_rng(1), (B, F, C, C))
    _close(tmvdr.hermitize(_t(r)).numpy(),
           np.asarray(jmvdr.hermitize(jnp.asarray(r))), 1e-6)


@pytest.mark.parametrize("iterations", [30, 100])
def test_steering_matches_jax(iterations):
    """Power iteration, ref-mic normalization and phase correction, each
    stage fed the JAX stage's input."""
    source, _ = _sim(np.random.default_rng(2))
    r = np.asarray(jmvdr.spatial_covariance(jnp.asarray(source)))
    want = np.asarray(jmvdr.principal_eigenvector(jnp.asarray(r),
                                                  iterations))
    got = tmvdr.principal_eigenvector(_t(r), iterations).numpy()
    # up to global phase: both normalized by their first component
    _close(got / got[..., :1], want / want[..., :1], 1e-4)

    want_n = np.asarray(jmvdr.normalize_steering(jnp.asarray(want), 0))
    _close(tmvdr.normalize_steering(_t(want), 0).numpy(), want_n, 1e-4)
    _close(tmvdr.phase_correct(_t(want_n)).numpy(),
           np.asarray(jmvdr.phase_correct(jnp.asarray(want_n))), 1e-4)


def test_mvdr_weights_match_jax():
    rng = np.random.default_rng(4)
    d = _rand_c(rng, (B, F, C))
    rn = _psd(rng, (B, F), C)
    want = np.asarray(jmvdr.mvdr_weights(jnp.asarray(d), jnp.asarray(rn)))
    got = tmvdr.mvdr_weights(_t(d), _t(rn)).numpy()
    _close(got, want, 1e-3)
    # the MVDR constraint w^H d = 1
    np.testing.assert_allclose(np.sum(got.conj() * d, -1), 1.0, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_mvdr_beamform_matches_jax(seed):
    source, mixture = _sim(np.random.default_rng(seed))
    want = np.asarray(jmvdr.mvdr_beamform(jnp.asarray(source),
                                          jnp.asarray(mixture)))
    got = tmvdr.mvdr_beamform(_t(source), _t(mixture))
    assert got.shape == (B, T, F) and got.dtype == torch.complex64
    _close(got.numpy(), want, 1e-3)


def test_mvdr_beamform_broadcasts_the_mixture():
    """Speakers as a batch axis against one broadcast mixture give each
    speaker's own call (the evaluator's one-launch layout)."""
    rng = np.random.default_rng(5)
    sources = np.stack([_sim(rng)[0] for _ in range(3)], axis=1)  # [B,S,...]
    mixture = sources.sum(1) + _rand_c(rng, (B, C, T, F), 0.1)
    together = tmvdr.mvdr_beamform(_t(sources), _t(mixture)[:, None])
    for s in range(3):
        alone = tmvdr.mvdr_beamform(_t(sources[:, s]), _t(mixture))
        _close(together[:, s].numpy(), alone.numpy(), 1e-6)


def test_alternates_match_jax():
    rng = np.random.default_rng(6)
    r = _psd(rng, (3, 5), 4)
    _close(tmvdr.condition_covariance(_t(r), 1e-2).numpy(),
           np.asarray(jmvdr.condition_covariance(jnp.asarray(r), 1e-2)), 1e-6)
    w = _rand_c(rng, (2, 5, 4))
    rn = _psd(rng, (2, 5), 4)
    _close(tmvdr.blind_analytic_normalization(_t(w), _t(rn)).numpy(),
           np.asarray(jmvdr.blind_analytic_normalization(jnp.asarray(w),
                                                         jnp.asarray(rn))),
           1e-5)
    _close(tmvdr.normalize_unit_power(_t(w)).numpy(),
           np.asarray(jmvdr.normalize_unit_power(jnp.asarray(w))), 1e-6)


def test_streaming_scm_matches_jax_and_full():
    rng = np.random.default_rng(7)
    x = _rand_c(rng, (C, 3 * T, F))
    blocks = x.reshape(C, 3, T, F).transpose(1, 0, 2, 3).copy()
    full = tmvdr.spatial_covariance(_t(x)[None])[0].numpy()

    jacc = jscm.scm_partial(jnp.asarray(blocks[0]))
    acc = tscm.scm_partial(_t(blocks[0]))
    _close(acc[0].numpy(), np.asarray(jacc[0]), 1e-5)
    assert float(acc[1]) == float(jacc[1]) == T
    for blk in blocks[1:]:
        jacc = jscm.streaming_scm_update(jacc, jnp.asarray(blk))
        acc = tscm.streaming_scm_update(acc, _t(blk))
    got = tscm.scm_finalize(acc).numpy()
    _close(got, np.asarray(jscm.scm_finalize(jacc)), 1e-5)
    _close(got, full, 1e-5)
    chunked = tscm.chunked_scm(_t(blocks)).numpy()
    _close(chunked, np.asarray(jscm.chunked_scm(jnp.asarray(blocks))), 1e-5)
    _close(chunked, full, 1e-5)


def test_collective_scm_is_refused(tmp_path):
    """The collective SCM is ported: over a one-rank gloo mesh it equals the
    unsharded SCM exactly (tests/test_torch_parallel.py runs two ranks);
    what it refuses is a mesh this rank is not in."""
    import torch.distributed as dist

    from misonet_tpu_torch.parallel import Mesh, make_mesh

    rng = np.random.default_rng(9)
    blocks = _t((rng.standard_normal((2, C, T, F))
                 + 1j * rng.standard_normal((2, C, T, F))).astype(np.complex64))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        got = tscm.chunked_scm(blocks, make_mesh())
        with pytest.raises(ValueError, match="not in the mesh"):
            tscm.chunked_scm(blocks, Mesh((1,), None))
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, tscm.chunked_scm(blocks))

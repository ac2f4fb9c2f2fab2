"""PyTorch port: STFT / iSTFT and chunking against the JAX package.

Tolerance: both sides are float32 framed FFTs of the same frames (pocketfft
through torch vs. XLA's CPU FFT), so they agree to float32 rounding of
sums over 256 samples: atol 1e-4 on spectra of unit-variance input, and
2e-5 on reconstructed waves."""

import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu.config import StftConfig  # noqa: E402
from misonet_tpu_torch.ops import chunk as tchunk  # noqa: E402
from misonet_tpu_torch.ops import stft as tstft  # noqa: E402

# misonet_tpu.ops re-exports functions named like its modules
jchunk = importlib.import_module("misonet_tpu.ops.chunk")
jstft = importlib.import_module("misonet_tpu.ops.stft")

CFG = StftConfig()  # 256 / 192 -> hop 64, 129 bins


@pytest.mark.parametrize("samples", [32000, 12345])  # hop multiple, not
@pytest.mark.parametrize("scaled", [True, False])
def test_stft_istft_match_jax(samples, scaled):
    rng = np.random.default_rng(samples)
    x = rng.standard_normal((2, 3, samples)).astype(np.float32)
    fwd_t, inv_t = ((tstft.stft_scaled, tstft.istft_scaled) if scaled
                    else (tstft.stft, tstft.istft))
    fwd_j, inv_j = ((jstft.stft_scaled, jstft.istft_scaled) if scaled
                    else (jstft.stft, jstft.istft))

    zt = fwd_t(torch.from_numpy(x), CFG)
    zj = np.asarray(fwd_j(jnp.asarray(x), CFG))
    assert zt.shape == zj.shape == (2, 3, CFG.num_frames(samples), 129)
    assert zt.dtype == torch.complex64
    scale = np.abs(zj).max()
    np.testing.assert_allclose(zt.numpy() / scale, zj / scale, atol=1e-4)

    yt = inv_t(zt, CFG, samples).numpy()
    yj = np.asarray(inv_j(jnp.asarray(zj), CFG, samples))
    np.testing.assert_allclose(yt, yj, atol=2e-5)
    np.testing.assert_allclose(yt, x, atol=2e-5)  # perfect reconstruction


def test_hann_matches():
    np.testing.assert_array_equal(tstft.hann_periodic(256),
                                  jstft.hann_periodic(256))


@pytest.mark.parametrize("n", [8000, 9999])
def test_chunks_match_jax(n):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    pt, gt = tchunk.split_chunks(x, 4000)
    pj, gj = jchunk.split_chunks(x, 4000)
    np.testing.assert_array_equal(pt, pj)
    assert gt == gj
    np.testing.assert_array_equal(tchunk.merge_chunks(pt, gt), x)

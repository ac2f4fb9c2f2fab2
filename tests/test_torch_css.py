"""PyTorch port: streaming CSS (``inference/css.py``) against the JAX
package's ``StreamingCSS`` on the CPU, with the same MISO1 weights (moved by
the bridge) and the same seeded recording, edge to edge and cross-faded,
with and without forgetting; and ``crossfade_stitch``.

Tolerance: 1e-3 of the JAX wave's max-abs (the blocks' MVDR solves are
LAPACK LU on the JAX side and kernel 4's Cholesky in the port; separated
waves agree to float32 rounding of the forward)."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from misonet_tpu.inference import css as jcss  # noqa: E402
from misonet_tpu_torch.inference import css as tcss  # noqa: E402
from misonet_tpu_torch.ops.chunk import split_chunks  # noqa: E402
from test_torch_cascade import DS, SMALL, STFT, _close, _pair, _port  # noqa: E402


@pytest.fixture(scope="module")
def css_pair():
    """(JAX, port) ``StreamingCSS`` per forgetting factor over the same
    MISO1 weights (the SMALL plan, 3 mics, 17 bins, 2000-sample chunks),
    built once: each JAX instance compiles its own block step."""
    jmodel, params, model = _pair("miso1", SMALL, 2)
    cache = {}

    def get(forget):
        if forget not in cache:
            cache[forget] = (
                jcss.StreamingCSS(jmodel, params, STFT, DS, forget=forget),
                tcss.StreamingCSS(model, _port(STFT), _port(DS),
                                  forget=forget))
        return cache[forget]

    return get


def _recording(n=6500):
    rng = np.random.default_rng(9)
    src = rng.standard_normal((2, n)).astype(np.float32)
    return (np.stack([src[0] + 0.5 * src[1], 0.7 * src[0] + src[1],
                      src[0] - src[1]], axis=1)
            + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)


@pytest.mark.parametrize("overlap", [0, 500])
@pytest.mark.parametrize("forget", [1.0, 0.9])
def test_streaming_css_matches_jax(css_pair, forget, overlap):
    jev, tev = css_pair(forget)
    wave = _recording()
    want = jev.process(wave, overlap=overlap)
    got = tev.process(wave, overlap=overlap)
    assert set(got) == set(want) == {"beamformed", "miso1"}
    for k in want:
        assert got[k].shape == (2, wave.shape[0])
        assert np.isfinite(got[k]).all()
        _close(got[k], np.asarray(want[k]), 1e-3)


def test_state_accumulates_like_jax(css_pair):
    """Block by block: the running SCMs and the forgetting-weighted frame
    count follow the JAX state."""
    jev, tev = css_pair(0.9)
    pieces, _ = split_chunks(_recording(4000), DS.chunk_samples)
    jstate, tstate = jev.init_state(2), tev.init_state(2)
    assert float(tstate.frames) == 0.0
    for p in pieces:
        jstate, _, _ = jev.process_block(jstate, p)
        tstate, _, _ = tev.process_block(tstate, p)
        np.testing.assert_allclose(float(tstate.frames),
                                   float(jstate.frames), rtol=1e-6)
        for k in ("source_scm", "noise_scm"):
            _close(getattr(tstate, k).numpy(),
                   np.asarray(getattr(jstate, k)), 1e-4)


def test_crossfade_stitch_matches_jax():
    rng = np.random.default_rng(3)
    sig = rng.standard_normal((2, 1000)).astype(np.float32)
    chunk, hop = 300, 200
    n = -(-(1000 - (chunk - hop)) // hop)
    padded = np.pad(sig, [(0, 0), (0, (n - 1) * hop + chunk - 1000)])
    blocks = np.stack([padded[:, i * hop : i * hop + chunk]
                       for i in range(n)])
    out = tcss.crossfade_stitch(blocks, hop, 1000)
    np.testing.assert_allclose(out, sig, atol=1e-6)   # consistent blocks
    noisy = blocks + rng.standard_normal(blocks.shape).astype(np.float32)
    np.testing.assert_array_equal(tcss.crossfade_stitch(noisy, hop, 1000),
                                  jcss.crossfade_stitch(noisy, hop, 1000))

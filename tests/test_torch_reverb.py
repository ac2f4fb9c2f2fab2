"""The REVERB 2-mix plan (configs/reverb_2mix.yml: 8 levels, F = 257, 8
mics, a 384-channel bottleneck and TCN) through the PyTorch port against
the JAX package, on the plain path in float32 at B = 1, T = 8 frames.

Both packages load the YAML with their own ``load_yaml``; the JAX
parameters are drawn from a numpy seed over the shapes of the JAX
model's init (``jax.eval_shape``: no compile) and reach the port through
``load_jax_params``.  One JAX compile: the jitted forward.  Tolerance: the
port's separated spectrogram within 1e-4 of the JAX output's max-abs
(float32, 8 levels of convs summed in another order)."""

import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu.config import load_yaml as jax_load_yaml  # noqa: E402
from misonet_tpu.models import make_miso1 as jax_miso1  # noqa: E402
from misonet_tpu_torch.config import load_yaml  # noqa: E402
from misonet_tpu_torch.models import make_miso1  # noqa: E402
from misonet_tpu_torch.utils.weights import load_jax_params  # noqa: E402

CONFIG = Path(__file__).parent.parent / "configs" / "reverb_2mix.yml"
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(shapes, rng):
    """numpy values over a tree of ShapeDtypeStructs: conv kernels
    LeCun-normal, biases and norm shifts 0.1-normal, norm gains 1 +
    0.1-normal, PReLU slopes 0.25."""
    out = {}
    for name, leaf in shapes.items():
        if hasattr(leaf, "items"):
            out[name] = _seeded(leaf, rng)
            continue
        shape = leaf.shape
        if name.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "alpha":
            v = np.full(shape, 0.25)
        elif name == "gamma":
            v = 1 + 0.1 * rng.standard_normal(shape)
        else:   # biases, norm shifts
            v = 0.1 * rng.standard_normal(shape)
        out[name] = jnp.asarray(v.astype(np.float32))
    return out


def test_reverb_plan_forward_matches_jax():
    jcfg = jax_load_yaml(CONFIG)
    tcfg = load_yaml(CONFIG)
    assert dataclasses.asdict(tcfg.miso1) == dataclasses.asdict(jcfg.miso1)
    jmodel = jax_miso1(dataclasses.replace(jcfg.miso1,
                                           compute_dtype="float32"))
    b, c, t, f = 1, tcfg.dataset.num_ch, 8, tcfg.stft.num_bins
    assert (c, f, tcfg.miso1.num_bottleneck) == (8, 257, 8)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((b, c, t, f))
         + 1j * rng.standard_normal((b, c, t, f))).astype(np.complex64)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x))
    params = {"params": _seeded(shapes["params"], rng)}
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))

    model = make_miso1(dataclasses.replace(tcfg.miso1,
                                           compute_dtype="float32"),
                       num_mics=c, device="cpu")
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (b, 2, t, f)
    assert np.isfinite(got).all()
    top = np.abs(want).max()
    err = np.abs(got - want).max() / top
    assert err <= TOL, err

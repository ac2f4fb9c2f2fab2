"""PyTorch port: the training losses (misonet_tpu_torch/losses.py) against
the JAX package's misonet_tpu/losses.py, values and gradients.

The same numpy inputs go to both.  The complex estimate enters as its real
and imaginary parts, so both frameworks differentiate with respect to two
real arrays.  Tolerance: float32 on both sides, summed in another order;
bound 1e-5 of max-abs for each value and gradient."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu import losses as jl  # noqa: E402
from misonet_tpu_torch import losses as tl  # noqa: E402

ATOL = 1e-5


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(out / scale, ref / scale, atol=ATOL)


def _inputs(seed, b=3, s=2, t=5, f=9):
    rng = np.random.default_rng(seed)
    est = rng.standard_normal((2, b, s, t, f)).astype(np.float32)
    ref = rng.standard_normal((2, b, s, t, f)).astype(np.float32)
    return est, ref[0] + 1j * ref[1]


LOSSES = {
    "upit": (jl.loss_upit, tl.loss_upit),
    "upit_overest": (lambda e, r: jl.loss_upit_overest(e, r, 0.3),
                     lambda e, r: tl.loss_upit_overest(e, r, 0.3)),
    "enhance": (jl.loss_enhance, tl.loss_enhance),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("spks", [1, 2, 3])
def test_loss_and_gradient_match_jax(name, spks):
    jfn, tfn = LOSSES[name]
    est, ref = _inputs(spks, s=spks)
    ref = ref.astype(np.complex64)

    def jloss(re, im):
        return jfn(jax.lax.complex(re, im), jnp.asarray(ref))

    jval, (jre, jim) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(est[0]), jnp.asarray(est[1]))

    re = torch.from_numpy(est[0]).requires_grad_()
    im = torch.from_numpy(est[1]).requires_grad_()
    val = tfn(torch.complex(re, im), torch.from_numpy(ref))
    val.backward()
    assert val.dim() == 0
    _close(val.detach().numpy(), np.asarray(jval))
    _close(re.grad.numpy(), np.asarray(jre))
    _close(im.grad.numpy(), np.asarray(jim))


def test_best_permutation_matches_jax():
    rng = np.random.default_rng(7)
    dist = rng.uniform(0.0, 10.0, (16, 3, 3)).astype(np.float32)
    want = np.asarray(jl.best_permutation(jnp.asarray(dist)))
    got = tl.best_permutation(torch.from_numpy(dist))
    np.testing.assert_array_equal(got.numpy(), want)


def test_magnitude_distance_matches_jax():
    est, ref = _inputs(4, s=2)
    est = (est[0] + 1j * est[1]).astype(np.complex64)
    ref = ref.astype(np.complex64)
    want = jl.magnitude_distance(jnp.asarray(est), jnp.asarray(ref))
    got = tl.magnitude_distance(torch.from_numpy(est), torch.from_numpy(ref))
    _close(got.numpy(), np.asarray(want))
